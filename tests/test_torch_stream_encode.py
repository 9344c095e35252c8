"""The rest of the port's encode API against the JAX package's, on the
same seeded numpy inputs:

- ``encode_animation`` (host, as in the reference): lossless, lossy and
  alpha-blended animations, byte for byte (mirrors
  ``tests/test_animation.py:19``, ``:31``);
- ``encode_streaming``: the multi-chunk stream (chunks on the host) byte
  for byte, one ``get_chunk`` call per DC-group chunk, and
  ``streaming_permutation`` (mirrors ``tests/test_streaming_api.py:223-297``);
  a single-group image takes the one-shot ``encode`` on the given torch
  device, which on the CPU is byte for byte the reference's
  ``encode(..., device=True)``;
- ``api.encoder.Encoder`` (the JxlEncoder analogue) with ``device``: a
  single frame byte for byte the reference's ``encode(...,
  device=True)``, an animation byte for byte the reference's
  ``Encoder``, and ``stats()`` accounting for every bit (mirrors
  ``tests/test_streaming_api.py:304``).

Without a card, the default device raises the port's "no CUDA device"
error for a lossy single frame; ``encode_animation`` needs no card."""

import numpy as np
import pytest
import torch

from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.api.encoder import Encoder as RefEncoder
from libjxl_tpu_torch import api as port_api
from libjxl_tpu_torch.api.encoder import Encoder, FrameSettingId, \
    FrameSettings


def _frames(n=4, h=40, w=50):
    y, x = np.mgrid[0:h, 0:w]
    return [np.stack([(x * 3 + t * 40) % 256, (y * 2 + t * 10) % 256,
                      (x + y + t * 5) % 256], -1).astype(np.uint8)
            for t in range(n)]


def _rgba_frames(n=3, h=56, w=72, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fr = np.zeros((h, w, 4), np.uint8)
        fr[:, :, :3] = np.clip(rng.normal(100 + 30 * i, 35, (h, w, 3)),
                               0, 255)
        a = np.zeros((h, w), np.uint8)
        a[6 * i:40 + 4 * i, 8:64] = 255
        a[25:30, :] = 100
        fr[:, :, 3] = a
        out.append(fr)
    return out


def _image(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = np.outer(np.sin(np.linspace(0, 9, h)),
                    np.cos(np.linspace(0, 21, w)))[..., None] * 100 + 128
    return np.clip(base + rng.normal(0, 10, (h, w, 3)),
                   0, 255).astype(np.uint8)


# One single-group image for every comparison with the reference's
# device encoder (one shape, one compilation of its jitted stages).
_SMALL = _image(120, 160, seed=9)
_REF_DEVICE: dict = {}


def _ref_device_encode(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _REF_DEVICE:
        _REF_DEVICE[key] = ref_api.encode(_SMALL, device=True, **kw)
    return _REF_DEVICE[key]


@pytest.mark.parametrize("kw", [
    dict(lossless=True, durations=[1, 2, 3, 4], tps=(24, 1)),
    dict(distance=1.0),
    dict(distance=2.0, num_loops=3),
], ids=["lossless", "lossy", "lossy_loops"])
def test_encode_animation_matches_reference(kw):
    frames = _frames(4 if kw.get("lossless") else 3)
    assert port_api.encode_animation(frames, **kw) == \
        ref_api.encode_animation(frames, **kw)


@pytest.mark.parametrize("lossless", [False, True])
def test_encode_animation_rgba_matches_reference(lossless):
    """RGBA frames; lossy ones compose with alpha (blend=True) through
    reference slot 1."""
    frames = _rgba_frames()
    kw = dict(lossless=True) if lossless else dict(distance=1.0,
                                                    blend=True)
    data = port_api.encode_animation(frames, **kw)
    assert data == ref_api.encode_animation(frames, **kw)


def test_encode_animation_runs_without_card(monkeypatch):
    """The host-only encoder takes no device and needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _frames(2)
    assert port_api.encode_animation(frames, distance=1.0) == \
        ref_api.encode_animation(frames, distance=1.0)


def test_encode_animation_decodes_exact():
    """A lossless animation decodes to its frames on the port's decode
    (on the CPU)."""
    frames = _frames()
    d = port_api.encode_animation(frames, lossless=True,
                                  durations=[1, 2, 3, 4], tps=(24, 1))
    out, meta = port_api.decode_all(d, device="cpu")
    assert meta.m.have_animation and meta.m.animation.tps_numerator == 24
    assert [o.duration for o in out] == [1, 2, 3, 4]
    for f, o in zip(frames, out):
        np.testing.assert_array_equal(o.pixels, f)


def test_encode_streaming_multi_chunk_matches_reference():
    """2500x300: two DC-group chunks side by side, one call each, and
    the reference's bytes (the chunks are encoded on the host whatever
    the device)."""
    img = _image(300, 2500)
    calls = []

    def chunk(x0, y0, w, h):
        calls.append((x0, y0, w, h))
        return img[y0:y0 + h, x0:x0 + w]

    data = port_api.encode_streaming(chunk, 2500, 300, distance=1.0,
                                     device="cpu")
    assert calls == [(0, 0, 2048, 300), (2048, 0, 452, 300)]
    assert data == ref_api.encode_streaming(
        lambda x0, y0, w, h: img[y0:y0 + h, x0:x0 + w], 2500, 300,
        distance=1.0)
    out = port_api.decode(data, device="cpu").pixels
    err = np.abs(out.astype(int) - img.astype(int))
    assert err.max() < 64
    assert np.sqrt((err.astype(float) ** 2).mean()) < 12


def test_encode_streaming_single_chunk_takes_device_encode():
    """A single-group image: the one-shot encode on the device, which on
    the CPU is the reference's ``encode(..., device=True)`` byte for
    byte."""
    data = port_api.encode_streaming(
        lambda x0, y0, w, h: _SMALL[y0:y0 + h, x0:x0 + w], 160, 120,
        distance=1.0, device="cpu")
    assert data == _ref_device_encode(distance=1.0)


def test_streaming_permutation_matches_reference():
    from libjxl_tpu.frame.streaming_encode import \
        streaming_permutation as ref_perm
    from libjxl_tpu_torch.base.frame_dimensions import FrameDimensions
    from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
    from libjxl_tpu_torch.bitstream.toc import read_toc, write_toc
    from libjxl_tpu_torch.frame.streaming_encode import \
        streaming_permutation
    for w, h in ((2500, 300), (4200, 2300), (300, 300)):
        fd = FrameDimensions.make(w, h)
        perm = streaming_permutation(fd)
        from libjxl_tpu.base.frame_dimensions import FrameDimensions as RFD
        assert perm == ref_perm(RFD.make(w, h))
    fd = FrameDimensions.make(2500, 300)
    perm = streaming_permutation(fd)
    n = 2 + fd.num_dc_groups + fd.num_groups
    assert sorted(perm) == list(range(n))
    assert perm[1 + fd.num_dc_groups] == n - 1     # ACGlobal last
    sizes_canonical = [10 + 3 * i for i in range(n)]
    stream_order = [0] * n
    for old, new in enumerate(perm):
        stream_order[new] = old
    wtr = BitWriter()
    write_toc([sizes_canonical[o] for o in stream_order], wtr,
              permutation=perm)
    wtr.align_to_byte()
    sizes, _ = read_toc(n, BitReader(wtr.get_bytes()))
    assert list(sizes) == sizes_canonical


@pytest.mark.parametrize("kw", [dict(distance=1.0),
                                dict(distance=2.0, effort=5)],
                         ids=["d1_e7", "d2_e5"])
def test_encoder_single_frame_matches_device_encode(kw):
    enc = Encoder(device="cpu")
    enc.add_image_frame(_SMALL, FrameSettings(**kw))
    assert enc.process_output() == _ref_device_encode(**kw)


def test_encoder_container_with_boxes_matches_reference_packing():
    """Boxes wrap the device-encoded codestream as the reference's
    ``pack_container`` does."""
    from libjxl_tpu.container.boxes import pack_container
    enc = Encoder(device="cpu")
    enc.add_image_frame(_SMALL, FrameSettings(distance=1.0))
    enc.add_box(b"Exif", b"\x00\x00\x00\x00II*\x00")
    enc.add_box(b"xml ", b"<x/>")
    assert enc.process_output() == pack_container(
        _ref_device_encode(distance=1.0),
        exif=b"\x00\x00\x00\x00II*\x00", xml=[b"<x/>"])


@pytest.mark.parametrize("lossless", [False, True])
def test_encoder_animation_matches_reference(lossless):
    """Several frames go through ``encode_animation`` on the host: the
    reference ``Encoder``'s bytes, whatever the device."""
    frames = _frames(3)
    out = []
    for enc in (Encoder(animation_tps=(30, 1), num_loops=2, device="cpu"),
                RefEncoder(animation_tps=(30, 1), num_loops=2)):
        for i, f in enumerate(frames):
            enc.add_image_frame(f, FrameSettings(distance=1.0,
                                                 lossless=lossless,
                                                 duration=i + 1))
        out.append(enc.process_output())
    assert out[0] == out[1]


def test_encoder_stats_account_every_bit():
    enc = Encoder(collect_stats=True, device="cpu")
    enc.add_image_frame(_SMALL)
    data = enc.process_output()
    st = enc.stats()
    assert st["total_bits"] == len(data) * 8 - (-st["total_bits"] % 8) \
        or abs(st["total_bits"] - len(data) * 8) < 64
    assert st["layers_bits"]["ac_tokens"] > 0
    assert st["layers_bits"]["dc"] > 0
    assert st["layers_bits"]["header"] > 0
    assert st["num_blocks"] > 0
    assert 0 < st["bpp"] < 24


def test_encoder_stats_lossless():
    enc = Encoder(collect_stats=True, device="cpu")
    enc.add_image_frame(_frames(1)[0], FrameSettings(lossless=True))
    enc.process_output()
    assert enc.stats()["layers_bits"]["modular_global"] > 0


def test_frame_setting_ids():
    fs = FrameSettings()
    fs.set_option(FrameSettingId.EFFORT, 3)
    assert fs.effort == 3
    fs.set_option(FrameSettingId.RESAMPLING, 2)
    assert fs.resampling == 2
    fs.set_option(FrameSettingId.PHOTON_NOISE, 800)
    assert fs.photon_noise_iso == 800
    fs.set_option(FrameSettingId.PATCHES, 0)
    assert fs.patches is False
    fs.set_option(FrameSettingId.BROTLI_EFFORT, 9)
    assert fs.options[FrameSettingId.BROTLI_EFFORT] == 9
    with pytest.raises(ValueError):
        fs.set_option(FrameSettingId.EFFORT, 11)
    fs.set_distance(0.0)
    assert fs.lossless
    with pytest.raises(ValueError):
        fs.set_distance(26.0)
    assert len(FrameSettingId) == 41


def test_aux_out_matches_reference():
    """``AuxOut`` block counters and summary: the reference's."""
    from libjxl_tpu.frame.aux_out import AuxOut as RefAux
    from libjxl_tpu_torch.frame.aux_out import AuxOut
    strat = np.random.default_rng(4).integers(-1, 27, (30, 40))
    a, b = AuxOut(), RefAux()
    for x in (a, b):
        x.count_strategies(strat)
        x.add("ac_tokens", 1234)
        x.add("header", 77)
    assert a.summary(4800) == b.summary(4800)


def test_default_device_raises_without_card(monkeypatch):
    """``Encoder`` defaults to ``cuda``: a lossy frame raises the port's
    "no CUDA device" error without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = Encoder()
    enc.add_image_frame(_SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.process_output()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.encode_streaming(
            lambda x0, y0, w, h: _SMALL[y0:y0 + h, x0:x0 + w], 160, 120)
