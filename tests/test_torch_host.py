"""The port's copied host parse (libjxl_tpu_torch.parse_to_feed) returns
the JAX package's feed bit for bit, on every key, for the committed HDR
corpus and for streams of the JAX package's own encoder at efforts 3, 5
and 7 (which mix big-block classes and take both the single-section and
the multi-section frame paths)."""

import os

import numpy as np
import pytest

from libjxl_tpu.api import simple
from libjxl_tpu.tpu.batch_decode import parse_to_feed as jax_parse
import libjxl_tpu_torch
from libjxl_tpu_torch.tpu.batch_decode import parse_to_feed

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_corpus")


def _image(h, w, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.clip(0.5 + 0.3 * np.sin(x / (11 + 2 * c) + c)
                            * np.cos(y / 17)
                            + rng.normal(0, 0.02, (h, w)), 0, 1)
                    for c in range(3)], axis=-1)
    return (img * 255).astype(np.uint8)


def assert_same(a, b, path="feed"):
    """Equal types, dtypes, shapes and values, recursively (header
    objects are the two packages' own classes: same name, same fields)."""
    assert type(a).__name__ == type(b).__name__, path
    if isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b), path
        assert np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__"):
        assert vars(a) == vars(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", ["1080p_hdr_pq_d1_e5_prog_epf3.jxl",
                                  "4k_hdr_pq_d1_e5_prog_epf3_0.jxl"])
def test_corpus_feed_bit_exact(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        data = f.read()
    feed = parse_to_feed(data)
    assert_same(jax_parse(data), feed)
    assert feed["coeff_nz"][0].size > 0 and feed["lf"].epf_iters == 3


@pytest.mark.parametrize("shape", [(96, 96), (200, 304)])
@pytest.mark.parametrize("effort", [3, 5, 7])
def test_own_encoder_feed_bit_exact(effort, shape):
    data = simple.encode(_image(*shape), distance=1.0, effort=effort)
    assert_same(jax_parse(data), parse_to_feed(data))


def test_container_feed_bit_exact():
    data = simple.encode(_image(64, 80), distance=1.0, effort=5,
                         container=True)
    assert_same(jax_parse(data), parse_to_feed(data))


def _screenshot():
    """Repeated glyphs: the encoder stores them as patches of a
    reference frame."""
    img = np.full((96, 160, 3), 235, np.uint8)
    glyph = np.zeros((9, 7), bool)
    glyph[1:8, 1] = True
    glyph[1, 2:6] = True
    glyph[4, 2:5] = True
    for y in range(6, 80, 24):
        for x in range(6, 150, 13):
            img[y:y + 9, x:x + 7][glyph] = (30, 30, 120)
    return img


def _rgba():
    img = _image(64, 64)
    return np.concatenate([img, np.full((64, 64, 1), 200, np.uint8)], -1)


def _splines_upsampled():
    """A 2x-resampled frame that also carries a spline."""
    from libjxl_tpu.api.simple import CodecMetadata
    from libjxl_tpu.bitstream.bit_io import BitWriter
    from libjxl_tpu.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    from libjxl_tpu.frame.encode_frame import encode_vardct_frame
    from libjxl_tpu.frame.headers import BitDepth, write_codestream_headers
    from libjxl_tpu.frame.splines import Splines, quantize_spline
    cps = [(10.0, 20.0), (40.0, 10.0), (60.0, 50.0)]
    color_dct = np.zeros((3, 32))
    color_dct[1, 0] = 0.4
    sigma_dct = np.zeros(32)
    sigma_dct[0] = 2.0
    s = Splines(splines=[quantize_spline(cps, color_dct, sigma_dct, 0,
                                         0.0, 1.0)],
                starting_points=[cps[0]])
    meta = CodecMetadata()
    meta.size.set(80, 64)
    meta.m.bit_depth = BitDepth.uint(8)
    meta.m.xyb_encoded = True
    w = BitWriter()
    write_codestream_headers(meta, w)
    srgb = _image(64, 80).astype(np.float32) / 255.0
    xyb = linear_rgb_to_xyb(srgb_to_linear(srgb).transpose(2, 0, 1))
    encode_vardct_frame(xyb, meta, w, distance=1.0, effort=5, splines=s,
                        resampling=2)
    w.align_to_byte()
    return w.get_bytes()


def _parse_every_frame(data):
    """The port's frame decode on its feed route on every frame of the
    stream in order (the patch sheet is a frame of its own, ahead of the
    frame that uses it)."""
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    r = BitReader(data)
    meta = read_codestream_headers(r)
    while not decode_frame(r, meta, device="feed").header.is_last:
        pass


@pytest.mark.parametrize("make,stage", [
    (lambda: simple.encode(_screenshot(), distance=1.0, effort=5,
                           patches=True), "patches"),
    (lambda: simple.encode(_rgba(), distance=1.0, effort=5),
     "extra channels"),
    (_splines_upsampled, "splines together with upsampling"),
], ids=["patches", "extra_channels", "splines_upsampled"])
def test_unported_stage_raises(make, stage):
    """Frame features the feed cannot carry raise on the feed route,
    naming the feature (noise, upsampling and splines alone ride in the
    feed: see tests/test_torch_stages.py; the port's decode API renders
    all three features: tests/test_torch_api.py)."""
    with pytest.raises(NotImplementedError, match=stage):
        _parse_every_frame(make())


POST_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_corpus")


@pytest.mark.parametrize("name,stages", [
    ("4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl",
     {"upsample", "noise", "final_hw"}),
    ("1080p_splines_d1.jxl", {"splines", "final_hw"})])
def test_post_corpus_feed_bit_exact(name, stages):
    """The committed post-stage streams: the feed equals JAX's bit for
    bit apart from the port's ``"post"`` entry (the reference's feed
    path drops the stages)."""
    with open(os.path.join(POST_CORPUS, name), "rb") as f:
        data = f.read()
    feed = parse_to_feed(data)
    post = feed.pop("post")
    assert set(post) == stages
    assert_same(jax_parse(data), feed)
    assert feed["image_hw"] == (1080, 1920)
    assert post["final_hw"] == ((2160, 3840) if "upsample" in stages
                                else (1080, 1920))


def test_package_reexports_entry_points():
    assert libjxl_tpu_torch.parse_to_feed is parse_to_feed
    assert callable(libjxl_tpu_torch.decode_device)


def test_native_sanitizer_build_command(monkeypatch):
    """JXL_NATIVE_SANITIZE selects the sanitizer build of the host
    library (the command only; nothing is built under ASan here)."""
    from libjxl_tpu_torch.native import build
    out, cmd = build.native_command("address,undefined")
    assert out == build.OUT_SAN and out.endswith("jxl_native.san.so")
    assert {"-fsanitize=address,undefined", "-fno-omit-frame-pointer",
            "-g"} <= set(cmd)
    out, cmd = build.native_command("")
    assert out == build.OUT
    assert not [c for c in cmd if c.startswith("-fsanitize")]
    seen = {}
    monkeypatch.setattr(build, "build_locked",
                        lambda out, src, cmd, force: seen.update(
                            out=out, cmd=cmd) or "")
    monkeypatch.setenv("JXL_NATIVE_SANITIZE", "address")
    assert build.build() == build.OUT_SAN
    assert "-fsanitize=address" in seen["cmd"] and seen["out"] == build.OUT_SAN
    monkeypatch.delenv("JXL_NATIVE_SANITIZE")
    assert build.build() == build.OUT and "-g" not in seen["cmd"]
