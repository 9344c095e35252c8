"""The port's low-memory row-streaming decode
(``libjxl_tpu_torch.frame.low_memory.decode_low_memory`` over
``frame/incremental.py``, re-exported by ``libjxl_tpu_torch.api``)
against the reference's ``decode_low_memory`` on the same streams,
which the JAX package's host encoder writes from seeded numpy images.
Both run native whole-frame reconstruction on the host, so every band
is held exact: the same ``(y0, rows)`` calls, rows equal to the last
bit. The reference's own tests compare low-memory output with a one-shot
host ``decode``, whose pixels depend on the CPU count (ROADMAP queue 3,
caveat 1); these do not. Mirrors ``tests/test_low_memory.py``."""

import numpy as np
import pytest

from libjxl_tpu.api.simple import encode
from libjxl_tpu.frame.low_memory import decode_low_memory as ref_lowmem
from libjxl_tpu_torch.api import decode_low_memory as port_lowmem
from libjxl_tpu_torch.frame.incremental import NotSupported


def _img(h, w, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.clip(0.5 + 0.3 * np.sin(x / 17 + c) * np.cos(y / 23)
                     + rng.normal(0, 0.02, (h, w)), 0, 1)
             for c in range(3)]
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _bands(fn, data):
    got = []
    hw = fn(data, lambda y0, rows: got.append((y0, np.array(rows))))
    return hw, got


def _assert_same_bands(data):
    """Port and reference give the same size and the same bands, and
    the bands tile the image in order."""
    (hw_r, ref), (hw_p, out) = _bands(ref_lowmem, data), \
        _bands(port_lowmem, data)
    assert hw_p == hw_r
    assert [(y0, r.shape) for y0, r in out] == \
        [(y0, r.shape) for y0, r in ref]
    covered = 0
    for (y0, a), (_, b) in zip(ref, out):
        assert y0 == covered
        covered += a.shape[0]
        assert b.dtype == a.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
    assert covered == hw_r[0]
    return len(out)


@pytest.mark.parametrize("epf", [-1, 0, 3])
def test_lowmem_matches_reference_epf(epf):
    data = encode(_img(600, 330), distance=1.0, effort=5, epf=epf)
    assert _assert_same_bands(data) >= 3


def test_lowmem_ragged_multicolumn():
    data = encode(_img(333, 777, seed=9), distance=2.0, effort=4)
    assert _assert_same_bands(data) >= 2


def test_lowmem_progressive():
    data = encode(_img(600, 300, seed=3), distance=1.5, progressive=True)
    _assert_same_bands(data)


def test_lowmem_noise():
    data = encode(_img(520, 300, seed=4), distance=1.0, noise=3200.0)
    _assert_same_bands(data)


def test_lowmem_upsampling():
    data = encode(_img(360, 260, seed=6), distance=1.0, resampling=2)
    _assert_same_bands(data)


def test_lowmem_progressive_epf_noise_combo():
    data = encode(_img(560, 280, seed=7), distance=2.0, progressive=True,
                  epf=2, noise=1600.0)
    _assert_same_bands(data)


def test_lowmem_small_single_section():
    _assert_same_bands(encode(_img(64, 80, seed=2), distance=1.0))


def _xyb(img):
    from libjxl_tpu.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    srgb = img.astype(np.float32) / 255.0
    return linear_rgb_to_xyb(srgb_to_linear(srgb).transpose(2, 0, 1))


def _header(h, w):
    from libjxl_tpu.bitstream.bit_io import BitWriter
    from libjxl_tpu.frame.headers import (BitDepth, CodecMetadata,
                                          write_codestream_headers)
    meta = CodecMetadata()
    meta.size.set(w, h)
    meta.m.bit_depth = BitDepth.uint(8)
    meta.m.xyb_encoded = True
    wtr = BitWriter()
    write_codestream_headers(meta, wtr)
    return meta, wtr


def test_lowmem_splines():
    """Spline strokes across several bands (tests/test_low_memory.py
    ``_spline_stream``)."""
    from libjxl_tpu.frame.encode_frame import encode_vardct_frame
    from libjxl_tpu.frame.splines import Splines, quantize_spline
    h, w = 600, 280
    meta, wtr = _header(h, w)
    cps = [(10.0, 20.0), (120.0, 300.0), (200.0, 560.0)]
    color_dct = np.zeros((3, 32))
    color_dct[1, 0] = 0.5
    sigma_dct = np.zeros(32)
    sigma_dct[0] = 2.0
    qs = quantize_spline(cps, color_dct, sigma_dct, 0, 0.0, 1.0)
    encode_vardct_frame(_xyb(_img(h, w, seed=8)), meta, wtr, distance=1.0,
                        splines=Splines(splines=[qs],
                                        starting_points=[cps[0]]))
    wtr.align_to_byte()
    _assert_same_bands(wtr.get_bytes())


def test_lowmem_patches():
    """A reference frame decoded whole, then the visible frame streamed
    with band-windowed patch blits (REPLACE and ADD)."""
    from libjxl_tpu.frame.encode_frame import encode_vardct_frame
    from libjxl_tpu.frame.patches import (PatchBlendMode, PatchBlending,
                                          PatchDictionary, PatchPosition,
                                          PatchRefPosition)
    h, w = 600, 280
    meta, wtr = _header(h, w)
    pd = PatchDictionary(
        ref_positions=[PatchRefPosition(ref=1, x0=4, y0=4,
                                        xsize=40, ysize=40)],
        positions=[PatchPosition(x=30, y=230, ref_idx=0),
                   PatchPosition(x=100, y=500, ref_idx=0)],
        blendings=[[PatchBlending(mode=PatchBlendMode.REPLACE)],
                   [PatchBlending(mode=PatchBlendMode.ADD)]])
    encode_vardct_frame(_xyb(_img(64, 64, seed=11)), meta, wtr,
                        distance=1.0, save_as_reference=1)
    encode_vardct_frame(_xyb(_img(h, w, seed=10)), meta, wtr, distance=1.0,
                        patches=pd)
    wtr.align_to_byte()
    _assert_same_bands(wtr.get_bytes())


def test_lowmem_container():
    """A containerized stream unpacks first, as in the reference."""
    data = encode(_img(300, 200, seed=12), distance=1.0, container=True)
    _assert_same_bands(data)


@pytest.mark.parametrize("kw", [dict(lossless=True),
                                dict(distance=1.0, modular=True)])
def test_lowmem_rejects_modular(kw):
    """Modular streams raise the port's NotSupported, as the
    reference's raise its own."""
    from libjxl_tpu.frame.incremental import NotSupported as RefNS
    data = encode(_img(96, 96), **kw)
    with pytest.raises(RefNS):
        ref_lowmem(data, lambda y0, rows: None)
    with pytest.raises(NotSupported):
        port_lowmem(data, lambda y0, rows: None)
