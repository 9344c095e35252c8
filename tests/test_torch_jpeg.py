"""The port's JPEG parser, writer, transcode and reconstruction
(``libjxl_tpu_torch.extras.jpeg_parser``, ``jpeg_writer``, ``jbrd``,
``jpeg_transcode``) against the JAX package's on the same JPEGs, which
PIL writes here from seeded numpy images (tests only; the port itself
imports no PIL on these paths). Every case is byte for byte, as the
modules are host copies: parsed coefficients equal, written JPEGs,
transcoded codestreams and containers, and reconstructed JPEGs the same
bytes as the reference's. Mirrors ``tests/test_jpeg_transcode.py``."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from libjxl_tpu.extras import jbrd as r_jbrd
from libjxl_tpu.extras import jpeg_parser as r_parser
from libjxl_tpu.extras import jpeg_transcode as r_tc
from libjxl_tpu.extras import jpeg_writer as r_writer
from libjxl_tpu_torch.extras import jbrd as p_jbrd
from libjxl_tpu_torch.extras import jpeg_parser as p_parser
from libjxl_tpu_torch.extras import jpeg_transcode as p_tc
from libjxl_tpu_torch.extras import jpeg_writer as p_writer

CORPUS_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_corpus", "1024x768_photo_q85_420.jpg")


def _img(h=120, w=152, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(128 + 90 * np.sin(x / 17)),
                     (128 + 70 * np.cos(y / 13)),
                     (120 + 60 * np.sin((x + y) / 23))], -1)
    return np.clip(base + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _jpeg(img, quality=85, subsampling=0, progressive=False):
    buf = io.BytesIO()
    if img.ndim == 2:
        Image.fromarray(img, "L").save(buf, "JPEG", quality=quality,
                                       progressive=progressive)
    else:
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=subsampling,
                                  progressive=progressive)
    return buf.getvalue()


def _gray(h=240, w=320):
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(128 + 90 * np.sin(x / 17) * np.cos(y / 13),
                   0, 255).astype(np.uint8)


def _with_restarts(data: bytes, interval: int, jbrd) -> bytes:
    """A restart-marker variant of ``data`` through the given package's
    spec writer (as ``tests/test_jpeg_transcode.py:_with_restarts``):
    DRI before the first scan, complete Huffman tables, no recorded
    flush points."""
    jd = jbrd.parse_jpeg_full(data)
    jd.restart_interval = interval
    jd.marker_order.insert(jd.marker_order.index(0xDA), 0xDD)
    for hc in jd.huffman_code:
        hc.counts = [0] * 17
        if hc.slot_id & 0x10:
            hc.counts[8], hc.counts[9] = 200, 57
            hc.values = list(range(256)) + [0]
        else:
            hc.counts[4] = 13
            hc.values = list(range(12)) + [0]
    for scan in jd.scan_info:
        scan.reset_points = []
        scan.extra_zero_runs = []
    return jbrd.write_jpeg_full(jd)


# name -> JPEG bytes; built once per module.
_CASES = {
    "444": lambda: _jpeg(_img()),
    "422": lambda: _jpeg(_img(), subsampling=1),
    "420": lambda: _jpeg(_img(), subsampling=2),
    "420_multigroup": lambda: _jpeg(_img(300, 360, seed=1), quality=80,
                                    subsampling=2),
    "gray": lambda: _jpeg(_gray()),
    "prog_444": lambda: _jpeg(_img(), progressive=True),
    "prog_422": lambda: _jpeg(_img(), subsampling=1, progressive=True),
    "prog_420": lambda: _jpeg(_img(), subsampling=2, progressive=True),
    "restart_seq": lambda: _with_restarts(_jpeg(_img(), subsampling=2),
                                          3, r_jbrd),
    "restart_prog": lambda: _with_restarts(
        _jpeg(_img(), subsampling=2, progressive=True), 1, r_jbrd),
}
_MEMO: dict = {}


def _case(name):
    if name not in _MEMO:
        _MEMO[name] = _CASES[name]()
    return _MEMO[name]


@pytest.mark.parametrize("name", sorted(_CASES))
def test_parse_matches_reference(name):
    """Parsed header fields and every component's coefficients equal
    the reference parser's (exact)."""
    data = _case(name)
    a, b = r_parser.parse_jpeg(data), p_parser.parse_jpeg(data)
    assert (a.width, a.height, a.progressive) == \
        (b.width, b.height, b.progressive)
    assert sorted(a.quant_tables) == sorted(b.quant_tables)
    for k in a.quant_tables:
        np.testing.assert_array_equal(a.quant_tables[k],
                                      b.quant_tables[k])
    assert len(a.components) == len(b.components)
    for ca, cb in zip(a.components, b.components):
        assert (ca.h_samp, ca.v_samp) == (cb.h_samp, cb.v_samp)
        np.testing.assert_array_equal(ca.coeffs, cb.coeffs)


@pytest.mark.parametrize("name", ["444", "420", "gray", "prog_420"])
def test_writer_matches_reference(name):
    """``write_jpeg`` of a parse: the same bytes as the reference's."""
    data = _case(name)
    out = p_writer.write_jpeg(p_parser.parse_jpeg(data))
    assert out == r_writer.write_jpeg(r_parser.parse_jpeg(data))


@pytest.mark.parametrize("name", ["444", "prog_420", "restart_prog"])
def test_jbrd_full_parse_write_matches_reference(name):
    """The spec parser and writer of ``jbrd``: the port's rewrite is
    the reference's, and the source JPEG comes back byte for byte."""
    data = _case(name)
    out = p_jbrd.write_jpeg_full(p_jbrd.parse_jpeg_full(data))
    assert out == r_jbrd.write_jpeg_full(r_jbrd.parse_jpeg_full(data))
    assert out == data


def test_restart_variant_built_by_port_matches():
    """The restart-marker variant built through the port's ``jbrd`` is
    the reference's, byte for byte."""
    src = _jpeg(_img(), subsampling=2)
    assert _with_restarts(src, 3, p_jbrd) == _case("restart_seq")


@pytest.mark.parametrize("name", ["444", "422", "420", "420_multigroup",
                                  "gray", "prog_420"])
def test_transcode_matches_reference(name):
    """``transcode_jpeg`` (bare codestream) and ``transcode_jxl_to_jpeg``
    (JPEG regenerated from it): the reference's bytes."""
    data = _case(name)
    jxl = p_tc.transcode_jpeg(data)
    assert jxl == r_tc.transcode_jpeg(data)
    assert p_tc.transcode_jxl_to_jpeg(jxl) == r_tc.transcode_jxl_to_jpeg(jxl)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_container_and_reconstruction_match_reference(name):
    """``transcode_jpeg_container`` (codestream + jbrd box): the
    reference's bytes; ``reconstruct_jpeg`` gives the input JPEG back
    byte for byte."""
    data = _case(name)
    box = p_tc.transcode_jpeg_container(data)
    assert box == r_tc.transcode_jpeg_container(data)
    assert p_tc.reconstruct_jpeg(box) == data


def test_corpus_jpeg_committed_and_round_trips():
    """The committed 1024x768 q85 4:2:0 JPEG of the card's checks:
    baseline, at most 200 KB, parsed as the reference parses it, and
    transcoded and reconstructed byte for byte."""
    with open(CORPUS_JPEG, "rb") as f:
        data = f.read()
    assert len(data) <= 200_000
    jd = p_parser.parse_jpeg(data)
    assert (jd.width, jd.height, jd.progressive) == (1024, 768, False)
    assert (jd.components[0].h_samp, jd.components[0].v_samp) == (2, 2)
    box = p_tc.transcode_jpeg_container(data)
    assert box == r_tc.transcode_jpeg_container(data)
    assert p_tc.reconstruct_jpeg(box) == data


def test_parse_garbage_raises():
    for bad in (b"\x00" * 100, b"\xff\xd8" + b"\x12" * 50):
        with pytest.raises(p_parser.JpegError):
            p_parser.parse_jpeg(bad)
