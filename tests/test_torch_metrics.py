"""The port's metrics (``libjxl_tpu_torch.metrics``: ``psnr``,
``max_abs_error``, ``ssimulacra2``) and its two metric tools
(``cli.butteraugli_main``, ``cli.ssimulacra2_main``) against the JAX
package's, on the same seeded numpy images. Both sides are the same
float64 host numpy over the same XYB code, so every value is held to
exact equality; the tools must print the reference tools' text."""

import contextlib
import io

import numpy as np
import pytest

from libjxl_tpu import metrics as ref_metrics
from libjxl_tpu.cli import butteraugli_main as ref_butteraugli_main
from libjxl_tpu.cli import ssimulacra2_main as ref_ssimulacra2_main
from libjxl_tpu.metrics.ssimulacra2 import _RG as REF_RG
from libjxl_tpu.metrics.ssimulacra2 import _fast_gaussian_1d as ref_blur
from libjxl_tpu_torch import metrics
from libjxl_tpu_torch.cli import butteraugli_main, ssimulacra2_main
from libjxl_tpu_torch.extras import codecs
from libjxl_tpu_torch.metrics.ssimulacra2 import _RG, _fast_gaussian_1d


def _img(h=96, w=80, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed),
                     128 + 90 * np.cos(y / 5),
                     120 + 80 * np.sin((x + y) / 11)], -1)
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _pair(kind, seed):
    """A source image and a distorted copy: small noise, heavy noise, a
    shift by one pixel, a constant offset, or the image itself."""
    a = _img(seed=seed)
    rng = np.random.default_rng(100 + seed)
    if kind == "slight":
        d = rng.integers(-2, 3, a.shape)
    elif kind == "heavy":
        d = rng.integers(-40, 41, a.shape)
    elif kind == "shift":
        return a, np.roll(a, 1, axis=1)
    elif kind == "offset":
        d = np.full(a.shape, 5)
    else:
        return a, a.copy()
    return a, np.clip(a.astype(int) + d, 0, 255).astype(np.uint8)


KINDS = ["same", "slight", "heavy", "shift", "offset"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_simple_metrics_equal_reference(kind, seed):
    a, b = _pair(kind, seed)
    assert metrics.psnr(a, b) == ref_metrics.psnr(a, b)
    assert metrics.psnr(a, b, peak=255.0) == ref_metrics.psnr(a, b,
                                                              peak=255.0)
    fa, fb = a / 255.0, b / 255.0
    assert metrics.psnr(fa, fb) == ref_metrics.psnr(fa, fb)
    assert metrics.max_abs_error(a, b) == ref_metrics.max_abs_error(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_ssimulacra2_equals_reference(kind, seed):
    a, b = _pair(kind, seed)
    assert metrics.ssimulacra2(a, b) == ref_metrics.ssimulacra2(a, b)


def test_ssimulacra2_pinned_value():
    """The pinned pair of tests/test_metrics.py, exactly its value."""
    y, x = np.mgrid[0:96, 0:80]
    a = np.stack([(128 + 100 * np.sin(x / 7)).clip(0, 255),
                  (128 + 90 * np.cos(y / 5)).clip(0, 255),
                  (120 + 80 * np.sin((x + y) / 11)).clip(0, 255)],
                 -1).astype(np.uint8)
    b = np.clip(a.astype(int)
                + ((x[..., None] + y[..., None]) % 5 - 2),
                0, 255).astype(np.uint8)
    got = metrics.ssimulacra2(a, b)
    assert got == ref_metrics.ssimulacra2(a, b)
    assert abs(got - 96.46293109504593) < 1e-9


def test_ssimulacra2_odd_and_small_sizes_equal_reference():
    """Odd sizes halve with a ragged edge at every scale; an 8x8 image
    stops the scales early."""
    for h, w in ((37, 53), (8, 8), (129, 7)):
        a = _img(h, w, seed=3)
        b = np.clip(a.astype(int) + 3 * (a % 3) - 3, 0, 255).astype(
            np.uint8)
        assert metrics.ssimulacra2(a, b) == ref_metrics.ssimulacra2(a, b)


def test_recursive_gaussian_equals_reference():
    assert _RG[0] == REF_RG[0]
    for mine, ref in zip(_RG[1:], REF_RG[1:]):
        np.testing.assert_array_equal(mine, ref)
    sig = np.random.default_rng(5).random((7, 61)).astype(np.float32)
    np.testing.assert_array_equal(_fast_gaussian_1d(sig), ref_blur(sig))


def _printed(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.mark.parametrize("tool,ref_tool,extra", [
    (ssimulacra2_main, ref_ssimulacra2_main, ()),
    (butteraugli_main, ref_butteraugli_main, ()),
    (butteraugli_main, ref_butteraugli_main, ("--pnorm", "3")),
], ids=["ssimulacra2", "butteraugli", "butteraugli_pnorm"])
def test_metric_tools_print_reference_text(tmp_path, tool, ref_tool,
                                           extra):
    """Two PPMs: the port's tool (PPM through the in-tree reader) prints
    what the reference's tool (PIL) prints."""
    a, b = _pair("slight", 4)
    pa, pb = tmp_path / "a.ppm", tmp_path / "b.ppm"
    pa.write_bytes(codecs.encode_pnm(a))
    pb.write_bytes(codecs.encode_pnm(b))
    got = _printed(tool.main, pa, pb, *extra)
    assert got == _printed(ref_tool.main, pa, pb, *extra)
    assert got[0] == 0 and got[1].strip()


def test_ssimulacra2_tool_size_mismatch_matches_reference(tmp_path):
    a = _img(32, 40)
    pa, pb = tmp_path / "a.ppm", tmp_path / "b.ppm"
    pa.write_bytes(codecs.encode_pnm(a))
    pb.write_bytes(codecs.encode_pnm(a[:16]))
    with contextlib.redirect_stderr(io.StringIO()):
        assert _printed(ssimulacra2_main.main, pa, pb) == \
            _printed(ref_ssimulacra2_main.main, pa, pb) == (1, "")


@pytest.mark.parametrize("shape,dtype", [
    ((13, 17, 3), np.uint8), ((13, 17), np.uint8), ((13, 17, 4), np.uint8),
    ((13, 17, 2), np.uint8), ((13, 17, 3), np.uint16),
    ((13, 17, 3), np.float32)],
    ids=["rgb8", "grey8", "rgba8", "greya8", "rgb16", "pfm"])
def test_load_rgb8_reads_pnm_as_rgb8(tmp_path, shape, dtype):
    """PNM and PFM inputs of the tools: 8-bit samples as PIL's
    ``convert("RGB")`` gives them (grey repeated, alpha dropped); wider
    and float samples scaled to 8 bits."""
    rng = np.random.default_rng(len(shape))
    if dtype == np.float32:
        img = rng.uniform(0, 1, shape).astype(np.float32)
    else:
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    path = tmp_path / "x.pnm"
    path.write_bytes(codecs.encode_pnm(img))
    got = codecs.load_rgb8(str(path))
    assert got.shape == (13, 17, 3) and got.dtype == np.uint8
    px = img if img.ndim == 3 else img[:, :, None]
    px = px[:, :, :3] if px.shape[2] != 2 else px[:, :, :1]
    if dtype == np.uint8:
        want = np.broadcast_to(px, (13, 17, 3))
    elif dtype == np.uint16:
        want = np.round(px * (255.0 / 65535.0)).astype(np.uint8)
    else:
        want = np.round(px * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    if dtype == np.uint8 and (len(shape) == 2 or shape[2] == 3):
        from PIL import Image       # PIL reads PPM and PGM, not PAM
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(path).convert("RGB")))
