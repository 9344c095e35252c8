"""The port's host tools against the JAX package's, on the same seeded
numpy inputs: ``api.extras_api`` (compressed ICC, gain-map bundles),
``extras.fast_lossless``, ``extras.refjxl`` (the system libjxl oracle,
skipped where it is absent, as ``tests/test_ref_interop.py`` skips),
``cli.jxlinfo``, ``cli.jxltran``, ``cli.hdr_tools`` and
``cli.benchmark_xl --device cpu``, and the device blend
(``ops/stages.py:blend_frame``) against the reference's host
``frame/blending.py``, which the port does not copy.

Bounds: bytes, text and arrays are equal, but for decoded pixels of two
float32 decoders, held within 1 LSB (the port's CPU route against the
reference's device route, and libjxl against the port: the bound of
``tests/test_ref_interop.py:143``)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import libjxl_tpu_torch
from libjxl_tpu.api import extras_api as ref_extras_api
from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.api.encoder import Encoder, FrameSettings
from libjxl_tpu.cli import benchmark_xl as ref_benchmark_xl
from libjxl_tpu.cli import hdr_tools as ref_hdr_tools
from libjxl_tpu.cli import jxlinfo as ref_jxlinfo
from libjxl_tpu.cli import jxltran as ref_jxltran
from libjxl_tpu.color import cms as ref_cms
from libjxl_tpu.color.color_encoding import ColorEncoding as RefColorEncoding
from libjxl_tpu.extras import fast_lossless as ref_fast_lossless
from libjxl_tpu.extras import refjxl as ref_refjxl
from libjxl_tpu.frame import blending as ref_blending
from libjxl_tpu.metrics import psnr as ref_psnr
from libjxl_tpu.metrics import ssimulacra2 as ref_ssimulacra2
from libjxl_tpu.metrics.butteraugli import (
    butteraugli_distance as ref_butteraugli_distance,
    butteraugli_pnorm as ref_butteraugli_pnorm)
from libjxl_tpu_torch.api import extras_api
from libjxl_tpu_torch.cli import benchmark_xl, hdr_tools, jxlinfo, jxltran
from libjxl_tpu_torch.color import cms
from libjxl_tpu_torch.color.color_encoding import ColorEncoding
from libjxl_tpu_torch.extras import codecs, fast_lossless, refjxl
from libjxl_tpu_torch.ops import stages


def _photo(h=64, w=80, seed=7):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 17), 128 + 70 * np.cos(y / 13),
                     120 + 60 * np.sin((x + y) / 23)], -1)
    return np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _lsb(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _printed(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue()


# ------------------------------------------------------------ extras_api

needs_cms = pytest.mark.skipif(not ref_cms.available(),
                               reason="lcms2 not installed")


def _icc(kind, cms_mod, ce_cls):
    """The sRGB profile, or one synthesized for linear sRGB or for sRGB
    with P3 primaries (as tests/test_cms.py makes it)."""
    if kind == "srgb":
        return cms_mod.srgb_icc()
    if kind == "linear":
        return cms_mod.synthesize_icc(ce_cls.linear_srgb())
    ce = ce_cls.srgb()
    ce.primaries = 11                # Primaries.P3
    ce.all_default = False
    return cms_mod.synthesize_icc(ce)


@needs_cms
@pytest.mark.parametrize("kind", ["srgb", "linear", "p3"])
def test_icc_profile_round_trip_matches_reference(kind):
    icc = _icc(kind, cms, ColorEncoding)
    assert icc == _icc(kind, ref_cms, RefColorEncoding)
    enc = extras_api.icc_profile_encode(icc)
    assert enc == ref_extras_api.icc_profile_encode(icc)
    assert extras_api.icc_profile_decode(enc) == icc
    assert ref_extras_api.icc_profile_decode(enc) == icc


@needs_cms
def test_gain_map_bundle_matches_reference():
    gm = ref_api.encode(_photo()[..., 0], distance=1.0, effort=1)
    icc = extras_api.icc_profile_encode(cms.srgb_icc())
    kw = dict(jhgm_version=0,
              gain_map_metadata=b"<x:xmpmeta>hdr gain map</x:xmpmeta>",
              alt_icc=icc, gain_map=gm)
    blob = extras_api.gain_map_write_bundle(extras_api.GainMapBundle(
        color_encoding=ColorEncoding.linear_srgb(), **kw))
    assert blob == ref_extras_api.gain_map_write_bundle(
        ref_extras_api.GainMapBundle(
            color_encoding=RefColorEncoding.linear_srgb(), **kw))
    back = extras_api.gain_map_read_bundle(blob)
    ref = ref_extras_api.gain_map_read_bundle(blob)
    for name in ("jhgm_version", "gain_map_metadata", "alt_icc",
                 "gain_map"):
        assert getattr(back, name) == getattr(ref, name) == kw[name]
    assert back.color_encoding.tf.transfer_function == \
        ref.color_encoding.tf.transfer_function
    errors = []
    for read in (extras_api.gain_map_read_bundle,
                 ref_extras_api.gain_map_read_bundle):
        with pytest.raises(Exception) as exc:
            read(blob[:5])
        errors.append(type(exc.value).__name__)
    assert errors[0] == errors[1]


# ------------------------------------------------------------ fast lossless

@pytest.mark.parametrize("shape,dtype,big_endian", [
    ((16, 24), np.uint8, False), ((16, 24, 2), np.uint8, False),
    ((16, 24, 3), np.uint8, False), ((16, 24, 4), np.uint8, False),
    ((12, 18, 3), np.uint16, False), ((12, 18, 3), np.uint16, True),
    ((300, 280, 3), np.uint8, False)],
    ids=["grey", "grey_alpha", "rgb", "rgba", "rgb16", "rgb16_be",
         "two_groups"])
def test_fast_lossless_matches_reference(shape, dtype, big_endian):
    """The reference's bytes, and an exact decode on the CPU."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    data = fast_lossless.fast_lossless_encode(img, big_endian=big_endian)
    assert data == ref_fast_lossless.fast_lossless_encode(
        img, big_endian=big_endian)
    out = libjxl_tpu_torch.decode(data, device="cpu").pixels
    want = img.byteswap() if big_endian else img
    want = want if want.ndim == 3 else want[:, :, None]
    np.testing.assert_array_equal(out[..., :want.shape[2]], want)


def test_fast_lossless_rejects_what_reference_rejects():
    bad = [np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 5), np.uint8),
           np.zeros((4,), np.uint8)]
    for img in bad:
        with pytest.raises(ValueError):
            fast_lossless.fast_lossless_encode(img)
        with pytest.raises(ValueError):
            ref_fast_lossless.fast_lossless_encode(img)


# ------------------------------------------------------------ refjxl

needs_libjxl = pytest.mark.skipif(not ref_refjxl.available(),
                                  reason="system libjxl not installed")


@needs_libjxl
@pytest.mark.parametrize("effort", [5, 7])
@pytest.mark.parametrize("progressive", [False, True])
def test_libjxl_decodes_port_stream_within_one_lsb(effort, progressive):
    """System libjxl decodes a port ``encode(..., device="cpu")`` stream
    within 1 LSB of the port's CPU decode."""
    assert refjxl.available()
    img = _photo(96, 96)
    data = libjxl_tpu_torch.encode(img, distance=1.0, effort=effort,
                                   progressive=progressive, device="cpu")
    ours = libjxl_tpu_torch.decode(data, device="cpu").pixels
    theirs = refjxl.decode(data, dtype="uint8").pixels
    assert _lsb(theirs, ours) <= 1
    np.testing.assert_array_equal(
        theirs, ref_refjxl.decode(data, dtype="uint8").pixels)


@needs_libjxl
def test_libjxl_round_trips_lossless_both_ways():
    img = _photo(48, 56)
    data = libjxl_tpu_torch.encode(img, lossless=True, effort=5,
                                   device="cpu")
    np.testing.assert_array_equal(refjxl.decode(data, dtype="uint8").pixels,
                                  img)
    theirs = refjxl.encode(img, lossless=True, effort=5)
    np.testing.assert_array_equal(
        libjxl_tpu_torch.decode(theirs, device="cpu").pixels, img)


def test_refjxl_availability_matches_reference():
    assert refjxl.available() == ref_refjxl.available()


# ------------------------------------------------------------ jxlinfo

def _info_streams():
    img = _photo()
    rng = np.random.default_rng(4)
    frames = [np.clip(img.astype(int) + rng.integers(-20, 20, img.shape),
                      0, 255).astype(np.uint8) for _ in range(3)]
    alpha = np.concatenate(
        [img, np.tile(np.arange(80, dtype=np.uint8)[None, :, None] * 3,
                      (64, 1, 1))], axis=2)
    enc = Encoder()
    enc.add_image_frame(img, FrameSettings(distance=2.0))
    enc.add_box(b"Exif", b"\x00\x00\x00\x00MM\x00\x2a")
    streams = {
        "lossless": ref_api.encode(img, lossless=True),
        "lossy_progressive": ref_api.encode(img, distance=1.0, effort=5,
                                            progressive=True),
        "container_exif": enc.process_output(),
        "animation": ref_api.encode_animation(frames, durations=[1, 2, 3],
                                              distance=1.0),
        "alpha": ref_api.encode(alpha, distance=1.0),
    }
    if ref_cms.available():
        streams["icc"] = ref_api.encode(
            img, lossless=True, effort=3,
            icc=_icc("p3", ref_cms, RefColorEncoding))
    return streams


INFO_STREAMS = ["lossless", "lossy_progressive", "container_exif",
                "animation", "alpha", "icc"]


@pytest.fixture(scope="module")
def info_streams():
    return _info_streams()


@pytest.mark.parametrize("name", INFO_STREAMS)
def test_jxlinfo_prints_reference_text(tmp_path, info_streams, name):
    if name not in info_streams:
        pytest.skip("lcms2 not installed")
    path = tmp_path / f"{name}.jxl"
    path.write_bytes(info_streams[name])
    got = _printed(jxlinfo.main, path)
    assert got == _printed(ref_jxlinfo.main, path)
    assert got[0] == 0 and "dimensions: 80x64" in got[1]
    assert "frame walk stopped" not in got[1]
    if name == "animation":
        assert got[1].count("\nframe ") == 3


# ------------------------------------------------------------ jxltran

@pytest.mark.parametrize("src,args", [
    ("bare", ["--pack"]), ("bare", ["--pack", "--jxlp", "3"]),
    ("bare", []), ("container", ["--strip"]), ("container", []),
    ("container", ["--pack"])],
    ids=["pack", "pack_jxlp3", "auto_bare", "strip", "auto_container",
         "repack"])
def test_jxltran_writes_reference_bytes(tmp_path, info_streams, src, args):
    data = info_streams["container_exif"] if src == "container" else \
        info_streams["lossy_progressive"]
    (tmp_path / "in.jxl").write_bytes(data)
    got = _printed(jxltran.main, tmp_path / "in.jxl", tmp_path / "out.jxl",
                   *args)
    ref = _printed(ref_jxltran.main, tmp_path / "in.jxl",
                   tmp_path / "ref.jxl", *args)
    assert got == ref and got[0] == 0
    out = (tmp_path / "out.jxl").read_bytes()
    assert out == (tmp_path / "ref.jxl").read_bytes()
    # Packing and stripping keep the codestream.
    from libjxl_tpu_torch.container.boxes import (is_container,
                                                  unpack_container)
    cs = unpack_container(out).codestream if is_container(out) else out
    want = unpack_container(data).codestream if is_container(data) \
        else data
    assert cs == want


# ------------------------------------------------------------ hdr_tools

def _pq_npy(path, seed=0):
    """A seeded PQ image: a luminance ramp to 2000 nits with noise."""
    from libjxl_tpu_torch.color.transfer_functions import (
        pq_encoded_from_display)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:48]
    nits = (xx / 47.0) ** 2 * 2000.0
    rgb = np.stack([nits, nits * 0.8, nits * 0.6], -1) / 10000.0
    rgb = np.clip(rgb * rng.uniform(0.7, 1.0, rgb.shape), 0, 1)
    np.save(path, pq_encoded_from_display(rgb, 10000.0).astype(np.float32))


@pytest.mark.parametrize("cmd,args", [
    ("pq_to_hlg", []), ("pq_to_hlg", ["-m", "1500"]),
    ("tone_map", ["-t", "100"]), ("tone_map", ["-t", "250", "-m", "4000"]),
    ("render_hlg", ["-t", "400"]), ("render_hlg", ["-t", "1000"])],
    ids=["pq_to_hlg", "pq_to_hlg_max", "tone_map", "tone_map_250",
         "render_hlg", "render_hlg_1000"])
@pytest.mark.parametrize("ext", [".npy", ".png"])
def test_hdr_tools_write_reference_arrays(tmp_path, cmd, args, ext):
    src = tmp_path / "pq.npy"
    _pq_npy(src, seed=len(args))
    if cmd == "render_hlg":          # an HLG input: the reference's own
        assert ref_hdr_tools.main(["pq_to_hlg", str(src),
                                   str(tmp_path / "hlg.npy")]) == 0
        src = tmp_path / "hlg.npy"
    got, ref = tmp_path / f"got{ext}", tmp_path / f"ref{ext}"
    assert hdr_tools.main([cmd, str(src), str(got), *args]) == 0
    assert ref_hdr_tools.main([cmd, str(src), str(ref), *args]) == 0
    assert got.read_bytes() == ref.read_bytes()
    if ext == ".npy":
        out = np.load(got)
        assert out.shape == (32, 48, 3) and np.isfinite(out).all()


# ------------------------------------------------------------ benchmark_xl

SPECS = ["jxl:d1.0", "jxl:d1.0:p", "jxl:lossless"]


@pytest.fixture(scope="module")
def bench_image():
    return _photo(64, 80, seed=11)


@pytest.mark.parametrize("spec", SPECS)
def test_benchmark_xl_cpu_matches_reference_device_route(bench_image,
                                                         spec):
    """``run_codec`` on the CPU: the bytes of the reference's ``encode``
    on its device route (host for lossless, as in the tool), pixels
    within 1 LSB of the reference's decode there (lossless: exact)."""
    img = bench_image
    data, out, enc_s, dec_s = benchmark_xl.run_codec(img, spec, "cpu")
    assert enc_s > 0 and dec_s > 0
    if spec == "jxl:lossless":
        assert data == ref_api.encode(img, lossless=True)
        np.testing.assert_array_equal(out, img)
        ref_data = ref_benchmark_xl.run_codec(img, spec)[0]
        assert data == ref_data
        return
    kw = {"progressive": True} if spec.endswith(":p") else {}
    assert data == ref_api.encode(img, distance=1.0, device=True, **kw)
    ref_px = ref_api.decode(data, device=True).pixels
    assert out.shape == img.shape and _lsb(out, ref_px) <= 1


def _row(text, spec):
    line = next(ln for ln in text.splitlines() if ln.startswith(spec + " "))
    return line.split()


def _gm(v):
    v = np.maximum(np.asarray(v, np.float64), 1e-9)
    return float(np.exp(np.mean(np.log(v))))


def test_benchmark_xl_row_equals_reference_metrics(tmp_path, bench_image):
    """The printed rows' bpp and metric columns equal a recomputation
    with the reference's metrics on the port's bytes and pixels; the
    header is the reference's."""
    img = bench_image
    (tmp_path / "a.ppm").write_bytes(codecs.encode_pnm(img))
    rc, text = _printed(benchmark_xl.main, "--input", tmp_path / "*.ppm",
                        "--codec", ",".join(SPECS), "--device", "cpu")
    assert rc == 0
    _, ref_text = _printed(ref_benchmark_xl.main, "--input",
                           tmp_path / "*.ppm", "--codec", "jxl:lossless")
    assert text.splitlines()[:2] == ref_text.splitlines()[:2]
    npix = img.shape[0] * img.shape[1]
    for spec in SPECS:
        data, out, _, _ = benchmark_xl.run_codec(img, spec, "cpu")
        d, dmap = ref_butteraugli_distance(img, out[:, :, :3],
                                           return_diffmap=True)
        want = [f"{_gm([len(data) * 8 / npix]):7.3f}",
                f"{_gm([d]):8.3f}",
                f"{_gm([ref_butteraugli_pnorm(dmap)]):7.3f}",
                f"{np.mean([ref_ssimulacra2(img, out[:, :, :3])]):7.2f}",
                f"{np.mean([ref_psnr(img, out[:, :, :3])]):7.2f}"]
        row = _row(text, spec)
        assert row[0] == spec and len(row) == 8
        assert [row[1]] + row[4:] == [w.strip() for w in want], spec


def test_benchmark_xl_no_metrics_and_no_inputs(tmp_path, bench_image):
    (tmp_path / "a.ppm").write_bytes(codecs.encode_pnm(bench_image))
    rc, text = _printed(benchmark_xl.main, "--input", tmp_path / "*.ppm",
                        "--codec", "jxl:lossless", "--no_metrics",
                        "--device", "cpu")
    assert rc == 0 and len(_row(text, "jxl:lossless")) == 4
    assert _printed(benchmark_xl.main, "--input", tmp_path / "*.png",
                    "--device", "cpu") == \
        _printed(ref_benchmark_xl.main, "--input", tmp_path / "*.png") \
        == (1, "")


# ------------------------------------------------------------ blending

@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_device_blend_matches_reference_host_blend(mode):
    """``ops/stages.py:blend_frame`` on the CPU against the reference's
    host ``frame/blending.py:blend_frame`` (in place on copies): every
    blend mode, with and without either alpha, premultiplied or not, at
    origins inside, across each edge and fully outside the canvas."""
    rng = np.random.default_rng(70 + mode)
    ch, cw, h, w = 29, 47, 21, 33
    canvas = rng.uniform(0, 1, (ch, cw, 3)).astype(np.float32)
    canvas_a = rng.uniform(0, 1, (ch, cw)).astype(np.float32)
    canvas_a[:3] = 0.0
    src = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    src_a = rng.uniform(0, 1, (h, w)).astype(np.float32)
    src_a[:, :4] = 0.0
    cases = 0
    for premul in (False, True):
        for sa in (src_a, None):
            for da in (canvas_a, None):
                for x0, y0 in [(5, 7), (-9, -4), (30, -6), (60, 3),
                               (-40, 0)]:
                    rc = canvas.copy()
                    ra = None if da is None else da.copy()
                    ref_blending.blend_frame(rc, ra, src, sa, mode, x0, y0,
                                             premul)
                    gc, ga = stages.blend_frame(
                        torch.from_numpy(canvas),
                        None if da is None else torch.from_numpy(da),
                        src, sa, mode, x0, y0, premul)
                    np.testing.assert_array_equal(gc.numpy(), rc)
                    assert (ga is None) == (ra is None)
                    if ga is not None:
                        np.testing.assert_array_equal(ga.numpy(), ra)
                    cases += 1
    assert cases == 40
