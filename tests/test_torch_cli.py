"""The port's command line (``libjxl_tpu_torch.cli.cjxl`` / ``djxl``)
and codec registry (``libjxl_tpu_torch.extras.codecs``) against the JAX
package's, on the same seeded numpy images:

- ``cjxl --device cpu`` against the reference's ``cjxl --device`` on a
  232x200 PPM at e5 and e7, at ``-d 0`` and at ``-q 90``: the same
  bytes (the port's plain stages on the CPU are byte for byte the
  reference's device route here; ROADMAP queue 3, difference 8 names
  the one image where e4 is not);
- ``djxl --device cpu`` against the reference's ``djxl --device``: 8-bit
  output within 1 LSB (two float32 backends; ROADMAP "Tolerances"), each
  output file readable back; ``--low-memory`` and JPEG reconstruction,
  both on the host, byte for byte;
- the codec registry's PNM, PAM, PFM, PGX, EXR and 16-bit PNG coders:
  the reference's bytes and pixels;
- no PIL on the card's paths: with ``sys.modules["PIL"] = None``,
  ``cjxl`` of a PPM and ``djxl`` to ``.npy``, PPM and 16-bit PNG run,
  and ``djxl`` to ``out_%d.png`` raises ``ImportError``; so do the
  other six tools, ``Decoder`` and ``fast_lossless_encode`` on PPM and
  ``.npy`` inputs (their parity tests are tests/test_torch_tools.py and
  tests/test_torch_metrics.py);
- the default device is ``cuda``: without a card the lossy paths
  (``benchmark_xl`` too) raise the port's "no CUDA device" error, and
  the host-only paths (JPEG transcode, lossless, ``--low-memory``, JPEG
  reconstruction, ``jxlinfo``, ``jxltran``, ``hdr_tools``, the metric
  tools, ``Decoder``, ``fast_lossless_encode``) run."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import libjxl_tpu_torch
from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.cli import cjxl as ref_cjxl
from libjxl_tpu.cli import djxl as ref_djxl
from libjxl_tpu.extras import codecs as ref_codecs
from libjxl_tpu_torch.cli import cjxl, djxl
from libjxl_tpu_torch.extras import codecs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _photo(h=200, w=232, seed=7):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 17), 128 + 70 * np.cos(y / 13),
                     120 + 60 * np.sin((x + y) / 23)], -1)
    return np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _run(main, *argv):
    with contextlib.redirect_stderr(io.StringIO()):
        assert main([str(a) for a in argv]) == 0


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The input PPM, a small JPEG, and the reference ``cjxl --device``
    streams of the PPM at e5 and e7, written once."""
    d = tmp_path_factory.mktemp("cli")
    img = _photo()
    ppm = d / "in.ppm"
    ppm.write_bytes(codecs.encode_pnm(img))
    buf = io.BytesIO()
    Image.fromarray(_photo(96, 120, seed=3)).save(buf, "JPEG", quality=85,
                                                  subsampling=2)
    jpg = d / "in.jpg"
    jpg.write_bytes(buf.getvalue())
    out = {"dir": d, "img": img, "ppm": ppm, "jpg": jpg}
    for e in (5, 7):
        p = d / f"ref_e{e}.jxl"
        _run(ref_cjxl.main, ppm, p, "--device", "-e", e)
        out[f"e{e}"] = p
    return out


@pytest.mark.parametrize("args", [("-e", "5"), ("-e", "7"), ("-d", "0"),
                                  ("-q", "90")],
                         ids=["e5", "e7", "d0", "q90"])
def test_cjxl_cpu_matches_reference_device(files, args):
    d = files["dir"]
    name = "_".join(args)
    ref = files.get(f"e{args[1]}") if args[0] == "-e" else None
    if ref is None:
        ref = d / f"ref_{name}.jxl"
        _run(ref_cjxl.main, files["ppm"], ref, "--device", *args)
    out = d / f"port_{name}.jxl"
    _run(cjxl.main, files["ppm"], out, "--device", "cpu", *args)
    assert _read(out) == _read(ref)


def test_cjxl_container_and_progressive_match_reference(files):
    d = files["dir"]
    args = ("-e", "7", "-p", "--container")
    _run(ref_cjxl.main, files["ppm"], d / "ref_pc.jxl", "--device", *args)
    _run(cjxl.main, files["ppm"], d / "port_pc.jxl", "--device", "cpu",
         *args)
    assert _read(d / "port_pc.jxl") == _read(d / "ref_pc.jxl")


def _read_png16(data: bytes) -> np.ndarray:
    """The samples of a 16-bit RGB(A) PNG as the in-tree writer writes it
    (one IDAT, filter 0 on every row). PIL reads such a PNG only reduced
    to 8 bits per channel, so the round trips read it here."""
    import struct
    import zlib
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    assert depth == 16 and ctype in (2, 6)
    ch = 3 if ctype == 2 else 4
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch * 2)
    assert not rows[:, 0].any()
    return rows[:, 1:].copy().view(">u2").reshape(h, w, ch).astype(
        np.uint16)


def _lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("ext", [".ppm", ".npy", ".png"])
def test_djxl_cpu_within_one_lsb_of_reference_device(files, ext):
    d = files["dir"]
    _run(ref_djxl.main, files["e7"], d / f"ref{ext}", "--device")
    _run(djxl.main, files["e7"], d / f"port{ext}", "--device", "cpu")
    if ext == ".npy":
        a, b = np.load(d / f"ref{ext}"), np.load(d / f"port{ext}")
    else:
        a = codecs.load_image(str(d / f"ref{ext}")).pixels
        b = codecs.load_image(str(d / f"port{ext}")).pixels
    assert a.shape == b.shape == files["img"].shape
    assert b.dtype == np.uint8
    assert _lsb(a, b) <= 1
    # ... and the port's output is its in-process decode, exactly.
    res = libjxl_tpu_torch.decode(_read(files["e7"]), device="cpu")
    np.testing.assert_array_equal(b, res.pixels)


def test_djxl_16bit_png_is_decode_and_reference_writer(tmp_path):
    """A 16-bit stream to PNG: the in-tree RGB48 writer, the port's
    decode exactly, and the reference writer's bytes for those pixels."""
    rng = np.random.default_rng(2)
    img16 = (rng.uniform(0.2, 0.8, (64, 80, 3)) * 65535).astype(np.uint16)
    jxl = tmp_path / "in16.jxl"
    jxl.write_bytes(ref_api.encode(img16, distance=1.0, effort=5))
    _run(djxl.main, jxl, tmp_path / "out.png", "--device", "cpu")
    data = _read(tmp_path / "out.png")
    px = libjxl_tpu_torch.decode(_read(jxl), device="cpu").pixels
    assert px.dtype == np.uint16
    assert data == ref_codecs.encode_to_bytes(px, "png")
    np.testing.assert_array_equal(_read_png16(data), px)


def test_djxl_low_memory_matches_reference(files):
    d = files["dir"]
    _run(ref_djxl.main, files["e5"], d / "ref_lm.ppm", "--low-memory")
    _run(djxl.main, files["e5"], d / "port_lm.ppm", "--low-memory")
    assert _read(d / "port_lm.ppm") == _read(d / "ref_lm.ppm")
    lm = codecs.load_image(str(d / "port_lm.ppm")).pixels
    _run(djxl.main, files["e5"], d / "port_full.ppm", "--device", "cpu")
    assert _lsb(lm, codecs.load_image(str(d / "port_full.ppm")).pixels) <= 1


def test_jpeg_transcode_and_reconstruct_match_reference(files):
    """``cjxl in.jpg`` (coefficient transcode into a container with the
    jbrd box) and ``djxl out.jxl rec.jpg``: the reference's bytes, and
    the input JPEG back byte for byte."""
    d = files["dir"]
    _run(ref_cjxl.main, files["jpg"], d / "ref_j.jxl")
    _run(cjxl.main, files["jpg"], d / "port_j.jxl")
    assert _read(d / "port_j.jxl") == _read(d / "ref_j.jxl")
    _run(djxl.main, d / "port_j.jxl", d / "rec.jpg")
    assert _read(d / "rec.jpg") == _read(files["jpg"])


def test_djxl_animation_frames_within_one_lsb(tmp_path):
    """``djxl out_%d.png`` (PIL) on the CPU against the reference's,
    frame by frame."""
    y, x = np.mgrid[0:40, 0:50]
    frames = [np.stack([(x * 3 + t * 40) % 256, (y * 2 + t * 10) % 256,
                        (x + y + t * 5) % 256], -1).astype(np.uint8)
              for t in range(3)]
    jxl = tmp_path / "anim.jxl"
    jxl.write_bytes(ref_api.encode_animation(frames, distance=1.0))
    _run(ref_djxl.main, jxl, tmp_path / "ref_%d.png")
    _run(djxl.main, jxl, tmp_path / "port_%d.png", "--device", "cpu")
    for i in range(3):
        a = np.asarray(Image.open(tmp_path / f"ref_{i}.png"))
        b = np.asarray(Image.open(tmp_path / f"port_{i}.png"))
        assert a.shape == b.shape == (40, 50, 3)
        assert _lsb(a, b) <= 1


# ------------------------------------------------------------ codecs

def _rng_img(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.uniform(0, 1, shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


@pytest.mark.parametrize("codec,shape,dtype", [
    ("pnm", (13, 17, 3), np.uint8),
    ("pnm", (13, 17, 3), np.uint16),
    ("pnm", (13, 17), np.uint8),
    ("pnm", (13, 17, 4), np.uint8),       # PAM RGB_ALPHA
    ("pnm", (13, 17, 2), np.uint16),      # PAM GRAYSCALE_ALPHA
    ("pnm", (13, 17, 3), np.float32),     # PFM colour
    ("pnm", (13, 17), np.float32),        # PFM grey
    ("pgx", (13, 17), np.uint8),
    ("pgx", (13, 17), np.uint16),
    ("exr", (13, 17, 3), np.float32),
    ("exr", (13, 17, 4), np.float32),
    ("exr", (40, 33), np.float32),
    ("png", (13, 17, 3), np.uint16),      # in-tree RGB48 writer
    ("png", (13, 17, 4), np.uint16),      # in-tree RGBA64 writer
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_codec_round_trip_matches_reference(codec, shape, dtype):
    """Bytes equal to the reference's encoder, pixels equal to the
    reference's decoder; lossless formats round-trip exactly (EXR writes
    half floats: within half precision; a 16-bit RGB PNG is read back
    here, as PIL reduces it to 8 bits for both registries)."""
    img = _rng_img(shape, dtype, seed=len(shape) + shape[-1])
    data = codecs.encode_to_bytes(img, codec)
    assert data == ref_codecs.encode_to_bytes(img, codec)
    assert codecs.detect_codec(data) == ref_codecs.detect_codec(data)
    a, b = codecs.decode_bytes(data), ref_codecs.decode_bytes(data)
    assert (a.bits_per_sample, a.float_samples, a.codec) == \
        (b.bits_per_sample, b.float_samples, b.codec)
    np.testing.assert_array_equal(a.pixels, b.pixels)
    if codec == "png":
        np.testing.assert_array_equal(_read_png16(data), img)
    elif codec == "exr":
        np.testing.assert_allclose(a.pixels.reshape(img.shape), img,
                                   rtol=1e-3, atol=1e-3)
    else:
        np.testing.assert_array_equal(a.pixels, img)


def test_load_save_facade_and_jxl_codec(tmp_path):
    """``save_image``/``load_image`` by extension; the JXL codec runs on
    the given device, with the reference's pixels within 1 LSB."""
    img = _rng_img((24, 32, 3), np.uint8, seed=5)
    codecs.save_image(img, str(tmp_path / "a.ppm"))
    np.testing.assert_array_equal(
        codecs.load_image(str(tmp_path / "a.ppm")).pixels, img)
    data = codecs.encode_to_bytes(img, "jxl", device="cpu")
    assert data == libjxl_tpu_torch.encode(img, device="cpu")
    (tmp_path / "a.jxl").write_bytes(data)
    dec = codecs.load_image(str(tmp_path / "a.jxl"), device="cpu")
    assert dec.codec == "jxl" and dec.pixels.shape == img.shape
    ref = ref_codecs.load_image(str(tmp_path / "a.jxl"))
    assert _lsb(dec.pixels, ref.pixels) <= 1


# ------------------------------------------------------------ no PIL

@pytest.fixture
def no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_cli_needs_no_pil_for_pnm_npy_and_png16(files, tmp_path, no_pil):
    _run(cjxl.main, files["ppm"], tmp_path / "o.jxl", "--device", "cpu",
         "-e", "5")
    assert _read(tmp_path / "o.jxl") == _read(files["e5"])
    for ext in (".npy", ".ppm"):
        _run(djxl.main, files["e5"], tmp_path / f"o{ext}", "--device",
             "cpu")
    rng = np.random.default_rng(4)
    img16 = (rng.uniform(0.2, 0.8, (32, 40, 3)) * 65535).astype(np.uint16)
    (tmp_path / "i16.ppm").write_bytes(codecs.encode_pnm(img16))
    _run(cjxl.main, tmp_path / "i16.ppm", tmp_path / "o16.jxl",
         "--device", "cpu", "-e", "5")
    _run(djxl.main, tmp_path / "o16.jxl", tmp_path / "o16.png",
         "--device", "cpu")
    px = libjxl_tpu_torch.decode(
        _read(tmp_path / "o16.jxl"), device="cpu").pixels
    assert px.dtype == np.uint16
    np.testing.assert_array_equal(_read_png16(_read(tmp_path / "o16.png")),
                                  px)
    with pytest.raises(ImportError):
        djxl.main([str(files["e5"]), str(tmp_path / "f_%d.png"),
                   "--device", "cpu"])


def test_cli_modules_import_no_pil():
    """Importing the eight tools and running ``--help`` loads no PIL."""
    code = ("import sys\n"
            "from libjxl_tpu_torch.cli import (\n"
            "    benchmark_xl, butteraugli_main, cjxl, djxl, hdr_tools,\n"
            "    jxlinfo, jxltran, ssimulacra2_main)\n"
            "for m in (cjxl, djxl, jxlinfo, jxltran, benchmark_xl,\n"
            "          butteraugli_main, ssimulacra2_main, hdr_tools):\n"
            "    try:\n"
            "        m.main(['--help'])\n"
            "    except SystemExit:\n"
            "        pass\n"
            "print('PIL' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=120)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert res.stdout.decode().strip().endswith("False")


def _tool_inputs(files, tmp_path):
    """A distorted copy of the input PPM, and a seeded PQ ``.npy``."""
    img = files["img"]
    b = np.clip(img.astype(int) + 3, 0, 255).astype(np.uint8)
    (tmp_path / "b.ppm").write_bytes(codecs.encode_pnm(b))
    rng = np.random.default_rng(9)
    np.save(tmp_path / "pq.npy",
            rng.uniform(0.1, 0.7, (24, 32, 3)).astype(np.float32))
    return files["ppm"], tmp_path / "b.ppm", tmp_path / "pq.npy"


def _tools_run(files, tmp_path, device_args):
    """The host tools on PPM and ``.npy`` inputs, and ``benchmark_xl``
    with ``device_args``; each must exit 0 and print something."""
    from libjxl_tpu_torch.api.decoder import Decoder, Event
    from libjxl_tpu_torch.cli import (benchmark_xl, butteraugli_main,
                                      hdr_tools, jxlinfo, jxltran,
                                      ssimulacra2_main)
    from libjxl_tpu_torch.extras.fast_lossless import fast_lossless_encode
    a, b, pq = _tool_inputs(files, tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _run(benchmark_xl.main, "--input", a, *device_args)
        _run(butteraugli_main.main, a, b, "--pnorm", "3")
        _run(ssimulacra2_main.main, a, b)
        _run(jxlinfo.main, files["e5"])
        _run(jxltran.main, files["e5"], tmp_path / "c.jxl", "--pack")
        _run(jxltran.main, tmp_path / "c.jxl", tmp_path / "s.jxl")
    assert _read(tmp_path / "s.jxl") == _read(files["e5"])
    assert "dimensions: 232x200" in out.getvalue()
    for cmd, dst in (("pq_to_hlg", "hlg.npy"), ("tone_map", "sdr.npy")):
        _run(hdr_tools.main, cmd, pq, tmp_path / dst)
    _run(hdr_tools.main, "render_hlg", tmp_path / "hlg.npy",
         tmp_path / "r.npy")
    assert np.load(tmp_path / "r.npy").shape == (24, 32, 3)
    dec = Decoder(events={Event.FULL_IMAGE})
    dec.set_input(_read(files["e5"]))
    dec.close_input()
    assert dec.process_input() == Event.FULL_IMAGE
    assert _lsb(dec.image, libjxl_tpu_torch.decode(
        _read(files["e5"]), device="cpu").pixels) <= 1
    px = files["img"]
    data = fast_lossless_encode(px)
    np.testing.assert_array_equal(
        libjxl_tpu_torch.decode(data, device="cpu").pixels, px)
    return out.getvalue()


def test_tools_need_no_pil_for_ppm_and_npy(files, tmp_path, no_pil):
    """The six new tools, ``Decoder`` and ``fast_lossless_encode`` on PPM
    and ``.npy`` inputs with PIL unimportable; ``benchmark_xl``'s PIL
    comparison codecs and a PNG input raise ``ImportError``."""
    from libjxl_tpu_torch.cli import benchmark_xl, ssimulacra2_main
    text = _tools_run(files, tmp_path, ("--device", "cpu", "--codec",
                                        "jxl:d1.0,jxl:lossless"))
    assert "jxl:d1.0 " in text and "jxl:lossless " in text
    with pytest.raises(ImportError):
        benchmark_xl.main(["--input", str(files["ppm"]), "--codec", "png",
                           "--device", "cpu"])
    (tmp_path / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 8)
    with pytest.raises(ImportError):
        ssimulacra2_main.main([str(tmp_path / "x.png"),
                               str(tmp_path / "x.png")])


# ------------------------------------------------------------ device

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_card(files, tmp_path, no_card):
    """cjxl of a lossy PPM, djxl of a VarDCT stream, ``load_image`` of
    a ``.jxl`` and ``benchmark_xl`` of a lossy codec default to ``cuda``
    and raise without a card."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cjxl.main([str(files["ppm"]), str(tmp_path / "x.jxl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cjxl.main([str(files["ppm"]), str(tmp_path / "x.jxl"), "--device"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        djxl.main([str(files["e5"]), str(tmp_path / "x.ppm")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.load_image(str(files["e5"]))
    from libjxl_tpu_torch.cli import benchmark_xl
    for extra in ([], ["--device"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark_xl.main(["--input", str(files["ppm"]),
                               "--no_metrics", *extra])


def test_host_only_paths_run_without_card(files, tmp_path, no_card):
    """JPEG transcode, lossless, ``--low-memory`` and JPEG
    reconstruction need no card, as in the reference."""
    _run(cjxl.main, files["jpg"], tmp_path / "j.jxl")
    _run(djxl.main, tmp_path / "j.jxl", tmp_path / "j.jpg")
    assert _read(tmp_path / "j.jpg") == _read(files["jpg"])
    _run(cjxl.main, files["ppm"], tmp_path / "ll.jxl", "-d", "0")
    _run(ref_cjxl.main, files["ppm"], tmp_path / "ll_ref.jxl", "-d", "0")
    assert _read(tmp_path / "ll.jxl") == _read(tmp_path / "ll_ref.jxl")
    _run(djxl.main, files["e5"], tmp_path / "lm.ppm", "--low-memory")
    assert codecs.load_image(str(tmp_path / "lm.ppm")).pixels.shape == \
        files["img"].shape


def test_host_tools_run_without_card(files, tmp_path, no_card):
    """``jxlinfo``, ``jxltran``, ``hdr_tools``, the metric tools,
    ``Decoder``, ``fast_lossless_encode`` and ``benchmark_xl
    jxl:lossless`` (the default device given) need no card."""
    text = _tools_run(files, tmp_path, ("--codec", "jxl:lossless"))
    assert "jxl:lossless " in text


def test_djxl_module_entry_runs_in_a_fresh_process(files, tmp_path):
    """``python -m libjxl_tpu_torch.cli.djxl ... --device cpu`` writes
    the in-process decode's pixels."""
    out = tmp_path / "m.npy"
    res = subprocess.run(
        [sys.executable, "-m", "libjxl_tpu_torch.cli.djxl",
         str(files["e5"]), str(out), "--device", "cpu"],
        capture_output=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        timeout=120)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    px = libjxl_tpu_torch.decode(_read(files["e5"]), device="cpu").pixels
    np.testing.assert_array_equal(np.load(out), px)
