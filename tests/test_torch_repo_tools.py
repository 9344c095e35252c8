"""The repository's tools ported into ``libjxl_tpu_torch.tools``, each run
on the CPU and held to its reference under tools/ on the same input:
the conformance checker, corpus runner and generator (with the committed
corpus of tests/torch_corpus/conformance/), the per-stage device
profile, the microbench, the RD table, the interop sweep, the fuzz hunt
and the bench-corpus image. Tests that need the system libjxl skip where
``refjxl.available()`` is False, as tests/test_ref_interop.py does."""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.extras import refjxl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "tests", "torch_corpus", "conformance")
with open(os.path.join(CONF, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SMALL_STREAM = os.path.join(ROOT, "tests", "corpus", "seed-vardct_prog.bin")

needs_libjxl = pytest.mark.skipif(not refjxl.available(),
                                  reason="system libjxl not installed")


def _reference(name: str):
    """A module of the reference's tools/ directory, loaded by path."""
    path = os.path.join(ROOT, "tools", *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        "ref_" + name.replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, *argv) -> tuple:
    """(exit code, standard output) of a tool's ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue()


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


# ---------------------------------------------------------------------------
# conformance

@pytest.mark.parametrize("case", ["same", "off_by_one", "peak", "shape",
                                  "uint16"])
def test_compare_matches_reference(case):
    from libjxl_tpu_torch.tools.conformance import conformance
    ref = _reference("conformance/conformance")
    rng = np.random.default_rng(3)
    a = rng.random((24, 40, 3)).astype(np.float32)
    b = {"same": a.copy(),
         "off_by_one": a + np.float32(1 / 255),
         "peak": np.where(rng.random(a.shape) < 0.01, a + 0.02, a),
         "shape": a[:, :32],
         "uint16": np.round(a * 65535).astype(np.uint16) / 65535.0}[case]
    for limits in ((0.001, 0.005), (0.01, 0.03)):
        assert conformance.compare(a, b, *limits) == \
            ref.compare(a, b, *limits)


def test_conformance_cli(tmp_path):
    """``check`` passes a committed case against its golden and fails it
    against another case's; ``decode`` writes the normalised pixels."""
    from libjxl_tpu_torch.tools.conformance import conformance
    jxl = os.path.join(CONF, "vardct_d1.jxl")
    rc, out = _run(conformance.main, "check", jxl,
                   os.path.join(CONF, "vardct_d1.npz"), "--device", "cpu")
    assert rc == 0 and out.startswith("PASS"), out
    rc, out = _run(conformance.main, "check", jxl,
                   os.path.join(CONF, "vardct_d4.npz"), "--device", "cpu")
    assert rc == 1 and out.startswith("FAIL"), out
    npy = tmp_path / "d1.npy"
    rc, _ = _run(conformance.main, "decode", jxl, npy, "--device", "cpu")
    got = np.load(npy)
    assert rc == 0 and got.dtype == np.float32 and got.shape == (128, 160, 3)
    assert os.listdir(tmp_path) == ["d1.npy"]


def test_committed_corpus_passes():
    """run_corpus on the committed corpus: every case within its
    manifest's limits, on the CPU."""
    from libjxl_tpu_torch.tools.conformance import run_corpus
    rc, out = _run(run_corpus.main, CONF, "--device", "cpu")
    assert rc == 0, out
    assert out.count("PASS ") == len(MANIFEST) == 28


def _frame_xyb(data, decode_frame, read_headers, reader, **kw):
    r = reader(data)
    return decode_frame(r, read_headers(r), **kw).xyb


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_case_matches_jax(name):
    """The JAX package decodes each committed stream within 1 LSB of the
    port, and the manifest keeps the reference generator's limits. The
    PQ stream is held on its XYB (1e-4): PQ codes of two float32
    decoders differ by more than one in dark tones (ROADMAP queue 3,
    caveat 5)."""
    from libjxl_tpu_torch.color.color_encoding import TransferFunction
    from libjxl_tpu_torch.tools.conformance import run_corpus
    limits = MANIFEST[name]
    assert limits["peak"] == limits["rmse"] * 4 + 1e-6
    assert limits["rmse"] in (0.0, 0.004)
    with open(os.path.join(CONF, name + ".jxl"), "rb") as f:
        data = f.read()
    anim = bool(limits.get("animation"))
    got = run_corpus.decoded_pixels(data, anim, device="cpu")
    with np.load(os.path.join(CONF, name + ".npz")) as z:
        assert z["golden"].dtype == got.dtype
    if anim:
        assert _lsb(got, ref_api.decode_all(data)[0][-1].pixels) <= 1
        return
    res = ref_api.decode(data)
    tf = res.metadata.m.color_encoding.tf.transfer_function
    if tf != TransferFunction.PQ:
        assert _lsb(got, res.pixels) <= 1
        return
    from libjxl_tpu.bitstream.bit_io import BitReader as RefReader
    from libjxl_tpu.frame.decode_frame import decode_frame as ref_frame
    from libjxl_tpu.frame.headers import read_codestream_headers as ref_hdr
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    xyb = _frame_xyb(data, decode_frame, read_codestream_headers,
                     BitReader, device="cpu")
    want = _frame_xyb(data, ref_frame, ref_hdr, RefReader)
    assert got.shape == res.pixels.shape
    assert np.abs(xyb - want).max() <= 1e-4


@needs_libjxl
def test_generate_corpus_reproduces_committed(tmp_path):
    """The generator on the CPU writes the committed corpus byte for
    byte, with the libjxl version in each oracle case."""
    from libjxl_tpu_torch.tools.conformance import generate_corpus
    rc, _ = _run(generate_corpus.main, "--out", tmp_path, "--device", "cpu")
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(CONF))
    for name in os.listdir(CONF):
        with open(os.path.join(CONF, name), "rb") as f, \
                open(tmp_path / name, "rb") as g:
            assert f.read() == g.read(), name
    version = ".".join(map(str, refjxl.version()))
    oracle = [c for c in MANIFEST.values() if c["golden"] == "oracle"]
    assert oracle and all(c["libjxl"] == version for c in oracle)
    total = sum(os.path.getsize(os.path.join(CONF, n))
                for n in os.listdir(CONF) if n.endswith(".npz"))
    assert total < 2 << 20


# ---------------------------------------------------------------------------
# profile_device, microbench

def test_profile_device_prints_every_stage():
    from libjxl_tpu_torch.tools import profile_device
    rc, out = _run(profile_device.main, "--stream", SMALL_STREAM,
                   "--device", "cpu", "--reps", "1")
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert rc == 0 and lines[0]["device"] == "cpu"
    stages = [ln["stage"] for ln in lines[1:]]
    assert stages == list(profile_device.STAGES)
    ms = {ln["stage"]: ln["ms"] for ln in lines[1:]}
    assert all(np.isfinite(v) for v in ms.values())
    assert ms["big_classes_by_difference"] == pytest.approx(
        ms["decode_xyb2_all_classes"] - ms["decode_xyb2_8x8_family"])
    assert ms["overhead_full_minus_chain"] == pytest.approx(
        ms["full_decode_frame_device2"] - ms["device_resident_chain"])
    assert lines[1]["classes"] and lines[1]["nnz"]


def test_microbench_names_match_reference(monkeypatch):
    """The host benches have the reference's names, in its order. Both
    tools run with their timing loops replaced by a recorder and their
    encoders by a stub, so only the benches' set-up runs. (The device
    bench runs on the card, in chip_smoke.py's conformance_path.)"""
    from libjxl_tpu.api import simple as ref_simple
    from libjxl_tpu_torch.tools import microbench
    ref = _reference("microbench")
    names, port_names = [], []
    monkeypatch.setattr(ref, "_bench",
                        lambda name, *a, **k: names.append(name))
    monkeypatch.setattr(ref_simple, "encode", lambda *a, **k: b"")
    assert ref.main([]) == 0
    monkeypatch.setattr(microbench, "_bench",
                        lambda out, name, *a, **k: port_names.append(name))
    monkeypatch.setattr(microbench, "_encode", lambda *a, **k: b"")
    assert microbench.run(None) == []
    assert port_names == names and len(names) == 12


# ---------------------------------------------------------------------------
# rd_table, interop_sweep (system libjxl)

@needs_libjxl
def test_rd_table_matches_reference(tmp_path, monkeypatch):
    """One image at distance 1: the port's bytes per pixel within
    max(8 B, 1%) of the reference's, the libjxl columns identical."""
    from libjxl_tpu_torch.tools import rd_table
    rc, _ = _run(rd_table.main, "--out", tmp_path / "port", "--images", 1,
                 "--distances", "1.0", "--device", "cpu")
    assert rc == 0
    ref = _reference("rd_table")
    monkeypatch.setattr(sys, "argv", [
        "rd_table.py", "--out", str(tmp_path / "ref.md"), "--images", "1",
        "--distances", "1.0"])
    with contextlib.redirect_stdout(io.StringIO()):
        ref.main()

    def row(path):
        with open(path) as f:
            line = [ln for ln in f if ln.startswith("| 1.0 |")][0]
        return [float(c) for c in line.strip("|\n ").split("|")]
    got, want = row(tmp_path / "port" / "RD_TABLE.md"), row(
        tmp_path / "ref.md")
    npix = 768 * 512
    assert abs(got[1] - want[1]) * npix / 8 <= max(8, 0.01 * want[1]
                                                   * npix / 8)
    assert got[2] == want[2] and got[4] == want[4]      # libjxl's encode
    assert got[6] == want[6]                            # SSIMULACRA2 ref
    assert abs(got[3] - want[3]) <= 0.05                # butteraugli ours
    assert os.listdir(tmp_path / "port") == ["RD_TABLE.md"]


@needs_libjxl
def test_interop_sweep_matches_reference():
    """Seed 0, two cases: the port's sweep and the reference's both end
    with no failure."""
    from libjxl_tpu_torch.tools import interop_sweep
    assert interop_sweep.sweep(0, 2, device="cpu") == []
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "interop_sweep.py"),
         "0", "2"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FAILURES: 0" in res.stdout


# ---------------------------------------------------------------------------
# fuzz_hunt, gen_bench_corpus

def _tree_state(path):
    return sorted((os.path.join(d, f), os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(path) for f in fs)


def test_fuzz_hunt_writes_only_under_out(tmp_path, monkeypatch):
    """A 5-second seeded hunt on the CPU finds no crasher and writes
    nothing outside ``--out``; ``--write-seeds`` writes the reference's
    40 seed names there, not into tests/corpus/."""
    from libjxl_tpu_torch.tools import fuzz_hunt
    corpus = os.path.join(ROOT, "tests", "corpus")
    before = _tree_state(corpus)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    rc, text = _run(fuzz_hunt.main, "--seconds", 5, "--seed", 0,
                    "--out", out, "--device", "cpu")
    assert rc == 0, text
    assert re.search(r"^\d+ inputs, 0 crashes$", text, re.M), text
    assert os.listdir(tmp_path) == [] or os.listdir(tmp_path) == ["out"]
    rc, _ = _run(fuzz_hunt.main, "--write-seeds", "--out", out,
                 "--device", "cpu")
    assert rc == 0
    assert sorted(os.listdir(out)) == sorted(
        n for n in os.listdir(corpus) if n.startswith("seed-"))
    assert _tree_state(corpus) == before
    assert os.listdir(tmp_path) == ["out"]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_bench_image_is_the_references(i):
    from libjxl_tpu_torch.tools import gen_bench_corpus
    ref = _reference("gen_bench_corpus")
    got = gen_bench_corpus.make_image(i)
    assert got.dtype == np.uint16 and got.shape == (2160, 3840, 3)
    assert np.array_equal(got, ref.make_image(i))


def test_tools_default_out_is_ignored():
    """Every tool's default ``--out`` lies under torch_tools_out/, which
    .gitignore lists."""
    from libjxl_tpu_torch.tools import default_out
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "torch_tools_out/" in f.read().split()
    assert default_out("x") == os.path.join(ROOT, "torch_tools_out", "x")
