"""The port stands alone: importing every module of libjxl_tpu_torch,
decoding a frame on the CPU (``decode_device``, ``decode``,
``decode_all``, the event-driven ``Decoder``), encoding one (``encode``,
``fast_lossless_encode``) and running ``benchmark_xl --device cpu``
loads neither ``jax`` nor anything of ``libjxl_tpu``, nor does the
sharded dry run in its parent or in any of its rank processes, and no
port source (or chip_smoke.py) imports them."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from libjxl_tpu.api import simple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "libjxl_tpu_torch")

_CHILD = r"""
import importlib, pkgutil, sys
import libjxl_tpu_torch
for m in pkgutil.walk_packages(libjxl_tpu_torch.__path__,
                               "libjxl_tpu_torch."):
    importlib.import_module(m.name)
data = sys.stdin.buffer.read()
out = libjxl_tpu_torch.decode_device(data, out="pq16", device="cpu")
assert tuple(out.shape) == (3, 64, 80), out.shape
res = libjxl_tpu_torch.decode(data, device="cpu")
assert res.pixels.shape == (64, 80, 3), res.pixels.shape
frames, _ = libjxl_tpu_torch.decode_all(data, device="cpu")
assert len(frames) == 1 and frames[0].pixels.shape == (64, 80, 3)
import numpy as np
img = (np.random.default_rng(1).uniform(0, 1, (48, 40, 3)) * 255).astype(
    np.uint8)
enc = libjxl_tpu_torch.encode(img, distance=1.0, effort=7, device="cpu")
assert libjxl_tpu_torch.decode(enc, device="cpu").pixels.shape == (48, 40, 3)
from libjxl_tpu_torch.api.decoder import Decoder, Event
dec = Decoder(events={Event.FULL_IMAGE})
dec.set_input(data)
dec.close_input()
assert dec.process_input() == Event.FULL_IMAGE
assert dec.image.shape == (64, 80, 3)
from libjxl_tpu_torch.extras.fast_lossless import fast_lossless_encode
ll = fast_lossless_encode(img)
assert (libjxl_tpu_torch.decode(ll, device="cpu").pixels == img).all()
import os, tempfile
from libjxl_tpu_torch.cli import benchmark_xl
from libjxl_tpu_torch.extras.codecs import encode_pnm
with tempfile.TemporaryDirectory() as tmp:
    with open(os.path.join(tmp, "a.ppm"), "wb") as f:
        f.write(encode_pnm(img))
    assert benchmark_xl.main(["--input", os.path.join(tmp, "*.ppm"),
                              "--codec", "jxl:d1.0,jxl:lossless",
                              "--device", "cpu", "--no_metrics"]) == 0
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "libjxl_tpu" or n.startswith("libjxl_tpu."))
print("BAD", bad)
"""


def test_port_loads_no_jax_and_no_reference_package():
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 1, (64, 80, 3)) * 255).astype(np.uint8)
    data = simple.encode(img, distance=1.0, effort=5)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _CHILD], input=data,
                         capture_output=True, cwd=ROOT, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert b"BAD []" in res.stdout, res.stdout.decode()


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith(("jax.", "jaxlib")) \
        or name == "libjxl_tpu" or name.startswith("libjxl_tpu.")


def test_dryrun_rank_processes_load_no_jax():
    """``dryrun_multichip(2)`` on the CPU: the parent and both spawned
    gloo ranks (every process inherits ``PYTHONPROFILEIMPORTTIME``, so
    each reports its imports on the shared stderr) load neither ``jax``
    nor ``libjxl_tpu``."""
    code = ("from libjxl_tpu_torch.entry import dryrun_multichip\n"
            "print(dryrun_multichip(2, device='cpu', timeout=240.0))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=ROOT, env=env, timeout=300)
    err = res.stderr.decode()
    assert res.returncode == 0, err[-3000:]
    assert "dryrun_multichip OK on 2 ranks" in res.stdout.decode()
    names = [ln.rsplit("|", 1)[1].strip() for ln in err.splitlines()
             if ln.startswith("import time:") and "|" in ln]
    # One import of the rank target's module per process: parent + 2.
    assert names.count("libjxl_tpu_torch.entry") == 3, names.count(
        "libjxl_tpu_torch.entry")
    assert not [n for n in names if _forbidden(n)]


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|libjxl_tpu)\b(?!_torch)"
    r"|from\s+(jax|libjxl_tpu)\b(?!_torch)[\w.]*\s+import)", re.M)


def _port_sources():
    for d, dirs, files in os.walk(PORT):
        dirs[:] = [x for x in dirs if x != "_build"]   # build outputs
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_port_sources_import_no_jax_and_no_reference_package():
    paths = [os.path.join(ROOT, "chip_smoke.py"), *_port_sources()]
    assert len(paths) > 40
    offenders = []
    for p in paths:
        with open(p) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(p, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(src)]
        # A module name in a string (importlib, __import__).
        if re.search(r"[\"'](jax|libjxl_tpu)[\"'.]", src):
            offenders.append(f"{os.path.relpath(p, ROOT)}: dynamic import")
    assert not offenders, offenders


def _module_exists(name: str) -> bool:
    base = os.path.join(ROOT, *name.split("."))
    return os.path.isfile(base + ".py") or \
        os.path.isfile(os.path.join(base, "__init__.py"))


def test_every_imported_port_module_exists():
    """Every ``libjxl_tpu_torch.*`` module that a port source imports,
    at the top or inside a function, exists in the port."""
    import ast
    named = set()
    for p in _port_sources():
        with open(p) as f:
            tree = ast.parse(f.read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                mods = [node.module]
            else:
                continue
            named.update((m, os.path.relpath(p, ROOT)) for m in mods
                         if m.split(".")[0] == "libjxl_tpu_torch")
    assert len({m for m, _ in named}) > 40
    missing = sorted(f"{src}: {m}" for m, src in named
                     if not _module_exists(m))
    assert not missing, missing


# The modules the public decode API and the device encoder brought into
# the port.
API_MODULES = ["libjxl_tpu_torch.api", "libjxl_tpu_torch.api.simple",
               "libjxl_tpu_torch.parallel",
               "libjxl_tpu_torch.parallel.runner",
               "libjxl_tpu_torch.color.transfer_functions",
               "libjxl_tpu_torch.color.ycbcr",
               "libjxl_tpu_torch.color.cms",
               "libjxl_tpu_torch.frame.patches",
               "libjxl_tpu_torch.ops.encode",
               "libjxl_tpu_torch.frame.encode_frame",
               "libjxl_tpu_torch.frame.adaptive_quant",
               "libjxl_tpu_torch.frame.acs_select",
               "libjxl_tpu_torch.frame.cfl_fit",
               "libjxl_tpu_torch.frame.ar_heuristic",
               "libjxl_tpu_torch.frame.text_patches",
               "libjxl_tpu_torch.frame.dots",
               "libjxl_tpu_torch.frame.enc_modular_heuristics",
               "libjxl_tpu_torch.metrics",
               "libjxl_tpu_torch.metrics.butteraugli",
               "libjxl_tpu_torch.color.color_description",
               # The last device modules: the v1 path, the sharded
               # decode and the entry points.
               "libjxl_tpu_torch.parallel.sharded_decode",
               "libjxl_tpu_torch.parallel.ranks",
               "libjxl_tpu_torch.entry",
               # The command line and the rest of the encode API, with
               # the low-memory decode and JPEG transcoding they use.
               "libjxl_tpu_torch.cli",
               "libjxl_tpu_torch.cli.cjxl",
               "libjxl_tpu_torch.cli.djxl",
               "libjxl_tpu_torch.api.encoder",
               "libjxl_tpu_torch.frame.aux_out",
               "libjxl_tpu_torch.frame.incremental",
               "libjxl_tpu_torch.frame.low_memory",
               "libjxl_tpu_torch.frame.streaming_encode",
               "libjxl_tpu_torch.extras.codecs",
               "libjxl_tpu_torch.extras.jpeg_parser",
               "libjxl_tpu_torch.extras.jpeg_writer",
               "libjxl_tpu_torch.extras.jbrd",
               "libjxl_tpu_torch.extras.jpeg_transcode",
               # The rest of the JAX package: the event-driven decoder,
               # the extras API, the metrics, the libjxl oracle, the
               # fast-lossless encoder and the six other tools.
               "libjxl_tpu_torch.api.decoder",
               "libjxl_tpu_torch.api.extras_api",
               "libjxl_tpu_torch.metrics.simple",
               "libjxl_tpu_torch.metrics.ssimulacra2",
               "libjxl_tpu_torch.metrics.ssimulacra2_weights",
               "libjxl_tpu_torch.extras.refjxl",
               "libjxl_tpu_torch.extras.fast_lossless",
               "libjxl_tpu_torch.cli.jxlinfo",
               "libjxl_tpu_torch.cli.jxltran",
               "libjxl_tpu_torch.cli.benchmark_xl",
               "libjxl_tpu_torch.cli.butteraugli_main",
               "libjxl_tpu_torch.cli.ssimulacra2_main",
               "libjxl_tpu_torch.cli.hdr_tools"]


@pytest.mark.parametrize("name", API_MODULES)
def test_api_module_stands_alone(name):
    """Each module exists in the port, imports neither ``jax`` nor
    ``libjxl_tpu``, and names only port modules that exist."""
    import ast
    assert _module_exists(name), name
    base = os.path.join(ROOT, *name.split("."))
    path = base + ".py" if os.path.isfile(base + ".py") else \
        os.path.join(base, "__init__.py")
    with open(path) as f:
        src = f.read()
    assert not _IMPORT.search(src), name
    for node in ast.walk(ast.parse(src, path)):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "libjxl_tpu_torch":
            assert _module_exists(node.module), (name, node.module)
