"""Build the port's native libraries into ``libjxl_tpu_torch/_build/``.

``jxl_native.so`` (g++, the host entropy decoder) is built here; the
CUDA kernels in ``csrc/`` go through the same ``build_locked`` with an
nvcc command (ops/epf_cuda.py). Each library is written to a temporary
name and moved into place with ``os.replace`` while holding an exclusive
lock of its own (``_build/<library>.lock``), so processes that trigger
the first build at once (pytest-xdist workers) neither race on the
output nor load a half-written file, and different libraries build in
parallel.

    python -m libjxl_tpu_torch.native.build

Sanitizer hardening: set JXL_NATIVE_SANITIZE=address (or
address,undefined / undefined) to build ``jxl_native.san.so`` with
-fsanitize instead, and run the tests against it:

    export JXL_NATIVE_SANITIZE=address,undefined
    python -m libjxl_tpu_torch.native.build
    LD_PRELOAD=$(g++ -print-file-name=libasan.so) \
        python -m pytest tests/test_torch_host.py -q

(The LD_PRELOAD is required because the host binary is python, not an
asan-linked executable.)
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "jxl_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
OUT = os.path.join(BUILD_DIR, "jxl_native.so")
OUT_SAN = os.path.join(BUILD_DIR, "jxl_native.san.so")


def _sanitize_mode() -> str:
    return os.environ.get("JXL_NATIVE_SANITIZE", "")


def _fresh(out: str, src: str) -> bool:
    return os.path.exists(out) and \
        os.path.getmtime(out) >= os.path.getmtime(src)


def build_locked(out: str, src: str, cmd: list, force: bool = False) -> str:
    """Run ``cmd + ["-o", tmp]`` and move ``tmp`` to ``out`` unless
    ``out`` is newer than ``src``. Returns the compiler's messages (empty
    when nothing was built); raises ``subprocess.CalledProcessError`` or
    ``FileNotFoundError`` when the compiler fails or is missing."""
    if not force and _fresh(out, src):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _fresh(out, src):
            return ""
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(cmd + ["-o", tmp], check=True,
                                 capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return res.stdout + res.stderr


def native_command(san: str = "") -> tuple:
    """(output path, g++ command without ``-o``) of the host library;
    ``san`` is a JXL_NATIVE_SANITIZE value ("" for the plain build)."""
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
           "-fPIC"]
    if san:
        cmd += [f"-fsanitize={san}", "-fno-omit-frame-pointer", "-g"]
    return (OUT_SAN if san else OUT), cmd + [SRC]


def build(force: bool = False) -> str | None:
    """Path of the host library (the sanitizer build under
    JXL_NATIVE_SANITIZE), built if stale; None when g++ fails (the
    caller then uses the pure-Python paths)."""
    out, cmd = native_command(_sanitize_mode())
    try:
        build_locked(out, SRC, cmd, force)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", str(e))
        print(f"native build failed: {msg}", file=sys.stderr)
        return None
    return out


if __name__ == "__main__":
    path = build(force=True)
    print(f"built: {path}" if path else "build failed")
    sys.exit(0 if path else 1)
