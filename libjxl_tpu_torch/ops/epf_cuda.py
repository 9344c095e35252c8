"""The gaborish + EPF loop-filter chain as one hand-written CUDA kernel.

Replaces the Pallas TPU kernel libjxl_tpu/ops/epf_pallas.py
(``apply_loop_filters_pallas``). The kernel source is csrc/epf.cu; it is
built by nvcc for sm_90a into a plain-C shared library at first use and
bound with ctypes (no PyTorch headers, so the build takes seconds).

``apply_loop_filters`` takes the same arguments as the JAX function,
and also a batch: (N, 3, H, W) frames are filtered by one launch, as the
reference's ``vmap`` is one dispatch. On a CPU tensor it runs the plain
PyTorch version (ops/filters.py); on a CUDA tensor it launches the
kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from libjxl_tpu_torch.native.build import BUILD_DIR, build_locked
from libjxl_tpu_torch.ops import filters
from libjxl_tpu_torch.pipeline.loop_filters import MIN_SIGMA

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "epf.cu")
LIB = os.path.join(BUILD_DIR, "libjxl_epf.so")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
              # No FMA contraction: the kernel rounds like the plain
              # PyTorch version, one operation at a time.
              "-fmad=false"]

# Kernel launches since the count was last set to 0 (only launches of
# the kernel count, not calls that take the plain version).
launches = 0
_lib = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(force: bool = False) -> str:
    """Compile csrc/epf.cu into _build/libjxl_epf.so if it is stale.
    Returns nvcc's messages (``-Xptxas -v``: registers, shared memory,
    spills); raises when nvcc fails or is missing."""
    return build_locked(LIB, SRC, [nvcc()] + NVCC_FLAGS + [SRC], force)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB)
        lib.jxl_epf_launch.restype = ctypes.c_int
        lib.jxl_epf_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        for fn in (lib.jxl_epf_occupancy, lib.jxl_epf_shared_bytes):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


def occupancy(epf_iters: int = 3, gab: bool = True) -> dict:
    """Resident blocks per SM and dynamic shared memory per block of the
    kernel instance that these stages launch, as the CUDA runtime
    reports them for the current device."""
    lib = _load()
    blocks = lib.jxl_epf_occupancy(int(bool(gab)), int(epf_iters))
    if blocks < 0:
        raise RuntimeError(f"EPF occupancy query failed: CUDA error "
                           f"{-blocks}")
    return {"blocks_per_sm": blocks,
            "shared_bytes": lib.jxl_epf_shared_bytes(int(bool(gab)),
                                                     int(epf_iters))}


def kernel_constants(gab_weights, epf_pass0_sigma_scale,
                     epf_pass2_sigma_scale, epf_border_sad_mul,
                     epf_channel_scale):
    """The 19 float32 constants of jxl_epf_launch: normalised gaborish
    weights, channel scales, (inside, border) sigma multipliers of the
    three passes, MIN_SIGMA. Products are formed in double and rounded
    once, as the plain version's ``_sad_mul`` rounds them."""
    vals = [w for ws in filters.gaborish_weights(gab_weights) for w in ws]
    vals += [float(s) for s in epf_channel_scale]
    for scale in (epf_pass0_sigma_scale, 1.0, epf_pass2_sigma_scale):
        sm = float(scale) * 1.65
        vals += [sm, sm * float(epf_border_sad_mul)]
    vals.append(MIN_SIGMA)
    return (ctypes.c_float * len(vals))(*vals)


def apply_loop_filters(img, inv_sigma_blocks, *, epf_iters=2, gab=True,
                       gab_weights=filters.DEFAULT_GAB_WEIGHTS,
                       epf_pass0_sigma_scale=0.9,
                       epf_pass2_sigma_scale=6.5,
                       epf_border_sad_mul=2.0 / 3,
                       epf_channel_scale=filters.DEFAULT_CHANNEL_SCALE):
    """Gaborish + EPF chain on (3, H, W) or (N, 3, H, W) float32 ``img``
    with the (ceil(H/8), ceil(W/8)) ``inv_sigma_blocks`` map, or
    (N, ...) maps, one per frame. Returns a new tensor; on a card it is
    written by one kernel launch on the current stream (one for the
    whole batch), without a synchronisation."""
    global launches
    kw = dict(epf_iters=epf_iters, gab=gab, gab_weights=gab_weights,
              epf_pass0_sigma_scale=epf_pass0_sigma_scale,
              epf_pass2_sigma_scale=epf_pass2_sigma_scale,
              epf_border_sad_mul=epf_border_sad_mul,
              epf_channel_scale=epf_channel_scale)
    if img.device.type == "cpu":
        return filters.apply_loop_filters(img, inv_sigma_blocks, **kw)
    if img.device.type != "cuda" or inv_sigma_blocks.device != img.device:
        raise ValueError("img and inv_sigma_blocks must be on one CUDA "
                         f"device, got {img.device} and "
                         f"{inv_sigma_blocks.device}")
    if img.dtype != torch.float32 or inv_sigma_blocks.dtype != torch.float32:
        raise TypeError("img and inv_sigma_blocks must be float32")
    if not (img.is_contiguous() and inv_sigma_blocks.is_contiguous()):
        raise ValueError("img and inv_sigma_blocks must be contiguous")
    if img.dim() not in (3, 4) or img.shape[-3] != 3:
        raise ValueError("img must be (3, H, W) or (N, 3, H, W), got "
                         f"{tuple(img.shape)}")
    n = img.shape[0] if img.dim() == 4 else 1
    h, w = img.shape[-2:]
    bmap = (-(-h // 8), -(-w // 8))
    if tuple(inv_sigma_blocks.shape) == bmap:
        map_stride = 0
    elif img.dim() == 4 and tuple(inv_sigma_blocks.shape) == (n,) + bmap:
        map_stride = bmap[0] * bmap[1]
    else:
        raise ValueError(f"inv_sigma_blocks must be {bmap} or {(n,) + bmap}"
                         f", got {tuple(inv_sigma_blocks.shape)}")
    if not gab and epf_iters <= 0:
        return img
    consts = kernel_constants(gab_weights, epf_pass0_sigma_scale,
                              epf_pass2_sigma_scale, epf_border_sad_mul,
                              epf_channel_scale)
    lib = _load()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.jxl_epf_launch(
            img.data_ptr(), inv_sigma_blocks.data_ptr(), out.data_ptr(),
            n, h, w, bmap[1], map_stride, int(bool(gab)),
            int(epf_iters), ctypes.addressof(consts), stream)
    if rc != 0:
        raise RuntimeError(f"EPF kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
