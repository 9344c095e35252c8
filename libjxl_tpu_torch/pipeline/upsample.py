"""Learned 2x/4x/8x upsampling (decoder side).

Reference: lib/jxl/render_pipeline/stage_upsampling.cc — per-phase 5x5
kernels reconstructed by 4-fold symmetry from the packed weight vector
(image_metadata.cc kWeights2/4/8), each output clamped to the min/max
of its 5x5 source window; borders are mirrored.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from libjxl_tpu_torch.pipeline.upsample_weights import (
    UPSAMPLING2_WEIGHTS, UPSAMPLING4_WEIGHTS, UPSAMPLING8_WEIGHTS,
)

_KERNEL_CACHE: dict = {}


def _expand_kernels(weights: np.ndarray, n: int) -> np.ndarray:
    """(N, N, 5, 5) kernels from the packed upper-triangle vector
    (stage_upsampling.cc:62-85)."""
    half = n // 2
    kernel = np.zeros((n, n, 5, 5), np.float64)
    for ky in range(half):
        for kx in range(half):
            for py in range(5):
                for px in range(5):
                    j = 5 * ky + py
                    i = 5 * kx + px
                    my, mx = min(i, j), max(i, j)
                    w = weights[5 * half * my - my * (my - 1) // 2
                                + mx - my]
                    kernel[ky, kx, py, px] = w
                    kernel[ky, n - 1 - kx, py, 4 - px] = w
                    kernel[n - 1 - ky, kx, 4 - py, px] = w
                    kernel[n - 1 - ky, n - 1 - kx, 4 - py, 4 - px] = w
    return kernel


def _kernels(n: int, weights=None) -> np.ndarray:
    if weights is None:
        if n not in _KERNEL_CACHE:
            default = {2: UPSAMPLING2_WEIGHTS, 4: UPSAMPLING4_WEIGHTS,
                       8: UPSAMPLING8_WEIGHTS}[n]
            _KERNEL_CACHE[n] = _expand_kernels(default, n)
        return _KERNEL_CACHE[n]
    return _expand_kernels(np.asarray(weights, np.float64), n)


def upsample_plane(plane: np.ndarray, n: int,
                   weights=None) -> np.ndarray:
    """Upsamples (H, W) by factor n in each dimension."""
    if n == 1:
        return plane
    k = _kernels(n, weights)
    h, w = plane.shape
    pad = np.pad(plane.astype(np.float64), 2, mode="symmetric")
    win = sliding_window_view(pad, (5, 5))      # (h, w, 5, 5)
    phases = np.einsum("hwij,abij->abhw", win, k, optimize=True)
    mins = win.min(axis=(2, 3))
    maxs = win.max(axis=(2, 3))
    phases = np.clip(phases, mins, maxs)
    out = phases.transpose(2, 0, 3, 1).reshape(h * n, w * n)
    return out.astype(plane.dtype, copy=False)


def upsample_image(planes: np.ndarray, n: int, weights=None) -> np.ndarray:
    """Upsamples (C, H, W) by factor n."""
    if n == 1:
        return planes
    return np.stack([upsample_plane(p, n, weights) for p in planes])
