"""Simple metrics (reference: lib/extras/metrics.h PSNR / pnorm).

Copy of libjxl_tpu/metrics/simple.py: host numpy, float64.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float | None = None) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if peak is None:
        peak = 255.0 if a.max() > 2 else 1.0
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def max_abs_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())
