"""Encoder chroma-from-luma fitting (fast path).

Reference: enc_chroma_from_luma.cc FindBestMultiplier (fast branch) +
ComputeTile: per 64x64 tile, least squares of chroma against luma over
inverse-quant-weighted AC coefficients, with a towards-zero shrink.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.vardct.cfl import DEFAULT_COLOR_FACTOR

K_YTOB_BASE = 1.0  # cms kYToBRatio


def _native_cfl():
    """Bound native lib with cfl_find_multiplier, or None."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_cfl_bound"):
        lib.cfl_find_multiplier.restype = C.c_int32
        lib.cfl_find_multiplier.argtypes = [
            C.POINTER(C.c_double), C.POINTER(C.c_double), C.c_int64,
            C.c_double]
        lib._cfl_bound = True
    return lib


def _shrink_round(x: float) -> int:
    towards_zero = 2.6
    if x >= towards_zero:
        x -= towards_zero
    elif x <= -towards_zero:
        x += towards_zero
    else:
        x = 0.0
    return int(np.clip(round(x), -128, 127))


def _find_best_multiplier(vm: np.ndarray, vs: np.ndarray, base: float,
                          distance_mul: float, fast: bool = False) -> int:
    """FindBestMultiplier (enc_chroma_from_luma.cc:128-185): fast =
    closed-form least squares; precise (squirrel and slower, the e7
    default) = up to 20 Newton steps on the robust saturated-L1 cost
    f(x) = 1/3 sum((|a x + b| + 1)^2 - 1)·[|ax+b| < 100]
           + distance_mul·x²·num  (CFLFunction::Compute)."""
    num = vm.size
    if num == 0:
        return 0
    a = vm / DEFAULT_COLOR_FACTOR
    b = base * vm - vs
    if fast:
        ca = np.sum(a * a)
        cb = np.sum(a * b)
        return _shrink_round(-cb / (ca + num * distance_mul * 0.5))
    lib = _native_cfl()
    if lib is not None:
        import ctypes as C
        a64 = np.ascontiguousarray(a, np.float64)
        b64 = np.ascontiguousarray(b, np.float64)
        return int(lib.cfl_find_multiplier(
            a64.ctypes.data_as(C.POINTER(C.c_double)),
            b64.ctypes.data_as(C.POINTER(C.c_double)),
            a64.size, distance_mul))
    k_coeff_x2 = (1.0 / 3) * 2.0
    thres = 100.0
    eps = 100.0

    def fprime3(x):
        """f'(x), f'(x+eps), f'(x-eps) — the saturation mask comes from
        the CENTRAL residual only, exactly like CFLFunction::Compute
        (the same `above` test gates all three accumulators)."""
        v = a * x + b
        keep = np.abs(v) < thres
        ak = a[keep]
        bk = b[keep]

        def deriv(xx):
            vv = ak * xx + bk
            d = k_coeff_x2 * ak * (np.abs(vv) + 1.0)
            return np.where(vv < 0, -d, d).sum()

        reg = 2 * distance_mul * num
        return (reg * x + deriv(x), reg * (x + eps) + deriv(x + eps),
                reg * (x - eps) + deriv(x - eps))

    x = 0.0
    for _ in range(20):
        d_f, d_pe, d_me = fprime3(x)
        ddf = (d_pe - d_me) / (2 * eps)
        step = d_f / (ddf + 0.85)
        x -= min(20.0, max(-20.0, step))
        if abs(step) < 3e-3:
            break
    return _shrink_round(x)


def fit_cfl_maps(coeffs: np.ndarray, inv_table: np.ndarray,
                 raw_quant: np.ndarray, quant_scale: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-64x64-tile ytox/ytob maps from 8x8 DCT coefficients.

    coeffs: (3, BY, BX, 64) float DCT coefficients.
    inv_table: (3, 64) inverse dequant weights.
    raw_quant: (BY, BX) int. quant_scale: quantizer Scale().
    Returns (ytox_map, ytob_map) int32 (ceil(BY/8), ceil(BX/8)).
    """
    _, by, bx, _ = coeffs.shape
    ty, tx = (by + 7) // 8, (bx + 7) // 8
    ytox = np.zeros((ty, tx), np.int32)
    ytob = np.zeros((ty, tx), np.int32)
    k_distance_mul_ac = 1e-9
    k_strange = 128.0
    ac = coeffs.copy()
    ac[..., 0] = 0.0  # zero LLF
    q = quant_scale * k_strange * raw_quant.astype(np.float64)
    lib = _native_cfl()
    if lib is not None and not hasattr(lib, "_cfl_tiles_bound"):
        import ctypes as C
        lib.cfl_fit_tiles.restype = None
        lib.cfl_fit_tiles.argtypes = [
            C.POINTER(C.c_double), C.POINTER(C.c_double),
            C.c_int64, C.c_int64, C.c_double, C.POINTER(C.c_int32)]
        lib._cfl_tiles_bound = True
    if lib is not None:
        import ctypes as C
        qe = q[..., None]

        def fit(vm, vs, base, dst):
            a = np.ascontiguousarray(vm / DEFAULT_COLOR_FACTOR,
                                     np.float64)
            b = np.ascontiguousarray(base * vm - vs, np.float64)
            lib.cfl_fit_tiles(a.ctypes.data_as(C.POINTER(C.c_double)),
                              b.ctypes.data_as(C.POINTER(C.c_double)),
                              by, bx, k_distance_mul_ac,
                              dst.ctypes.data_as(C.POINTER(C.c_int32)))
        fit(ac[1] * inv_table[0] * qe, ac[0] * inv_table[0] * qe,
            0.0, ytox)
        fit(ac[1] * inv_table[2] * qe, ac[2] * inv_table[2] * qe,
            K_YTOB_BASE, ytob)
        return ytox, ytob
    for t_y in range(ty):
        for t_x in range(tx):
            sl = (slice(t_y * 8, min((t_y + 1) * 8, by)),
                  slice(t_x * 8, min((t_x + 1) * 8, bx)))
            qtile = q[sl][..., None]
            wy_x = (ac[1][sl] * inv_table[0] * qtile).ravel()
            wx = (ac[0][sl] * inv_table[0] * qtile).ravel()
            wy_b = (ac[1][sl] * inv_table[2] * qtile).ravel()
            wb = (ac[2][sl] * inv_table[2] * qtile).ravel()
            ytox[t_y, t_x] = _find_best_multiplier(
                wy_x, wx, 0.0, k_distance_mul_ac)
            ytob[t_y, t_x] = _find_best_multiplier(
                wy_b, wb, K_YTOB_BASE, k_distance_mul_ac)
    return ytox, ytob
