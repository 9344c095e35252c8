"""Adaptive-reconstruction (EPF sharpness) heuristic.

Reference: lib/jxl/enc_heuristics.cc:892-1016 ComputeARHeuristics — the
encoder reconstructs the frame with a few constant sharpness values,
measures per-block weighted L2 against the original, and picks each
block's sharpness with a neighbor-context histogram reweighting pass so
the signalled field stays cheap to code.
"""

from __future__ import annotations

import numpy as np

# Per-channel weights of the block L2 (enc_heuristics.cc:883-887).
_KW = (12.339445295782363, 1.0, 0.2)
_FAVOR_NO_SMOOTHING = 0.99
_C3_BASE = 0.98017198824148288
_C3_CLAMP = 0.85970338919928291
_C5 = 0.1087690359555803


def _block_l2(orig: np.ndarray, dec: np.ndarray, mask1x1: np.ndarray,
              BY: int, BX: int) -> np.ndarray:
    """Per-8x8-block masked, channel-weighted squared error."""
    h = min(orig.shape[1], dec.shape[1])
    w = min(orig.shape[2], dec.shape[2])
    d2 = (orig[:, :h, :w] - dec[:, :h, :w]) ** 2 \
        * (mask1x1[:h, :w] ** 2)[None]
    err = (_KW[0] * d2[0] + _KW[1] * d2[1] + _KW[2] * d2[2])
    ph, pw = BY * 8 - h, BX * 8 - w
    err = np.pad(err, ((0, ph), (0, pw)))
    return err.reshape(BY, 8, BX, 8).sum(axis=(1, 3))


def _native_select(error_images: dict, epf_steps: list, BY: int, BX: int,
                   clamped: float):
    """Run both greedy selection passes natively; None when the native
    module is unavailable."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_ar_bound"):
        lib.ar_sharpness_select.restype = None
        lib.ar_sharpness_select.argtypes = [
            C.POINTER(C.c_double), C.POINTER(C.c_int32), C.c_int,
            C.c_int64, C.c_int64, C.c_double, C.c_double, C.c_double,
            C.c_double, C.POINTER(C.c_int32)]
        lib._ar_bound = True
    err = np.ascontiguousarray(
        np.stack([error_images[v] for v in epf_steps]), np.float64)
    steps = np.asarray(epf_steps, np.int32)
    out = np.zeros((BY, BX), np.int32)
    c3 = max(_C3_CLAMP, _C3_BASE ** clamped)
    lib.ar_sharpness_select(
        err.ctypes.data_as(C.POINTER(C.c_double)),
        steps.ctypes.data_as(C.POINTER(C.c_int32)), len(epf_steps),
        BY, BX, _FAVOR_NO_SMOOTHING, _C5, c3, clamped,
        out.ctypes.data_as(C.POINTER(C.c_int32)))
    return out


def compute_ar_sharpness(orig_xyb: np.ndarray, prefilter: np.ndarray,
                         lf, quantizer, raw_quant: np.ndarray,
                         strategies: np.ndarray, fd, distance: float,
                         mask1x1: np.ndarray | None = None) -> np.ndarray:
    """(BY, BX) uint8 sharpness field.

    orig_xyb: original opsin (3, >=ysize, >=xsize); prefilter: the
    reconstructed frame BEFORE loop filters (3, ysize_padded, ...).
    """
    from libjxl_tpu_torch.pipeline.loop_filters import (
        apply_loop_filters, compute_sigma_map, epf0, epf1, epf2,
        epf_native, gaborish, gaborish_native)

    BY, BX = fd.ysize_blocks, fd.xsize_blocks
    clamped = min(5.0, distance)
    if distance > 4.5:
        epf_steps = [0, 4]
    else:
        epf_steps = [0, 2, 7]
    steps_lut = {v: i for i, v in enumerate(epf_steps)}
    if mask1x1 is None:
        mask1x1 = np.ones((fd.ysize, fd.xsize), np.float32)

    img = prefilter[:, :fd.ysize, :fd.xsize]
    if lf.gab:
        gn = gaborish_native(np.ascontiguousarray(img), lf)
        img = gn if gn is not None \
            else gaborish(np.ascontiguousarray(img), lf)

    orig = orig_xyb[:, :fd.ysize, :fd.xsize].astype(np.float32)
    error_images = {}
    for val in epf_steps:
        sharp = np.full((BY, BX), val, np.int32)
        inv_sigma = compute_sigma_map(lf, raw_quant, sharp,
                                      quantizer.global_scale_float)
        out = epf_native(img, lf, inv_sigma) if lf.epf_iters > 0 \
            else None
        if out is None:
            out = img
            if lf.epf_iters >= 3:
                out = epf0(out, lf, inv_sigma)
            if lf.epf_iters >= 1:
                out = epf1(out, lf, inv_sigma)
            if lf.epf_iters >= 2:
                out = epf2(out, lf, inv_sigma)
        error_images[val] = _block_l2(orig, out, mask1x1, BY, BX)

    # Native path: both greedy passes in one C call (the per-block
    # Python loops dominated this heuristic's cost).
    sharp_n = _native_select(error_images, epf_steps, BY, BX, clamped)
    if sharp_n is not None:
        err_stack = np.stack([error_images[v] for v in epf_steps])
        lut_arr = np.zeros(8, np.int64)
        for i, v in enumerate(epf_steps):
            lut_arr[v] = i
        field_err = float(np.take_along_axis(
            err_stack, lut_arr[sharp_n][None], axis=0).sum())
        uni_errs = {v: float(error_images[v].sum()) for v in epf_steps}
        best_uni = min(uni_errs, key=uni_errs.get)
        if field_err > 0.98 * uni_errs[best_uni]:
            sharp_n[:] = best_uni
        return sharp_n.astype(np.int32)

    # Pass 1: greedy per-block choice with top/left reuse preference.
    sharpness = np.zeros((BY, BX), np.uint8)
    histo = np.zeros((9, 8), np.int64)
    totals = np.ones(9, np.int64)
    for by in range(BY):
        for bx in range(BX):
            top_val = int(sharpness[by - 1, bx]) if by > 0 else 0
            left_val = int(sharpness[by, bx - 1]) if bx > 0 else 0
            best_val, best_error = 0, np.inf
            for val in epf_steps:
                error = error_images[val][by, bx]
                if val == 0:
                    error *= _FAVOR_NO_SMOOTHING
                if error < best_error:
                    best_val, best_error = val, error
            top_error = error_images[top_val][by, bx]
            left_error = error_images[left_val][by, bx]
            if best_error < min(top_error, left_error):
                sharpness[by, bx] = best_val
            elif top_error < left_error:
                sharpness[by, bx] = top_val
            else:
                sharpness[by, bx] = left_val
            ctx = steps_lut[top_val] * 3 + steps_lut[left_val]
            histo[ctx][sharpness[by, bx]] += 1
            totals[ctx] += 1

    # Context-frequency reweighting (cheaper-to-code values favored).
    c3 = max(_C3_CLAMP, _C3_BASE ** clamped)
    mul = np.zeros(27)
    for tv in epf_steps:
        for lv in epf_steps:
            ctx = steps_lut[tv] * 3 + steps_lut[lv]
            for val in epf_steps:
                ix = steps_lut[val] + 3 * ctx
                mul[ix] = 1.0 / (1.0 + _C5 * np.log1p(
                    histo[ctx][val] / totals[ctx]) / clamped)
                if val == 0:
                    mul[ix] *= c3
    for by in range(BY):
        for bx in range(BX):
            top_val = int(sharpness[by - 1, bx]) if by > 0 else 0
            left_val = int(sharpness[by, bx - 1]) if bx > 0 else 0
            ctx = steps_lut[top_val] * 3 + steps_lut[left_val]
            best_val, best_error = 0, np.inf
            for val in epf_steps:
                ix = steps_lut[val] + 3 * ctx
                error = error_images[val][by, bx] * mul[ix]
                if error < best_error:
                    best_val, best_error = val, error
            sharpness[by, bx] = best_val

    # Guard: signalling a varying field costs bits; fall back to the
    # best uniform value unless the varying field buys a real error
    # reduction (small images especially).
    field_err = sum(error_images[int(v)][by, bx]
                    for (by, bx), v in np.ndenumerate(sharpness))
    uni_errs = {v: float(error_images[v].sum()) for v in epf_steps}
    best_uni = min(uni_errs, key=uni_errs.get)
    if field_err > 0.98 * uni_errs[best_uni]:
        sharpness[:] = best_uni
    return sharpness.astype(np.int32)
