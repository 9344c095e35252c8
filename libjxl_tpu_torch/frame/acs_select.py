"""AC strategy selection: choose transform sizes per region.

Reference: lib/jxl/enc_ac_strategy.cc — per-8x8 entropy estimates, then
greedy merging into larger DCTs where the estimated rate drops. This
implementation scores candidates with a vectorized entropy proxy over
quantized coefficients (sum log2(1+|q|) + nonzero cost), merging
8x8 -> 16x16 -> 32x32 and trying 16-wide pairs.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct.dct import dct_matrix

# Merge-acceptance thresholds. The rate proxy carries no distortion
# term (the reference's EstimateEntropy mixes rate with a masked
# information-loss penalty, enc_ac_strategy.cc), so acceptance is
# distance-scheduled instead: strict below d=0.6 where any extra
# smearing is visible, loose at d>=1.0 where the reference also tiles
# smooth/noisy content with 16x16-64x64 transforms. Calibrated A/B vs
# cjxl e5 at d in {0.5, 1, 2} on photo/noise/text corpora (merge at
# 0.92/0.45 overspent up to 1.8x on noisy content for negligible
# butteraugli gain; 1.05/0.10 at d<1 overshot distortion).


def _merge_factor(distance: float) -> tuple:
    t = min(1.0, max(0.0, (distance - 0.6) / 0.4))
    return 0.92 + 0.13 * t, 0.45 - 0.35 * t


def _big_merge_factor(distance: float) -> float:
    """Acceptance for >=32px transforms, stricter at low distance
    (ringing) via the residual (2 - d) penalty."""
    mf, bd = _merge_factor(distance)
    return max(0.0, mf - bd * max(0.0, 2.0 - distance))


# Fixed per-block signalling overhead (nzeros token, strategy, etc.).
_BLOCK_OVERHEAD = 2.0


def _bits_proxy(q: np.ndarray, axis) -> np.ndarray:
    a = np.abs(q)
    return (np.log2(1.0 + a).sum(axis=axis)
            + 1.3 * (a > 0).sum(axis=axis) + _BLOCK_OVERHEAD)


def select_strategies(planes: np.ndarray, raw_quant: np.ndarray,
                      quantizer, *, enable_16: bool = True,
                      enable_32: bool = True,
                      enable_rect: bool = True,
                      enable_64: bool = True,
                      distance: float = 1.0) -> np.ndarray:
    """Returns per-8x8-block strategy map (-1 marks covered non-first
    blocks). planes: (3, H, W) XYB padded to blocks."""
    _, h, w = planes.shape
    by, bx = h // 8, w // 8
    strategies = np.zeros((by, bx), np.int32)
    if not (enable_16 or enable_32 or enable_rect):
        return strategies

    dm = quantizer.dequant
    inv_gs = quantizer.inv_global_scale
    y = planes[1].astype(np.float64)

    m8 = dct_matrix(8)
    blocks8 = y.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    coef8 = np.einsum("ui,abij,wj->abuw", m8, blocks8, m8, optimize=True)
    inv8y = (1.0 / dm.table(acs.DCT8X8))[1].ravel()
    scale8 = raw_quant.astype(np.float64) / inv_gs
    q8 = np.round(coef8.reshape(by, bx, 64) * inv8y * scale8[..., None])
    q8[..., 0] = 0
    bits8 = _bits_proxy(q8, axis=-1)

    accept = None
    bits16 = None
    # ---- 16x16 pass (vectorized over all aligned 2x2 tiles) ----
    if enable_16 and by >= 2 and bx >= 2:
        m16 = dct_matrix(16)
        inv16y = (1.0 / dm.table(acs.DCT16X16))[1]
        ty, tx = by // 2, bx // 2
        regions = y[:ty * 16, :tx * 16].reshape(ty, 16, tx, 16)
        regions = regions.transpose(0, 2, 1, 3)  # (ty,tx,16,16)
        coef16 = np.einsum("ui,abij,wj->abuw", m16, regions, m16,
                           optimize=True)
        rq16 = raw_quant[:ty * 2, :tx * 2].reshape(ty, 2, tx, 2) \
            .max(axis=(1, 3))
        sc16 = (rq16 / inv_gs)[..., None, None]
        q16 = np.round(coef16 * inv16y * sc16)
        q16[..., :2, :2] = 0
        bits16 = _bits_proxy(q16, axis=(-2, -1))
        bits8_t = bits8[:ty * 2, :tx * 2].reshape(ty, 2, tx, 2) \
            .sum(axis=(1, 3))
        accept = bits16 < bits8_t * _merge_factor(distance)[0]
        for t_y, t_x in zip(*np.nonzero(accept)):
            b0y, b0x = t_y * 2, t_x * 2
            strategies[b0y:b0y + 2, b0x:b0x + 2] = -1
            strategies[b0y, b0x] = acs.DCT16X16

        accept32_grid = None
        # ---- 32x32 pass over regions fully covered by accepted 16s ----
        if enable_32 and ty >= 2 and tx >= 2:
            m32 = dct_matrix(32)
            inv32y = (1.0 / dm.table(acs.DCT32X32))[1]
            qy, qx = by // 4, bx // 4
            cand = accept[:qy * 2, :qx * 2].reshape(qy, 2, qx, 2) \
                .all(axis=(1, 3))
            if cand.any():
                regions32 = y[:qy * 32, :qx * 32].reshape(qy, 32, qx, 32)
                regions32 = regions32.transpose(0, 2, 1, 3)
                coef32 = np.einsum("ui,abij,wj->abuw", m32, regions32, m32,
                                   optimize=True)
                rq32 = raw_quant[:qy * 4, :qx * 4].reshape(qy, 4, qx, 4) \
                    .max(axis=(1, 3))
                sc32 = (rq32 / inv_gs)[..., None, None]
                q32 = np.round(coef32 * inv32y * sc32)
                q32[..., :4, :4] = 0
                bits32 = _bits_proxy(q32, axis=(-2, -1))
                bits16_q = bits16[:qy * 2, :qx * 2].reshape(qy, 2, qx, 2) \
                    .sum(axis=(1, 3))
                accept32 = cand & (bits32 < bits16_q
                                   * _big_merge_factor(distance))
                accept32_grid = (accept32, bits32)
                for t_y, t_x in zip(*np.nonzero(accept32)):
                    b0y, b0x = t_y * 4, t_x * 4
                    strategies[b0y:b0y + 4, b0x:b0x + 4] = -1
                    strategies[b0y, b0x] = acs.DCT32X32

        # ---- 64x64 pass over regions fully covered by accepted 32s ----
        if enable_32 and enable_64 and accept32_grid is not None \
                and by >= 8 and bx >= 8:
            accept32, bits32 = accept32_grid
            qy, qx = accept32.shape
            oy, ox = qy // 2, qx // 2
            if oy and ox:
                cand64 = accept32[:oy * 2, :ox * 2] \
                    .reshape(oy, 2, ox, 2).all(axis=(1, 3))
                if cand64.any():
                    m64 = dct_matrix(64)
                    inv64y = (1.0 / dm.table(acs.DCT64X64))[1]
                    regions64 = y[:oy * 64, :ox * 64] \
                        .reshape(oy, 64, ox, 64).transpose(0, 2, 1, 3)
                    coef64 = np.einsum("ui,abij,wj->abuw", m64,
                                       regions64, m64, optimize=True)
                    rq64 = raw_quant[:oy * 8, :ox * 8] \
                        .reshape(oy, 8, ox, 8).max(axis=(1, 3))
                    sc64 = (rq64 / inv_gs)[..., None, None]
                    q64 = np.round(coef64 * inv64y * sc64)
                    q64[..., :8, :8] = 0
                    bits64 = _bits_proxy(q64, axis=(-2, -1))
                    bits32_o = bits32[:oy * 2, :ox * 2] \
                        .reshape(oy, 2, ox, 2).sum(axis=(1, 3))
                    accept64 = cand64 & (
                        bits64 < bits32_o * _big_merge_factor(distance))
                    for t_y, t_x in zip(*np.nonzero(accept64)):
                        b0y, b0x = t_y * 8, t_x * 8
                        strategies[b0y:b0y + 8, b0x:b0x + 8] = -1
                        strategies[b0y, b0x] = acs.DCT64X64

    # ---- 16-wide pairs on remaining 8x8 blocks ----
    if enable_rect and bx >= 2:
        m16 = dct_matrix(16)
        invwy = (1.0 / dm.table(acs.DCT8X16))[1]  # (8,16)
        px = bx // 2
        regions = y[:, :px * 16].reshape(by, 8, px, 16).transpose(0, 2, 1, 3)
        coefw = np.einsum("ui,abij,wj->abuw", m8, regions, m16,
                          optimize=True)  # (by,px,8,16)
        rqw = raw_quant[:, :px * 2].reshape(by, px, 2).max(axis=-1)
        scw = (rqw / inv_gs)[..., None, None]
        qw = np.round(coefw * invwy * scw)
        qw[..., :1, :2] = 0
        bitsw = _bits_proxy(qw, axis=(-2, -1))
        bits8_p = bits8[:, :px * 2].reshape(by, px, 2).sum(axis=-1)
        free = (strategies[:, 0:px * 2:2] == acs.DCT8X8) \
            & (strategies[:, 1:px * 2:2] == acs.DCT8X8)
        accept_w = free & (bitsw < bits8_p * _big_merge_factor(distance))
        for yy, pp in zip(*np.nonzero(accept_w)):
            strategies[yy, pp * 2] = acs.DCT8X16
            strategies[yy, pp * 2 + 1] = -1

    # ---- 16-tall pairs (DCT16X8) on what is still free ----
    if enable_rect and by >= 2:
        m16 = dct_matrix(16)
        # DCT16X8 table is (8, 16) in coefficient layout (wider on x);
        # the vertical pair's coefficients transpose into that layout.
        invty = (1.0 / dm.table(acs.DCT16X8))[1]  # (8, 16)
        py = by // 2
        regions = y[:py * 16, :].reshape(py, 16, bx, 8).transpose(0, 2, 1, 3)
        coeft = np.einsum("ui,abij,wj->abuw", m16, regions, m8,
                          optimize=True)  # (py,bx,16,8)
        coeft = coeft.transpose(0, 1, 3, 2)  # layout (8,16)
        rqt = raw_quant[:py * 2, :].reshape(py, 2, bx).max(axis=1)
        sct = (rqt / inv_gs)[..., None, None]
        qt = np.round(coeft * invty * sct)
        qt[..., :1, :2] = 0
        bitst = _bits_proxy(qt, axis=(-2, -1))
        bits8_t = bits8[:py * 2, :].reshape(py, 2, bx).sum(axis=1)
        free = (strategies[0:py * 2:2, :] == acs.DCT8X8) \
            & (strategies[1:py * 2:2, :] == acs.DCT8X8)
        accept_t = free & (bitst < bits8_t * _big_merge_factor(distance))
        for pp, xx in zip(*np.nonzero(accept_t)):
            strategies[pp * 2, xx] = acs.DCT16X8
            strategies[pp * 2 + 1, xx] = -1
    return strategies


# ---------------------------------------------------------------------------
# Sub-8x8 transform choice (enc_ac_strategy.cc FindBest8x8Transform +
# EstimateEntropy, ported with the reference's constants). Every
# within-8x8 transform is linear, so exact batched (64, 64) matrices
# are derived once by probing the per-block reference implementations
# (vardct/reconstruct.py) on basis vectors; evaluation is then one
# einsum per candidate over every block of the frame.

_TX8_CANDIDATES = (
    # (strategy, encoding_speed_tier_max_limit, entropy_mul)
    (acs.DCT8X8, 9, 0.8),
    (acs.DCT4X4, 5, 1.08),
    (acs.DCT2X2, 5, 0.95),
    (acs.DCT4X8, 4, 0.85931637428340035),
    (acs.DCT8X4, 4, 0.85931637428340035),
    (acs.IDENTITY, 5, 1.0427542510634957),
    (acs.AFV0, 4, 0.81779489591359944),
    (acs.AFV1, 4, 0.81779489591359944),
    (acs.AFV2, 4, 0.81779489591359944),
    (acs.AFV3, 4, 0.81779489591359944),
)

_TX8_MATS: dict = {}


def _tx8_matrices(s: int):
    """(fwd, inv): coeffs_flat = pix_flat @ fwd.T; pix = coeffs @ inv.T."""
    if s not in _TX8_MATS:
        from libjxl_tpu_torch.vardct.reconstruct import (
            transform_from_pixels, transform_to_pixels)
        eye = np.eye(64)
        fwd = np.stack([transform_from_pixels(
            s, eye[i].reshape(8, 8)).ravel() for i in range(64)], axis=1)
        inv = np.stack([transform_to_pixels(
            s, eye[i].reshape(8, 8)).ravel() for i in range(64)], axis=1)
        _TX8_MATS[s] = (fwd, inv)
    return _TX8_MATS[s]


def _sub8x8_entropy_mul(s: int, em: float, distance: float) -> float:
    """Candidate-dependent entropy multiplier adjustments
    (enc_ac_strategy.cc FindBest8x8Transform's per-type tweaks)."""
    entropy_mul = em / 0.8
    if s in (acs.DCT2X2, acs.IDENTITY) and distance < 5.0:
        entropy_mul -= 0.4 * ((5.0 - distance) / 5.0) ** 2
    if s not in (acs.DCT8X8, acs.DCT2X2, acs.IDENTITY) and distance > 4.0:
        mul = (12.0 - 4.0) / (distance - 4.0) if distance < 12.0 else 1.0
        entropy_mul += 0.5 * mul
    return entropy_mul


def _select_sub8x8_native(blocks, masku, quant, strategies, cands,
                          matrices, distance, info_loss_multiplier,
                          zeros_mul, cost_delta, cmap_factors, masku_off,
                          channel_mul):
    """Native fused cost passes around BLAS float32 transforms; only
    blocks still assigned DCT8X8 are evaluated. Returns the mutated
    strategies, or None when the native module is unavailable."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_acs_bound"):
        F = C.POINTER(C.c_float)
        lib.acs_sub8x8_stage1.restype = None
        lib.acs_sub8x8_stage1.argtypes = [
            C.c_int64, F, F, F, F, F, C.c_float, C.c_float, F, F]
        lib.acs_sub8x8_stage2.restype = None
        lib.acs_sub8x8_stage2.argtypes = [
            C.c_int64, F, F, F, F, F, F, C.c_float, C.c_float,
            C.c_int32, F, C.POINTER(C.c_int32)]
        lib._acs_bound = True

    take = strategies == acs.DCT8X8
    byv, bxv = np.nonzero(take)
    n = len(byv)
    if n == 0:
        return strategies

    def fp(a):
        return a.ctypes.data_as(C.POINTER(C.c_float))

    blk = np.ascontiguousarray(
        blocks[:, byv, bxv].astype(np.float32))        # (3, n, 64)
    msk = np.ascontiguousarray(masku[byv, bxv].astype(np.float32))
    qv = np.ascontiguousarray(quant[byv, bxv].astype(np.float32))
    cmapf = np.asarray(cmap_factors, np.float32)
    moff = np.asarray(masku_off, np.float32)
    cmul = np.asarray(channel_mul, np.float32)
    best_cost = np.full(n, np.inf, np.float32)
    best_s = np.zeros(n, np.int32)
    coef = np.empty((3, n, 64), np.float32)
    diffm = np.empty((3, n, 64), np.float32)
    err = np.empty((3, n, 64), np.float32)
    entropy = np.empty(n, np.float32)
    for s, em in cands:
        entropy_mul = _sub8x8_entropy_mul(s, em, distance)
        fwd, inv = _tx8_matrices(s)
        tab = matrices.table(s).reshape(3, 64)
        m32 = np.ascontiguousarray(tab.astype(np.float32))
        invm = np.ascontiguousarray((1.0 / tab).astype(np.float32))
        np.matmul(blk, np.ascontiguousarray(fwd.T.astype(np.float32)),
                  out=coef)
        lib.acs_sub8x8_stage1(n, fp(coef), fp(qv), fp(invm), fp(m32),
                              fp(cmapf), zeros_mul, cost_delta,
                              fp(diffm), fp(entropy))
        np.matmul(diffm, np.ascontiguousarray(inv.T.astype(np.float32)),
                  out=err)
        lib.acs_sub8x8_stage2(n, fp(err), fp(msk), fp(moff), fp(cmul),
                              fp(qv), fp(entropy), entropy_mul,
                              info_loss_multiplier, s, fp(best_cost),
                              best_s.ctypes.data_as(
                                  C.POINTER(C.c_int32)))
    strategies[byv, bxv] = best_s
    return strategies


def _mask1x1_kernel() -> np.ndarray:
    """Symmetric5 blur kernel, same quadrant layout as the gaborish
    kernels (c r R / r d L / R L D), weights kFilterMask1x1."""
    k = (0.364911248, 0.05, 0.1688888021, 0.221069183, 0.306563504)
    norm = 1.0 / (1.0 + 4 * (k[0] + k[1] + k[2] + k[4] + 2 * k[3]))
    ker = np.zeros((5, 5))
    ker[2, 2] = norm
    for (dy, dx), wv in (((0, 1), norm * k[0]), ((0, 2), norm * k[2]),
                         ((1, 1), norm * k[1]), ((2, 2), norm * k[4]),
                         ((1, 2), norm * k[3])):
        for sy in (-1, 1):
            for sx in (-1, 1):
                ker[2 + sy * dy, 2 + sx * dx] = wv
                ker[2 + sy * dx, 2 + sx * dy] = wv
    return ker


def masking_1x1(xyb: np.ndarray) -> np.ndarray:
    """Per-pixel masking field for the ACS information-loss term
    (enc_adaptive_quantization.cc ComputeTile mask1x1 + Blur1x1Masking:
    1 / (log1p(|gammac * laplacian|) + 0.01), Symmetric5-blurred)."""
    from libjxl_tpu_torch.frame.adaptive_quant import ratio_of_derivatives
    y = np.ascontiguousarray(xyb[1], np.float64)
    ker = _mask1x1_kernel()
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes as C
        if not hasattr(lib, "_m1x1_bound"):
            D = C.POINTER(C.c_double)
            lib.acs_mask1x1.restype = None
            lib.acs_mask1x1.argtypes = [D, C.c_int64, C.c_int64, D, D]
            lib._m1x1_bound = True
        h, w = y.shape
        out = np.empty((h, w), np.float64)
        k64 = np.ascontiguousarray(ker, np.float64)
        D = C.POINTER(C.c_double)
        lib.acs_mask1x1(y.ctypes.data_as(D), h, w,
                        k64.ctypes.data_as(D), out.ctypes.data_as(D))
        return out
    p = np.pad(y, 1, mode="edge")
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = ratio_of_derivatives(y + 0.019, invert=False)
    diff = np.log1p(np.abs(gammac * (y - base)))
    m = 1.0 / (diff + 0.01)
    pm = np.pad(m, 2, mode="symmetric")
    out = np.zeros_like(m)
    for dy in range(5):
        for dx in range(5):
            if ker[dy, dx] != 0:
                out += ker[dy, dx] * pm[dy:dy + m.shape[0],
                                        dx:dx + m.shape[1]]
    return out


def select_sub8x8(planes: np.ndarray, strategies: np.ndarray,
                  qf_float: np.ndarray, mask1x1: np.ndarray,
                  distance: float, effort: int, matrices,
                  ytox_base: float, ytob_base: float) -> np.ndarray:
    """Replace 8x8 DCT blocks with the best within-8x8 transform where
    the reference cost model says so. Mutates and returns `strategies`
    (blocks covered by merged transforms are untouched)."""
    speed_tier = 10 - effort
    cands = [(s, em) for (s, lim, em) in _TX8_CANDIDATES
             if lim >= speed_tier]
    if len(cands) <= 1:
        return strategies
    _, h, w = planes.shape
    by, bx = h // 8, w // 8
    blocks = planes.reshape(3, by, 8, bx, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(3, by, bx, 64).astype(np.float64)
    masku = mask1x1[:by * 8, :bx * 8].reshape(by, 8, bx, 8) \
        .transpose(0, 2, 1, 3).reshape(by, bx, 64)
    quant = qf_float[:by, :bx].astype(np.float64)

    k_bias = 0.13731742964354549
    ratio = (distance + k_bias) / (1.0 + k_bias)
    info_loss_multiplier = 1.2 * ratio ** 0.33677806662454718
    zeros_mul = 9.3089059022677905 * ratio ** 0.50990926717963703
    cost_delta = 10.833273317067883 * ratio ** 0.36702940662370243
    cmap_factors = (ytox_base, 0.0, ytob_base)
    masku_off = (12.0, 0.0, 4.0)
    channel_mul = (8.2 ** 8, 1.0, 1.03 ** 8)

    native = _select_sub8x8_native(
        blocks, masku, quant, strategies, cands, matrices, distance,
        info_loss_multiplier, zeros_mul, cost_delta, cmap_factors,
        masku_off, channel_mul)
    if native is not None:
        return native

    best_cost = None
    best_s = None
    for s, em in cands:
        entropy_mul = _sub8x8_entropy_mul(s, em, distance)
        fwd, inv = _tx8_matrices(s)
        coef = np.einsum("cbxk,jk->cbxj", blocks, fwd, optimize=True)
        entropy = np.zeros((by, bx))
        loss = np.zeros((by, bx))
        for c in range(3):
            inv_m = (1.0 / matrices.table(s))[c].ravel()
            m = matrices.table(s)[c].ravel()
            val = (coef[c] - cmap_factors[c] * coef[1]) \
                * inv_m * quant[..., None]
            rval = np.round(val)
            diff = val - rval
            q = np.abs(rval)
            entropy += cost_delta * np.sqrt(q).sum(-1)
            nzero = (q != 0).sum(-1)
            nbits = np.where(nzero > 0,
                             np.int64(np.log2(np.maximum(nzero, 1)))
                             + 1, 0) + 1
            entropy += zeros_mul * (
                np.int64(np.log2(nbits + 17)) + 1 + nbits)
            err_pix = np.einsum("bxk,jk->bxj", diff * m, inv,
                                optimize=True)
            e = (masku + masku_off[c]) * err_pix
            loss += channel_mul[c] * (e ** 8).sum(-1)
        loss_scalar = (loss / 64.0) ** 0.125 * 64.0 / quant
        cost = entropy * entropy_mul + info_loss_multiplier * loss_scalar
        if best_cost is None:
            best_cost = cost
            best_s = np.full((by, bx), s, np.int32)
        else:
            better = cost < best_cost
            best_cost = np.where(better, cost, best_cost)
            best_s = np.where(better, s, best_s)
    take = strategies == acs.DCT8X8
    strategies[take] = best_s[take]
    return strategies
