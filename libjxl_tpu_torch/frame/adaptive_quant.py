"""Adaptive quantization field (encoder masking model).

Reference: lib/jxl/enc_adaptive_quantization.cc — per-pixel gamma-scaled
Laplacian energy, 4x downsample, fuzzy erosion, then per-block
modulations (ComputeMask, GammaModulation, HfModulation,
BlueModulation). Numpy-vectorized; constants ported verbatim (they are
the format's perceptual model).
"""

from __future__ import annotations

import numpy as np

INV_LOG2E = 0.6931471805599453  # 1/log2(e) = ln(2)

K_AC_QUANT = 0.765
K_DC_QUANT = 1.095924047623553
K_DC_QUANT_POW = 0.83

_SG_MUL = 226.77216153508914
_SG_MUL2 = 1.0 / 73.377132366608819
_SG_RET_MUL = _SG_MUL2 * 18.6580932135 * INV_LOG2E
_SG_VOFFSET = 7.7825991679894591


def ratio_of_derivatives(v: np.ndarray, invert: bool) -> np.ndarray:
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (enc_adaptive_quantization.cc:125-144)."""
    eps = 1e-2
    v = np.maximum(v, 0.0)
    num_mul = _SG_RET_MUL * 3 * _SG_MUL
    v_offset = _SG_VOFFSET * INV_LOG2E + eps
    den_mul = INV_LOG2E * _SG_MUL
    v2 = v * v
    num = num_mul * v2 + eps
    den = den_mul * v * v2 + v_offset
    return num / den if invert else den / num


def masking_sqrt(v: np.ndarray) -> np.ndarray:
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * np.sqrt(v * np.sqrt(k_mul * 1e8) + k_log_offset)


def compute_mask(out_val: np.ndarray) -> np.ndarray:
    """ComputeMask (enc_adaptive_quantization.cc:93-116)."""
    k_base = -0.7647
    k_mul4 = 9.4708735624378946
    k_mul2 = 17.35036561631863
    k_offset2 = 302.59587815579727
    k_mul3 = 6.7943250517376494
    k_offset3 = 3.7179635626140772
    k_offset4 = 0.25 * k_offset3
    k_mul0 = 0.80061762862741759
    v1 = np.maximum(out_val * k_mul0, 1e-3)
    v2 = 1.0 / (v1 + k_offset2)
    v3 = 1.0 / (v1 * v1 + k_offset3)
    v4 = 1.0 / (v1 * v1 + k_offset4)
    return k_base + k_mul4 * v4 + k_mul2 * v2 + k_mul3 * v3


def _block_reduce(img: np.ndarray, n: int, op) -> np.ndarray:
    h, w = img.shape
    hb, wb = h // n, w // n
    return op(img[:hb * n, :wb * n].reshape(hb, n, wb, n), axis=(1, 3))


def gamma_modulation(x_plane, y_plane, mask_val):
    """GammaModulation per 8x8 block (cc:179-211)."""
    k_bias = 0.16
    iny = y_plane + k_bias
    r = ratio_of_derivatives(iny - x_plane, invert=True)
    g = ratio_of_derivatives(iny + x_plane, invert=True)
    overall = _block_reduce(r + g, 8, np.sum) * (0.5 / 64)
    k_gamma = 0.1005613337192697
    return mask_val + k_gamma * np.log2(np.maximum(overall, 1e-9))


def hf_modulation(y_plane, mask_val):
    """HfModulation (cc:260-313): capped 4-connected abs deltas."""
    valmin = 0.0206
    dx = np.minimum(np.abs(np.diff(y_plane, axis=1)), valmin)
    dy = np.minimum(np.abs(np.diff(y_plane, axis=0)), valmin)
    h, w = y_plane.shape
    # Per-block sums; differences crossing the right/bottom block edge
    # are excluded (kMaskRight / row handling in the reference).
    dx_f = np.zeros((h, w))
    dx_f[:, :w - 1] = dx
    dx_f[:, 7::8] = 0
    dy_f = np.zeros((h, w))
    dy_f[:h - 1, :] = dy
    dy_f[7::8, :] = 0
    sum_y = _block_reduce(dx_f + dy_f, 8, np.sum)
    return mask_val + sum_y * -0.38 + 0.42


def blue_modulation(x_plane, y_plane, b_plane, mask_val):
    """BlueModulation (cc:216-258)."""
    k_limit = 0.010474084867598155
    k_offset = 0.0031994768654636393
    k_mul = 0.90590804735610064
    k_max_limit = 15.463398341612438
    p_y_eff = y_plane + k_offset + np.abs(x_plane)
    contrib = np.where(b_plane > p_y_eff,
                       np.minimum(b_plane - p_y_eff, k_limit), 0.0)
    s = _block_reduce(contrib, 8, np.sum)
    s = np.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = np.minimum(s, k_max_limit * k_limit)
    return mask_val + s * k_mul


def fuzzy_erosion(pre: np.ndarray, butteraugli_target: float) -> np.ndarray:
    """FuzzyErosion (cc:389-450): weighted sum of the 4 smallest in each
    3x3 neighborhood, then 2x2 accumulate."""
    k_mul_base = np.array([0.125, 0.1, 0.09, 0.06])
    k_mul_add = np.array([0.0, -0.1, -0.09, -0.06])
    mul = max(0.0, (2.0 - butteraugli_target) / 2.0) \
        if butteraugli_target < 2.0 else 0.0
    k_mul = k_mul_base + mul * k_mul_add
    k_mul *= 0.29959705784054957 / k_mul.sum()

    h, w = pre.shape
    p = np.pad(pre, 1, mode="edge")
    neighbors = np.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    part = np.partition(neighbors, 3, axis=0)[:4]
    part.sort(axis=0)
    v = (k_mul[:, None, None] * part).sum(axis=0)
    return _block_reduce(v, 2, np.sum)


def initial_quant_dc(butteraugli_target: float) -> float:
    """InitialQuantDC (cc:1250-1262)."""
    k_dc_mul = 0.3
    bt_dc = max(0.5 * butteraugli_target,
                min(butteraugli_target,
                    k_dc_mul * ((1.0 / k_dc_mul) * butteraugli_target)
                    ** K_DC_QUANT_POW))
    return min(K_DC_QUANT / bt_dc, 50.0)


def _native_quant_field(butteraugli_target, xyb, rescale):
    """Fused native InitialQuantField (jxl_native.cpp
    aq_initial_quant_field); None when unavailable. Matches the numpy
    chain below to ~1e-15 relative (sequential vs pairwise sums)."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_aq_bound"):
        lib.aq_initial_quant_field.restype = None
        lib.aq_initial_quant_field.argtypes = [
            C.POINTER(C.c_float), C.c_int64, C.c_int64,
            C.c_double, C.c_double, C.c_double, C.POINTER(C.c_float)]
        lib._aq_bound = True
    _, h, w = xyb.shape
    if h % 8 or w % 8:
        return None
    src = np.ascontiguousarray(xyb, np.float32)
    qf = np.empty((h // 8, w // 8), np.float32)
    lib.aq_initial_quant_field(
        src.ctypes.data_as(C.POINTER(C.c_float)), h, w,
        float(butteraugli_target), float(rescale), float(_MASK_STEEPEN),
        qf.ctypes.data_as(C.POINTER(C.c_float)))
    return qf


def initial_quant_field(butteraugli_target: float, xyb: np.ndarray,
                        rescale: float = 1.0) -> np.ndarray:
    """InitialQuantField: per-8x8-block float quant field.

    xyb: (3, H, W) padded to whole blocks."""
    nat = _native_quant_field(butteraugli_target, xyb, rescale)
    if nat is not None:
        return nat
    _, h, w = xyb.shape
    y_plane = xyb[1].astype(np.float64)
    match_gamma_offset = 0.019
    limit = 0.2

    p = np.pad(y_plane, 1, mode="edge")
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = ratio_of_derivatives(y_plane + match_gamma_offset, invert=False)
    diff = gammac * (y_plane - base)
    diff = np.minimum(diff * diff, limit)
    diff = masking_sqrt(diff)

    # Reference accumulates 4 rows then averages 4 columns * 0.25
    # => sum over the 4x4 tile * 0.25 (cc:698-704).
    pre_erosion = _block_reduce(diff, 4, np.sum) * 0.25
    aq_map = fuzzy_erosion(pre_erosion, butteraugli_target)

    scale = K_AC_QUANT / butteraugli_target * rescale
    mask_val = compute_mask(aq_map)
    mask_val = gamma_modulation(xyb[0].astype(np.float64), y_plane, mask_val)
    out_val = hf_modulation(y_plane, mask_val)
    out_val = np.minimum(out_val,
                         blue_modulation(xyb[0].astype(np.float64), y_plane,
                                         xyb[2].astype(np.float64), mask_val))

    # One-sided masking steepening: on busy content the reference
    # encoder's field drops RELATIVELY further below its median than
    # this model produces (measured against system-cjxl raw_quant
    # fields on adversarial corpora: busy blocks ~1.5x finer here at
    # equal nominal distance, smooth blocks matched). Amplify only the
    # below-median exponent so textured areas coarsen while smooth
    # areas keep their allocation — this changes the SHAPE of the
    # allocation (the matched-quality RD position), not just the scale.
    m = np.median(out_val)
    out_val = out_val + (_MASK_STEEPEN - 1.0) * np.minimum(
        0.0, out_val - m)

    base_level = 0.48 * scale
    k_ramp_start, k_ramp_end = 2.0, 14.0
    dampen = 1.0
    if butteraugli_target >= k_ramp_start:
        dampen = max(0.0, 1.0 - (butteraugli_target - k_ramp_start)
                     / (k_ramp_end - k_ramp_start))
    mul = scale * dampen
    add = (1.0 - dampen) * base_level
    qf = np.exp(out_val) * mul + add
    return qf.astype(np.float32)


# Low-side exponent amplification (see comment in initial_quant_field).
# Measured on the adversarial corpus: steepening reallocates along the
# same RD curve (no matched-butteraugli gain), so it ships neutral; the
# hook stays for per-content tuning experiments.
_MASK_STEEPEN = 1.0


# -- gaborish inverse (encoder) --------------------------------------------

_GABORISH_INV = [-0.09495815671340026, -0.041031725066768575,
                 0.013710004822696948, 0.006510206083837737,
                 -0.0014789063378272242]


def gaborish_inverse(xyb: np.ndarray, mul: float = 1.0) -> np.ndarray:
    """GaborishInverse (enc_gaborish.cc:20-72): symmetric-5x5 sharpen
    applied before DCT so the decoder's 3x3 gaborish smoothing is
    net-neutral. Kernel quadrant layout c r R / r d L / R L D."""
    k = _GABORISH_INV
    s = 1.0 + mul * 4 * (k[0] + k[1] + k[2] + k[4] + 2 * k[3])
    s = max(s, 1e-5)
    norm = 1.0 / s
    nm = mul * norm
    # Build full 5x5 kernel.
    ker = np.zeros((5, 5))
    ker[2, 2] = norm
    for (dy, dx), wv in (
            ((0, 1), nm * k[0]), ((0, 2), nm * k[2]),
            ((1, 1), nm * k[1]), ((2, 2), nm * k[4]),
            ((1, 2), nm * k[3])):
        for sy in (-1, 1):
            for sx in (-1, 1):
                ker[2 + sy * dy, 2 + sx * dx] = wv
                ker[2 + sy * dx, 2 + sx * dy] = wv
    if xyb.dtype == np.float32 and xyb.shape[0] == 3:
        out = _gaborish_inverse_native(xyb, ker)
        if out is not None:
            return out
    out = np.empty_like(xyb)
    for c in range(3):
        p = np.pad(xyb[c], 2, mode="symmetric")
        acc = np.zeros_like(xyb[c], np.float64)
        for dy in range(5):
            for dx in range(5):
                if ker[dy, dx] != 0:
                    acc += ker[dy, dx] * p[dy:dy + xyb.shape[1],
                                           dx:dx + xyb.shape[2]]
        out[c] = acc
    return out


def _gaborish_inverse_native(xyb: np.ndarray, ker: np.ndarray
                             ) -> np.ndarray | None:
    """Native 5x5 symmetric-pad convolution (same f64 tap order as the
    numpy loop above; f32 output absorbs contraction ULPs)."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_gab_inv_bound"):
        lib.gaborish_inverse_f32.restype = None
        lib.gaborish_inverse_f32.argtypes = [
            C.POINTER(C.c_float), C.c_int64, C.c_int64,
            C.POINTER(C.c_double), C.POINTER(C.c_float)]
        lib._gab_inv_bound = True
    src = np.ascontiguousarray(xyb, np.float32)
    k64 = np.ascontiguousarray(ker, np.float64)
    out = np.empty_like(src)
    lib.gaborish_inverse_f32(
        src.ctypes.data_as(C.POINTER(C.c_float)),
        src.shape[1], src.shape[2],
        k64.ctypes.data_as(C.POINTER(C.c_double)),
        out.ctypes.data_as(C.POINTER(C.c_float)))
    return out
