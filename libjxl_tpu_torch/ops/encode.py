"""Device VarDCT encoder compute stages in plain PyTorch.

Port of libjxl_tpu/ops/encode_pipeline.py: XYB forward, gaborish inverse
and the adaptive-quant masking field (enc_adaptive_quantization.cc),
the batched trial-DCT AC-strategy search (enc_ac_strategy.cc), forward
DCTs, the CfL fit (enc_chroma_from_luma.cc), the per-block quant
adjustment and dead-zone quantization (enc_group.cc
ComputeCoefficients). ``frame/encode_frame.py`` runs them on the torch
device of ``encode(img, device=...)``; the host keeps the global-scale
selection, the sub-8x8 pass, header, TOC and entropy writing.

Every function takes tensors on one device and computes there in
float32 (TF32 is off: ``libjxl_tpu_torch.device`` is imported). Big
transforms use the dense aligned-tile formulation of the reference:
every (cy, cx)-aligned tile is transformed and quantized, and per-tile
masks say which tiles are real. The reference's jitted dispatch
(``stage_b_jitted``) is ``stage_b``, a plain dispatch on the same static
arguments. The stages count their calls per device type in ``calls``.
"""

from __future__ import annotations

import collections
import functools
import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from libjxl_tpu_torch.color.constants import (
    OPSIN_ABSORBANCE_BIAS, OPSIN_ABSORBANCE_MATRIX,
)
from libjxl_tpu_torch.device import _const
from libjxl_tpu_torch.frame.adaptive_quant import (
    _GABORISH_INV, _SG_MUL, _SG_RET_MUL, _SG_VOFFSET, INV_LOG2E, K_AC_QUANT,
)
from libjxl_tpu_torch.ops.filters import pad_symmetric
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct.cfl import DEFAULT_COLOR_FACTOR
from libjxl_tpu_torch.vardct.dct import dct_matrix, idct_matrix, resample_scales

# Calls of each stage since the counter was cleared, keyed by
# (stage, device type): ("encode_stage_b", "cuda") and so on.
calls: collections.Counter = collections.Counter()


def _count(stage: str, t: torch.Tensor) -> None:
    calls[(stage, t.device.type)] += 1


def _f32(dev, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative float32 tensor (``jnp.cbrt`` on the
    reference's inputs): ``pow(x, 1/3)`` and one Newton step, which
    brings it within about one ulp of the correctly rounded root."""
    y = x.pow(1.0 / 3.0)
    safe = torch.where(y > 0, y, torch.ones_like(y))
    return torch.where(y > 0, y - (y - x / (safe * safe)) / 3.0, y)


# ---------------------------------------------------------------------------
# Stage A: pixels -> XYB (+gaborish inverse) + adaptive-quant field


def _ratio_of_derivatives(v, invert: bool):
    eps = 1e-2
    v = torch.clamp(v, min=0.0)
    num_mul = _SG_RET_MUL * 3 * _SG_MUL
    v_offset = _SG_VOFFSET * INV_LOG2E + eps
    den_mul = INV_LOG2E * _SG_MUL
    v2 = v * v
    num = num_mul * v2 + eps
    den = den_mul * v * v2 + v_offset
    return num / den if invert else den / num


def _masking_sqrt(v):
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * torch.sqrt(v * float(np.sqrt(k_mul * 1e8))
                             + k_log_offset)


def _compute_mask(out_val):
    k_base = -0.7647
    k_mul4 = 9.4708735624378946
    k_mul2 = 17.35036561631863
    k_offset2 = 302.59587815579727
    k_mul3 = 6.7943250517376494
    k_offset3 = 3.7179635626140772
    k_offset4 = 0.25 * k_offset3
    k_mul0 = 0.80061762862741759
    v1 = torch.clamp(out_val * k_mul0, min=1e-3)
    v2 = 1.0 / (v1 + k_offset2)
    v3 = 1.0 / (v1 * v1 + k_offset3)
    v4 = 1.0 / (v1 * v1 + k_offset4)
    return k_base + k_mul4 * v4 + k_mul2 * v2 + k_mul3 * v3


def _block_reduce_sum(img, n: int):
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).sum(dim=(1, 3))


def _pad_edge(img, pad: int):
    """(H, W) padded by repeating the edge pixel (``mode="edge"``)."""
    return F.pad(img[None, None], (pad,) * 4, mode="replicate")[0, 0]


def _fuzzy_erosion(pre, butteraugli_target: float):
    k_mul_base = np.array([0.125, 0.1, 0.09, 0.06])
    k_mul_add = np.array([0.0, -0.1, -0.09, -0.06])
    mul = max(0.0, (2.0 - butteraugli_target) / 2.0) \
        if butteraugli_target < 2.0 else 0.0
    k_mul = k_mul_base + mul * k_mul_add
    k_mul = k_mul * (0.29959705784054957 / k_mul.sum())
    h, w = pre.shape
    p = _pad_edge(pre, 1)
    neighbors = torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                             for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    part = torch.sort(neighbors, dim=0).values[:4]
    v = (_f32(pre.device, k_mul)[:, None, None] * part).sum(dim=0)
    return _block_reduce_sum(v, 2)


def initial_quant_field(butteraugli_target: float, xyb,
                        rescale: float = 1.0):
    """InitialQuantField (enc_adaptive_quantization.cc:1264), float32;
    the reference's ``initial_quant_field_jnp``. xyb: (3, H, W) with H
    and W multiples of 8 -> (H/8, W/8)."""
    _count("initial_quant_field", xyb)
    y_plane = xyb[1]
    match_gamma_offset = 0.019
    limit = 0.2
    p = _pad_edge(y_plane, 1)
    h, w = y_plane.shape
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = _ratio_of_derivatives(y_plane + match_gamma_offset, False)
    diff = gammac * (y_plane - base)
    diff = torch.clamp(diff * diff, max=limit)
    diff = _masking_sqrt(diff)
    pre_erosion = _block_reduce_sum(diff, 4) * 0.25
    aq_map = _fuzzy_erosion(pre_erosion, butteraugli_target)

    scale = K_AC_QUANT / butteraugli_target * rescale
    mask_val = _compute_mask(aq_map)
    # GammaModulation
    k_bias = 0.16
    iny = y_plane + k_bias
    r = _ratio_of_derivatives(iny - xyb[0], True)
    g = _ratio_of_derivatives(iny + xyb[0], True)
    overall = _block_reduce_sum(r + g, 8) * (0.5 / 64)
    k_gamma = 0.1005613337192697
    mask_val = mask_val + k_gamma * torch.log2(torch.clamp(overall,
                                                           min=1e-9))
    # HfModulation
    valmin = 0.0206
    dx = torch.clamp(torch.abs(y_plane[:, 1:] - y_plane[:, :-1]),
                     max=valmin)
    dy = torch.clamp(torch.abs(y_plane[1:, :] - y_plane[:-1, :]),
                     max=valmin)
    dx_f = torch.zeros_like(y_plane)
    dx_f[:, :w - 1] = dx
    dx_f[:, 7::8] = 0
    dy_f = torch.zeros_like(y_plane)
    dy_f[:h - 1, :] = dy
    dy_f[7::8, :] = 0
    sum_y = _block_reduce_sum(dx_f + dy_f, 8)
    out_val = mask_val + sum_y * -0.38 + 0.42
    # BlueModulation
    k_limit = 0.010474084867598155
    k_offset = 0.0031994768654636393
    k_mul = 0.90590804735610064
    k_max_limit = 15.463398341612438
    p_y_eff = y_plane + k_offset + torch.abs(xyb[0])
    contrib = torch.where(xyb[2] > p_y_eff,
                          torch.clamp(xyb[2] - p_y_eff, max=k_limit),
                          torch.zeros_like(y_plane))
    s = _block_reduce_sum(contrib, 8)
    s = torch.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = torch.clamp(s, max=k_max_limit * k_limit)
    blue = mask_val + s * k_mul
    out_val = torch.minimum(out_val, blue)

    base_level = 0.48 * scale
    k_ramp_start, k_ramp_end = 2.0, 14.0
    dampen = 1.0
    if butteraugli_target >= k_ramp_start:
        dampen = max(0.0, 1.0 - (butteraugli_target - k_ramp_start)
                     / (k_ramp_end - k_ramp_start))
    mul = scale * dampen
    add = (1.0 - dampen) * base_level
    return torch.exp(out_val) * mul + add


def gaborish_inverse(xyb, mul: float = 1.0):
    """GaborishInverse: symmetric 5x5 sharpen (enc_gaborish.cc:20-72);
    the reference's ``gaborish_inverse_jnp``. The frame edge repeats the
    edge pixel (``mode="symmetric"``)."""
    k = _GABORISH_INV
    s = 1.0 + mul * 4 * (k[0] + k[1] + k[2] + k[4] + 2 * k[3])
    s = max(s, 1e-5)
    norm = 1.0 / s
    nm = mul * norm
    ker = np.zeros((5, 5))
    ker[2, 2] = norm
    for (dy, dx), wv in (((0, 1), nm * k[0]), ((0, 2), nm * k[2]),
                         ((1, 1), nm * k[1]), ((2, 2), nm * k[4]),
                         ((1, 2), nm * k[3])):
        for sy in (-1, 1):
            for sx in (-1, 1):
                ker[2 + sy * dy, 2 + sx * dx] = wv
                ker[2 + sy * dx, 2 + sx * dy] = wv
    _, h, w = xyb.shape
    p = pad_symmetric(xyb, 2)
    acc = torch.zeros_like(xyb)
    for dy in range(5):
        for dx in range(5):
            if ker[dy, dx] != 0:
                acc = acc + float(np.float32(ker[dy, dx])) \
                    * p[:, dy:dy + h, dx:dx + w]
    return acc


def encode_stage_pre(xyb, distance: float, gab: bool,
                     flat_qf: bool = False):
    """Pre-gaborish XYB (3, H, W) -> (qf, stage-B input XYB), both on
    xyb's device.

    The adaptive-quant field reads PRE-gaborish pixels while the coded
    planes are gaborish-inverted (enc_heuristics.cc:1109,1121): both are
    made here from one upload."""
    _count("encode_stage_pre", xyb)
    if flat_qf:
        _, h, w = xyb.shape
        qf = torch.full((h // 8, w // 8), 0.52 / max(distance, 0.1),
                        dtype=torch.float32, device=xyb.device)
    else:
        qf = initial_quant_field(distance, xyb)
    return qf, (gaborish_inverse(xyb) if gab else xyb)


def _opsin_mix(linear):
    """Opsin absorbance (3x3 matrix over the colour axis -3, then the
    bias), summed term by term in the matrix's column order."""
    m = OPSIN_ABSORBANCE_MATRIX.astype(np.float32)
    rows = []
    for i in range(3):
        acc = float(m[i, 0]) * linear[..., 0, :, :]
        for j in (1, 2):
            acc = acc + float(m[i, j]) * linear[..., j, :, :]
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def _xyb_from_mixed(mixed):
    bias = _f32(mixed.device, OPSIN_ABSORBANCE_BIAS)
    c = cbrt(mixed) - cbrt(bias).reshape(3, 1, 1)
    x = 0.5 * (c[..., 0, :, :] - c[..., 1, :, :])
    y = 0.5 * (c[..., 0, :, :] + c[..., 1, :, :])
    return torch.stack([x, y, c[..., 2, :, :]], dim=-3)


def srgb_to_xyb(srgb):
    """(..., 3, H, W) sRGB [0,1] -> XYB (enc_xyb.cc LinearRGBToXYB)."""
    _count("srgb_to_xyb", srgb)
    linear = torch.where(srgb <= 0.04045, srgb / 12.92,
                         ((srgb + 0.055) / 1.055) ** 2.4)
    bias = _f32(srgb.device, OPSIN_ABSORBANCE_BIAS)
    mixed = torch.clamp(_opsin_mix(linear) + bias.reshape(3, 1, 1),
                        min=0.0)
    return _xyb_from_mixed(mixed)


def encode_stage_a(linear, distance: float, gab: bool,
                   flat_qf: bool = False):
    """linear (3, H, W) linear RGB (block-padded) -> (xyb, qf).

    xyb has the gaborish inverse applied when gab. qf is the
    per-8x8-block adaptive quant field (flat for effort<=2)."""
    _count("encode_stage_a", linear)
    bias = _f32(linear.device, OPSIN_ABSORBANCE_BIAS)
    mixed = torch.clamp(_opsin_mix(linear) + bias[:, None, None], min=0.0)
    xyb = _xyb_from_mixed(mixed)
    if flat_qf:
        _, h, w = xyb.shape
        qf = torch.full((h // 8, w // 8), 0.52 / max(distance, 0.1),
                        dtype=torch.float32, device=xyb.device)
    else:
        qf = initial_quant_field(distance, xyb)
    if gab:
        xyb = gaborish_inverse(xyb)
    return xyb, qf


# ---------------------------------------------------------------------------
# Stage B: XYB + raw quant field -> strategies, quantized coefficients,
# DC, CfL maps.

_MERGE_FACTOR = 0.92
_BLOCK_OVERHEAD = 2.0


def _bits_proxy(q, dims):
    a = torch.abs(q)
    return (torch.log2(1.0 + a).sum(dim=dims)
            + 1.3 * (a > 0).sum(dim=dims) + _BLOCK_OVERHEAD)


def _tile_max(a, cy, cx):
    by, bx = a.shape
    return a[:by // cy * cy, :bx // cx * cx] \
        .reshape(by // cy, cy, bx // cx, cx).amax(dim=(1, 3))


def _tile_sum(a, cy, cx):
    by, bx = a.shape
    return a[:by // cy * cy, :bx // cx * cx] \
        .reshape(by // cy, cy, bx // cx, cx).sum(dim=(1, 3))


def _dct_mat(dev, n: int) -> torch.Tensor:
    return _const(dev, ("enc_dct", n), lambda: torch.from_numpy(
        dct_matrix(n).astype(np.float32)))


def _fwd_dct_tiles(y, cy8, cx8):
    """Dense forward DCT of every (cy8, cx8) pixel tile of plane(s) y
    (..., H, W) -> (..., TH, TW, cy8, cx8) coefficient grids (stored
    orientation applied by caller)."""
    h, w = y.shape[-2:]
    th, tw = h // cy8, w // cx8
    tiles = y.reshape(y.shape[:-2] + (th, cy8, tw, cx8))
    tiles = torch.movedim(tiles, -3, -2)      # (..., th, tw, cy8, cx8)
    mr = _dct_mat(y.device, cy8)
    mc = _dct_mat(y.device, cx8)
    return torch.matmul(torch.matmul(mr, tiles), mc.T)


def _expand(mask, cy, cx, by, bx):
    """A (ty, tx) tile mask repeated over its blocks, in a (by, bx) map."""
    m = mask.repeat_interleave(cy, 0).repeat_interleave(cx, 1)
    full = torch.zeros((by, bx), dtype=torch.bool, device=mask.device)
    full[:m.shape[0], :m.shape[1]] = m
    return full


def _anchors(mask, cy, cx, by, bx):
    """A (ty, tx) tile mask on the top-left block of each tile."""
    full = torch.zeros((by, bx), dtype=torch.bool, device=mask.device)
    full[:mask.shape[0] * cy:cy, :mask.shape[1] * cx:cx] = mask
    return full


def acs_select(y, raw_quant, inv_gs, inv8y, inv16y, inv32y, inv64y,
               invwy, invty, *, enable_16, enable_32, enable_64,
               enable_rect, big_factor=_MERGE_FACTOR,
               merge16=_MERGE_FACTOR):
    """select_strategies (frame/acs_select.py) as tensor ops; the
    reference's ``acs_select_jnp``.

    Returns the (BY, BX) int32 strategy map with -1 on covered blocks."""
    h, w = y.shape
    by, bx = h // 8, w // 8
    dev = y.device
    strategies = torch.zeros((by, bx), dtype=torch.int32, device=dev)
    if not (enable_16 or enable_32 or enable_rect):
        return strategies

    def as_id(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    coef8 = _fwd_dct_tiles(y, 8, 8)
    scale8 = raw_quant.float() / inv_gs
    q8 = torch.round(coef8.reshape(by, bx, 64) * inv8y
                     * scale8[..., None])
    q8[..., 0] = 0
    bits8 = _bits_proxy(q8, -1)
    del coef8, q8

    cover = torch.zeros((by, bx), dtype=torch.bool, device=dev)
    if enable_16 and by >= 2 and bx >= 2:
        ty, tx = by // 2, bx // 2
        coef16 = _fwd_dct_tiles(y[:ty * 16, :tx * 16], 16, 16)
        rq16 = _tile_max(raw_quant, 2, 2).float()
        sc16 = (rq16 / inv_gs)[..., None, None]
        q16 = torch.round(coef16 * inv16y * sc16)
        del coef16
        q16[..., :2, :2] = 0
        bits16 = _bits_proxy(q16, (-2, -1))
        del q16
        bits8_t = _tile_sum(bits8, 2, 2)
        accept16 = bits16 < bits8_t * merge16

        accept32 = None
        bits32 = None
        if enable_32 and ty >= 2 and tx >= 2:
            qy, qx = by // 4, bx // 4
            cand = _tile_sum(accept16[:qy * 2, :qx * 2].int(), 2, 2) == 4
            coef32 = _fwd_dct_tiles(y[:qy * 32, :qx * 32], 32, 32)
            rq32 = _tile_max(raw_quant, 4, 4).float()
            sc32 = (rq32 / inv_gs)[..., None, None]
            q32 = torch.round(coef32 * inv32y * sc32)
            del coef32
            q32[..., :4, :4] = 0
            bits32 = _bits_proxy(q32, (-2, -1))
            del q32
            bits16_q = _tile_sum(bits16[:qy * 2, :qx * 2], 2, 2)
            accept32 = cand & (bits32 < bits16_q * big_factor)

        accept64 = None
        if enable_32 and enable_64 and accept32 is not None \
                and by >= 8 and bx >= 8:
            qy, qx = accept32.shape
            oy, ox = qy // 2, qx // 2
            if oy and ox:
                cand64 = _tile_sum(
                    accept32[:oy * 2, :ox * 2].int(), 2, 2) == 4
                coef64 = _fwd_dct_tiles(y[:oy * 64, :ox * 64], 64, 64)
                rq64 = _tile_max(raw_quant, 8, 8).float()
                sc64 = (rq64 / inv_gs)[..., None, None]
                q64 = torch.round(coef64 * inv64y * sc64)
                del coef64
                q64[..., :8, :8] = 0
                bits64 = _bits_proxy(q64, (-2, -1))
                del q64
                bits32_o = _tile_sum(bits32[:oy * 2, :ox * 2], 2, 2)
                accept64 = cand64 & (bits64 < bits32_o * big_factor)

        # Largest-first precedence: 64 wins over 32 wins over 16.
        none = torch.zeros((by, bx), dtype=torch.bool, device=dev)
        if accept64 is not None:
            c64 = _expand(accept64, 8, 8, by, bx)
            an64 = _anchors(accept64, 8, 8, by, bx)
        else:
            c64, an64 = none, none
        if accept32 is not None:
            a32 = accept32 & ~_tile_max(c64.int(), 4, 4)[
                :accept32.shape[0], :accept32.shape[1]].bool()
            c32 = _expand(a32, 4, 4, by, bx)
            an32 = _anchors(a32, 4, 4, by, bx)
        else:
            c32, an32 = none, none
        a16 = accept16 & ~_tile_max((c64 | c32).int(), 2, 2)[
            :accept16.shape[0], :accept16.shape[1]].bool()
        c16 = _expand(a16, 2, 2, by, bx)
        an16 = _anchors(a16, 2, 2, by, bx)
        cover = c64 | c32 | c16
        strategies = torch.where(cover, as_id(-1), strategies)
        strategies = torch.where(an64, as_id(acs.DCT64X64), strategies)
        strategies = torch.where(an32, as_id(acs.DCT32X32), strategies)
        strategies = torch.where(an16, as_id(acs.DCT16X16), strategies)

    # 16-wide pairs (DCT8X16) on remaining DCT8 blocks.
    if enable_rect and bx >= 2:
        px = bx // 2
        coefw = _fwd_dct_tiles(y[:, :px * 16], 8, 16)  # (by,px,8,16)
        rqw = _tile_max(raw_quant, 1, 2).float()
        scw = (rqw / inv_gs)[..., None, None]
        qw = torch.round(coefw * invwy * scw)
        del coefw
        qw[..., :1, :2] = 0
        bitsw = _bits_proxy(qw, (-2, -1))
        del qw
        bits8_p = _tile_sum(bits8, 1, 2)
        free = (~cover[:, 0:px * 2:2]) & (~cover[:, 1:px * 2:2]) \
            & (strategies[:, 0:px * 2:2] == acs.DCT8X8) \
            & (strategies[:, 1:px * 2:2] == acs.DCT8X8)
        accept_w = free & (bitsw < bits8_p * big_factor)
        strategies = strategies.clone()
        strategies[:, 0:px * 2:2] = torch.where(
            accept_w, as_id(acs.DCT8X16), strategies[:, 0:px * 2:2])
        strategies[:, 1:px * 2:2] = torch.where(
            accept_w, as_id(-1), strategies[:, 1:px * 2:2])
        cover = cover.clone()
        cover[:, 0:px * 2:2] = cover[:, 0:px * 2:2] | accept_w
        cover[:, 1:px * 2:2] = cover[:, 1:px * 2:2] | accept_w

    # 16-tall pairs (DCT16X8).
    if enable_rect and by >= 2:
        py = by // 2
        coeft = _fwd_dct_tiles(y[:py * 16, :], 16, 8)  # (py,bx,16,8)
        coeft = coeft.transpose(-1, -2)                 # stored (8,16)
        rqt = _tile_max(raw_quant, 2, 1).float()
        sct = (rqt / inv_gs)[..., None, None]
        qt = torch.round(coeft * invty * sct)
        del coeft
        qt[..., :1, :2] = 0
        bitst = _bits_proxy(qt, (-2, -1))
        del qt
        bits8_t = _tile_sum(bits8, 2, 1)
        free = (strategies[0:py * 2:2, :] == acs.DCT8X8) \
            & (strategies[1:py * 2:2, :] == acs.DCT8X8)
        accept_t = free & (bitst < bits8_t * big_factor)
        strategies = strategies.clone()
        strategies[0:py * 2:2, :] = torch.where(
            accept_t, as_id(acs.DCT16X8), strategies[0:py * 2:2, :])
        strategies[1:py * 2:2, :] = torch.where(
            accept_t, as_id(-1), strategies[1:py * 2:2, :])
    return strategies


# Big-transform classes handled densely: (cy, cx) -> strategy id.
BIG_CLASSES = {(2, 2): acs.DCT16X16, (4, 4): acs.DCT32X32,
               (8, 8): acs.DCT64X64, (1, 2): acs.DCT8X16,
               (2, 1): acs.DCT16X8}


def _quad_consts(dev):
    """Static 64-position masks of AdjustQuantBlockAC: (notllf,
    hf_region, the four quadrant masks without the LLF, the quadrant of
    each position)."""
    def make():
        pos = np.arange(64)
        row, col = pos // 8, pos % 8
        quad = ((row >= 4).astype(np.int64) * 2 + (col >= 4))
        hf = (((row >= 7) & (col >= 7))
              | (((row == 7) | (col == 7)) & (row >= 4) & (col >= 4)))
        return (torch.from_numpy(pos != 0), torch.from_numpy(hf),
                torch.from_numpy(np.stack([(quad == i) & (pos != 0)
                                           for i in range(4)])),
                torch.from_numpy(quad))
    return _const(dev, "enc_quad", make)


def _adjust_quant_blocks(coeffs, flat_inv, raw_quant, inv_gs,
                         x_mul, b_mul, dct8_mask, quant_max):
    """AdjustQuantBlockAC (enc_group.cc:104-330), float32; the
    reference's ``_adjust_quant_blocks_jnp``. Returns the adjusted
    (BY, BX) int32 raw quant and the (BY, BX, 4) Y thresholds."""
    dev = coeffs.device
    notllf, hf_region, quad_masks, quad = _quad_consts(dev)

    quant0 = raw_quant.float()
    scale0 = quant0 / inv_gs
    qmul = {1: 1.0, 0: x_mul, 2: b_mul}
    hf_mul = {0: 70.0, 1: 30.0, 2: 60.0}
    trial_thr = _f32(dev, [0.58, 0.64, 0.64, 0.64])
    thr_quad = trial_thr[quad]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    quant_final = torch.zeros_like(quant0)
    thr_y = None
    for c in (1, 0, 2):
        thr = trial_thr.expand(raw_quant.shape + (4,))
        val = coeffs[c] * flat_inv[c] * (scale0 * qmul[c])[..., None]
        v = torch.where(torch.abs(val) >= thr_quad, torch.round(val), zero)
        av = torch.abs(v) * notllf
        err = torch.abs(val - v) * notllf
        hfnz = torch.stack([torch.where(m, av, zero).sum(-1)
                            for m in quad_masks], -1)
        sum_vals = av.sum(-1)
        sum_hf = torch.where((v != 0) & hf_region & notllf,
                             torch.abs(val), zero).sum(-1)
        quant = quant0
        if c == 1:
            hfme = torch.stack(
                [torch.where(m & (v == 0), err, zero).amax(-1)
                 for m in quad_masks], -1)
            allzero = sum_vals * 8 < 1.0
            bump = allzero & ((hfnz[..., 1:] == 0)
                              & (hfme[..., 1:] > 0.46)).any(-1)
            new_quant = quant + bump
            ratio = new_quant / quant
            cond3 = allzero & (hfnz[..., 3] == 0) & (hfme[..., 3] > 0.46)
            cond12 = allzero & ~cond3 & (
                ((hfnz[..., 1] == 0) & (hfme[..., 1] > 0.46))
                | ((hfnz[..., 2] == 0) & (hfme[..., 2] > 0.46)))
            cond0 = allzero & ~cond3 & ~cond12 \
                & (hfnz[..., 0] == 0) & (hfme[..., 0] > 0.46)
            t3 = torch.where(cond3, 0.9999 * hfme[..., 3] * ratio,
                             thr[..., 3])
            t12 = 0.9999 * torch.maximum(hfme[..., 1], hfme[..., 2]) * ratio
            t1 = torch.where(cond12, t12, thr[..., 1])
            t2 = torch.where(cond12, t12, thr[..., 2])
            t0 = torch.where(cond0, 0.9999 * hfme[..., 0] * ratio,
                             thr[..., 0])
            thr = torch.stack([t0, t1, t2, t3], dim=-1)
            quant = new_quant
        allnz = hfnz.sum(-1) + 1.0
        boost = hf_mul[c] * sum_hf
        quant = torch.where(boost >= allnz,
                            torch.clamp(quant + torch.trunc(boost / allnz),
                                        max=quant_max - 1), quant)
        quant = torch.where(hfnz.sum(-1) < 11,
                            torch.clamp(quant + 1, max=quant_max - 1), quant)
        min_hf = hfnz.amin(-1)
        activity = torch.where(min_hf < 15.0, torch.trunc(min_hf),
                               torch.full_like(min_hf, 15.0))
        if c == 1:
            thr = torch.cat([thr[..., :1],
                             thr[..., 1:] + 0.01 * activity[..., None]], -1)
            thr_y = thr
        qp = quant - activity
        limit = torch.clamp(torch.trunc(quant / 2), min=4)
        qp = torch.maximum(qp, limit)
        quant_final = torch.maximum(quant_final, qp)

    new_rq = torch.where(dct8_mask, quant_final.int(), raw_quant)
    return new_rq, thr_y


def _fit_cfl(coeffs, inv_table, raw_quant, quant_scale):
    """fit_cfl_maps (frame/cfl_fit.py), vectorized over 64x64 tiles; the
    reference's ``_fit_cfl_jnp``. Returns the (ytox, ytob) int32 maps."""
    _, by, bx, _ = coeffs.shape
    ty, tx = -(-by // 8), -(-bx // 8)
    k_distance_mul_ac = 1e-9
    k_strange = 128.0
    ac = coeffs.clone()
    ac[..., 0] = 0.0
    q = quant_scale * k_strange * raw_quant.float()
    # Pad to tile multiples; padded blocks contribute zero.
    pby, pbx = ty * 8, tx * 8
    acp = F.pad(ac, (0, 0, 0, pbx - bx, 0, pby - by))
    qp = F.pad(q, (0, pbx - bx, 0, pby - by))
    del ac, q

    def tile_sum(a):
        # (pby, pbx, 64) -> (ty, tx) sums over blocks and coefficients
        return a.reshape(ty, 8, tx, 8, 64).sum(dim=(1, 3, 4))

    def fit(vm_w, vs_w, base):
        # Precise FindBestMultiplier (enc_chroma_from_luma.cc CFLFunction
        # + Newton): up to 20 damped Newton steps per tile on the
        # saturated robust cost, with the saturation mask taken from the
        # CENTRAL residual for all three derivative samples.
        a = vm_w / DEFAULT_COLOR_FACTOR
        b = base * vm_w - vs_w
        # Per-tile sample count: real blocks per tile times 64.
        ones = F.pad(torch.ones((by, bx), device=a.device),
                     (0, pbx - bx, 0, pby - by))
        n = ones.reshape(ty, 8, tx, 8).sum(dim=(1, 3)) * 64
        k2 = (1.0 / 3) * 2.0
        eps = 100.0
        reg = 2 * k_distance_mul_ac * n

        def expand(t):
            return t.repeat_interleave(8, 0).repeat_interleave(8, 1)[
                ..., None]

        def dsum(xe, keep):
            vv = a * xe + b
            d = k2 * a * (torch.abs(vv) + 1.0)
            d = torch.where(vv < 0, -d, d)
            return tile_sum(torch.where(keep, d, torch.zeros_like(d)))

        x = torch.zeros((ty, tx), dtype=torch.float32, device=a.device)
        done = torch.zeros((ty, tx), dtype=torch.bool, device=a.device)
        for _ in range(20):
            xe = expand(x)
            keep = torch.abs(a * xe + b) < 100.0
            fd = reg * x + dsum(xe, keep)
            fpe = reg * (x + eps) + dsum(xe + eps, keep)
            fme = reg * (x - eps) + dsum(xe - eps, keep)
            step = fd / ((fpe - fme) / (2 * eps) + 0.85)
            x = torch.where(done, x, x - torch.clamp(step, -20.0, 20.0))
            done = done | (torch.abs(step) < 3e-3)
        towards_zero = 2.6
        x = torch.where(x >= towards_zero, x - towards_zero,
                        torch.where(x <= -towards_zero, x + towards_zero,
                                    torch.zeros_like(x)))
        return torch.clamp(torch.round(x), -128, 127).int()

    qe = qp[..., None]
    wy_x = acp[1] * inv_table[0] * qe
    wx = acp[0] * inv_table[0] * qe
    ytox = fit(wy_x, wx, 0.0)
    del wy_x, wx
    wy_b = acp[1] * inv_table[2] * qe
    wb = acp[2] * inv_table[2] * qe
    return ytox, fit(wy_b, wb, 1.0)


def _deadzone_thr(rows, cols, chroma, covered):
    thr = np.array([0.58, 0.62, 0.62, 0.62] if chroma
                   else [0.56, 0.62, 0.62, 0.62], np.float32)
    if chroma and covered >= 4:
        thr = np.maximum(thr - 0.00744 * covered, 0.5)
    yy = (np.arange(rows) >= rows // 2).astype(np.int64) * 2
    xx = (np.arange(cols) >= cols // 2).astype(np.int64)
    return thr[yy[:, None] + xx[None, :]]


def _qdz(val, thr):
    return torch.where(torch.abs(val) >= thr, torch.round(val),
                       torch.zeros_like(val))


_BY_BIAS = 1.0 - 0.07005449891748593


def _adjust_bias_y(q):
    gen = q - 0.145 / torch.where(q == 0, torch.ones_like(q), q)
    return torch.where(q == 0, torch.zeros_like(q),
                       torch.where(q == 1, torch.full_like(q, _BY_BIAS),
                                   torch.where(q == -1,
                                               torch.full_like(q, -_BY_BIAS),
                                               gen)))


def encode_stage_b(xyb, raw_quant, inv_gs, x_mul, b_mul, mul_dc, cfl_fac,
                   tables, *, effort: int, quant_max: int,
                   base_cx: float, base_cb: float, color_scale: float,
                   fixed_strategies=None, big_factor=_MERGE_FACTOR,
                   merge16=_MERGE_FACTOR):
    """XYB + raw quant field -> strategies, quantized coefficients, DC,
    CfL maps (compute_vardct_encoding's device half). All dense, all on
    xyb's device: ``inv_gs``, ``x_mul`` and ``b_mul`` are 0-dim float32
    tensors, ``mul_dc`` and ``cfl_fac`` (3,) float32, ``tables`` from
    ``tables_to_torch``.

    The reference computes every big class's transform before the CfL
    fit and quantizes them after it; here the fit and the 8x8 path run
    first and each class is transformed, folded into the DC and
    quantized in turn, so one class's coefficients are alive at a time.
    No value depends on that order."""
    _count("encode_stage_b", xyb)
    dev = xyb.device
    _, H, W = xyb.shape
    BY, BX = H // 8, W // 8

    # ---- AC strategy selection ----
    if fixed_strategies is not None:
        strategies = fixed_strategies
    elif effort <= 3:
        strategies = torch.zeros((BY, BX), dtype=torch.int32, device=dev)
    else:
        strategies = acs_select(
            xyb[1], raw_quant, inv_gs, tables["inv8y"], tables["inv16y"],
            tables["inv32y"], tables["inv64y"], tables["invwy"],
            tables["invty"],
            enable_16=True, enable_32=effort >= 5,
            enable_rect=effort >= 6, enable_64=effort >= 7,
            big_factor=big_factor, merge16=merge16)

    # ---- AdjustQuantField: uniform (max) qf within multi-block
    # strategies, dense per class ----
    rq = raw_quant.clone()
    class_masks = {}
    for (cy, cx), sid in BIG_CLASSES.items():
        if BY // cy == 0 or BX // cx == 0:
            class_masks[(cy, cx)] = None
            continue
        m = strategies[:BY // cy * cy:cy, :BX // cx * cx:cx] == sid
        class_masks[(cy, cx)] = m
        tby, tbx = m.shape
        rqc = rq[:tby * cy, :tbx * cx]
        rqt = rqc.reshape(tby, cy, tbx, cx).amax(dim=(1, 3))
        spread = rqt.repeat_interleave(cy, 0).repeat_interleave(cx, 1)
        sel = m.repeat_interleave(cy, 0).repeat_interleave(cx, 1)
        rq[:tby * cy, :tbx * cx] = torch.where(sel, spread, rqc)
    raw_quant = rq

    # ---- Forward 8x8 DCT (stored layout) + DC ----
    coef8 = _fwd_dct_tiles(xyb, 8, 8)              # (3, BY, BX, 8, 8)
    dc_float = coef8[..., 0, 0].clone()
    coef8s = coef8.transpose(-1, -2).reshape(3, BY, BX, 64)
    del coef8

    # ---- CfL fit (on the 8x8 coefficients) ----
    flat_inv = tables["i8"]
    if effort <= 2:
        ty, tx = -(-BY // 8), -(-BX // 8)
        ytox_map = torch.zeros((ty, tx), dtype=torch.int32, device=dev)
        ytob_map = torch.zeros((ty, tx), dtype=torch.int32, device=dev)
    else:
        ytox_map, ytob_map = _fit_cfl(coef8s, flat_inv, raw_quant,
                                      1.0 / inv_gs)

    # ---- 8x8 quantization ----
    scale = raw_quant.float() / inv_gs
    tile_y = torch.arange(BY, device=dev) // 8
    tile_x = torch.arange(BX, device=dev) // 8
    fx_b = base_cx + ytox_map.index_select(0, tile_y).index_select(
        1, tile_x) * color_scale
    fb_b = base_cb + ytob_map.index_select(0, tile_y).index_select(
        1, tile_x) * color_scale
    thr_c8 = _f32(dev, _deadzone_thr(8, 8, True, 1).reshape(64))
    if effort >= 5:
        dct8_mask = strategies == acs.DCT8X8
        raw_quant, thr_y_quad = _adjust_quant_blocks(
            coef8s, flat_inv, raw_quant, inv_gs, x_mul, b_mul,
            dct8_mask, quant_max)
        scale = raw_quant.float() / inv_gs
        _, _, _, quad64 = _quad_consts(dev)
        thr_y8 = thr_y_quad[..., quad64]
    else:
        thr_y8 = _f32(dev, _deadzone_thr(8, 8, False, 1).reshape(64))
    sc = scale[..., None]
    qy = _qdz(coef8s[1] * flat_inv[1] * sc, thr_y8)
    dq_y = _adjust_bias_y(qy) * tables["t8"][1] / sc
    qx = _qdz((coef8s[0] - fx_b[..., None] * dq_y)
              * flat_inv[0] * (sc * x_mul), thr_c8)
    qb = _qdz((coef8s[2] - fb_b[..., None] * dq_y)
              * flat_inv[2] * (sc * b_mul), thr_c8)
    qall = torch.stack([qx, qy, qb]).int()
    qall[..., 0] = 0
    del qx, qy, qb, dq_y, coef8s, thr_y8, sc

    # ---- Big classes: dense fwd DCT, DC from the LLF, quantization ----
    big_q = {}
    for (cy, cx), sid in BIG_CLASSES.items():
        m = class_masks[(cy, cx)]
        if m is None:
            continue
        tby, tbx = m.shape
        ph, pw = tby * cy * 8, tbx * cx * 8
        coef = _fwd_dct_tiles(xyb[:, :ph, :pw], cy * 8, cx * 8)
        if cy >= cx:
            coef = coef.transpose(-1, -2)          # stored layout
        # DC from LLF (dct_scales.h DCTResampleScales): slice the STORED
        # grid then un-transpose, exactly as the host encoder does.
        ly, lx = acs.coefficient_layout(cy, cx)
        llf = coef[..., :ly, :lx]
        if cy >= cx:
            llf = llf.transpose(-1, -2)            # -> (cy, cx)
        sy = _f32(dev, resample_scales(cy, cy * 8))
        sx = _f32(dev, resample_scales(cx, cx * 8))
        ir = _f32(dev, idct_matrix(cy))
        ic = _f32(dev, idct_matrix(cx))
        dcb = torch.matmul(torch.matmul(
            ir, llf / (sy[:, None] * sx[None, :])), ic.T)
        dcb = dcb.permute(0, 1, 3, 2, 4)           # (3, tby, cy, tbx, cx)
        cur = dc_float[:, :tby * cy, :tbx * cx].reshape(3, tby, cy, tbx, cx)
        sel = m[None, :, None, :, None]
        dc_float[:, :tby * cy, :tbx * cx] = torch.where(
            sel, dcb, cur).reshape(3, tby * cy, tbx * cx)
        del llf, dcb, cur
        coef = coef.reshape(3, tby, tbx, cy * cx * 64)

        size = cy * cx * 64
        t_s = tables[f"t{cy}x{cx}"]                # (3, size)
        inv_s = 1.0 / t_s
        sc_s = (raw_quant[:tby * cy:cy, :tbx * cx:cx].float()
                / inv_gs)[..., None]
        fx_t = fx_b[:tby * cy:cy, :tbx * cx:cx][..., None]
        fb_t = fb_b[:tby * cy:cy, :tbx * cx:cx][..., None]
        thr_yb = _f32(dev, _deadzone_thr(ly * 8, lx * 8, False,
                                         cy * cx).reshape(size))
        thr_cb = _f32(dev, _deadzone_thr(ly * 8, lx * 8, True,
                                         cy * cx).reshape(size))
        q1 = _qdz(coef[1] * inv_s[1] * sc_s, thr_yb)
        dqy = _adjust_bias_y(q1) * t_s[1] / sc_s
        q0 = _qdz((coef[0] - fx_t * dqy) * inv_s[0] * (sc_s * x_mul),
                  thr_cb)
        q2 = _qdz((coef[2] - fb_t * dqy) * inv_s[2] * (sc_s * b_mul),
                  thr_cb)
        del coef, dqy
        qn = torch.stack([q0, q1, q2], dim=0).int()
        del q0, q1, q2
        llf_zero = np.zeros((ly * 8, lx * 8), bool)
        llf_zero[:ly, :lx] = True
        qn = qn * torch.from_numpy((~llf_zero).ravel().astype(
            np.int32)).to(dev)
        big_q[f"{cy}x{cx}"] = qn

    # ---- DC quantization with CfL ----
    qdc1 = torch.round(dc_float[1] / mul_dc[1])
    y_dec = qdc1 * mul_dc[1]
    qdc0 = torch.round((dc_float[0] - cfl_fac[0] * y_dec) / mul_dc[0])
    qdc2 = torch.round((dc_float[2] - cfl_fac[2] * y_dec) / mul_dc[2])
    qdc = torch.stack([qdc0, qdc1, qdc2]).int()

    return dict(strategies=strategies, raw_quant=raw_quant, qall=qall,
                big_q=big_q, dc_float=dc_float, qdc=qdc,
                ytox_map=ytox_map, ytob_map=ytob_map)


def stage_b(effort: int, quant_max: int, base_cx: float, base_cb: float,
            color_scale: float, with_fixed: bool = False,
            big_factor: float = _MERGE_FACTOR,
            merge16: float = _MERGE_FACTOR):
    """``encode_stage_b`` with its static arguments bound: called as
    ``fn(xyb, raw_quant, inv_gs, x_mul, b_mul, mul_dc, cfl_fac, tables)``,
    plus ``fixed_strategies`` when ``with_fixed`` (the reference's
    ``stage_b_jitted``, without a compile)."""
    fn = functools.partial(
        encode_stage_b, effort=effort, quant_max=quant_max,
        base_cx=base_cx, base_cb=base_cb, color_scale=color_scale,
        big_factor=big_factor, merge16=merge16)
    if not with_fixed:
        return fn

    def fixed(xyb, raw_quant, inv_gs, x_mul, b_mul, mul_dc, cfl_fac,
              tables, fixed_strategies):
        return fn(xyb, raw_quant, inv_gs, x_mul, b_mul, mul_dc, cfl_fac,
                  tables, fixed_strategies=fixed_strategies)
    return fixed


def make_tables(matrices) -> dict:
    """Dequant-table bundle for stage B, numpy float32 (cached on the
    matrices)."""
    cached = getattr(matrices, "_device_enc_tables", None)
    if cached is not None:
        return cached
    t8 = matrices.table(acs.DCT8X8).reshape(3, 64).astype(np.float32)
    tables = {
        "t8": t8, "i8": (1.0 / t8).astype(np.float32),
        "inv8y": (1.0 / matrices.table(acs.DCT8X8))[1].ravel()
        .astype(np.float32),
        "inv16y": (1.0 / matrices.table(acs.DCT16X16))[1]
        .astype(np.float32),
        "inv32y": (1.0 / matrices.table(acs.DCT32X32))[1]
        .astype(np.float32),
        "inv64y": (1.0 / matrices.table(acs.DCT64X64))[1]
        .astype(np.float32),
        "invwy": (1.0 / matrices.table(acs.DCT8X16))[1]
        .astype(np.float32),
        "invty": (1.0 / matrices.table(acs.DCT16X8))[1]
        .astype(np.float32),
    }
    for (cy, cx), sid in BIG_CLASSES.items():
        tables[f"t{cy}x{cx}"] = matrices.table(sid).reshape(
            3, cy * cx * 64).astype(np.float32)
    matrices._device_enc_tables = tables
    return tables


def tables_to_torch(tables: dict, device) -> dict:
    """A ``make_tables`` bundle (this module's or the JAX package's: a
    dict of numpy arrays) -> the same keys as float32 tensors on
    ``device``. Cached per device and table content, so the constant
    tables cross to the card once."""
    dev = torch.device(device)
    h = hashlib.sha1()
    for k in sorted(tables):
        a = np.ascontiguousarray(tables[k], np.float32)
        h.update(k.encode() + str(a.shape).encode() + a.tobytes())

    def make():
        return tuple(torch.from_numpy(np.ascontiguousarray(
            tables[k], np.float32)) for k in sorted(tables))
    vals = _const(dev, ("enc_tables", h.hexdigest()), make)
    return dict(zip(sorted(tables), vals))


def to_host(tensors: dict) -> dict:
    """A (nested) dict of tensors -> numpy arrays, through one
    synchronisation: on a card every copy is queued asynchronously into
    pinned host memory and the stream is waited on once."""
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v
    walk(tensors, ())
    cuda = [t.device for t in flat.values() if t.device.type == "cuda"]
    host = {k: t.to("cpu", non_blocking=True) for k, t in flat.items()}
    if cuda:
        torch.cuda.current_stream(cuda[0]).synchronize()
    out: dict = {}
    for k, t in host.items():
        d = out
        for p in k[:-1]:
            d = d.setdefault(p, {})
        d[k[-1]] = t.numpy()
    return out
