"""Frame encoder: VarDCT (fast path) and modular frames.

Reference: lib/jxl/enc_frame.cc (EncodeFrame / ComputeEncodingData),
enc_group.cc (ComputeCoefficients). This is the effort-1-class path:
8x8-only strategies, uniform quant field, CfL from a global fit,
default tables; the heuristics ladder (adaptive quant, ACS search,
butteraugli iteration) comes on top of this skeleton.

Copy of libjxl_tpu/frame/encode_frame.py with these changes, all in the
device route (reference line numbers):
- ``compute_vardct_encoding_device`` (:268-418) runs the stages of the
  port's ``ops/encode.py`` on a torch ``device`` (new argument): the
  planes cross once through pinned memory (``device._stage``) in place
  of ``jax.device_put`` (:294, :303, :308); ``encode_stage_pre``,
  ``initial_quant_field`` and ``stage_b`` with ``tables_to_torch``
  replace the jitted functions (:297, :310, :336-345); the outputs come
  back through one synchronising copy (``to_host``, :346-353), which
  also brings back the gaborish-inverted planes for the host sub-8x8
  pass (:371); without the fused pre-stage the host planes serve it;
- ``encode_vardct_frame(device=)`` (:768, :911, :915-921) takes None
  for the host route or a torch device, in place of False/True.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjxl_tpu_torch.base.frame_dimensions import FrameDimensions
from libjxl_tpu_torch.base.rect import Rect
from libjxl_tpu_torch.bitstream.bit_io import BitWriter
from libjxl_tpu_torch.bitstream.fields import bundle_write
from libjxl_tpu_torch.bitstream.toc import write_toc
from libjxl_tpu_torch.frame.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags, FrameHeader,
)
from libjxl_tpu_torch.frame.headers import CodecMetadata
from libjxl_tpu_torch.frame.modular_frame import ModularFrameEncoder
from libjxl_tpu_torch.modular.image import ModularImage
from libjxl_tpu_torch.modular.predict import P_GRADIENT
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
from libjxl_tpu_torch.vardct.coeff_order import write_used_orders
from libjxl_tpu_torch.vardct.group import CoeffBlock, tokenize_group_coeffs
from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices
from libjxl_tpu_torch.vardct.quantizer import Quantizer
from libjxl_tpu_torch.vardct.reconstruct import (
    b_qm_multiplier, transform_from_pixels, x_qm_multiplier,
)


def initial_quant_dc(distance: float) -> float:
    """enc_adaptive_quantization.cc InitialQuantDC:
    kDcQuant / max(distance, kMinButteraugli...)-ish."""
    k_dc_quant = 1.095924047623553
    k_ac_quant = 0.7381485255235064
    butteraugli_target_dc = max(0.5 * distance,
                                min(1.0, distance))
    return k_dc_quant / butteraugli_target_dc


def initial_quant_ac(distance: float) -> float:
    k_ac_quant = 0.7381485255235064
    return k_ac_quant / distance


@dataclasses.dataclass
class VarDCTEncodeState:
    frame_dim: FrameDimensions
    quantizer: Quantizer
    raw_quant: np.ndarray
    strategies: np.ndarray
    qdc: np.ndarray
    blocks_per_group: dict
    ytox_map: np.ndarray
    ytob_map: np.ndarray




def _deadzone_thresholds(rows: int, cols: int, chroma: bool,
                         covered: int) -> np.ndarray:
    """Per-coefficient dead-zone thresholds (enc_group.cc:336-360,503):
    quadrant values {0.56, 0.62, 0.62, 0.62} for Y and
    {0.58, 0.62, 0.62, 0.62} for X/B, the chroma set lowered by
    0.00744 * covered_blocks (min 0.5) on multi-block transforms."""
    thr = np.array([0.58, 0.62, 0.62, 0.62] if chroma
                   else [0.56, 0.62, 0.62, 0.62], np.float32)
    if chroma and covered >= 4:
        thr = np.maximum(thr - 0.00744 * covered, 0.5)
    yy = (np.arange(rows) >= rows // 2).astype(np.int64) * 2
    xx = (np.arange(cols) >= cols // 2).astype(np.int64)
    return thr[yy[:, None] + xx[None, :]]


def _quantize_deadzone(val: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """QuantizeBlockAC: values under the dead-zone threshold snap to 0
    (enc_group.cc:97 nzero_mask)."""
    return np.where(np.abs(val) >= thr, np.round(val), 0.0)


def _adjust_quant_blocks(coeffs, flat_inv, raw_quant, inv_gs,
                         x_mul, b_mul, dct8_mask, quant_max):
    """AdjustQuantBlockAC (enc_group.cc:104-330), vectorized over the
    batched 8x8 blocks: trial-quantization statistics drive per-block
    quant tweaks (dead-zone error bound, high-frequency pattern boost,
    flat-block blockiness fix, activity-based reduction).

    Returns (adjusted raw_quant (BY,BX) int32,
             per-block Y thresholds (BY,BX, 4) float32)."""
    nat = _adjust_quant_native(coeffs, flat_inv, raw_quant, inv_gs,
                               x_mul, b_mul, dct8_mask, quant_max)
    if nat is not None:
        return nat
    pos = np.arange(64)
    row, col = pos // 8, pos % 8
    quad = ((row >= 4).astype(np.int64) * 2 + (col >= 4))
    notllf = pos != 0
    hf_region = (((row >= 7) & (col >= 7))
                 | (((row == 7) | (col == 7)) & (row >= 4) & (col >= 4)))
    quad_masks = [(quad == i) & notllf for i in range(4)]

    quant0 = raw_quant.astype(np.float64)
    scale0 = quant0 / inv_gs
    qmul = {1: 1.0, 0: x_mul, 2: b_mul}
    hf_mul = {0: 70.0, 1: 30.0, 2: 60.0}
    trial_thr = np.array([0.58, 0.64, 0.64, 0.64])

    quant_final = np.zeros_like(quant0)  # max over channel results
    thr_y = np.broadcast_to(trial_thr, raw_quant.shape + (4,)).copy()
    for c in (1, 0, 2):
        thr = np.broadcast_to(trial_thr, raw_quant.shape + (4,)).copy()
        val = coeffs[c] * flat_inv[c] * (scale0 * qmul[c])[..., None]
        v = _quantize_deadzone(val, trial_thr[quad])
        av = np.abs(v) * notllf
        err = np.abs(val - v) * notllf
        hfnz = np.stack([np.where(m, av, 0).sum(-1)
                         for m in quad_masks], -1)      # (BY,BX,4)
        sum_vals = av.sum(-1)
        sum_hf = np.where((v != 0) & hf_region & notllf,
                          np.abs(val), 0).sum(-1)
        quant = quant0.copy()
        if c == 1:
            hfme = np.stack(
                [np.where(m & (v == 0), err, 0).max(-1)
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
            thr[..., 3] = np.where(
                cond3, 0.9999 * hfme[..., 3] * ratio, thr[..., 3])
            t12 = 0.9999 * np.maximum(hfme[..., 1], hfme[..., 2]) * ratio
            thr[..., 1] = np.where(cond12, t12, thr[..., 1])
            thr[..., 2] = np.where(cond12, t12, thr[..., 2])
            thr[..., 0] = np.where(
                cond0, 0.9999 * hfme[..., 0] * ratio, thr[..., 0])
            quant = new_quant
        # High-frequency pattern boost (enc_group.cc:208-218).
        allnz = hfnz.sum(-1) + 1.0
        boost = hf_mul[c] * sum_hf
        quant = np.where(boost >= allnz,
                         np.minimum(quant + np.trunc(boost / allnz),
                                    quant_max - 1), quant)
        # Flat-DCT8 blockiness fix (cc:219-228).
        quant = np.where(hfnz.sum(-1) < 11,
                         np.minimum(quant + 1, quant_max - 1), quant)
        # Activity-based reduction (cc:306-327).
        min_hf = hfnz.min(-1)
        activity = np.where(min_hf < 15.0,
                            np.trunc(min_hf), 15.0)
        if c == 1:
            thr[..., 1:] += 0.01 * activity[..., None]
            thr_y = thr
        qp = quant - activity
        limit = np.maximum(4, np.trunc(quant / 2))
        qp = np.maximum(qp, limit)
        quant_final = np.maximum(quant_final, qp)

    new_rq = np.where(dct8_mask, quant_final,
                      raw_quant).astype(np.int32)
    return new_rq, thr_y.astype(np.float32)


def _adjust_quant_native(coeffs, flat_inv, raw_quant, inv_gs, x_mul,
                         b_mul, dct8_mask, quant_max):
    """One C call over all blocks (jxl_native.cpp adjust_quant_blocks);
    None when the native module is unavailable. Matches the numpy chain
    up to sequential-vs-pairwise sum rounding (encoder freedom)."""
    import ctypes as C
    try:
        from libjxl_tpu_torch.native.bindings import get_lib
        lib = get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    if not hasattr(lib, "_adjq_bound"):
        D = C.POINTER(C.c_double)
        lib.adjust_quant_blocks.restype = None
        lib.adjust_quant_blocks.argtypes = [
            D, D, C.POINTER(C.c_int32), C.c_double, C.c_double,
            C.c_double, C.POINTER(C.c_uint8), C.c_int32, C.c_int64,
            C.POINTER(C.c_int32), C.POINTER(C.c_float)]
        lib._adjq_bound = True
    BY, BX = raw_quant.shape
    N = BY * BX
    cf = np.ascontiguousarray(coeffs, np.float64).reshape(3, N, 64)
    fi = np.ascontiguousarray(flat_inv, np.float64)
    rq = np.ascontiguousarray(raw_quant, np.int32)
    mk = np.ascontiguousarray(dct8_mask, np.uint8)
    out_rq = np.empty(N, np.int32)
    thr_y = np.empty((N, 4), np.float32)
    D = C.POINTER(C.c_double)
    lib.adjust_quant_blocks(
        cf.ctypes.data_as(D), fi.ctypes.data_as(D),
        rq.ctypes.data_as(C.POINTER(C.c_int32)), float(inv_gs),
        float(x_mul), float(b_mul),
        mk.ctypes.data_as(C.POINTER(C.c_uint8)), int(quant_max), N,
        out_rq.ctypes.data_as(C.POINTER(C.c_int32)),
        thr_y.ctypes.data_as(C.POINTER(C.c_float)))
    return out_rq.reshape(BY, BX), thr_y.reshape(BY, BX, 4)


def _requantize_sub8x8(flips, planes, matrices, quantizer, raw_quant,
                       ytox_map, ytob_map, cmap, x_mul, b_mul, mul_dc,
                       cfl_fac, qdc, big_q) -> None:
    """Transform + quantize 1x1-covered sub-8x8 blocks host-side for
    the device encoder flow (enc_group.cc math on DCT4x4/2x2/IDENTITY/
    AFV blocks), updating big_q and the quantized DC in place."""
    from libjxl_tpu_torch.vardct.dct import dc_from_llf
    from libjxl_tpu_torch.vardct.reconstruct import transform_from_pixels
    by_bias = 1.0 - 0.07005449891748593
    for (by, bx, s) in flips:
        region = planes[:, by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        cb = np.stack([np.asarray(transform_from_pixels(
            s, region[c].astype(np.float64))).reshape(64)
            for c in range(3)])                   # (3, 64)
        t_s = matrices.table(s).reshape(3, 64)
        inv_s = 1.0 / t_s
        flat = cb
        sc = float(raw_quant[by, bx]) / quantizer.inv_global_scale
        ytox_v = (cmap.base_correlation_x
                  + ytox_map[by // 8, bx // 8] * cmap.color_scale)
        ytob_v = (cmap.base_correlation_b
                  + ytob_map[by // 8, bx // 8] * cmap.color_scale)
        thr_yb = _deadzone_thresholds(8, 8, False, 1).reshape(64)
        thr_cb = _deadzone_thresholds(8, 8, True, 1).reshape(64)
        q1 = _quantize_deadzone(flat[1] * inv_s[1] * sc, thr_yb)
        with np.errstate(divide="ignore", invalid="ignore"):
            gen = q1 - 0.145 / np.where(q1 == 0, 1, q1)
        dqy = np.where(q1 == 0, 0.0,
                       np.where(q1 == 1, by_bias,
                                np.where(q1 == -1, -by_bias, gen))) \
            * t_s[1] / sc
        q0 = _quantize_deadzone((flat[0] - ytox_v * dqy) * inv_s[0]
                                * (sc * x_mul), thr_cb)
        q2 = _quantize_deadzone((flat[2] - ytob_v * dqy) * inv_s[2]
                                * (sc * b_mul), thr_cb)
        qn = np.stack([q0, q1, q2], axis=0).astype(np.int32)
        qn[:, 0] = 0                               # LLF slot
        big_q[(by, bx)] = qn
        # DC comes from the sub-transform LLF; re-quantize with CfL.
        dc = np.array([float(dc_from_llf(
            cb[c].reshape(8, 8)[:1, :1], 8, 8)) for c in range(3)])
        q_y = round(dc[1] / mul_dc[1])
        y_dec = q_y * mul_dc[1]
        qdc[1, by, bx] = q_y
        qdc[0, by, bx] = round((dc[0] - cfl_fac[0] * y_dec) / mul_dc[0])
        qdc[2, by, bx] = round((dc[2] - cfl_fac[2] * y_dec) / mul_dc[2])


def compute_vardct_encoding_device(planes, fd, fh, distance,
                                   qf_adjust=None, quantizer=None,
                                   effort=7, aq_planes=None,
                                   aq_distance=None,
                                   pre_gaborish_gab=None, device=None):
    """Device variant of compute_vardct_encoding: adaptive quant, ACS
    search, forward DCTs, CfL fit and quantization run as two PyTorch
    stages on the torch ``device`` (ops/encode.py); the host keeps the
    global-scale selection and assembles the per-group block lists for
    the writer.

    float32 throughout (the host path mixes float64), so bitstreams can
    differ from the host encoder in occasional +-1 quantization
    decisions — validated by size/metric parity, not bit-equality."""
    from libjxl_tpu_torch.device import _stage, resolve_device
    from libjxl_tpu_torch.frame.adaptive_quant import initial_quant_dc as aq_dc
    from libjxl_tpu_torch.ops import encode as ep

    dev = resolve_device(device)
    BY, BX = fd.ysize_blocks, fd.xsize_blocks
    if aq_planes is None:
        aq_planes = planes
    if aq_distance is None:
        aq_distance = distance
    planes_host = None
    if pre_gaborish_gab is not None:
        # `planes` are PRE-gaborish: one upload, qf + gaborish inverse
        # fused on device (encode_stage_pre).
        pre_dev = _stage(planes, dev, np.float32)
        # The flat e<=2 field uses the frame distance, not the
        # AQ-modulated one (matches the host branch below).
        qf_dev, planes_dev = ep.encode_stage_pre(
            pre_dev,
            float(distance if effort <= 2 else aq_distance),
            bool(pre_gaborish_gab), flat_qf=effort <= 2)
        qf = ep.to_host({"qf": qf_dev})["qf"]
    else:
        planes_host = np.ascontiguousarray(planes, np.float32)
        planes_dev = _stage(planes_host, dev)
        if effort <= 2:
            qf = np.full((BY, BX), 0.52 / max(distance, 0.1), np.float32)
        else:
            aq_dev = planes_dev if aq_planes is planes else _stage(
                aq_planes, dev, np.float32)
            qf = ep.to_host({"qf": ep.initial_quant_field(
                aq_distance, aq_dev)})["qf"]
    if qf_adjust is not None:
        qf = qf * qf_adjust[:qf.shape[0], :qf.shape[1]]
    if quantizer is None:
        matrices = DequantMatrices()
        quantizer = Quantizer(matrices)
        raw_quant = quantizer.set_quant_field(aq_dc(distance), qf)
    else:
        matrices = quantizer.dequant
        from libjxl_tpu_torch.vardct.quantizer import GLOBAL_SCALE_DENOM, QUANT_MAX
        sc0 = quantizer.global_scale / GLOBAL_SCALE_DENOM
        raw_quant = np.clip(np.round(np.asarray(qf, np.float32) / sc0),
                            1, QUANT_MAX).astype(np.int32)

    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()
    x_mul = x_qm_multiplier(fh.x_qm_scale)
    b_mul = b_qm_multiplier(fh.b_qm_scale)
    mul_dc = quantizer.mul_dc()
    cfl_fac = cmap.dc_factors()

    from libjxl_tpu_torch.vardct.quantizer import QUANT_MAX
    from libjxl_tpu_torch.frame.acs_select import (_big_merge_factor,
                                                   _merge_factor)
    eff = min(effort, 7)
    fn = ep.stage_b(eff, QUANT_MAX, cmap.base_correlation_x,
                    cmap.base_correlation_b, cmap.color_scale,
                    big_factor=float(_big_merge_factor(distance)),
                    merge16=float(_merge_factor(distance)[0]))
    tables = ep.tables_to_torch(ep.make_tables(matrices), dev)
    scalars = _stage(np.array([quantizer.inv_global_scale, x_mul, b_mul],
                              np.float32), dev)
    res = fn(planes_dev, _stage(raw_quant, dev, np.int32),
             scalars[0], scalars[1], scalars[2],
             _stage(np.asarray(mul_dc, np.float32), dev),
             _stage(np.asarray(cfl_fac, np.float32), dev), tables)
    # One synchronising copy back: the stage outputs and, for the host
    # sub-8x8 pass, the gaborish-inverted planes made on the device.
    fetch = {k: res[k] for k in ("strategies", "raw_quant", "qall", "qdc",
                                 "ytox_map", "ytob_map", "big_q")}
    if effort >= 5 and planes_host is None:
        fetch["planes"] = planes_dev
    host = ep.to_host(fetch)
    del res, fetch, planes_dev
    strategies = host["strategies"]
    raw_quant = host["raw_quant"]
    qall = host["qall"]
    qdc = host["qdc"]
    ytox_map = host["ytox_map"]
    ytob_map = host["ytob_map"]
    big_q_dense = {tuple(int(t) for t in k.split("x")): v
                   for k, v in host.get("big_q", {}).items()}

    # Assemble per-group block lists for the section writer.
    big_q = {}
    for (cy, cx), qn in big_q_dense.items():
        sid = ep.BIG_CLASSES[(cy, cx)]
        bys, bxs = np.nonzero(strategies == sid)
        if len(bys) == 0:
            continue
        sel = qn[:, bys // cy, bxs // cx]        # (3, n, size)
        for i, (by0, bx0) in enumerate(zip(bys, bxs)):
            big_q[(int(by0), int(bx0))] = sel[:, i]
    # Sub-8x8 transform choice (host numpy, same function as the host
    # path; see select_sub8x8). Flipped blocks are re-transformed and
    # re-quantized host-side — they're a small fraction of the frame
    # and their math is per-block.
    if effort >= 5:
        from libjxl_tpu_torch.frame.acs_select import masking_1x1, select_sub8x8
        if planes_host is None:
            planes_host = host["planes"]
        strategies = select_sub8x8(
            planes_host, np.array(strategies), qf, masking_1x1(aq_planes),
            distance, effort, matrices,
            cmap.base_correlation_x, cmap.base_correlation_b)
        flips = [(int(by), int(bx), int(strategies[by, bx]))
                 for by, bx in zip(*np.nonzero(
                     (strategies > 0) & (raw_quant > 0)))
                 if (int(by), int(bx)) not in big_q
                 and acs.covered_blocks(int(strategies[by, bx]))
                 == (1, 1)]
        if flips:
            qdc = np.array(qdc)      # device output is read-only
            _requantize_sub8x8(
                flips, planes_host, matrices, quantizer, raw_quant,
                ytox_map, ytob_map, cmap, x_mul, b_mul, mul_dc,
                cfl_fac, qdc, big_q)

    blocks_per_group: dict = {}
    for g in range(fd.num_groups):
        brect = fd.block_group_rect(g)
        blist = []
        for by in range(brect.ysize):
            for bx in range(brect.xsize):
                aby, abx = brect.y0 + by, brect.x0 + bx
                s = int(strategies[aby, abx])
                if s < 0:
                    continue
                if s == acs.DCT8X8:
                    blist.append(CoeffBlock(bx, by, s,
                                            qall[:, aby, abx]))
                else:
                    blist.append(CoeffBlock(bx, by, s, big_q[(aby, abx)]))
        blocks_per_group[g] = blist

    # Quantization-aware block context clustering
    # (FindBestBlockEntropyModel, enc_heuristics.cc:1220: chosen at
    # cheetah and slower once strategies + quant field are final).
    if effort >= 4:
        from libjxl_tpu_torch.vardct.ac_context import (
            find_best_block_entropy_model)
        ctx_map = find_best_block_entropy_model(distance, raw_quant,
                                                strategies)
    return dict(matrices=matrices, quantizer=quantizer, ctx_map=ctx_map,
                cmap=cmap, qdc=qdc, raw_quant=raw_quant,
                strategies=strategies, blocks_per_group=blocks_per_group,
                ytox_map=ytox_map, ytob_map=ytob_map, x_mul=x_mul,
                b_mul=b_mul, mul_dc=mul_dc, cfl_fac=cfl_fac)


def compute_vardct_encoding(planes, fd, fh, distance,
                            qf_adjust=None, external_dc=None,
                            quantizer=None, effort=7,
                            aq_planes=None, aq_distance=None):
    """The per-region VarDCT encoding computation: adaptive quant,
    ACS selection, forward transforms, CfL fit, coefficient
    quantization (enc_frame.cc ComputeEncodingData's VarDCT half).
    Position-independent, so the streaming encoder runs it per
    2048x2048 DC-group chunk (enc_frame.cc:2047).

    effort maps to the reference's speed tiers
    (enc_params.h SpeedTier, enc_ac_strategy.cc:1010 gating):
      1-2 lightning/thunder: flat quant field, 8x8 only, no CfL fit
      3   falcon:            adaptive quant, 8x8 only
      4   cheetah:           + 16x16 transforms
      5   hare:              + 32x32
      6   wombat:            + rectangular transforms, EPF sharpness
      7+  squirrel..:        + 64x64 (and, at 8+, the butteraugli
                             quant-field iteration in the caller)."""
    from libjxl_tpu_torch.frame.adaptive_quant import (
        initial_quant_dc as aq_dc, initial_quant_field as aq_field)
    if aq_planes is None:
        aq_planes = planes
    if aq_distance is None:
        aq_distance = distance
    if effort <= 2:
        # Flat quant field for the fastest tiers (enc_heuristics.cc:1107
        # uses 0.79/distance; rescaled to this encoder's AQ-field
        # calibration, whose mean at a given distance is ~0.52/d).
        qf = np.full((fd.ysize_blocks, fd.xsize_blocks),
                     0.52 / max(distance, 0.1), np.float32)
    else:
        qf = aq_field(aq_distance, aq_planes)
    if qf_adjust is not None:
        # Per-block multiplier from the butteraugli-guided outer loop
        # (enc_heuristics FindBestQuantization analogue).
        qf = qf * qf_adjust[:qf.shape[0], :qf.shape[1]]
    if quantizer is None:
        matrices = DequantMatrices()
        quantizer = Quantizer(matrices)
        raw_quant = quantizer.set_quant_field(aq_dc(distance), qf)
    else:
        # Streaming mode: a fixed, shared quantizer — only the raw
        # per-block field varies per chunk (enc_frame.cc streaming).
        matrices = quantizer.dequant
        from libjxl_tpu_torch.vardct.quantizer import GLOBAL_SCALE_DENOM, QUANT_MAX
        sc0 = quantizer.global_scale / GLOBAL_SCALE_DENOM
        raw_quant = np.clip(np.round(np.asarray(qf, np.float32) / sc0),
                            1, QUANT_MAX).astype(np.int32)

    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()
    x_mul = x_qm_multiplier(fh.x_qm_scale)
    b_mul = b_qm_multiplier(fh.b_qm_scale)

    # ---- AC strategy selection ----
    if external_dc is not None:
        # kUseDcFrame carries plain block means: large transforms would
        # need dc_from_llf-domain values, so stick to 8x8 blocks.
        strategies = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                              np.int32)
    elif effort <= 3:
        strategies = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                              np.int32)
    else:
        from libjxl_tpu_torch.frame.acs_select import select_strategies
        strategies = select_strategies(
            planes, raw_quant, quantizer,
            enable_32=effort >= 5, enable_rect=effort >= 6,
            enable_64=effort >= 7, distance=distance)
        if effort >= 5:
            # Within-8x8 transforms (IDENTITY/DCT2x2/4x4/4x8/AFV) where
            # the reference cost model beats plain DCT8
            # (enc_ac_strategy.cc FindBest8x8Transform).
            from libjxl_tpu_torch.frame.acs_select import (masking_1x1,
                                                     select_sub8x8)
            strategies = select_sub8x8(
                planes, strategies, qf, masking_1x1(aq_planes),
                distance, effort, matrices,
                cmap.base_correlation_x, cmap.base_correlation_b)
    # AdjustQuantField: uniform qf within a multi-block strategy (max).
    for by0, bx0 in zip(*np.nonzero(strategies > 0)):
        s = int(strategies[by0, bx0])
        cx, cy = acs.covered_blocks(s)
        raw_quant[by0:by0 + cy, bx0:bx0 + cx] = \
            raw_quant[by0:by0 + cy, bx0:bx0 + cx].max()

    # ---- Forward DCT (batched 8x8 plus per-strategy large blocks) ----
    table = matrices.table(acs.DCT8X8)  # (3, 8, 8)
    inv_table = 1.0 / table

    # DC path
    mul_dc = quantizer.mul_dc()  # per-channel dequant step
    cfl_fac = cmap.dc_factors()

    dc_float = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks), np.float32)
    coeffs = np.zeros(
        (3, fd.ysize_blocks, fd.xsize_blocks, 64), np.float32)
    # Batched 8x8 DCT via matrix multiplication.
    from libjxl_tpu_torch.vardct.dct import dct_matrix, dc_from_llf
    m8 = dct_matrix(8)
    for c in range(3):
        blocks = planes[c].reshape(fd.ysize_blocks, 8, fd.xsize_blocks, 8)
        blocks = blocks.transpose(0, 2, 1, 3)  # (by, bx, 8, 8)
        # Store transposed (hfreq, vfreq): square-DCT storage convention
        # (dct-inl.h ComputeScaledDCT, ROWS >= COLS branch).
        coef = np.einsum("ui,abij,wj->abwu", m8, blocks, m8,
                         optimize=True)
        coeffs[c] = coef.reshape(fd.ysize_blocks, fd.xsize_blocks, 64)
        dc_float[c] = coef[:, :, 0, 0]

    # Large/rect blocks: batched per-strategy transforms + DC-from-LLF
    # (one einsum per distinct strategy instead of a per-block loop).
    from libjxl_tpu_torch.vardct.dct import idct_matrix, resample_scales
    from libjxl_tpu_torch.vardct.reconstruct import transform_from_pixels
    big_blocks = {}
    ys_all, xs_all = np.nonzero(strategies > 0)
    strat_vals = strategies[ys_all, xs_all]
    _PURE_DCT = {st for st in range(acs.NUM_STRATEGIES)
                 if acs.COVERED_X[st] * acs.COVERED_Y[st] > 1}
    for s in (int(v) for v in np.unique(strat_vals)):
        sel = strat_vals == s
        bys, bxs = ys_all[sel], xs_all[sel]
        cx, cy = acs.covered_blocks(s)
        ly, lx = acs.coefficient_layout(cy, cx)
        H8, W8 = cy * 8, cx * 8
        if s not in _PURE_DCT:
            for by0, bx0 in zip(bys, bxs):
                region = planes[:, by0 * 8:by0 * 8 + H8,
                                bx0 * 8:bx0 * 8 + W8]
                cblock = np.stack([
                    transform_from_pixels(s, region[c].astype(np.float64))
                    for c in range(3)]).astype(np.float32)
                big_blocks[(int(by0), int(bx0))] = cblock
                for c in range(3):
                    grid = cblock[c].reshape(ly * 8, lx * 8)
                    llf = grid[:ly, :lx]
                    if cy >= cx:
                        llf = llf.T
                    dc_float[c, by0:by0 + cy, bx0:bx0 + cx] = \
                        dc_from_llf(llf, H8, W8)
            continue
        n = len(bys)
        regions = np.empty((n, 3, H8, W8), np.float64)
        for i in range(n):
            regions[i] = planes[:, bys[i] * 8:bys[i] * 8 + H8,
                                bxs[i] * 8:bxs[i] * 8 + W8]
        mr, mc = dct_matrix(H8), dct_matrix(W8)
        coef = np.einsum("ui,ncij,wj->ncuw", mr, regions, mc,
                         optimize=True)
        if cy >= cx:
            coef = coef.transpose(0, 1, 3, 2)
        cflat = np.ascontiguousarray(coef.reshape(n, 3, -1), np.float32)
        # Batched DC-from-LLF.
        llf = coef[:, :, :ly, :lx]
        if cy >= cx:
            llf = llf.transpose(0, 1, 3, 2)
        sy = resample_scales(cy, H8)
        sx = resample_scales(cx, W8)
        ir, ic = idct_matrix(cy), idct_matrix(cx)
        dc_blk = np.einsum("yu,ncuv,xv->ncyx", ir,
                           llf / (sy[:, None] * sx[None, :]), ic,
                           optimize=True)
        for i in range(n):
            by0, bx0 = int(bys[i]), int(bxs[i])
            big_blocks[(by0, bx0)] = cflat[i]
            dc_float[:, by0:by0 + cy, bx0:bx0 + cx] = dc_blk[i]

    if external_dc is not None:
        # DC comes from the saved DC frame; overwrite the source DC so
        # LLF insertion matches what the decoder will reconstruct.
        h_dc = min(external_dc.shape[1], fd.ysize_blocks)
        w_dc = min(external_dc.shape[2], fd.xsize_blocks)
        dc_float[:, :h_dc, :w_dc] = external_dc[:, :h_dc, :w_dc]
    # Quantize DC with CfL (Y first, then X/B against dequantized Y).
    qdc = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks), np.int32)
    qdc[1] = np.round(dc_float[1] / mul_dc[1]).astype(np.int32)
    y_dec = qdc[1] * mul_dc[1]
    qdc[0] = np.round((dc_float[0] - cfl_fac[0] * y_dec)
                      / mul_dc[0]).astype(np.int32)
    qdc[2] = np.round((dc_float[2] - cfl_fac[2] * y_dec)
                      / mul_dc[2]).astype(np.int32)

    # Fit per-tile chroma-from-luma factors (fast least squares).
    flat_table = table.reshape(3, 64)
    flat_inv = inv_table.reshape(3, 64)
    if effort <= 2:
        ty = (fd.ysize_blocks + 7) // 8
        tx = (fd.xsize_blocks + 7) // 8
        ytox_map = np.zeros((ty, tx), np.int32)
        ytob_map = np.zeros((ty, tx), np.int32)
    else:
        from libjxl_tpu_torch.frame.cfl_fit import fit_cfl_maps
        ytox_map, ytob_map = fit_cfl_maps(coeffs, flat_inv, raw_quant,
                                          quantizer.global_scale_float)

    # Quantize AC, vectorized over all blocks. Y first; X/B have the
    # (quantize-dequantized) Y scaled by the CfL factors subtracted
    # (enc_group.cc ComputeCoefficients).
    rq = raw_quant.astype(np.float32)
    scale = rq / quantizer.inv_global_scale  # (BY,BX)
    tile_y = np.arange(fd.ysize_blocks) // 8
    tile_x = np.arange(fd.xsize_blocks) // 8
    ytox_b = (cmap.base_correlation_x
              + ytox_map[np.ix_(tile_y, tile_x)] * cmap.color_scale)
    ytob_b = (cmap.base_correlation_b
              + ytob_map[np.ix_(tile_y, tile_x)] * cmap.color_scale)
    thr_c8 = _deadzone_thresholds(8, 8, True, 1).reshape(64)
    if effort >= 5:
        # Hare-and-slower: per-block quant adjustment from trial-
        # quantization stats (enc_group.cc QuantizeRoundtripYBlockAC's
        # AdjustQuantBlockAC loop over {Y, X, B}).
        from libjxl_tpu_torch.vardct.quantizer import QUANT_MAX
        raw_quant, thr_y_quad = _adjust_quant_blocks(
            coeffs, flat_inv, raw_quant, quantizer.inv_global_scale,
            x_mul, b_mul, strategies == acs.DCT8X8, QUANT_MAX)
        rq = raw_quant.astype(np.float32)
        scale = rq / quantizer.inv_global_scale
        pos64 = np.arange(64)
        quad64 = ((pos64 // 8 >= 4).astype(np.int64) * 2
                  + (pos64 % 8 >= 4))
        thr_y8 = thr_y_quad[..., quad64]        # (BY,BX,64)
    else:
        thr_y8 = _deadzone_thresholds(8, 8, False, 1).reshape(64)
    sc = scale[..., None]
    qy = _quantize_deadzone(coeffs[1] * flat_inv[1] * sc,
                            thr_y8).astype(np.int32)
    # AdjustQuantBias for the y channel (bias index 1).
    xq = qy.astype(np.float32)
    by_bias = 1.0 - 0.07005449891748593
    with np.errstate(divide="ignore", invalid="ignore"):
        gen = xq - 0.145 / np.where(xq == 0, 1, xq)
    biased_y = np.where(xq == 0, 0.0,
                        np.where(xq == 1, by_bias,
                                 np.where(xq == -1, -by_bias, gen)))
    dq_y = biased_y * flat_table[1] / sc
    # X/B coefficients are stored scaled UP by the qm multiplier; the
    # decoder divides it back out (enc_cache.cc:78, dec_cache.h:161).
    qx = _quantize_deadzone((coeffs[0] - ytox_b[..., None] * dq_y)
                            * flat_inv[0] * (sc * x_mul),
                            thr_c8).astype(np.int32)
    qb = _quantize_deadzone((coeffs[2] - ytob_b[..., None] * dq_y)
                            * flat_inv[2] * (sc * b_mul),
                            thr_c8).astype(np.int32)
    qall = np.stack([qx, qy, qb], axis=0)  # (3,BY,BX,64)
    qall[..., 0] = 0  # LLF slot not coded

    # Quantize the large blocks, batched per strategy (same math as the
    # old per-block loop: per-strategy tables, CfL from the tile maps).
    big_q = {}
    by_bias2 = 1.0 - 0.07005449891748593
    for s in (int(v) for v in np.unique(strat_vals)):
        sel = strat_vals == s
        bys, bxs = ys_all[sel], xs_all[sel]
        cx, cy = acs.covered_blocks(s)
        ly, lx = acs.coefficient_layout(cy, cx)
        size = cx * cy * 64
        t_s = matrices.table(s).reshape(3, size)
        inv_s = 1.0 / t_s
        cb = np.stack([big_blocks[(int(b), int(x))]
                       for b, x in zip(bys, bxs)])      # (n, 3, size)
        sc_s = (raw_quant[bys, bxs].astype(np.float64)
                / quantizer.inv_global_scale)[:, None]
        ytox_v = (cmap.base_correlation_x
                  + ytox_map[bys // 8, bxs // 8]
                  * cmap.color_scale)[:, None]
        ytob_v = (cmap.base_correlation_b
                  + ytob_map[bys // 8, bxs // 8]
                  * cmap.color_scale)[:, None]
        thr_yb = _deadzone_thresholds(ly * 8, lx * 8, False,
                                      cx * cy).reshape(size)
        thr_cb = _deadzone_thresholds(ly * 8, lx * 8, True,
                                      cx * cy).reshape(size)
        q1 = _quantize_deadzone(cb[:, 1] * inv_s[1] * sc_s, thr_yb)
        with np.errstate(divide="ignore", invalid="ignore"):
            gen2 = q1 - 0.145 / np.where(q1 == 0, 1, q1)
        dqy = np.where(q1 == 0, 0.0,
                       np.where(q1 == 1, by_bias2,
                                np.where(q1 == -1, -by_bias2, gen2))) \
            * t_s[1] / sc_s
        q0 = _quantize_deadzone((cb[:, 0] - ytox_v * dqy) * inv_s[0]
                                * (sc_s * x_mul), thr_cb)
        q2 = _quantize_deadzone((cb[:, 2] - ytob_v * dqy) * inv_s[2]
                                * (sc_s * b_mul), thr_cb)
        qn = np.stack([q0, q1, q2], axis=1).astype(np.int32)
        qn.reshape(-1, 3, ly * 8, lx * 8)[:, :, :ly, :lx] = 0
        for i, (b, x) in enumerate(zip(bys, bxs)):
            big_q[(int(b), int(x))] = qn[i]

    blocks_per_group: dict = {}
    for g in range(fd.num_groups):
        brect = fd.block_group_rect(g)
        blist = []
        for by in range(brect.ysize):
            for bx in range(brect.xsize):
                aby, abx = brect.y0 + by, brect.x0 + bx
                s = int(strategies[aby, abx])
                if s < 0:
                    continue
                if s == acs.DCT8X8:
                    blist.append(CoeffBlock(bx, by, s,
                                            qall[:, aby, abx]))
                else:
                    blist.append(CoeffBlock(bx, by, s, big_q[(aby, abx)]))
        blocks_per_group[g] = blist

    # Quantization-aware block context clustering
    # (FindBestBlockEntropyModel, enc_heuristics.cc:1220: chosen at
    # cheetah and slower once strategies + quant field are final).
    if effort >= 4:
        from libjxl_tpu_torch.vardct.ac_context import (
            find_best_block_entropy_model)
        ctx_map = find_best_block_entropy_model(distance, raw_quant,
                                                strategies)
    return dict(matrices=matrices, quantizer=quantizer, ctx_map=ctx_map,
                cmap=cmap, qdc=qdc, raw_quant=raw_quant,
                strategies=strategies, blocks_per_group=blocks_per_group,
                ytox_map=ytox_map, ytob_map=ytob_map, x_mul=x_mul,
                b_mul=b_mul, mul_dc=mul_dc, cfl_fac=cfl_fac)


def encode_vardct_frame(xyb: np.ndarray, metadata: CodecMetadata,
                        w: BitWriter, distance: float = 1.0,
                        is_last: bool = True,
                        extra_channels: list | None = None,
                        pass_shifts: list | None = None,
                        noise: float | None = None,
                        duration: int = 0,
                        blend_mode: int | None = None,
                        blend_source: int = 0,
                        save_slot: int | None = None,
                        patches=None,
                        splines=None,
                        save_as_reference: int | None = None,
                        resampling: int = 1,
                        qf_adjust: np.ndarray | None = None,
                        is_preview: bool = False,
                        dc_frame_level: int | None = None,
                        external_dc: np.ndarray | None = None,
                        ar_sharpness: bool = False,
                        effort: int = 7,
                        aux_out=None,
                        debug_dir: str | None = None,
                        decoding_speed: int = 0,
                        group_order_center: tuple | bool | None = None,
                        already_downsampled: bool = False,
                        epf: int = -1,
                        device=None) -> None:
    """Encode (3, H, W) float XYB as a VarDCT frame.

    epf: -1 = distance-derived EPF iteration count; 0..3 forces the
    strength (JXL_ENC_FRAME_SETTING_EPF, encode.h).

    pass_shifts: per-pass coefficient shifts for progressive encoding
    (e.g. [2, 0]); the last entry must be 0. None = single pass.
    noise: synthetic film-grain strength in [0, 1] (constant LUT).
    device: None for the host route, or the torch device that runs the
    VarDCT stages (compute_vardct_encoding_device).
    Writes frame header + TOC + sections into `w` (byte-aligned)."""
    if resampling not in (1, 2, 4, 8):
        raise ValueError("resampling must be 1, 2, 4 or 8")
    if resampling != 1 and not already_downsampled:
        # Box-downsample to the coded resolution (encoder freedom;
        # cjxl --resampling).
        n = resampling
        _, fy, fx = xyb.shape
        py, px = (-fy) % n, (-fx) % n
        padded = np.pad(xyb, ((0, 0), (0, py), (0, px)), mode="edge")
        xyb = padded.reshape(3, (fy + py) // n, n, (fx + px) // n, n) \
            .mean(axis=(2, 4))
        if extra_channels:
            # Extra channels follow the frame resampling
            # (extra_channel_upsampling; ec_up must be >= upsampling).
            ds = []
            for ec in extra_channels:
                eh, ew = ec.shape
                pey, pex = (-eh) % n, (-ew) % n
                pecc = np.pad(ec, ((0, pey), (0, pex)), mode="edge")
                ds.append(np.round(
                    pecc.reshape((eh + pey) // n, n, (ew + pex) // n, n)
                    .mean(axis=(1, 3))).astype(ec.dtype))
            extra_channels = ds
    _, ysize, xsize = xyb.shape
    fh = FrameHeader(nonserialized_metadata=metadata)
    fh.nonserialized_is_preview = is_preview
    if is_preview:
        fh.is_last = False
        is_last = False
    fh.upsampling = resampling
    if resampling != 1 and extra_channels:
        fh.extra_channel_upsampling = [resampling] * len(extra_channels)
    fh.encoding = FrameEncoding.VARDCT
    fh.flags = int(FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING)
    noise_lut = None
    if isinstance(noise, np.ndarray):
        # Full 8-point LUT (photon-noise model or custom).
        if noise.max() > 0:
            noise_lut = noise.astype(np.float32)
            fh.flags |= int(FrameFlags.NOISE)
        noise = None
    if noise is not None and noise > 0:
        fh.flags |= int(FrameFlags.NOISE)
        noise_lut = np.full(8, float(noise), np.float32)
    fh.is_last = is_last
    fh.animation_frame.duration = duration
    if blend_mode is not None:
        from libjxl_tpu_torch.frame.frame_header import BlendingInfo
        fh.blending_info.mode = int(blend_mode)
        # Blending reads the background from reference slot `source`
        # (frame_header.h BlendingInfo::source); the frame it blends
        # onto must have been stored there via save_as_reference.
        fh.blending_info.source = int(blend_source)
        # Alpha (and other EC) planes blend with the same mode; the
        # header visitor keeps a pre-sized list (frame_header.py:460
        # replaces mismatched lists with defaults = REPLACE).
        fh.extra_channel_blending_info = [
            BlendingInfo(mode=int(blend_mode), source=int(blend_source))
            for _ in range(metadata.m.num_extra_channels)]
    if save_slot is not None:
        # Store this REGULAR frame in a reference slot so later frames
        # can blend onto it (frame_header.h CanBeReferenced: a
        # duration>0 frame is only stored when save_as_reference != 0).
        fh.save_as_reference = int(save_slot)
    if dc_frame_level is not None:
        from libjxl_tpu_torch.frame.frame_header import FrameType
        fh.frame_type = FrameType.DC_FRAME
        fh.dc_level = dc_frame_level
        fh.is_last = False
        is_last = False
    if external_dc is not None:
        fh.flags |= int(FrameFlags.USE_DC_FRAME)
    if patches is not None:
        fh.flags |= int(FrameFlags.PATCHES)
    if splines is not None:
        fh.flags |= int(FrameFlags.SPLINES)
    if save_as_reference is not None:
        from libjxl_tpu_torch.frame.frame_header import FrameType
        fh.frame_type = FrameType.REFERENCE_ONLY
        fh.save_as_reference = save_as_reference
        fh.save_before_color_transform = True
        fh.is_last = False
    if pass_shifts and len(pass_shifts) > 1:
        if pass_shifts[-1] != 0:
            raise ValueError("last pass must have shift 0")
        fh.passes.num_passes = len(pass_shifts)
        for i, s in enumerate(pass_shifts):
            fh.passes.shift[i] = s
    # Loop filters (enc_frame.cc:315-345): gaborish at hare-or-slower
    # when distance > 0.5 (and decoding_speed < 4); EPF iteration count
    # from the distance thresholds {0.7, 1.5, 4.0}, reduced by the
    # decoding-speed tier. DC frames skip them: smoothing would corrupt
    # the block means they exist to carry.
    if dc_frame_level is not None:
        fh.loop_filter.all_default = False
        fh.loop_filter.gab = False
        fh.loop_filter.epf_iters = 0
    else:
        gab = effort >= 5 and distance > 0.15 and decoding_speed < 4
        if epf >= 0:
            epf_iters = epf
        else:
            epf_iters = 0
            if decoding_speed < 3:
                for i in range(1 if decoding_speed == 2 else 0, 3):
                    if distance >= (0.7, 1.5, 4.0)[i]:
                        epf_iters += 1
        fh.loop_filter.gab = gab
        fh.loop_filter.epf_iters = epf_iters
        fh.loop_filter.all_default = (gab and epf_iters == 2)
        fh.x_qm_scale, fh.b_qm_scale = _chromacity_adjustments(
            xyb, distance, effort)
    fd = fh.to_frame_dimensions()

    # Pad to whole blocks by edge replication.
    pad_y = fd.ysize_padded - ysize
    pad_x = fd.xsize_padded - xsize
    planes = np.pad(xyb, ((0, 0), (0, pad_y), (0, pad_x)), mode="edge")

    from libjxl_tpu_torch.frame.adaptive_quant import (
        gaborish_inverse, initial_quant_dc as aq_dc,
        initial_quant_field as aq_field)
    # The adaptive-quant field is computed on PRE-gaborish pixels
    # (enc_heuristics.cc:1109 "relies on pre-gaborish values"; the
    # gaborish inverse sharpens local contrast and would overestimate
    # masking); without gaborish the reference tightens the target by
    # 0.62x (enc_heuristics.cc:1121).
    aq_planes = planes
    aq_distance = distance if fh.loop_filter.gab else distance * 0.62
    # The AR-sharpness heuristic consumes the post-gaborish planes on
    # host, so the fused device pre-stage only runs without it.
    ar_active = (ar_sharpness and fh.loop_filter.epf_iters > 0
                 and distance >= 0.5 and dc_frame_level is None)
    device_pre = (device is not None and external_dc is None
                  and not ar_active)
    if fh.loop_filter.gab and not device_pre:
        planes = gaborish_inverse(planes)

    if device is not None and external_dc is None:
        enc = compute_vardct_encoding_device(
            planes, fd, fh, distance, qf_adjust=qf_adjust,
            effort=effort, aq_planes=aq_planes,
            aq_distance=aq_distance,
            pre_gaborish_gab=(bool(fh.loop_filter.gab) if device_pre
                              else None), device=device)
    else:
        enc = compute_vardct_encoding(planes, fd, fh, distance,
                                      qf_adjust=qf_adjust,
                                      external_dc=external_dc,
                                      effort=effort,
                                      aq_planes=aq_planes,
                                      aq_distance=aq_distance)
    matrices = enc["matrices"]
    quantizer = enc["quantizer"]
    ctx_map = enc["ctx_map"]
    cmap = enc["cmap"]
    qdc = enc["qdc"]
    raw_quant = enc["raw_quant"]
    strategies = enc["strategies"]
    blocks_per_group = enc["blocks_per_group"]
    ytox_map = enc["ytox_map"]
    ytob_map = enc["ytob_map"]
    x_mul = enc["x_mul"]
    b_mul = enc["b_mul"]
    mul_dc = enc["mul_dc"]
    cfl_fac = enc["cfl_fac"]

    # Adaptive-reconstruction (EPF sharpness) field
    # (enc_heuristics.cc:892 ComputeARHeuristics).
    sharpness_map = None
    if ar_sharpness and fh.loop_filter.epf_iters > 0 \
            and distance >= 0.5 and dc_frame_level is None:
        from libjxl_tpu_torch.frame.ar_heuristic import compute_ar_sharpness
        from libjxl_tpu_torch.vardct.reconstruct import (
            native_reconstruct_group, reconstruct_group)
        y_dc = qdc[1] * mul_dc[1]
        dc_dec = np.stack([qdc[0] * mul_dc[0] + cfl_fac[0] * y_dc,
                           y_dc,
                           qdc[2] * mul_dc[2] + cfl_fac[2] * y_dc])
        prefilter = np.zeros((3, fd.ysize_padded, fd.xsize_padded),
                             np.float32)
        ytox_m = ytox_map if ytox_map is not None else \
            np.zeros(((fd.ysize_blocks + 7) // 8,
                      (fd.xsize_blocks + 7) // 8), np.int32)
        ytob_m = ytob_map if ytob_map is not None else \
            np.zeros(((fd.ysize_blocks + 7) // 8,
                      (fd.xsize_blocks + 7) // 8), np.int32)
        for g in range(fd.num_groups):
            brect = fd.block_group_rect(g)
            sl = brect.slices()
            # Same fused native kernel as the decoder (numpy fallback).
            pix = native_reconstruct_group(
                blocks_per_group[g], brect, quantizer, raw_quant[sl],
                dc_dec[:, brect.y0:brect.y1, brect.x0:brect.x1], cmap,
                ytox_m, ytob_m, 1.0 / x_mul, 1.0 / b_mul)
            if pix is None:
                pix = reconstruct_group(
                    blocks_per_group[g], brect.xsize, brect.ysize,
                    quantizer, raw_quant[sl],
                    dc_dec[:, brect.y0:brect.y1, brect.x0:brect.x1],
                    cmap, ytox_m, ytob_m, brect.x0, brect.y0,
                    1.0 / x_mul, 1.0 / b_mul)
            prefilter[:, brect.y0 * 8:brect.y0 * 8 + brect.ysize * 8,
                      brect.x0 * 8:brect.x0 * 8 + brect.xsize * 8] = pix
        # Masking proxy: the adaptive quant field tracks the masking
        # model (enc_adaptive_quantization.cc mask1x1), expanded to
        # pixels and normalized.
        qf_norm = raw_quant.astype(np.float32)
        qf_norm /= max(qf_norm.mean(), 1e-6)
        mask1x1 = np.repeat(np.repeat(qf_norm, 8, 0), 8, 1)
        sharpness_map = compute_ar_sharpness(
            planes, prefilter, fh.loop_filter, quantizer, raw_quant,
            strategies, fd, distance,
            mask1x1=mask1x1[:fd.ysize, :fd.xsize])

    if aux_out is not None:
        aux_out.count_strategies(strategies)
    if debug_dir is not None:
        _dump_debug_images(debug_dir, enc, sharpness_map, fd)
    _write_vardct_sections(w, fh, fd, metadata, quantizer, ctx_map, cmap,
                           qdc, raw_quant, strategies, blocks_per_group,
                           ytox_map, ytob_map, extra_channels, noise_lut,
                           patches, splines, sharpness_map,
                           aux_out=aux_out,
                           group_order_center=group_order_center,
                           effort=effort)



def _dump_debug_images(debug_dir, enc, sharpness_map, fd) -> None:
    """DumpPlaneNormalized-style debug dumps (enc_debug_image.cc /
    cparams.debug_image usage): raw quant field, AC-strategy map, CfL
    maps and the EPF sharpness field as normalized PNGs."""
    import os

    from PIL import Image

    os.makedirs(debug_dir, exist_ok=True)

    def dump(name, plane):
        plane = np.asarray(plane, np.float64)
        lo, hi = plane.min(), plane.max()
        norm = (plane - lo) / (hi - lo) if hi > lo \
            else np.zeros_like(plane)
        Image.fromarray(np.round(norm * 255).astype(np.uint8)).save(
            os.path.join(debug_dir, name + ".png"))

    dump("raw_quant_field", enc["raw_quant"])
    dump("ac_strategy", np.maximum(enc["strategies"], 0))
    dump("ytox_map", enc["ytox_map"])
    dump("ytob_map", enc["ytob_map"])
    dump("dc_y", enc["qdc"][1])
    if sharpness_map is not None:
        dump("epf_sharpness", sharpness_map)



def _chromacity_adjustments(xyb: np.ndarray, distance: float,
                            effort: int) -> tuple[int, int]:
    """ComputeChromacityAdjustments (enc_frame.cc:665-692): distance-
    stepped x_qm_scale plus pixel-stats escalation from worst-case
    neighbor deltas of the X plane / B-Y exposure."""
    x_qm = 2
    for step in (2.5, 5.5, 9.5):
        if distance > step:
            x_qm += 1
    b_qm = 2
    if effort >= 7 and xyb.shape[1] > 1 and xyb.shape[2] > 1:
        x_pl = xyb[0]
        dx = max(float(np.abs(np.diff(x_pl, axis=1)).max()),
                 float(np.abs(np.diff(x_pl, axis=0)).max()))
        x_level = 3 if dx >= 0.026 else 2 if dx >= 0.022 \
            else 1 if dx >= 0.015 else 0
        x_qm = max(x_qm, 2 + x_level)
        yp, bp = xyb[1], xyb[2]
        diff_b = bp - yp
        db = max(float(np.abs(np.diff(diff_b, axis=1)).max()),
                 float(np.abs(np.diff(diff_b, axis=0)).max()))
        exposed = bp - yp * 1.2
        act = (np.abs(np.diff(bp, axis=1, prepend=bp[:, :1]))
               + np.abs(np.diff(bp, axis=0, prepend=bp[:1])))
        eb = float(np.where(exposed >= 0, exposed * act, 0.0)[1:, 1:].max())
        add = 1 if eb >= 0.13 else 0
        b_level = (2 + add) if db > 0.38 else (1 + add) if db > 0.33 \
            else add if db > 0.28 else 0
        b_qm = 2 + b_level
    return min(x_qm, 7), min(b_qm, 3)


def _split_pass_blocks(blocks_per_group: dict, shifts: list,
                       ) -> list[dict]:
    """Split quantized coefficients across progressive passes so that
    sum_p(t_p << shift_p) reconstructs the original values
    (enc_progressive / progressive_split.h semantics; the exact split
    is encoder freedom). Truncation toward zero keeps early-pass
    previews unbiased."""
    per_pass: list[dict] = [dict() for _ in shifts]
    for g, blist in blocks_per_group.items():
        residual = [blk.coeffs.astype(np.int64) for blk in blist]
        for p, s in enumerate(shifts):
            out = []
            for i, blk in enumerate(blist):
                r = residual[i]
                t = np.sign(r) * (np.abs(r) >> s)
                residual[i] = r - (t << s)
                out.append(CoeffBlock(blk.bx, blk.by, blk.strategy,
                                      t.astype(np.int32)))
            per_pass[p][g] = out
    return per_pass


def _write_vardct_sections(w, fh, fd, metadata, quantizer, ctx_map, cmap,
                           qdc, raw_quant, strategies, blocks_per_group,
                           ytox_map=None, ytob_map=None,
                           extra_channels=None, noise_lut=None, patches=None,
                           splines=None, sharpness_map=None, aux_out=None,
                           group_order_center=None, effort: int = 7):
    from libjxl_tpu_torch.entropy.codes import (
        build_and_encode_histograms, write_tokens)
    from libjxl_tpu_torch.bitstream.toc import num_toc_entries

    mfe = ModularFrameEncoder(fd)
    bitdepth = metadata.m.bit_depth.bits_per_sample

    mod_state = {}

    def _acmeta_parts(g):
        rect = fd.dc_group_rect(g)
        sl = rect.slices()
        cr_w = (rect.xsize + 7) >> 3
        cr_h = (rect.ysize + 7) >> 3
        cr = (slice(rect.y0 >> 3, (rect.y0 >> 3) + cr_h),
              slice(rect.x0 >> 3, (rect.x0 >> 3) + cr_w))
        ytox = ytox_map[cr] if ytox_map is not None \
            else np.zeros((cr_h, cr_w), np.int32)
        ytob = ytob_map[cr] if ytob_map is not None \
            else np.zeros((cr_h, cr_w), np.int32)
        if sharpness_map is not None:
            epf = sharpness_map[sl].astype(np.int32)
        else:
            # Fast path: constant sharpness 4 (enc_heuristics.cc:907).
            epf = np.full((rect.ysize, rect.xsize), 4, np.int32)
        return rect, sl, ytox, ytob, epf

    # Learned global tree over the DC + AC-metadata streams
    # (enc_modular.cc squirrel+; prepare_vardct_aux measures both
    # variants exactly and returns None when fixed trees are smaller).
    aux_state = None
    acmeta_cache = {}
    if effort >= 6 and not extra_channels:
        dc_entries = []
        if not (fh.flags & FrameFlags.USE_DC_FRAME):
            for g in range(fd.num_dc_groups):
                rect = fd.dc_group_rect(g)
                dc_entries.append((g, mfe.build_vardct_dc_image(
                    qdc[:, rect.y0:rect.y1, rect.x0:rect.x1], bitdepth)))
        acmeta_entries = []
        for g in range(fd.num_dc_groups):
            rect, sl, ytox, ytob, epf = _acmeta_parts(g)
            img, count = mfe.build_ac_metadata_image(
                rect, ytox, ytob, strategies[sl], raw_quant[sl], epf,
                bitdepth)
            acmeta_entries.append((g, rect, count, img))
            acmeta_cache[g] = (rect, count)
        aux_state = mfe.prepare_vardct_aux(dc_entries, acmeta_entries,
                                           bitdepth)

    def _mark(sw, layer, state=[0]):
        if aux_out is not None:
            aux_out.add(layer, sw.bits_written - state[0])
            state[0] = sw.bits_written

    def write_lf_global(sw):
        pos = [sw.bits_written]
        if patches is not None:
            from libjxl_tpu_torch.frame.patches import encode_patches
            encode_patches(patches, metadata.m.num_extra_channels, sw)
        _mark(sw, "dictionary", pos)
        if splines is not None:
            from libjxl_tpu_torch.frame.splines import encode_splines
            encode_splines(splines, sw)
        _mark(sw, "splines", pos)
        if noise_lut is not None:
            from libjxl_tpu_torch.frame.noise import encode_noise
            encode_noise(noise_lut, sw)
        _mark(sw, "noise", pos)
        quantizer.dequant.encode_dc(sw)
        quantizer.encode(sw)
        ctx_map.encode(sw)
        cmap.encode_dc(sw)
        _mark(sw, "quant", pos)
        if aux_state is not None:
            mfe.write_vardct_aux_global(sw, aux_state)
        elif extra_channels:
            full = ModularImage.from_planes(extra_channels,
                                            metadata.m.bit_depth.bits_per_sample)
            st = mfe.encode_global_info(sw, full_image=full)
            if st:
                mod_state.update(st)
        else:
            mfe.encode_global_info(sw)
        _mark(sw, "modular_global", pos)

    def write_dc_group(sw, g):
        pos = [sw.bits_written]
        from libjxl_tpu_torch.frame.modular_frame import (
            stream_ac_metadata, stream_vardct_dc)
        if aux_state is not None:
            rect, count = acmeta_cache[g]
            if not (fh.flags & FrameFlags.USE_DC_FRAME):
                sw.write(2, 0)  # extra_precision = 0
                mfe.write_aux_with_tree(sw, aux_state,
                                        stream_vardct_dc(g, fd))
            _mark(sw, "dc", pos)
            mfe._write_acmeta_count(sw, rect, count)
            mfe.write_aux_with_tree(sw, aux_state,
                                    stream_ac_metadata(g, fd))
            _mark(sw, "control_fields", pos)
            return
        rect = fd.dc_group_rect(g)
        sl = rect.slices()
        if not (fh.flags & FrameFlags.USE_DC_FRAME):
            mfe.encode_vardct_dc(
                sw, qdc[:, rect.y0:rect.y1, rect.x0:rect.x1], bitdepth)
        # ModularDC stream is geometrically empty for VarDCT frames:
        # nothing is written (decoder skips it, dec_modular.cc:377).
        _rect, sl, ytox, ytob, epf = _acmeta_parts(g)
        _mark(sw, "dc", pos)
        mfe.encode_ac_metadata(sw, rect, ytox, ytob,
                               strategies[sl], raw_quant[sl], epf, bitdepth)
        _mark(sw, "control_fields", pos)

    # Tokenize all groups up-front (shared histograms live in ACGlobal).
    num_passes = fh.passes.num_passes
    shifts = [fh.passes.shift[p] for p in range(num_passes)]
    pass_blocks = _split_pass_blocks(blocks_per_group, shifts) \
        if num_passes > 1 else [blocks_per_group]
    orders = {}
    for s in range(acs.NUM_STRATEGIES):
        ord_b = acs.STRATEGY_ORDER[s]
        for c in range(3):
            orders[(ord_b, c)] = acs.natural_coeff_order(s)
    from libjxl_tpu_torch.vardct.group_native import (
        native_tokenize_group, prepare_blocks)
    pass_tokens = []
    for p in range(num_passes):
        group_tokens = []
        for g in range(fd.num_groups):
            brect = fd.block_group_rect(g)
            sl = brect.slices()
            prep = prepare_blocks(strategies[sl], raw_quant[sl], ctx_map,
                                  orders)
            nat = native_tokenize_group(pass_blocks[p][g], brect.xsize,
                                        brect.ysize, prep, ctx_map)
            if nat is not None:
                group_tokens.append(nat)
                continue
            tokens = []
            tokenize_group_coeffs(pass_blocks[p][g], brect.xsize,
                                  brect.ysize, raw_quant[sl], orders,
                                  ctx_map, tokens)
            group_tokens.append(tokens)
        pass_tokens.append(group_tokens)

    ac_codes_holder = {}

    def write_ac_global(sw):
        pos = [sw.bits_written]
        quantizer.dequant.encode(sw)
        _mark(sw, "quant", pos)
        num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
            if fd.num_groups > 1 else 0
        if num_histo_bits:
            sw.write(num_histo_bits, 0)  # num_histograms = 1
        num_contexts = ctx_map.num_ac_contexts()
        codes = []
        for p in range(num_passes):
            write_used_orders(0, sw)  # natural orders everywhere
            _mark(sw, "coeff_order", pos)
            codes.append(build_and_encode_histograms(
                num_contexts, pass_tokens[p], sw))
            _mark(sw, "ac", pos)
        ac_codes_holder["codes"] = codes

    def write_ac_group(sw, g, p):
        pos = [sw.bits_written]
        # single histogram set: no selector bits
        write_tokens(pass_tokens[p][g], ac_codes_holder["codes"][p], sw)
        _mark(sw, "ac_tokens", pos)
        if mod_state:
            min_s, max_s = fh.passes.downsampling_bracket(p)
            mrect = fd.group_rect(g)
            prect = Rect(mrect.x0, mrect.y0, fd.group_dim, fd.group_dim)
            mfe.encode_group(sw, mod_state, prect, min_s, max_s)
            _mark(sw, "modular_ac_group", pos)

    parts = [write_lf_global]
    parts += [(lambda g: (lambda sw: write_dc_group(sw, g)))(g)
              for g in range(fd.num_dc_groups)]
    parts += [write_ac_global]
    parts += [(lambda g, p: (lambda sw: write_ac_group(sw, g, p)))(g, p)
              for p in range(num_passes) for g in range(fd.num_groups)]
    perm = None
    if group_order_center is not None and group_order_center is not False \
            and fd.num_groups > 1:
        center = None if group_order_center is True else group_order_center
        perm = _center_first_permutation(fd, num_passes, center)
    _emit_sections(w, fh, fd, parts, num_passes, aux_out=aux_out,
                   permutation=perm)



def _center_first_permutation(fd, num_passes: int,
                              center: tuple | None = None) -> list[int]:
    """ComputePermutationForCenterFirst (enc_frame.cc:1725-1790):
    AC groups ordered by concentric squares around the center group,
    clockwise from the side nearest the requested center point."""
    import math
    perm = list(range(fd.num_dc_groups + 2))
    gd = fd.group_dim
    icx = center[0] if center is not None else fd.xsize // 2
    icy = center[1] if center is not None else fd.ysize // 2
    cx = (icx // gd) * gd + gd // 2
    cy = (icy // gd) * gd + gd // 2
    direction = -math.atan2(icy - cy, icx - cx)
    side = int(math.fmod(direction + 5 * math.pi / 4, 2 * math.pi)
               * 2 / math.pi)

    def key(gid):
        r = fd.group_rect(gid)
        gcx, gcy = r.x0 + gd // 2, r.y0 + gd // 2
        dx, dy = gcx - cx, gcy - cy
        angle = math.remainder(
            math.atan2(dy, dx) + math.pi / 4 + side * (math.pi / 2),
            2 * math.pi)
        return (max(abs(dx), abs(dy)), angle)

    order = sorted(range(fd.num_groups), key=key)
    inv = [0] * fd.num_groups
    for i, v in enumerate(order):
        inv[v] = i
    for _ in range(num_passes):
        base = len(perm)
        perm.extend(base + v for v in inv)
    return perm


def _emit_sections(w, fh, fd, parts, num_passes: int = 1, aux_out=None,
                   permutation: list | None = None):
    """Write frame header + TOC + sections. Single-TOC-entry frames
    concatenate all parts bit-unaligned in one section
    (enc_frame.cc one-shot small-frame path); otherwise each section is
    byte-aligned with its own TOC size entry."""
    from libjxl_tpu_torch.bitstream.toc import num_toc_entries

    toc_entries = num_toc_entries(fd.num_groups, fd.num_dc_groups, num_passes)
    pos0 = w.bits_written
    bundle_write(fh, w)
    if aux_out is not None:
        aux_out.add("header", w.bits_written - pos0)
    if toc_entries == 1:
        pw = BitWriter()
        for f in parts:
            f(pw)
        pw.align_to_byte()
        payload = pw.get_bytes()
        pos0 = w.bits_written
        write_toc([len(payload)], w)
        if aux_out is not None:
            aux_out.add("toc", w.bits_written - pos0)
        w.append_bytes(payload)
    else:
        sections = []
        for f in parts:
            sw = BitWriter()
            f(sw)
            sw.align_to_byte()
            sections.append(sw.get_bytes())
        pos0 = w.bits_written
        if permutation is not None:
            stream_order = [0] * len(permutation)
            for old, new in enumerate(permutation):
                stream_order[new] = old
            write_toc([len(sections[o]) for o in stream_order], w,
                      permutation=permutation)
            if aux_out is not None:
                aux_out.add("toc", w.bits_written - pos0)
            for o in stream_order:
                w.append_bytes(sections[o])
            return
        write_toc([len(s) for s in sections], w)
        if aux_out is not None:
            aux_out.add("toc", w.bits_written - pos0)
        for s in sections:
            w.append_bytes(s)


def _squeeze_lossy_quantizer(distance: float, maxval: int,
                             nb_meta: int):
    """Per-channel post-squeeze quantization (enc_modular.cc:980-1035):
    residual channels snap to multiples of q, where q follows the
    squeeze level (hshift+vshift) via the luma/chroma q-tables."""
    sq_quality_factor = 0.35
    sq_luma_factor = 1.1
    luma_qtable = [163.84 / (1 << i) for i in range(16)]
    chroma_qtable = [min(1024.0 / (1 << i), 0.5) if 1024.0 / (1 << i) < 0.5
                     else 1024.0 / (1 << i) for i in range(16)]
    chroma_qtable = [max(v, 0.5) for v in chroma_qtable]
    base = 0.25 * (distance ** 1.2) * (maxval / 255.0)

    def quantize(i, ch):
        shift = min(ch.hshift + ch.vshift, 16)
        if shift > 0:
            shift -= 1
        component = getattr(ch, "component", i - nb_meta) % 3
        if component in (1, 2):
            q = base * sq_quality_factor * chroma_qtable[shift]
        else:
            q = base * sq_quality_factor * sq_luma_factor \
                * luma_qtable[shift]
        q = max(1, int(q))
        if q == 1:
            return
        d = ch.data.astype(np.int64)
        ch.data = (np.where(d < 0, -((-d + q // 2) // q),
                            (d + q // 2) // q) * q).astype(ch.data.dtype)

    return quantize


def encode_modular_frame(channels: list, metadata: CodecMetadata,
                         w: BitWriter, *, transforms: list | None = None,
                         predictor: int = P_GRADIENT,
                         is_last: bool = True, duration: int = 0,
                         ycbcr_subsampling: list | None = None,
                         learn_tree: bool = True,
                         lossy_distance: float = 0.0,
                         use_prefix: bool = False,
                         try_lz77: bool = True) -> None:
    """Lossless modular frame from int channel planes.

    ycbcr_subsampling: channel_mode triple (e.g. [0, 1, 0] for 4:2:0;
    frame_header.h YCbCrChromaSubsampling) — channels must then be
    [Cb, Y, Cr] already subsampled to their coded sizes."""
    fh = FrameHeader(nonserialized_metadata=metadata)
    fh.encoding = FrameEncoding.MODULAR
    fh.is_last = is_last
    fh.animation_frame.duration = duration
    fh.color_transform = ColorTransform.NONE
    if ycbcr_subsampling is not None:
        fh.color_transform = ColorTransform.YCBCR
        fh.chroma_subsampling.channel_mode = list(ycbcr_subsampling)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    fd = fh.to_frame_dimensions()

    img = ModularImage.from_planes(
        channels, metadata.m.bit_depth.bits_per_sample)
    if ycbcr_subsampling is not None:
        for c in range(min(3, len(img.channel))):
            img.channel[c].hshift = fh.chroma_subsampling.hshift(c)
            img.channel[c].vshift = fh.chroma_subsampling.vshift(c)
    mfe = ModularFrameEncoder(fd)
    from libjxl_tpu_torch.frame.modular_frame import (
        stream_modular_ac, stream_modular_dc)
    quantize = None
    if lossy_distance > 0:
        maxval = (1 << metadata.m.bit_depth.bits_per_sample) - 1
        quantize = _squeeze_lossy_quantizer(lossy_distance, maxval,
                                            img.nb_meta_channels)
    state = mfe.prepare_global_tree(img, transforms or [], fh,
                                    learn=learn_tree, quantize=quantize,
                                    use_prefix=use_prefix,
                                    try_lz77=try_lz77)

    def write_lf_global(sw):
        DequantMatrices().encode_dc(sw)
        mfe.write_global_with_tree(sw, state)

    def write_dc_group(sw, g):
        mfe.write_group_with_tree(sw, state, stream_modular_dc(g, fd))

    def write_ac_global(sw):
        pass  # modular frames carry nothing in ACGlobal

    def write_ac_group(sw, g):
        mfe.write_group_with_tree(sw, state, stream_modular_ac(g, 0, fd))

    parts = [write_lf_global]
    parts += [(lambda g: (lambda sw: write_dc_group(sw, g)))(g)
              for g in range(fd.num_dc_groups)]
    parts += [write_ac_global]
    parts += [(lambda g: (lambda sw: write_ac_group(sw, g)))(g)
              for g in range(fd.num_groups)]
    _emit_sections(w, fh, fd, parts)


# ---------------------------------------------------------------------------
# Chroma-subsampled YCbCr VarDCT encode (420/422 with loop filters and
# progressive passes — streams the reference only produces via JPEG
# transcoding, but that its decoder accepts generally;
# render_pipeline/stage_chroma_upsampling.cc + dec_group.cc hshift
# handling define the decode semantics this mirrors).

# JPEG Annex K base tables (quality scaling analogue; values transposed
# into the jxl stored-coefficient layout at use site).
_JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_JPEG_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64).reshape(8, 8)


def encode_ycbcr_vardct_frame(rgb: np.ndarray, metadata: CodecMetadata,
                              w: BitWriter, *, distance: float = 1.0,
                              subsampling: str = "420",
                              gab: bool = True, epf: int = -1,
                              progressive: bool = False) -> None:
    """Encode (H, W, 3) uint8 sRGB as a chroma-subsampled YCbCr VarDCT
    frame: BT.601 conversion, box-downsampled chroma, DCT8X8 with
    RAW-signaled JPEG-style quant tables, optional gaborish/EPF and a
    2-pass progressive split."""
    from libjxl_tpu_torch.color.ycbcr import rgb_to_ycbcr
    from libjxl_tpu_torch.entropy.codes import (
        build_and_encode_histograms, write_tokens)
    from libjxl_tpu_torch.frame.frame_header import ColorTransform
    from libjxl_tpu_torch.vardct.dct import dct_matrix
    from libjxl_tpu_torch.vardct.group import tokenize_group_coeffs_subsampled
    from libjxl_tpu_torch.vardct.quant_weights import MODE_RAW, QuantEncoding

    h_img, w_img = rgb.shape[:2]
    fh = FrameHeader(nonserialized_metadata=metadata)
    fh.encoding = FrameEncoding.VARDCT
    fh.color_transform = ColorTransform.YCBCR
    # channel_mode order is (X=Cb, Y, B=Cr); Y gets the max shift entry
    # so chroma ends up shifted (frame_header.h kHShift/kVShift).
    fh.chroma_subsampling.channel_mode = \
        [0, 1, 0] if subsampling == "420" else [0, 2, 0]
    fh.flags = int(FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = bool(gab)
    if epf < 0:
        epf = 1 if distance >= 0.5 else 0
    fh.loop_filter.epf_iters = int(epf)
    pass_shifts = [2, 0] if progressive else [0]
    if len(pass_shifts) > 1:
        fh.passes.num_passes = len(pass_shifts)
        for i, s in enumerate(pass_shifts):
            fh.passes.shift[i] = s
    fd = fh.to_frame_dimensions()
    cs = fh.chroma_subsampling
    shifts = [(cs.hshift(c), cs.vshift(c)) for c in range(3)]

    # YCbCr planes; chroma box-downsampled to coded resolution.
    srgb = rgb.astype(np.float32) / 255.0
    cb, yp, cr = rgb_to_ycbcr(srgb[..., 0], srgb[..., 1], srgb[..., 2])
    planes_full = [cb, yp, cr]      # channel order X=Cb, Y, B=Cr

    # RAW quant tables scaled by distance (JPEG Annex K shapes).
    den = 1.0 / (8.0 * 255.0)
    qscale = max(0.25, min(8.0, distance))
    qraw = np.zeros((3, 64), np.int64)
    dc_quant = np.zeros(3, np.float32)
    for p in range(3):
        base = _JPEG_LUMA_Q if p == 1 else _JPEG_CHROMA_Q
        q = np.clip(np.round(base * qscale * 0.5), 1, 255).astype(np.int64)
        qraw[p] = q.T.ravel()
        dc_quant[p] = q[0, 0] / (8.0 * 255.0)

    matrices = DequantMatrices()
    matrices.encodings[0] = QuantEncoding(MODE_RAW, qraw_table=qraw,
                                          qraw_den=den)
    matrices.dc_quant = dc_quant
    matrices.inv_dc_quant = 1.0 / dc_quant
    quantizer = Quantizer(matrices, quant_dc=1, global_scale=1 << 16)
    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()
    cmap.base_correlation_b = 0.0

    by, bx = fd.ysize_blocks, fd.xsize_blocks
    strategies = np.zeros((by, bx), np.int32)
    raw_quant = np.ones((by, bx), np.int32)
    d8 = dct_matrix(8).astype(np.float64)

    # Per-plane quantized (stored-layout) coefficients + quantized DC.
    coeff_planes = []
    dc_planes = []
    table8 = quantizer.dequant.table(0)  # (3, 8, 8) stored layout
    for p in range(3):
        hs, vs = shifts[p]
        cw = -(-bx // (1 << hs))
        chh = -(-by // (1 << vs))
        pw, ph = cw * 8, chh * 8
        src = planes_full[p]
        if hs or vs:
            f = 1 << max(hs, vs)
            hh = -(-src.shape[0] // (1 << vs)) * (1 << vs)
            ww = -(-src.shape[1] // (1 << hs)) * (1 << hs)
            pad = np.pad(src, ((0, hh - src.shape[0]),
                               (0, ww - src.shape[1])), mode="edge")
            src = pad.reshape(hh >> vs, 1 << vs, ww >> hs,
                              1 << hs).mean(axis=(1, 3))
        pad = np.pad(src, ((0, ph - src.shape[0]),
                           (0, pw - src.shape[1])), mode="edge")
        blocks = pad.reshape(chh, 8, cw, 8).transpose(0, 2, 1, 3)
        # Decoder: pix = i8 @ dq_stored.T @ i8.T with i8 = inverse of
        # dct_matrix  =>  dq_stored = d8 @ pix.T @ d8.T.
        dq = np.einsum("vy,abwy,uw->abvu", d8, blocks, d8,
                       optimize=True)
        qc = np.round(dq.reshape(chh, cw, 64)
                      / table8[p].reshape(64)).astype(np.int32)
        dcq = np.round(dq[:, :, 0, 0] / dc_quant[p]).astype(np.int32)
        qc[:, :, 0] = 0
        coeff_planes.append(qc)
        dc_planes.append(dcq)

    ord_b = acs.STRATEGY_ORDER[acs.DCT8X8]
    orders = {}
    for c in range(3):
        orders[(ord_b, c)] = acs.natural_coeff_order(acs.DCT8X8)

    # Progressive split: pass p carries t_p with sum(t_p << shift_p)
    # reconstructing the quantized coefficients.
    pass_planes = []
    residual = [cp.astype(np.int64) for cp in coeff_planes]
    for s in pass_shifts:
        cur = []
        for p in range(3):
            t = np.sign(residual[p]) * (np.abs(residual[p]) >> s)
            residual[p] = residual[p] - (t << s)
            cur.append(t.astype(np.int32))
        pass_planes.append(cur)

    pass_group_tokens = []
    for pp in pass_planes:
        group_tokens = []
        for g in range(fd.num_groups):
            brect = fd.block_group_rect(g)
            sl = brect.slices()
            gcoeffs = []
            for p in range(3):
                hs, vs = shifts[p]
                gcoeffs.append(pp[p][brect.y0 >> vs:, brect.x0 >> hs:])
            tokens = []
            tokenize_group_coeffs_subsampled(
                gcoeffs, brect.xsize, brect.ysize, raw_quant[sl], orders,
                ctx_map, tokens, shifts)
            group_tokens.append(tokens)
        pass_group_tokens.append(group_tokens)

    mfe = ModularFrameEncoder(fd)
    holder = {}

    def write_lf_global(sw):
        matrices.encode_dc(sw)
        quantizer.encode(sw)
        ctx_map.encode(sw)
        cmap.encode_dc(sw)
        mfe.encode_global_info(sw)

    def write_dc_group(sw, g):
        rect = fd.dc_group_rect(g)
        qdc_g = []
        for p in range(3):
            hs, vs = shifts[p]
            y0, x0 = rect.y0 >> vs, rect.x0 >> hs
            hh = -(-rect.ysize // (1 << vs))
            ww = -(-rect.xsize // (1 << hs))
            qdc_g.append(dc_planes[p][y0:y0 + hh, x0:x0 + ww])
        mfe.encode_vardct_dc(sw, qdc_g, 8, shifts=shifts)
        sl = rect.slices()
        cr_w = (rect.xsize + 7) >> 3
        cr_h = (rect.ysize + 7) >> 3
        zeros = np.zeros((cr_h, cr_w), np.int32)
        sharp = np.zeros((rect.ysize, rect.xsize), np.int32)
        mfe.encode_ac_metadata(sw, rect, zeros, zeros, strategies[sl],
                               raw_quant[sl], sharp, 8)

    def write_ac_global(sw):
        matrices.encode(sw)
        num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
            if fd.num_groups > 1 else 0
        if num_histo_bits:
            sw.write(num_histo_bits, 0)
        holder["codes"] = []
        for pt in pass_group_tokens:
            write_used_orders(0, sw)
            holder["codes"].append(build_and_encode_histograms(
                ctx_map.num_ac_contexts(), pt, sw))

    def make_ac_group(p, g):
        def write_ac_group(sw):
            write_tokens(pass_group_tokens[p][g], holder["codes"][p], sw)
        return write_ac_group

    parts = [write_lf_global]
    parts += [(lambda g: (lambda sw: write_dc_group(sw, g)))(g)
              for g in range(fd.num_dc_groups)]
    parts += [write_ac_global]
    for p in range(len(pass_shifts)):
        parts += [make_ac_group(p, g) for g in range(fd.num_groups)]
    _emit_sections(w, fh, fd, parts, num_passes=len(pass_shifts))
