"""Elementwise decode stages in plain PyTorch: AdjustQuantBias and the
XYB -> sRGB8 / PQ16 output tails.

Port of libjxl_tpu/ops/decode_tpu.py. The arithmetic runs in float32
and int32; the result is cast to uint8/uint16 once, at the end, because
PyTorch's uint16 has few kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_tpu_torch.color.constants import (
    DEFAULT_INVERSE_OPSIN_MATRIX, OPSIN_ABSORBANCE_BIAS,
)


def adjust_quant_bias(x: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """quantizer-inl.h AdjustQuantBias on float32 quantized values: 0
    stays 0, +-1 map to +-bias[c], any other x becomes x - bias[3] / x.
    ``biases`` is (4,) with the channel on axis 0 of ``x``, or (NB, 4)
    with the frame on axis 0 and the channel on axis 1."""
    lead = biases.shape[:-1]
    rest = (1,) * (x.ndim - len(lead) - 1)
    bias_c = biases[..., :3].reshape(lead + (3,) + rest)
    b3 = biases[..., 3].reshape(lead + (1,) + rest)
    general = x - b3 / torch.where(x == 0, 1.0, x)
    return torch.where(x == 0, 0.0,
                       torch.where(x == 1, bias_c,
                                   torch.where(x == -1, -bias_c, general)))


def _opsin_inverse(xyb: torch.Tensor):
    """(..., 3, H, W) XYB -> three linear planes (nits/255 units): the
    opsin bias cube and the 3x3 inverse opsin matrix as nine FMAs."""
    bias = np.asarray(OPSIN_ABSORBANCE_BIAS, np.float32)
    bias_cbrt = np.cbrt(bias)
    inv_m = np.asarray(DEFAULT_INVERSE_OPSIN_MATRIX, np.float32)
    x = xyb[..., 0, :, :]
    y = xyb[..., 1, :, :]
    b = xyb[..., 2, :, :]
    gl = y + x + float(bias_cbrt[0])
    gm = y - x + float(bias_cbrt[1])
    gs = b + float(bias_cbrt[2])
    m0 = gl * gl * gl - float(bias[0])
    m1 = gm * gm * gm - float(bias[1])
    m2 = gs * gs * gs - float(bias[2])
    return [float(inv_m[i, 0]) * m0 + float(inv_m[i, 1]) * m1
            + float(inv_m[i, 2]) * m2 for i in range(3)]


def xyb_to_srgb8(xyb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) XYB -> uint8 sRGB (stage_xyb FastXYBTosRGB8)."""
    outs = []
    for lin in _opsin_inverse(xyb):
        lin = lin.clamp(0.0, 1.0)
        srgb = torch.where(lin <= 0.0031308, lin * 12.92,
                           1.055 * lin ** (1 / 2.4) - 0.055)
        outs.append(torch.round(srgb * 255.0).clamp(0, 255)
                    .to(torch.int32))
    return torch.stack(outs, dim=-3).to(torch.uint8)


def xyb_to_pq16(xyb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) XYB -> uint16 PQ-encoded BT.2100 output: linear
    nits/255 -> fraction of 10000 nits -> PQ inverse EOTF
    (cms/transfer_functions-inl.h TF_PQ)."""
    m1, m2 = 0.1593017578125, 78.84375
    c1, c2, c3 = 0.8359375, 18.8515625, 18.6875
    outs = []
    for lin in _opsin_inverse(xyb):
        d = (lin * (255.0 / 10000.0)).clamp(0.0, 1.0)
        xp = d ** m1
        pq = ((c1 + c2 * xp) / (1.0 + c3 * xp)) ** m2
        outs.append(torch.round(pq * 65535.0).clamp(0, 65535)
                    .to(torch.int32))
    return torch.stack(outs, dim=-3).to(torch.uint16)
