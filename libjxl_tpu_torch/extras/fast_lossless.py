"""Standalone fast-lossless encoder (fjxl).

Reference: lib/jxl/enc_fast_lossless.{h,cc} JxlFastLosslessEncode — a
self-contained effort-1 streaming lossless encoder: fixed YCoCg-style
RCT, clamped-gradient prediction with a fixed tree, prefix codes, no
search.

This module fronts this codec's dedicated fast path (the `effort<=1`
branch): in-place int32 YCoCg, a native single-leaf gradient tokenizer
(jxl_native.cpp mod_encode_channel fast path), native token histograms
and a native forward prefix-code emitter (prefix_write_tokens) — the
same architecture as fjxl (prefix over ANS, fixed decisions), not a
delegation to the search-based encoder.

Copy of libjxl_tpu/extras/fast_lossless.py. It calls the port's
``encode`` with ``device="cpu"``: the lossless path uses no device, and
the port's ``encode`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import numpy as np


def fast_lossless_encode(pixels: np.ndarray, *,
                         big_endian: bool = False) -> bytes:
    """JxlFastLosslessEncode (enc_fast_lossless.h:51): (H, W, 1|2|3|4)
    uint8/uint16 samples -> complete JPEG XL codestream, single shot,
    no options. Raises on unsupported shapes/dtypes like the C API
    returns 0."""
    from libjxl_tpu_torch.api.simple import encode
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    if pixels.ndim != 3 or pixels.shape[2] not in (1, 2, 3, 4):
        raise ValueError("expected (H, W, {1,2,3,4}) samples")
    if pixels.dtype not in (np.uint8, np.uint16):
        raise ValueError("expected uint8 or uint16 samples")
    if big_endian and pixels.dtype == np.uint16:
        pixels = pixels.byteswap()
    return encode(np.ascontiguousarray(pixels), lossless=True, effort=1,
                  device="cpu")
