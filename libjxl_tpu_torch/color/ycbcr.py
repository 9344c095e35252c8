"""YCbCr color transform + chroma upsampling (JPEG-style frames).

Reference: lib/jxl/render_pipeline/stage_ycbcr.cc (full-range BT.601
per JFIF clause 7) and stage_chroma_upsampling.cc (3-tap 0.75/0.25
triangle filter, horizontal then vertical).
"""

from __future__ import annotations

import numpy as np

_CRCR = 1.402
_CGCB = -0.114 * 1.772 / 0.587
_CGCR = -0.299 * 1.402 / 0.587
_CBCB = 1.772


def ycbcr_to_rgb(cb: np.ndarray, y: np.ndarray, cr: np.ndarray,
                 ) -> np.ndarray:
    """Float planes (Y already includes no offset) -> (3, H, W) RGB.
    The 128/255 offset of stage_ycbcr is added here."""
    yv = y + 128.0 / 255.0
    r = yv + _CRCR * cr
    g = yv + _CGCB * cb + _CGCR * cr
    b = yv + _CBCB * cb
    return np.stack([r, g, b])


def rgb_to_ycbcr(r: np.ndarray, g: np.ndarray, b: np.ndarray,
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of ycbcr_to_rgb (BT.601 full range, float [0,1])."""
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / _CBCB
    cr = (r - y) / _CRCR
    return cb, y - 128.0 / 255.0, cr


def chroma_upsample(plane: np.ndarray, hshift: int, vshift: int,
                    xsize: int, ysize: int) -> np.ndarray:
    """Upsamples a subsampled chroma plane to (ysize, xsize) with the
    0.25/0.75 triangle filter (stage_chroma_upsampling.cc)."""
    out = plane.astype(np.float64)
    for _ in range(hshift):
        h, w = out.shape
        left = np.concatenate([out[:, :1], out[:, :-1]], axis=1)
        right = np.concatenate([out[:, 1:], out[:, -1:]], axis=1)
        up = np.empty((h, w * 2), np.float64)
        up[:, 0::2] = 0.75 * out + 0.25 * left
        up[:, 1::2] = 0.75 * out + 0.25 * right
        out = up
    for _ in range(vshift):
        h, w = out.shape
        top = np.concatenate([out[:1], out[:-1]], axis=0)
        bottom = np.concatenate([out[1:], out[-1:]], axis=0)
        up = np.empty((h * 2, w), np.float64)
        up[0::2] = 0.75 * out + 0.25 * top
        up[1::2] = 0.75 * out + 0.25 * bottom
        out = up
    return out[:ysize, :xsize]
