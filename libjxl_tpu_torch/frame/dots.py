"""Dot detection: isolated impulse features encoded as patches.

Reference: lib/jxl/enc_dots.cc / enc_detect_dots.{h,cc} — small
high-intensity ellipses are detected, removed from the VarDCT base
image and re-drawn losslessly via the patch dictionary against a
synthesized reference frame. This implementation detects isolated
high-frequency extrema in Y, packs their 5x5 XYB sprites into a sprite
sheet reference frame, and smooths them out of the base image.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.frame.patches import (
    PatchBlendMode, PatchBlending, PatchDictionary, PatchPosition,
    PatchRefPosition,
)

_SPRITE = 5                 # sprite side (pixels)
_MAX_DOTS = 1024


def detect_dots(xyb: np.ndarray, distance: float = 1.0,
                max_dots: int = _MAX_DOTS):
    """Returns (dot_positions [(y, x)...], cleaned_xyb) or (None, xyb).

    A dot is a local Y extremum whose 3x3 neighborhood energy is
    concentrated in the center and which exceeds the masking-scaled
    threshold (enc_detect_dots.cc's interest-point criterion,
    simplified)."""
    y = xyb[1].astype(np.float64)
    h, w = y.shape
    if h < 2 * _SPRITE or w < 2 * _SPRITE:
        return None, xyb
    # High-pass: y - 3x3 box mean (excluding center bias).
    p = np.pad(y, 1, mode="edge")
    box = np.zeros_like(y)
    for dy in range(3):
        for dx in range(3):
            box += p[dy:dy + h, dx:dx + w]
    ring = (box - y) / 8.0
    resid = y - ring
    thresh = 0.12 * max(distance, 0.5)
    cand = np.abs(resid) > thresh
    # Keep only isolated impulses: neighbors must be much weaker.
    r = np.pad(np.abs(resid), 1)
    neigh_max = np.zeros_like(y)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh_max = np.maximum(neigh_max, r[dy:dy + h, dx:dx + w])
    cand &= neigh_max < 0.5 * np.abs(resid)
    # Stay clear of the borders so sprites fit.
    m = _SPRITE // 2
    cand[:m] = cand[-m:] = False
    cand[:, :m] = False
    cand[:, -m:] = False
    ys, xs = np.nonzero(cand)
    if ys.size == 0:
        return None, xyb
    if ys.size > max_dots:
        order = np.argsort(-np.abs(resid[ys, xs]))[:max_dots]
        ys, xs = ys[order], xs[order]
    # Remove the dots from the base image (fill with the ring mean so
    # the smooth background encodes cheaply).
    cleaned = xyb.copy()
    for c in range(3):
        pc = np.pad(xyb[c].astype(np.float64), 1, mode="edge")
        boxc = np.zeros((h, w))
        for dy in range(3):
            for dx in range(3):
                boxc += pc[dy:dy + h, dx:dx + w]
        ringc = (boxc - xyb[c]) / 8.0
        cleaned[c][ys, xs] = ringc[ys, xs]
    return list(zip(ys.tolist(), xs.tolist())), cleaned


def build_dot_sheet(xyb: np.ndarray, dots: list,
                    ) -> tuple[np.ndarray, PatchDictionary]:
    """Packs each dot's 5x5 sprite into a sheet image (the reference
    frame) and returns the patch dictionary that redraws them."""
    n = len(dots)
    cols = min(64, n)
    rows = (n + cols - 1) // cols
    sheet = np.zeros((3, rows * _SPRITE, cols * _SPRITE), np.float32)
    m = _SPRITE // 2
    d = PatchDictionary()
    for i, (py, px) in enumerate(dots):
        ty, tx = divmod(i, cols)
        sheet[:, ty * _SPRITE:(ty + 1) * _SPRITE,
              tx * _SPRITE:(tx + 1) * _SPRITE] = \
            xyb[:, py - m:py + m + 1, px - m:px + m + 1]
        d.ref_positions.append(PatchRefPosition(
            ref=1, x0=tx * _SPRITE, y0=ty * _SPRITE,
            xsize=_SPRITE, ysize=_SPRITE))
        d.positions.append(PatchPosition(px - m, py - m, i))
        d.blendings.append([PatchBlending(PatchBlendMode.REPLACE)])
    return sheet, d
