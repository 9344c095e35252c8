"""Splines: centripetal Catmull-Rom curves drawn as Gaussian strokes.

Reference: lib/jxl/splines.{h,cc} — QuantizedSpline::Decode/Dequantize,
DecodeAllStartingPoints, DrawCentripetalCatmullRomSpline,
ForEachEquallySpacedPoint, ContinuousIDCT, ComputeSegments/DrawSegment.
Control points are delta-delta coded; color/sigma vary along the curve
via 32-point DCTs; each arc-length-equidistant point is rendered as an
erf-profile stroke, added to the XYB image.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from libjxl_tpu_torch.base.errors import BitstreamError
from libjxl_tpu_torch.base.signed import pack_signed, unpack_signed

# Context numbering (splines.h:35-42).
QUANT_ADJUSTMENT_CTX = 0
STARTING_POSITION_CTX = 1
NUM_SPLINES_CTX = 2
NUM_CONTROL_POINTS_CTX = 3
CONTROL_POINTS_CTX = 4
DCT_CTX = 5
NUM_SPLINE_CONTEXTS = 6

# X, Y, B, sigma (splines.cc kChannelWeight).
CHANNEL_WEIGHT = (0.0042, 0.075, 0.07, 0.3333)
DESIRED_RENDERING_DISTANCE = 1.0
MAX_NUM_CONTROL_POINTS = 1 << 20
SQRT2 = math.sqrt(2.0)
SQRT0_5 = math.sqrt(0.5)
POS_LIMIT = 1 << 23


def adjusted_quant(adjustment: int) -> float:
    return (1.0 + 0.125 * adjustment) if adjustment >= 0 \
        else 1.0 / (1.0 - 0.125 * adjustment)


def inv_adjusted_quant(adjustment: int) -> float:
    return 1.0 / (1.0 + 0.125 * adjustment) if adjustment >= 0 \
        else (1.0 - 0.125 * adjustment)


@dataclasses.dataclass
class QuantizedSpline:
    control_points: list                  # [(ddx, ddy), ...]
    color_dct: np.ndarray                 # (3, 32) int
    sigma_dct: np.ndarray                 # (32,) int


@dataclasses.dataclass
class Splines:
    quantization_adjustment: int = 0
    splines: list = dataclasses.field(default_factory=list)
    starting_points: list = dataclasses.field(default_factory=list)


def decode_splines(br, num_pixels: int) -> Splines:
    """Splines::Decode (splines.cc:600-650)."""
    from libjxl_tpu_torch.entropy.codes import SymbolReader, decode_histograms

    codes = decode_histograms(br, NUM_SPLINE_CONTEXTS)
    dec = SymbolReader(codes, br)
    num_splines = dec.read(NUM_SPLINES_CTX)
    max_cp = min(MAX_NUM_CONTROL_POINTS, num_pixels // 2)
    if num_splines + 1 > max_cp:
        raise BitstreamError("too many splines")
    num_splines += 1

    points = []
    last_x = last_y = 0
    for i in range(num_splines):
        dx = dec.read(STARTING_POSITION_CTX)
        dy = dec.read(STARTING_POSITION_CTX)
        if i != 0:
            x = unpack_signed(dx) + last_x
            y = unpack_signed(dy) + last_y
        else:
            x, y = dx, dy
        if abs(x) >= POS_LIMIT or abs(y) >= POS_LIMIT:
            raise BitstreamError("spline start out of bounds")
        points.append((float(x), float(y)))
        last_x, last_y = x, y

    out = Splines(starting_points=points)
    out.quantization_adjustment = unpack_signed(
        dec.read(QUANT_ADJUSTMENT_CTX))
    total_cp = num_splines
    for _ in range(num_splines):
        n_cp = dec.read(NUM_CONTROL_POINTS_CTX)
        total_cp += n_cp
        if total_cp > max_cp:
            raise BitstreamError("too many control points")
        cps = []
        for _i in range(n_cp):
            ddx = unpack_signed(dec.read(CONTROL_POINTS_CTX))
            ddy = unpack_signed(dec.read(CONTROL_POINTS_CTX))
            if abs(ddx) >= (1 << 30) or abs(ddy) >= (1 << 30):
                raise BitstreamError("spline delta-delta out of bounds")
            cps.append((ddx, ddy))
        color_dct = np.zeros((3, 32), np.int64)
        for c in range(3):
            for i in range(32):
                color_dct[c, i] = unpack_signed(dec.read(DCT_CTX))
        sigma_dct = np.zeros(32, np.int64)
        for i in range(32):
            sigma_dct[i] = unpack_signed(dec.read(DCT_CTX))
        out.splines.append(QuantizedSpline(cps, color_dct, sigma_dct))
    if not dec.check_final_state():
        raise BitstreamError("bad ANS state in splines")
    return out


def encode_splines(s: Splines, w) -> None:
    """enc_splines.cc Encode: token order mirrors decode."""
    from libjxl_tpu_torch.entropy.codes import build_and_encode_histograms, \
        write_tokens

    tokens = []

    def put(ctx, val):
        tokens.append((ctx, int(val)))

    put(NUM_SPLINES_CTX, len(s.splines) - 1)
    last_x = last_y = 0
    for i, (x, y) in enumerate(s.starting_points):
        x, y = int(round(x)), int(round(y))
        if i == 0:
            put(STARTING_POSITION_CTX, x)
            put(STARTING_POSITION_CTX, y)
        else:
            put(STARTING_POSITION_CTX, pack_signed(x - last_x))
            put(STARTING_POSITION_CTX, pack_signed(y - last_y))
        last_x, last_y = x, y
    put(QUANT_ADJUSTMENT_CTX, pack_signed(s.quantization_adjustment))
    for sp in s.splines:
        put(NUM_CONTROL_POINTS_CTX, len(sp.control_points))
        for ddx, ddy in sp.control_points:
            put(CONTROL_POINTS_CTX, pack_signed(ddx))
            put(CONTROL_POINTS_CTX, pack_signed(ddy))
        for c in range(3):
            for i in range(32):
                put(DCT_CTX, pack_signed(int(sp.color_dct[c, i])))
        for i in range(32):
            put(DCT_CTX, pack_signed(int(sp.sigma_dct[i])))

    arrs = (np.array([t[0] for t in tokens], np.int32),
            np.array([t[1] for t in tokens], np.int64))
    codes = build_and_encode_histograms(NUM_SPLINE_CONTEXTS, [arrs], w)
    write_tokens(arrs, codes, w)


def quantize_spline(control_points: list, color_dct: np.ndarray,
                    sigma_dct: np.ndarray, quantization_adjustment: int,
                    y_to_x: float, y_to_b: float) -> QuantizedSpline:
    """QuantizedSpline::Create (splines.cc:385-437)."""
    cps = []
    px, py = int(round(control_points[0][0])), int(round(control_points[0][1]))
    pdx = pdy = 0
    for (x, y) in control_points[1:]:
        nx, ny = int(round(x)), int(round(y))
        dx, dy = nx - px, ny - py
        cps.append((dx - pdx, dy - pdy))
        pdx, pdy = dx, dy
        px, py = nx, ny
    quant = adjusted_quant(quantization_adjustment)
    inv_quant = inv_adjusted_quant(quantization_adjustment)
    qcolor = np.zeros((3, 32), np.int64)
    for c in (1, 0, 2):
        factor = y_to_x if c == 0 else (0.0 if c == 1 else y_to_b)
        for i in range(32):
            dct_factor = SQRT2 if i == 0 else 1.0
            inv_dct_factor = SQRT0_5 if i == 0 else 1.0
            restored_y = qcolor[1, i] * inv_dct_factor * \
                CHANNEL_WEIGHT[1] * inv_quant
            decorrelated = color_dct[c, i] - factor * restored_y
            qcolor[c, i] = int(round(
                decorrelated * dct_factor * quant / CHANNEL_WEIGHT[c]))
    qsigma = np.zeros(32, np.int64)
    for i in range(32):
        dct_factor = SQRT2 if i == 0 else 1.0
        qsigma[i] = int(round(sigma_dct[i] * dct_factor * quant
                              / CHANNEL_WEIGHT[3]))
    return QuantizedSpline(cps, qcolor, qsigma)


def _dequantize(qs: QuantizedSpline, start: tuple, adjustment: int,
                y_to_x: float, y_to_b: float):
    cps = [(float(round(start[0])), float(round(start[1])))]
    cx, cy = int(round(start[0])), int(round(start[1]))
    dx = dy = 0
    for ddx, ddy in qs.control_points:
        dx += ddx
        dy += ddy
        cx += dx
        cy += dy
        if abs(cx) >= POS_LIMIT or abs(cy) >= POS_LIMIT:
            raise BitstreamError("spline point out of bounds")
        cps.append((float(cx), float(cy)))
    inv_quant = inv_adjusted_quant(adjustment)
    dct_f = np.ones(32)
    dct_f[0] = SQRT0_5
    color = qs.color_dct.astype(np.float64) * dct_f * inv_quant
    color[0] *= CHANNEL_WEIGHT[0]
    color[1] *= CHANNEL_WEIGHT[1]
    color[2] *= CHANNEL_WEIGHT[2]
    color[0] += y_to_x * color[1]
    color[2] += y_to_b * color[1]
    sigma = qs.sigma_dct.astype(np.float64) * dct_f * inv_quant \
        * CHANNEL_WEIGHT[3]
    return cps, color, sigma


def _catmull_rom(points: list) -> list:
    """DrawCentripetalCatmullRomSpline (splines.cc:300-342)."""
    if len(points) == 1:
        return list(points)
    pts = [None] + list(points) + [None]
    p0 = (2 * points[0][0] - points[1][0], 2 * points[0][1] - points[1][1])
    pn = (2 * points[-1][0] - points[-2][0], 2 * points[-1][1] - points[-2][1])
    pts[0], pts[-1] = p0, pn
    n_pts = 16
    result = []
    for start in range(len(pts) - 3):
        p = pts[start:start + 4]
        result.append(p[1])
        d = [0.0] * 3
        t = [0.0] * 4
        for k in range(3):
            d[k] = math.sqrt(math.hypot(p[k + 1][0] - p[k][0],
                                        p[k + 1][1] - p[k][1]))
            t[k + 1] = t[k] + d[k]
        for i in range(1, n_pts):
            tt = d[0] + (i / n_pts) * d[1]
            a = []
            for k in range(3):
                f = (tt - t[k]) / d[k]
                a.append((p[k][0] + f * (p[k + 1][0] - p[k][0]),
                          p[k][1] + f * (p[k + 1][1] - p[k][1])))
            b = []
            for k in range(2):
                f = (tt - t[k]) / (d[k] + d[k + 1])
                b.append((a[k][0] + f * (a[k + 1][0] - a[k][0]),
                          a[k][1] + f * (a[k + 1][1] - a[k][1])))
            f = (tt - t[1]) / d[1]
            result.append((b[0][0] + f * (b[1][0] - b[0][0]),
                           b[0][1] + f * (b[1][1] - b[0][1])))
    result.append(pts[-2])
    return result


def _equally_spaced(points: list) -> list:
    """ForEachEquallySpacedPoint: (point, multiplier) pairs."""
    out = [(points[0], DESIRED_RENDERING_DISTANCE)]
    current = points[0]
    i = 0
    while True:
        previous = current
        arc = 0.0
        while True:
            if i >= len(points):
                out.append((previous, arc))
                return out
            nxt = points[i]
            seg = math.hypot(nxt[0] - previous[0], nxt[1] - previous[1])
            if arc + seg >= DESIRED_RENDERING_DISTANCE:
                f = (DESIRED_RENDERING_DISTANCE - arc) / seg
                current = (previous[0] + f * (nxt[0] - previous[0]),
                           previous[1] + f * (nxt[1] - previous[1]))
                out.append((current, DESIRED_RENDERING_DISTANCE))
                break
            arc += seg
            previous = nxt
            i += 1


_IDCT_MULT = np.pi / 32 * np.arange(32)


def _continuous_idct(dct: np.ndarray, t: float) -> float:
    return float(np.sum(SQRT2 * dct * np.cos(_IDCT_MULT * (t + 0.5))))


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7)."""
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-x * x))


def render_splines(s: Splines, xyb: np.ndarray, cmap,
                   sign: float = 1.0, y_off: int = 0) -> None:
    """Draws every spline additively onto (3, H, W) XYB in place
    (InitializeDrawCache + DrawSegment). y_off renders the window of
    frame rows [y_off, y_off + H) into the given band (the low-memory
    pipeline's per-band spline stage). Row coordinates stay ABSOLUTE in
    the stroke arithmetic (only the destination index shifts), so band
    renders are bit-identical to the whole-frame result — shifting the
    center first would change float rounding on boundary pixels."""
    _, h, w = xyb.shape
    y_to_x = cmap.base_correlation_x
    y_to_b = cmap.base_correlation_b
    for qs, start in zip(s.splines, s.starting_points):
        cps, color_dct, sigma_dct = _dequantize(
            qs, start, s.quantization_adjustment, y_to_x, y_to_b)
        if len(cps) > 1 and any(a == b for a, b in zip(cps, cps[1:])):
            raise BitstreamError("identical successive spline control points")
        dense = _catmull_rom(cps)
        arc_length = (len(dense) - 2) * DESIRED_RENDERING_DISTANCE
        pts = _equally_spaced(dense)
        inv_arc = 1.0 / arc_length if arc_length > 0 else 0.0
        for k, (pt, mult) in enumerate(pts):
            progress = min(1.0, k * DESIRED_RENDERING_DISTANCE * inv_arc)
            t31 = 31.0 * progress
            color = np.array([_continuous_idct(color_dct[c], t31)
                              for c in range(3)])
            sigma = _continuous_idct(sigma_dct, t31)
            _draw_stroke(xyb, pt, mult * sign, color, sigma, h, w,
                         y_off=y_off)


def _draw_stroke(xyb, center, intensity, color, sigma, h, w,
                 y_off: int = 0):
    """ComputeSegments + DrawSegment (erf-profile circular stroke).
    With y_off, rows [y_off, y_off + h) of the frame render into
    xyb[:, 0:h] using absolute-coordinate arithmetic."""
    if not (np.isfinite(sigma) and sigma != 0.0 and np.isfinite(intensity)):
        return
    max_color = max(0.01, float(np.max(np.abs(color * intensity))))
    arg = -2.0 * sigma * sigma * (math.log(0.1) * 5 - math.log(max_color))
    if arg <= 0:
        return
    max_dist = math.sqrt(arg)
    cx, cy = center
    y0 = max(y_off, int(round(cy - max_dist)))
    y1 = min(y_off + h, int(round(cy + max_dist)) + 1)
    x0 = max(0, int(round(cx - max_dist)))
    x1 = min(w, int(round(cx + max_dist)) + 1)
    if y1 <= y0 or x1 <= x0:
        return
    ys = np.arange(y0, y1, dtype=np.float32) - cy
    xs = np.arange(x0, x1, dtype=np.float32) - cx
    dist = np.sqrt(ys[:, None] ** 2 + xs[None, :] ** 2)
    inv_sigma = 1.0 / sigma
    one_over_2s2 = 0.353553391
    factor = _erf((dist * 0.5 + one_over_2s2) * inv_sigma) \
        - _erf((dist * 0.5 - one_over_2s2) * inv_sigma)
    local = (0.25 * sigma * intensity) * factor * factor
    for c in range(3):
        xyb[c, y0 - y_off:y1 - y_off, x0:x1] += color[c] * local
