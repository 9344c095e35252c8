"""Render-pipeline post stages in plain PyTorch: learned upsampling,
noise synthesis, spline strokes, spot colours and frame blending.

Port of libjxl_tpu/ops/stages_tpu.py (the reference's post stages are
XLA, not Pallas kernels, so they stay plain PyTorch here):
- upsampling (render_pipeline/stage_upsampling.cc): per-phase 5x5
  kernels, each output clamped to the min and max of its 5x5 source
  window, symmetric borders;
- noise (stage_noise.cc): the raw xorshift128+ planes depend only on
  the frame shape, the group size and the frame index, never on the
  pixels (dec_noise.cc Random3Planes), so they are made once per shape
  on the host and cached; the 5x5 Laplacian, the strength LUT and the
  chroma-correlated add run on the device;
- splines (splines.cc DrawSegment): the stroke geometry is walked on the
  host (``spline_stroke_params``), and every arc sample is drawn as a
  (2R+1)^2 erf splat scatter-added into the frame with ``index_add_``.
  On a card the adds land in no fixed order, so two runs may differ by
  float rounding;
- spot colours (stage_spot.cc) and frame blending (blending.cc
  PerformBlending), as ``render_spot_tpu`` and ``blend_frame_tpu`` run
  them: element-wise work on tensors of the caller's device.

Every post stage takes a (3, H, W) float32 tensor and returns a new one;
``blend_frame`` takes (H, W, 3) canvases, as the reference's does.
Products run in full float32 (``libjxl_tpu_torch.device`` turns TF32
off); none of these stages uses a convolution.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from libjxl_tpu_torch.ops.filters import pad_symmetric

# ---------------------------------------------------------------------------
# Learned 2x/4x/8x upsampling


def _windows(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (25, H, W): the 5x5 neighbourhood of every pixel, row
    by row, with symmetric borders."""
    h, w = plane.shape
    p = pad_symmetric(plane, 2)
    return torch.stack([p[dy:dy + h, dx:dx + w]
                        for dy in range(5) for dx in range(5)])


def upsample_plane(plane: torch.Tensor, n: int,
                   kernels: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H*n, W*n); ``kernels`` (n, n, 5, 5) float32
    (pipeline/upsample._kernels). Per-phase 5x5 dot products, each
    clamped to its source window's min and max."""
    h, w = plane.shape
    flat = _windows(plane)
    mins = flat.amin(dim=0)
    maxs = flat.amax(dim=0)
    k = kernels.reshape(n * n, 25).to(plane)
    phases = torch.matmul(k, flat.reshape(25, h * w)).reshape(n * n, h, w)
    phases = torch.minimum(torch.maximum(phases, mins[None]), maxs[None])
    return phases.reshape(n, n, h, w).permute(2, 0, 3, 1) \
        .reshape(h * n, w * n)


def upsample_image(planes: torch.Tensor, n: int,
                   kernels: torch.Tensor) -> torch.Tensor:
    """(3, H, W) -> (3, H*n, W*n), one plane at a time (the 25 windows
    of one 1080p plane take 207 MB)."""
    return torch.stack([upsample_plane(planes[c], n, kernels)
                        for c in range(planes.shape[0])])


# ---------------------------------------------------------------------------
# Noise synthesis


@functools.lru_cache(maxsize=8)
def _cached_noise_planes(h: int, w: int, group_dim: int,
                         visible_frame_index: int) -> np.ndarray:
    from libjxl_tpu_torch.frame.noise import synthesize_noise_planes
    return synthesize_noise_planes(h, w, group_dim, visible_frame_index)


def noise_planes_for(h: int, w: int, group_dim: int,
                     visible_frame_index: int = 1) -> np.ndarray:
    """Content-independent raw noise planes (3, h, w) float32, made on
    the host once per shape (lru cache)."""
    return _cached_noise_planes(h, w, group_dim, visible_frame_index)


def laplacian5(plane: torch.Tensor) -> torch.Tensor:
    """ConvolveNoiseStage: 0.16 * (5x5 sum - centre) - 3.84 * centre,
    symmetric borders; the 24 neighbours are added row by row."""
    h, w = plane.shape
    p = pad_symmetric(plane, 2)
    acc = torch.zeros_like(plane)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            acc = acc + p[dy:dy + h, dx:dx + w]
    return acc * 0.16 + plane * -3.84


def strength_lut(lut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear noise strength of intensity ``x`` from the
    8-point ``lut``, clamped to [0, 1]."""
    n_points = lut.shape[0]
    scale = n_points - 2
    sx = torch.clamp_min(x * scale, 0.0)
    fx = torch.floor(sx)
    frac = sx - fx
    over = sx >= scale + 1
    fx = torch.where(over, float(scale), fx).to(torch.int64)
    frac = torch.where(over, 1.0, frac)
    lo = lut[fx]
    hi = lut[torch.clamp_max(fx + 1, n_points - 1)]
    v = lo * (1.0 - frac) + hi * frac
    return torch.clamp(v, 0.0, 1.0)


def add_noise(xyb: torch.Tensor, raw_planes: torch.Tensor,
              lut: torch.Tensor, ytox: float, ytob: float) -> torch.Tensor:
    """AddNoiseStage: xyb (3, H, W), raw_planes (3, H, W) random fields
    on the same device, lut (8,) strength curve."""
    rnd = [laplacian5(raw_planes[c]) for c in range(3)]
    norm_const = 0.22
    k_rg_corr = 0.9921875
    k_rgn_corr = 0.0078125
    vx, vy = xyb[0], xyb[1]
    strength_g = strength_lut(lut, (vy - vx) * 0.5)
    strength_r = strength_lut(lut, (vy + vx) * 0.5)
    nr = rnd[0] * norm_const
    ng = rnd[1] * norm_const
    nc = rnd[2] * norm_const
    red_noise = strength_r * (k_rgn_corr * nr + k_rg_corr * nc)
    green_noise = strength_g * (k_rgn_corr * ng + k_rg_corr * nc)
    rg_noise = red_noise + green_noise
    return torch.stack([
        xyb[0] + ytox * rg_noise + (red_noise - green_noise),
        xyb[1] + rg_noise,
        xyb[2] + ytob * rg_noise,
    ])


# ---------------------------------------------------------------------------
# Spline strokes (after upsampling and patches, before noise)

SPLINE_R = 48   # largest splat radius drawn on the device


def spline_stroke_params(splines, cmap):
    """Host geometry walk of render_splines (Catmull-Rom -> equally
    spaced arc samples -> per-sample colour and sigma), without drawing.
    Returns (cy, cx, sigma, intensity, color3) float32 arrays padded to
    a power of two of at least 64 samples (zero intensity draws
    nothing), or None when a splat's radius exceeds ``SPLINE_R``."""
    from libjxl_tpu_torch.base.errors import BitstreamError
    from libjxl_tpu_torch.frame import splines as SP

    y_to_x = cmap.base_correlation_x
    y_to_b = cmap.base_correlation_b
    rows = []
    for qs, start in zip(splines.splines, splines.starting_points):
        cps, color_dct, sigma_dct = SP._dequantize(
            qs, start, splines.quantization_adjustment, y_to_x, y_to_b)
        if len(cps) > 1 and any(a == b for a, b in zip(cps, cps[1:])):
            raise BitstreamError(
                "identical successive spline control points")
        dense = SP._catmull_rom(cps)
        arc_length = (len(dense) - 2) * SP.DESIRED_RENDERING_DISTANCE
        pts = SP._equally_spaced(dense)
        inv_arc = 1.0 / arc_length if arc_length > 0 else 0.0
        for k, (pt, mult) in enumerate(pts):
            progress = min(1.0, k * SP.DESIRED_RENDERING_DISTANCE
                           * inv_arc)
            t31 = 31.0 * progress
            color = np.array([SP._continuous_idct(color_dct[c], t31)
                              for c in range(3)])
            sigma = SP._continuous_idct(sigma_dct, t31)
            if not (np.isfinite(sigma) and sigma != 0.0
                    and np.isfinite(mult)):
                continue
            max_color = max(0.01, float(np.max(np.abs(color * mult))))
            arg = -2.0 * sigma * sigma * (math.log(0.1) * 5
                                          - math.log(max_color))
            if arg <= 0:
                continue
            if math.sqrt(arg) > SPLINE_R:
                return None
            rows.append((pt[1], pt[0], sigma, mult, color))
    n = len(rows)
    cap = max(64, 1 << (n - 1).bit_length()) if n else 64
    cy = np.zeros(cap, np.float32)
    cx = np.zeros(cap, np.float32)
    sig = np.ones(cap, np.float32)
    inten = np.zeros(cap, np.float32)
    col = np.zeros((cap, 3), np.float32)
    for i, (a, b, c_, d, e) in enumerate(rows):
        cy[i], cx[i], sig[i], inten[i] = a, b, c_, d
        col[i] = e
    return cy, cx, sig, inten, col


def render_splines(xyb: torch.Tensor, cy, cx, sig, inten,
                   col) -> torch.Tensor:
    """Additive erf-profile strokes: every sample drawn as a
    (2R+1)^2 splat, scatter-added into a copy of the frame; samples of
    zero intensity add nothing."""
    R = SPLINE_R
    _, h, w = xyb.shape
    dev = xyb.device
    n = cy.shape[0]
    ar = torch.arange(2 * R + 1, device=dev)
    y0 = torch.clamp(torch.round(cy).to(torch.int64) - R, -2 * R, h)
    x0 = torch.clamp(torch.round(cx).to(torch.int64) - R, -2 * R, w)
    yy = y0[:, None] + ar[None, :]
    xx = x0[:, None] + ar[None, :]
    dy = yy.to(torch.float32) - cy[:, None]
    dx = xx.to(torch.float32) - cx[:, None]
    dist = torch.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2)
    inv_sigma = (1.0 / sig)[:, None, None]
    c = 0.353553391
    factor = torch.erf((dist * 0.5 + c) * inv_sigma) \
        - torch.erf((dist * 0.5 - c) * inv_sigma)
    local = (0.25 * sig * inten)[:, None, None] * factor * factor
    valid = ((yy[:, :, None] >= 0) & (yy[:, :, None] < h)
             & (xx[:, None, :] >= 0) & (xx[:, None, :] < w))
    lin = (torch.clamp(yy[:, :, None], 0, h - 1) * w
           + torch.clamp(xx[:, None, :], 0, w - 1))
    contrib = torch.where(valid, local, 0.0).reshape(n, -1)
    flat = xyb.reshape(3, h * w).clone()
    flat.index_add_(1, lin.reshape(-1),
                    (col.t()[:, :, None] * contrib[None]).reshape(3, -1))
    return flat.reshape(3, h, w)


# ---------------------------------------------------------------------------
# Spot colours and frame blending (stage_spot.cc, stage_blending.cc /
# blending.cc PerformBlending)


def render_spot(color3: torch.Tensor, mixes: torch.Tensor,
                spot_rgba: torch.Tensor) -> torch.Tensor:
    """Spot-colour mix, one spot channel after the other:
    p = mix * spot_rgb + (1 - mix) * p with mix = s * spot_alpha.
    color3 (3, H, W); mixes (N, H, W) in [0, 1]; spot_rgba (N, 4); all
    float32 on one device."""
    for i in range(mixes.shape[0]):
        mix = mixes[i] * spot_rgba[i, 3]
        color3 = (mix[None] * spot_rgba[i, :3, None, None]
                  + (1.0 - mix)[None] * color3)
    return color3


BLEND_MODES = (0, 1, 2, 3, 4)   # REPLACE, ADD, BLEND, ALPHA_WEIGHTED_ADD, MUL


def blend_frame(canvas: torch.Tensor, canvas_alpha, src, src_alpha,
                mode: int, x0: int, y0: int,
                alpha_is_premultiplied: bool = False):
    """Blend ``src`` (h, w, 3) with alpha ``src_alpha`` (h, w) or None
    onto ``canvas`` (H, W, 3) with alpha ``canvas_alpha`` (H, W) or None,
    at origin (x0, y0). Returns the new (canvas, canvas_alpha) on the
    canvas's device, so an animation's canvas stays there between
    frames; the inputs are not modified. ``src`` and ``src_alpha`` may
    be numpy arrays or tensors. The blit rectangle is clipped on the
    host; a frame entirely outside the canvas returns it unchanged."""
    if int(mode) not in BLEND_MODES:
        raise ValueError(f"unknown blend mode {mode}")
    dev = canvas.device
    h, w = src.shape[0], src.shape[1]
    ch, cw = canvas.shape[0], canvas.shape[1]
    sx0, sy0 = max(0, -x0), max(0, -y0)
    dx0, dy0 = max(0, x0), max(0, y0)
    bw = min(w - sx0, cw - dx0)
    bh = min(h - sy0, ch - dy0)
    if bw <= 0 or bh <= 0:
        return canvas, canvas_alpha

    def on_dev(a):
        a = a[sy0:sy0 + bh, sx0:sx0 + bw]
        if torch.is_tensor(a):
            return a.to(dev, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    s = on_dev(src)
    has_sa = src_alpha is not None
    has_da = canvas_alpha is not None
    win = (slice(dy0, dy0 + bh), slice(dx0, dx0 + bw))
    d = canvas[win]
    da = canvas_alpha[win] if has_da else torch.ones(
        (bh, bw), dtype=torch.float32, device=dev)
    sa = on_dev(src_alpha) if has_sa else torch.ones(
        (bh, bw), dtype=torch.float32, device=dev)
    new_a = da
    mode = int(mode)
    if mode == 0:      # REPLACE
        out = s
        new_a = sa
    elif mode == 1:    # ADD
        out = d + s
        new_a = torch.clamp(da + sa, 0.0, 1.0) if has_sa else da
    elif mode == 4:    # MUL
        out = d * s
    elif mode == 2:    # BLEND
        if alpha_is_premultiplied:
            out = s + d * (1.0 - sa)[..., None]
            new_a = sa + da * (1.0 - sa)
        else:
            new_a = sa + da * (1.0 - sa)
            safe = torch.where(new_a == 0, 1.0, new_a)
            out = (s * sa[..., None]
                   + d * (da * (1.0 - sa))[..., None]) / safe[..., None]
            out = torch.where((new_a == 0)[..., None], 0.0, out)
    else:              # ALPHA_WEIGHTED_ADD
        out = d + s * sa[..., None]
        new_a = torch.clamp(da + sa, 0.0, 1.0) if has_sa else da
    canvas = canvas.clone()
    canvas[win] = out
    if has_da:
        canvas_alpha = canvas_alpha.clone()
        canvas_alpha[win] = new_a
    return canvas, canvas_alpha
