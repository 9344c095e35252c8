"""Noise synthesis (film-grain) — parameters, RNG, and application.

Reference: lib/jxl/noise.h (NoiseParams, 8-point LUT at 1024 precision),
dec_noise.cc (DecodeNoise, Xorshift128Plus-seeded random planes per
group), render_pipeline/stage_noise.cc (5x5 Laplacian convolution +
AddNoise stage), xorshift128plus-inl.h (8-lane generator seeded via
SplitMix64). The convolution and strength application are vectorized
over whole planes; the per-group RNG stream layout matches the
reference's batch structure exactly.
"""

from __future__ import annotations

import numpy as np

NOISE_PRECISION = 1024.0
NUM_NOISE_POINTS = 8
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def decode_noise(r) -> np.ndarray:
    """DecodeNoise: 8 x 10-bit LUT values / 1024."""
    return np.array([r.read(10) / NOISE_PRECISION
                     for _ in range(NUM_NOISE_POINTS)], np.float32)


def encode_noise(lut: np.ndarray, w) -> None:
    for v in lut:
        q = int(np.clip(round(float(v) * NOISE_PRECISION), 0, 1023))
        w.write(10, q)


class Xorshift128Plus:
    """8 independent xorshift128+ generators (xorshift128plus-inl.h)."""

    N = 8

    def __init__(self, seed1: int, seed2: int, seed3: int, seed4: int):
        def split_mix(z: np.uint64) -> np.uint64:
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z &= _MASK
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            z &= _MASK
            return z ^ (z >> np.uint64(31))

        golden = np.uint64(0x9E3779B97F4A7C15)
        s0 = np.zeros(self.N, np.uint64)
        s1 = np.zeros(self.N, np.uint64)
        with np.errstate(over="ignore"):
            s0[0] = split_mix(
                (np.uint64((seed1 << 32) + seed2) + golden) & _MASK)
            s1[0] = split_mix(
                (np.uint64((seed3 << 32) + seed4) + golden) & _MASK)
            for i in range(1, self.N):
                s0[i] = split_mix(s0[i - 1])
                s1[i] = split_mix(s1[i - 1])
        self.s0 = s0
        self.s1 = s1

    def fill(self) -> np.ndarray:
        """Returns 16 uint32 of random bits (one batch)."""
        a, b = self.s0, self.s1
        with np.errstate(over="ignore"):
            bits = (a + b) & _MASK
            self.s0 = b
            t = (a ^ ((a << np.uint64(23)) & _MASK))
            self.s1 = t ^ b ^ (t >> np.uint64(18)) ^ (b >> np.uint64(5))
        return bits.view(np.uint32)  # little-endian: low word first


def _bits_to_float(u32: np.ndarray) -> np.ndarray:
    # 1.0 + 23 random mantissa bits => [1, 2)
    return ((u32 >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)


def _random_plane_rows(rng: Xorshift128Plus, xsize: int, ysize: int,
                       ) -> np.ndarray:
    """RandomImage: per-row batches of 16 floats; the tail row segment
    always consumes a fresh batch (dec_noise.cc:48-76)."""
    out = np.empty((ysize, xsize), np.float32)
    batch = 2 * Xorshift128Plus.N  # 16 floats per Fill
    # Full batches while x + batch <= xsize, then ONE unconditional
    # remainder Fill — even when the row is an exact multiple of the
    # batch, a batch is consumed and discarded (libjxl 0.7 RandomImage;
    # verified against system-libjxl noise fields).
    n_full = xsize // batch
    for y in range(ysize):
        x = 0
        for _ in range(n_full):
            out[y, x:x + batch] = _bits_to_float(rng.fill())
            x += batch
        tail = _bits_to_float(rng.fill())
        if x < xsize:
            out[y, x:] = tail[:xsize - x]
    return out


def synthesize_noise_planes(h: int, w: int, group_dim: int,
                            visible_frame_index: int = 1,
                            nonvisible_frame_index: int = 0) -> np.ndarray:
    """Generates the 3 raw noise planes for the whole (possibly
    upsampled) frame, seeding one RNG per group_dim tile
    (dec_noise.cc PrepareNoiseInput/Random3Planes; the upsampling
    sub-tile loop produces the same seed grid)."""
    planes = np.empty((3, h, w), np.float32)
    gd = group_dim
    for gy in range((h + gd - 1) // gd):
        for gx in range((w + gd - 1) // gd):
            x0, y0 = gx * gd, gy * gd
            rw, rh = min(gd, w - x0), min(gd, h - y0)
            rng = Xorshift128Plus(visible_frame_index,
                                  nonvisible_frame_index, x0, y0)
            for c in range(3):
                planes[c, y0:y0 + rh, x0:x0 + rw] = \
                    _random_plane_rows(rng, rw, rh)
    return planes


def synthesize_noise_rows(y_lo: int, y_hi: int, h_total: int, w: int,
                          group_dim: int, visible_frame_index: int = 1,
                          nonvisible_frame_index: int = 0) -> np.ndarray:
    """Rows [y_lo, y_hi) of the frame noise planes, bit-identical to
    the corresponding slice of synthesize_noise_planes(h_total, w):
    tiles are seeded by absolute origin and filled whole (the RNG
    stream is consumed tile-sequentially), then sliced."""
    gd = group_dim
    out = np.empty((3, y_hi - y_lo, w), np.float32)
    for gy in range(y_lo // gd, (y_hi - 1) // gd + 1):
        ty0 = gy * gd
        rh = min(gd, h_total - ty0)
        tile = np.empty((3, rh, w), np.float32)
        for gx in range((w + gd - 1) // gd):
            x0 = gx * gd
            rw = min(gd, w - x0)
            rng = Xorshift128Plus(visible_frame_index,
                                  nonvisible_frame_index, x0, ty0)
            for c in range(3):
                tile[c, :, x0:x0 + rw] = _random_plane_rows(rng, rw, rh)
        s0 = max(y_lo - ty0, 0)
        s1 = min(y_hi - ty0, rh)
        out[:, ty0 + s0 - y_lo:ty0 + s1 - y_lo] = tile[:, s0:s1]
    return out


def add_noise_band(xyb_band: np.ndarray, y_off: int, lut: np.ndarray,
                   cmap, fd, visible_frame_index: int = 1) -> np.ndarray:
    """Band-windowed add_noise: applies the frame's noise field rows
    [y_off, y_off + band_h) to a (3, band_h, W) band in place —
    bit-identical to slicing a whole-frame add_noise (the laplacian's
    2-row support comes from real neighbor noise rows, not the band
    edge)."""
    H, W = fd.ysize_upsampled, fd.xsize_upsampled
    h = min(xyb_band.shape[1], H - y_off)
    w = min(xyb_band.shape[2], W)
    if h <= 0:
        return xyb_band
    if (h, w) != (xyb_band.shape[1], xyb_band.shape[2]):
        inner = add_noise_band(
            np.ascontiguousarray(xyb_band[:, :h, :w]), y_off, lut, cmap,
            fd, visible_frame_index)
        xyb_band[:, :h, :w] = inner
        return xyb_band
    e_lo = max(0, y_off - 2)
    e_hi = min(H, y_off + h + 2)
    raw = synthesize_noise_rows(e_lo, e_hi, H, w, fd.group_dim,
                                visible_frame_index)
    rnd = np.stack([_convolve_laplacian(p) for p in raw])
    rnd = rnd[:, y_off - e_lo:y_off - e_lo + h]
    _apply_noise_formula(xyb_band, rnd, lut, cmap)
    return xyb_band


def _convolve_laplacian(plane: np.ndarray) -> np.ndarray:
    """ConvolveNoiseStage: 4*(1 - 5x5 box) with symmetric borders."""
    p = np.pad(plane, 2, mode="symmetric").astype(np.float32)
    h, w = plane.shape
    acc = np.zeros((h, w), np.float32)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            acc += p[dy:dy + h, dx:dx + w]
    return acc * 0.16 + plane * -3.84


def _strength_lut(lut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """StrengthEvalLut + Clamp0ToMax(., 1)."""
    scale = NUM_NOISE_POINTS - 2
    sx = np.maximum(0.0, x * scale)
    fx = np.floor(sx)
    frac = sx - fx
    over = sx >= scale + 1
    fx = np.where(over, scale, fx).astype(np.int32)
    frac = np.where(over, 1.0, frac)
    low = lut[fx]
    hi = lut[fx + 1]
    return np.clip(low + (hi - low) * frac, 0.0, 1.0)


def add_noise(xyb: np.ndarray, lut: np.ndarray, cmap, fd,
              visible_frame_index: int = 1) -> np.ndarray:
    """Applies synthesized noise to (3, H, W) XYB in place
    (stage_noise.cc AddNoiseStage).

    Noise planes span the image (upsampled) area, NOT the padded
    buffer — the pipeline rects are clipped to xsize/ysize_upsampled
    (low_memory_render_pipeline.cc:461-468)."""
    h = min(xyb.shape[1], fd.ysize_upsampled)
    w = min(xyb.shape[2], fd.xsize_upsampled)
    if (h, w) != (xyb.shape[1], xyb.shape[2]):
        inner = add_noise(np.ascontiguousarray(xyb[:, :h, :w]), lut, cmap,
                          fd, visible_frame_index)
        xyb[:, :h, :w] = inner
        return xyb
    raw = synthesize_noise_planes(h, w, fd.group_dim, visible_frame_index)
    rnd = np.stack([_convolve_laplacian(p) for p in raw])
    _apply_noise_formula(xyb, rnd, lut, cmap)
    return xyb


def _apply_noise_formula(xyb: np.ndarray, rnd: np.ndarray,
                         lut: np.ndarray, cmap) -> None:
    """Pixelwise noise mix (stage_noise.cc AddNoiseRow), shared by the
    whole-frame and band paths."""
    norm_const = np.float32(0.22)
    k_rg_corr = np.float32(0.9921875)
    k_rgn_corr = np.float32(0.0078125)
    vx, vy = xyb[0], xyb[1]
    in_g = vy - vx
    in_r = vy + vx
    strength_g = _strength_lut(lut, in_g * 0.5)
    strength_r = _strength_lut(lut, in_r * 0.5)
    nr = rnd[0] * norm_const
    ng = rnd[1] * norm_const
    nc = rnd[2] * norm_const
    red_noise = strength_r * (k_rgn_corr * nr + k_rg_corr * nc)
    green_noise = strength_g * (k_rgn_corr * ng + k_rg_corr * nc)
    rg_noise = red_noise + green_noise
    ytox = cmap.base_correlation_x
    ytob = cmap.base_correlation_b
    xyb[0] += ytox * rg_noise + (red_noise - green_noise)
    xyb[1] += rg_noise
    xyb[2] += ytob * rg_noise


def estimate_noise(xyb: np.ndarray) -> np.ndarray | None:
    """Estimates an 8-point noise LUT from the image (enc_noise.cc
    GetNoiseParameter's role, simplified): per-intensity-bucket robust
    std of the high-pass Y residual over non-edge pixels, scaled so
    re-synthesized grain matches the measured amplitude (the 0.494
    calibration is the Y-std produced by a unit LUT).

    Returns None when the image carries no measurable grain."""
    y = xyb[1].astype(np.float64)
    hp = _convolve_laplacian(y.astype(np.float32)).astype(np.float64) / 3.84
    gy, gx = np.gradient(y)
    grad = np.hypot(gy, gx)
    flat = grad < np.quantile(grad, 0.5)
    intensity = np.clip(y * (NUM_NOISE_POINTS - 2), 0,
                        NUM_NOISE_POINTS - 1).astype(np.int32)
    lut = np.zeros(NUM_NOISE_POINTS, np.float32)
    seen = 0
    for b in range(NUM_NOISE_POINTS):
        sel = flat & (intensity == b)
        if sel.sum() < 256:
            continue
        # Robust sigma via median absolute deviation.
        r = hp[sel]
        sigma = 1.4826 * np.median(np.abs(r - np.median(r)))
        lut[b] = sigma / 0.494
        seen += 1
    if seen == 0 or lut.max() < 0.01:
        return None
    # Fill unobserved buckets from their neighbors.
    for b in range(NUM_NOISE_POINTS):
        if lut[b] == 0:
            nz = lut[lut > 0]
            lut[b] = nz.mean() if nz.size else 0.0
    return np.clip(lut, 0.0, 1.0)


def simulate_photon_noise(xsize: int, ysize: int, iso: float) -> np.ndarray:
    """ISO/sensor model -> 8-point noise LUT
    (enc_photon_noise.cc SimulatePhotonNoise)."""
    from libjxl_tpu_torch.color.constants import OPSIN_ABSORBANCE_BIAS
    k_photons_per_lxs_per_um2 = 11260.0
    k_quantum_efficiency = 0.20
    k_prnu = 0.005
    k_read_noise = 3.0
    k_sensor_area_um2 = 36000.0 * 24000.0
    k_noise_lut_max = 1023.4999 / NOISE_PRECISION

    bias = float(OPSIN_ABSORBANCE_BIAS[1])
    bias_cbrt = np.cbrt(bias)
    h_18 = 10.0 / iso
    pixel_area = k_sensor_area_um2 / (xsize * ysize)
    electrons_18 = (k_quantum_efficiency * k_photons_per_lxs_per_um2
                    * h_18 * pixel_area)
    lut = np.zeros(NUM_NOISE_POINTS, np.float32)
    for i in range(NUM_NOISE_POINTS):
        scaled = i / (NUM_NOISE_POINTS - 2.0)
        y = 2.0 * scaled
        linear = max(0.0, (y - bias_cbrt) ** 3 + bias)
        electrons = electrons_18 * (linear / 0.18)
        noise = np.sqrt(k_read_noise ** 2 + electrons
                        + (k_prnu * electrons) ** 2)
        linear_noise = noise * (0.18 / electrons_18)
        opsin_derivative = (1.0 / 3.0) / np.cbrt(linear - bias) ** 2
        opsin_noise = linear_noise * opsin_derivative
        lut[i] = np.clip(opsin_noise / (0.22 * np.sqrt(2.0) * 1.13),
                         0.0, k_noise_lut_max)
    return lut
