"""SSIMULACRA2 perceptual metric.

Reference: tools/ssimulacra2.cc (537 LoC) — 6-scale XYB multi-scale
SSIM' with ringing/blur edge maps and a tuned 108-weight sum. Ported
with the same constants, including the reference's recursive Gaussian
(tools/gauss_blur.cc CreateRecursiveGaussian/FastGaussian1D: the
three-pole cosine-modulated IIR approximation of Charalampidis 2016,
sigma 1.5, zero-pad boundary) — NOT a true Gaussian, so matching it
exactly matters for score parity with the reference binary.

Copy of libjxl_tpu/metrics/ssimulacra2.py with imports rewritten to the
port: host numpy over the port's ``color/xyb.py``, as in the reference.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.color.xyb import linear_rgb_to_xyb, srgb_to_linear
from libjxl_tpu_torch.metrics.ssimulacra2_weights import WEIGHTS

_C2 = 0.0009
_NUM_SCALES = 6


def _rg_constants(sigma: float = 1.5):
    """gauss_blur.cc:433 CreateRecursiveGaussian — solve for the
    three-pole IIR weights in double, store float32 like the
    reference's RecursiveGaussian struct."""
    radius = round(3.2795 * sigma + 0.2546)              # (57), "N"
    pi_div_2r = np.pi / (2.0 * radius)
    omega = np.array([pi_div_2r, 3.0 * pi_div_2r, 5.0 * pi_div_2r])
    p = np.array([+1.0 / np.tan(0.5 * omega[0]),         # (37)
                  -1.0 / np.tan(0.5 * omega[1]),
                  +1.0 / np.tan(0.5 * omega[2])])
    r = np.array([+p[0] * p[0] / np.sin(omega[0]),       # (44)
                  -p[1] * p[1] / np.sin(omega[1]),
                  +p[2] * p[2] / np.sin(omega[2])])
    neg_half_sigma2 = -0.5 * sigma * sigma
    rho = np.exp(neg_half_sigma2 * omega * omega) / radius   # (50)
    d_13 = p[0] * r[1] - r[0] * p[1]
    d_35 = p[1] * r[2] - r[1] * p[2]
    d_51 = p[2] * r[0] - r[2] * p[0]
    zeta_15 = d_35 / d_13                                # (52)
    zeta_35 = d_51 / d_13
    a = np.array([[p[0], p[1], p[2]],
                  [r[0], r[1], r[2]],
                  [zeta_15, zeta_35, 1.0]])
    gamma = np.array([1.0, radius * radius - sigma * sigma,  # (55)
                      zeta_15 * rho[0] + zeta_35 * rho[1] + rho[2]])
    beta = np.linalg.inv(a) @ gamma                      # (53)
    n2 = -beta * np.cos(omega * (radius + 1.0))          # (33)
    d1 = -2.0 * np.cos(omega)                            # (33)
    return int(radius), n2.astype(np.float32), d1.astype(np.float32)


_RG = _rg_constants()


def _fast_gaussian_1d(rows: np.ndarray) -> np.ndarray:
    """FastGaussian1D (gauss_blur.cc:46) along the last axis of a
    float32 (R, X) batch: out[n] = sum_k y_k[n] with
    y_k[n] = n2_k*(in[n-N-1] + in[n+N-1]) - d1_k*y_k[n-1] - y_k[n-2],
    zero-padded input, warm-up from n = -N+1."""
    n_r, n2, d1 = _RG
    rows = np.ascontiguousarray(rows, np.float32)
    nrows, xsize = rows.shape
    out = np.empty((nrows, xsize), np.float32)
    prev = np.zeros((3, nrows), np.float32)
    prev2 = np.zeros((3, nrows), np.float32)
    zero = np.zeros(nrows, np.float32)
    n2c = n2[:, None]
    d1c = d1[:, None]
    for n in range(-n_r + 1, xsize):
        left = n - n_r - 1
        right = n + n_r - 1
        lv = rows[:, left] if left >= 0 else zero
        rv = rows[:, right] if right < xsize else zero
        y = n2c * (lv + rv)[None, :] - d1c * prev - prev2
        prev2 = prev
        prev = y
        if n >= 0:
            out[:, n] = y[0] + y[1] + y[2]
    return out


def _blur(img3: np.ndarray) -> np.ndarray:
    """FastGaussian (gauss_blur.cc:528): horizontal then vertical IIR
    pass, all three planes batched."""
    c, h, w = img3.shape
    hpass = _fast_gaussian_1d(img3.reshape(c * h, w)).reshape(c, h, w)
    t = hpass.transpose(0, 2, 1).reshape(c * w, h)
    vpass = _fast_gaussian_1d(t).reshape(c, w, h).transpose(0, 2, 1)
    return np.ascontiguousarray(vpass)


def _downsample2(img3: np.ndarray) -> np.ndarray:
    c, h, w = img3.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    pad = np.pad(img3, ((0, 0), (0, oh * 2 - h), (0, ow * 2 - w)),
                 mode="edge")
    return pad.reshape(c, oh, 2, ow, 2).mean(axis=(2, 4))


def _positive_xyb(xyb: np.ndarray) -> np.ndarray:
    x, y, b = xyb
    return np.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55])


def _quartic(v):
    v2 = v * v
    return v2 * v2


def _ssim_map(mu1, mu2, s11, s22, s12) -> np.ndarray:
    out = np.zeros(6)
    n = mu1[0].size
    for c in range(3):
        m1, m2 = mu1[c], mu2[c]
        # float32 intermediates, double accumulation — the reference's
        # exact promotion pattern (ssimulacra2.cc:143-180).
        num_m = np.float32(1.0) - (m1 - m2) ** 2
        num_s = np.float32(2) * (s12[c] - m1 * m2) + np.float32(_C2)
        denom_s = (s11[c] - m1 * m1) + (s22[c] - m2 * m2) + np.float32(_C2)
        d = np.maximum(
            1.0 - (num_s / denom_s * num_m).astype(np.float64), 0.0)
        out[c * 2] = d.sum() / n
        out[c * 2 + 1] = (np.sum(_quartic(d)) / n) ** 0.25
    return out


def _edge_diff_map(img1, mu1, img2, mu2) -> np.ndarray:
    out = np.zeros(12)
    n = img1[0].size
    for c in range(3):
        # |.| in float32, the ratio in double (ssimulacra2.cc:196-200).
        d1 = (1.0 + np.abs(img2[c] - mu2[c]).astype(np.float64)) \
            / (1.0 + np.abs(img1[c] - mu1[c]).astype(np.float64)) - 1.0
        artifact = np.maximum(d1, 0.0)
        detail_lost = np.maximum(-d1, 0.0)
        out[c * 4] = artifact.sum() / n
        out[c * 4 + 1] = (np.sum(_quartic(artifact)) / n) ** 0.25
        out[c * 4 + 2] = detail_lost.sum() / n
        out[c * 4 + 3] = (np.sum(_quartic(detail_lost)) / n) ** 0.25
    return out


def ssimulacra2(orig: np.ndarray, dist: np.ndarray) -> float:
    """Score in (-inf, 100]; ~90 visually lossless, <50 low quality.

    orig/dist: (H, W, 3) uint8/float sRGB."""
    def prep(im):
        im = np.asarray(im)
        if im.dtype == np.uint8:
            im = im.astype(np.float32) / 255.0
        elif im.dtype == np.uint16:
            im = im.astype(np.float32) / 65535.0
        return srgb_to_linear(im.transpose(2, 0, 1))

    lin1, lin2 = prep(orig), prep(dist)
    scores = []
    for scale in range(_NUM_SCALES):
        if lin1.shape[1] < 8 or lin1.shape[2] < 8:
            break
        if scale:
            lin1 = _downsample2(lin1)
            lin2 = _downsample2(lin2)
        # float32 planes end-to-end like the reference's Image3F.
        img1 = _positive_xyb(linear_rgb_to_xyb(lin1).astype(np.float32))
        img2 = _positive_xyb(linear_rgb_to_xyb(lin2).astype(np.float32))
        mu1 = _blur(img1)
        mu2 = _blur(img2)
        s11 = _blur(img1 * img1)
        s22 = _blur(img2 * img2)
        s12 = _blur(img1 * img2)
        avg_ssim = _ssim_map(mu1, mu2, s11, s22, s12)
        avg_edge = _edge_diff_map(img1, mu1, img2, mu2)
        scores.append((avg_ssim, avg_edge))

    ssim = 0.0
    i = 0
    # NOTE: like the reference, the weight index advances only over
    # scales that actually ran (ssimulacra2.cc:412-444).
    for c in range(3):
        for (avg_ssim, avg_edge) in scores:
            for n in range(2):
                ssim += WEIGHTS[i] * abs(avg_ssim[c * 2 + n]); i += 1
                ssim += WEIGHTS[i] * abs(avg_edge[c * 4 + n]); i += 1
                ssim += WEIGHTS[i] * abs(avg_edge[c * 4 + n + 2]); i += 1
    ssim *= 0.9562382616834844
    ssim = (2.326765642916932 * ssim - 0.020884521182843837 * ssim * ssim
            + 6.248496625763138e-05 * ssim ** 3)
    if ssim > 0:
        return float(100.0 - 10.0 * ssim ** 0.6276336467831387)
    return 100.0
