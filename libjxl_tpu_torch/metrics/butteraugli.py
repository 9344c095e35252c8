"""Butteraugli: psychovisual distance between two sRGB images.

Reference: lib/jxl/butteraugli/butteraugli.{h,cc} — OpsinDynamicsImage,
SeparateFrequencies (LF/MF/HF/UHF), Malta directional edge diffs,
masking (CombineChannelsForMasking/Mask/FuzzyErosion), and
CombineChannelsToDiffmap; multi-resolution combine via SubSample2x +
AddSupersampled2x (ButteraugliInterfaceInPlace). Fully vectorized with
numpy; every constant matches the reference.
"""

from __future__ import annotations

import math

import numpy as np

# --- weights (butteraugli.cc:60-76) ---
_W_MF_MALTA = 37.0819870399
_NORM1_MF = 130262059.556
_W_MF_MALTA_X = 8246.75321353
_NORM1_MF_X = 1009002.70582
_W_HF_MALTA = 18.7237414387
_NORM1_HF = 4498534.45232
_W_HF_MALTA_X = 6923.99476109
_NORM1_HF_X = 8051.15833247
_W_UHF_MALTA = 1.10039032555
_NORM1_UHF = 71.7800275169
_W_UHF_MALTA_X = 173.5
_NORM1_UHF_X = 5.0
_WMUL = (400.0, 1.50815703118, 0.0,
         2150.0, 10.6195433239, 16.2176043152,
         29.2353797994, 0.844626970982, 0.703646627719)

_GLOBAL_SCALE = 1.0 / (17.83 * 0.79079917404)


_BLUR_NORM_CACHE: dict = {}


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian blur with border renormalization (ComputeKernel +
    ConvolutionWithTranspose border handling). The border
    normalization term depends only on (shape, sigma), so it is cached;
    the separable convolution itself runs through scipy when present."""
    m = 2.25
    diff = max(1, int(m * abs(sigma)))
    scaler = -1.0 / (2.0 * sigma * sigma)
    k = np.exp(scaler * np.arange(-diff, diff + 1) ** 2).astype(np.float64)

    try:
        from scipy.ndimage import correlate1d

        def raw(a, axis):
            return correlate1d(a, k, axis=axis, mode="constant", cval=0.0)
    except ImportError:
        def raw(a, axis):
            pad = [(0, 0), (0, 0)]
            pad[axis] = (diff, diff)
            ap = np.pad(a, pad)
            out = np.zeros_like(a, np.float64)
            for i, w in enumerate(k):
                sl = [slice(None), slice(None)]
                sl[axis] = slice(i, i + a.shape[axis])
                out += w * ap[tuple(sl)]
            return out

    key = (img.shape, round(float(sigma), 9))
    norm = _BLUR_NORM_CACHE.get(key)
    if norm is None:
        ones = np.ones(img.shape, np.float64)
        norm = raw(raw(ones, 0), 1)
        if len(_BLUR_NORM_CACHE) > 64:
            _BLUR_NORM_CACHE.clear()
        _BLUR_NORM_CACHE[key] = norm

    return raw(raw(img.astype(np.float64), 0), 1) / norm


def _gamma(v: np.ndarray) -> np.ndarray:
    v = np.maximum(v, 0.0)
    return 19.245013259874995 * np.log(v + 9.9710635769299145) \
        - 23.16046239805755


def _opsin_absorbance(r, g, b, clamp: bool):
    mix = (0.29956550340058319, 0.63373087833825936, 0.077705617820981968,
           1.7557483643287353, 0.22158691104574774, 0.69391388044116142,
           0.0987313588422, 1.7557483643287353, 0.02, 0.02,
           0.20480129041026129, 12.226454707163354)
    o0 = mix[0] * r + mix[1] * g + mix[2] * b + mix[3]
    o1 = mix[4] * r + mix[5] * g + mix[6] * b + mix[7]
    o2 = mix[8] * r + mix[9] * g + mix[10] * b + mix[11]
    if clamp:
        o0 = np.maximum(o0, mix[3])
        o1 = np.maximum(o1, mix[7])
        o2 = np.maximum(o2, mix[11])
    return o0, o1, o2


def _opsin_dynamics(rgb: np.ndarray, intensity_target: float) -> np.ndarray:
    """(3, H, W) linear RGB -> butteraugli XYB (OpsinDynamicsImage)."""
    it = intensity_target
    blurred = [_blur(rgb[c], 1.2) for c in range(3)]
    pm0, pm1, pm2 = _opsin_absorbance(blurred[0] * it, blurred[1] * it,
                                      blurred[2] * it, True)
    sens = []
    for pm in (pm0, pm1, pm2):
        pm = np.maximum(pm, 1e-4)
        sens.append(np.maximum(_gamma(pm) / pm, 1e-4))
    c0, c1, c2 = _opsin_absorbance(rgb[0] * it, rgb[1] * it, rgb[2] * it,
                                   False)
    c0 = np.maximum(c0 * sens[0], 1.7557483643287353)
    c1 = np.maximum(c1 * sens[1], 1.7557483643287353)
    c2 = np.maximum(c2 * sens[2], 12.226454707163354)
    return np.stack([c0 - c1, c0 + c1, c2])


def _remove_range(x, w):
    return np.where(x > w, x - w, np.where(x < -w, x + w, 0.0))


def _amplify_range(x, w):
    return np.where(x > w, x + w, np.where(x < -w, x - w, 2.0 * x))


def _maximum_clamp(v, maxval):
    k = 0.724216145665
    return np.where(v >= maxval, (v - maxval) * k + maxval,
                    np.where(v < -maxval, (v + maxval) * k - maxval, v))


def _xyb_lf_to_vals(lf: np.ndarray) -> np.ndarray:
    xmul, ymul, bmul = 33.832837186260, 14.458268100570, 49.87984651440
    y_to_b = -0.362267051518
    out = np.empty_like(lf)
    out[2] = (y_to_b * lf[1] + lf[2]) * bmul
    out[0] = lf[0] * xmul
    out[1] = lf[1] * ymul
    return out


def _separate_frequencies_exact(xyb: np.ndarray):
    lf = np.stack([_blur(xyb[c], 7.15593339443) for c in range(3)])
    mf = xyb - lf
    lf = _xyb_lf_to_vals(lf)

    hf = [None, None]
    for i in range(2):
        pre = mf[i].copy()
        mf[i] = _blur(mf[i], 3.22489901262)
        hf[i] = pre - mf[i]
        if i == 0:
            mf[i] = _remove_range(mf[i], 0.29)
        else:
            mf[i] = _amplify_range(mf[i], 0.1)
    mf[2] = _blur(mf[2], 3.22489901262)
    suppress, s = 46.0, 0.653020556257
    scaler = (suppress / (hf[1] * hf[1] + suppress)) * (1.0 - s) + s
    hf[0] = hf[0] * scaler

    uhf = [None, None]
    for i in range(2):
        pre = hf[i].copy()
        hf[i] = _blur(hf[i], 1.56416327805)
        if i == 0:
            uhf[0] = pre - hf[0]
            hf[0] = _remove_range(hf[0], 1.5)
            uhf[0] = _remove_range(uhf[0], 0.04)
        else:
            hf[1] = _maximum_clamp(hf[1], 28.4691806922)
            uhf[1] = _maximum_clamp(pre - hf[1], 5.19175294647)
            uhf[1] = uhf[1] * 2.69313763794
            hf[1] = _amplify_range(hf[1] * 2.155, 0.132)
    return lf, mf, hf, uhf


# --- Malta kernels as (dy, dx) offset tuples ---
_MALTA_LF = (
    ((0, -4), (0, -2), (0, 0), (0, 2), (0, 4)),
    ((-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0)),
    ((-3, -3), (-2, -2), (0, 0), (2, 2), (3, 3)),
    ((-3, 3), (-2, 2), (0, 0), (2, -2), (3, -3)),
    ((-4, 1), (-2, 1), (0, 0), (2, -1), (4, -1)),
    ((-4, -1), (-2, -1), (0, 0), (2, 1), (4, 1)),
    ((-1, -4), (-1, -2), (0, 0), (1, 2), (1, 4)),
    ((1, -4), (1, -2), (0, 0), (-1, 2), (-1, 4)),
    ((-3, -2), (-2, -1), (0, 0), (2, 1), (3, 2)),
    ((-3, 2), (-2, 1), (0, 0), (2, -1), (3, -2)),
    ((-2, -3), (-1, -2), (0, 0), (1, 2), (2, 3)),
    ((-2, 3), (-1, 2), (0, 0), (1, -2), (2, -3)),
    ((2, -4), (1, -2), (0, 0), (-1, 2), (-2, 4)),
    ((-2, -4), (-1, -2), (0, 0), (1, 2), (2, 4)),
    ((-4, -2), (-2, -1), (0, 0), (2, 1), (4, 2)),
    ((-4, 2), (-2, 1), (0, 0), (2, -1), (4, -2)),
)

_MALTA_HF = (
    ((0, -4), (0, -3), (0, -2), (0, -1), (0, 0), (0, 1), (0, 2), (0, 3),
     (0, 4)),
    ((-4, 0), (-3, 0), (-2, 0), (-1, 0), (0, 0), (1, 0), (2, 0), (3, 0),
     (4, 0)),
    ((-3, -3), (-2, -2), (-1, -1), (0, 0), (1, 1), (2, 2), (3, 3)),
    ((-3, 3), (-2, 2), (-1, 1), (0, 0), (1, -1), (2, -2), (3, -3)),
    ((-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1),
     (4, -1)),
    ((-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1),
     (4, 1)),
    ((-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3),
     (1, 4)),
    ((1, -4), (1, -3), (1, -2), (0, -1), (0, 0), (0, 1), (-1, 2), (-1, 3),
     (-1, 4)),
    ((-3, -2), (-2, -1), (-1, -1), (0, 0), (1, 1), (2, 1), (3, 2)),
    ((-3, 2), (-2, 1), (-1, 1), (0, 0), (1, -1), (2, -1), (3, -2)),
    ((-2, -3), (-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2), (2, 3)),
    ((-2, 3), (-1, 2), (-1, 1), (0, 0), (1, -1), (1, -2), (2, -3)),
    ((1, -4), (1, -3), (1, -2), (0, -1), (0, 0), (0, 1), (-1, 2), (-1, 3),
     (-1, 4)),
    ((-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3),
     (1, 4)),
    ((-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1),
     (4, 1)),
    ((-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1),
     (4, -1)),
)


def _malta_convolve(diffs: np.ndarray, kernels) -> np.ndarray:
    """Sum over kernels of (line sum)^2, zero padding at borders
    (MaltaUnit / PaddedMaltaUnit)."""
    h, w = diffs.shape
    p = np.pad(diffs, 4)
    out = np.zeros((h, w), np.float64)
    for kern in kernels:
        acc = np.zeros((h, w), np.float64)
        for (dy, dx) in kern:
            acc += p[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
        out += acc * acc
    return out


def _malta_diff_map(lum0, lum1, w_0gt1, w_0lt1, norm1, mulli, kernels,
                    block_diff_ac):
    """MaltaDiffMapT (butteraugli.cc:988-1086)."""
    len_ = 3.75
    w_pre0gt1 = mulli * math.sqrt(0.5 * w_0gt1) / (len_ * 2 + 1)
    w_pre0lt1 = mulli * math.sqrt(0.33 * w_0lt1) / (len_ * 2 + 1)
    norm2_0gt1 = w_pre0gt1 * norm1
    norm2_0lt1 = w_pre0lt1 * norm1

    absval = 0.5 * (np.abs(lum0) + np.abs(lum1))
    diff = lum0 - lum1
    scaler = norm2_0gt1 / (norm1 + absval)
    diffs = scaler * diff
    scaler2 = norm2_0lt1 / (norm1 + absval)
    fabs0 = np.abs(lum0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    neg = lum0 < 0
    impact_neg = np.where(
        lum1 > -too_small, scaler2 * (lum1 + too_small),
        np.where(lum1 < -too_big, -(scaler2 * (-lum1 - too_big)), 0.0))
    impact_pos = np.where(
        lum1 < too_small, scaler2 * (too_small - lum1),
        np.where(lum1 > too_big, -(scaler2 * (lum1 - too_big)), 0.0))
    diffs = diffs + np.where(neg, -impact_neg, impact_pos)
    block_diff_ac += _malta_convolve(diffs, kernels)


def _fuzzy_erosion(from_: np.ndarray) -> np.ndarray:
    """FuzzyErosion: weighted 3 smallest of the 9-point +/x ring at
    step 3 (butteraugli.cc:1190-1228)."""
    h, w = from_.shape
    step = 3
    vals = [from_]
    big = np.float64(np.inf)

    def shifted(dy, dx):
        out = np.full((h, w), big)
        ys = slice(max(0, dy), min(h, h + dy))
        yd = slice(max(0, -dy), min(h, h - dy))
        xs = slice(max(0, dx), min(w, w + dx))
        xd = slice(max(0, -dx), min(w, w - dx))
        out[yd, xd] = from_[ys, xs]
        return out

    for dy in (-step, 0, step):
        for dx in (-step, 0, step):
            if dy == 0 and dx == 0:
                continue
            vals.append(shifted(dy, dx))
    # min0 from all; min1/min2 seeded at 2*center like the reference.
    # Partition along the LAST axis (contiguous) — an axis-0 partition
    # of the (11, H, W) stack strides across whole planes per compare
    # and dominated effort-8 encode time.
    center = from_
    seeded = np.stack(vals + [2 * center, 2 * center], axis=-1)
    part = np.partition(seeded, 2, axis=-1)
    min0, min1, min2 = part[..., 0], part[..., 1], part[..., 2]
    return 0.45 * min0 + 0.3 * min1 + 0.25 * min2


def _mask(mask0, mask1, diff_ac):
    """Mask (butteraugli.cc:1230-1266): returns mask; adds to diff_ac."""
    k_mul, k_bias, k_radius = 6.19424080439, 12.61050594197, 2.7

    def diff_precompute(a):
        bias = k_mul * k_bias
        return np.sqrt(k_mul * np.abs(a) + bias) - math.sqrt(bias)

    d0 = diff_precompute(mask0)
    d1 = diff_precompute(mask1)
    blurred0 = _blur(d0, k_radius)
    mask = _fuzzy_erosion(blurred0)
    blurred1 = _blur(d1, k_radius)
    db = blurred0 - blurred1
    diff_ac += 10.0 * db * db
    return mask


def _mask_y(delta):
    c = 2.5485944793 / ((0.451936922203 * delta) + 0.829591754942)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _mask_dc_y(delta):
    c = 0.505054525019 / ((3.87449418804 * delta) + 0.20025578522)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def butteraugli_diffmap(rgb0: np.ndarray, rgb1: np.ndarray, *,
                        hf_asymmetry: float = 0.8, xmul: float = 1.0,
                        intensity_target: float = 80.0) -> np.ndarray:
    """(3, H, W) linear RGB pair -> diffmap (ButteraugliDiffmapInPlace)."""
    xyb0 = _opsin_dynamics(rgb0, intensity_target)
    xyb1 = _opsin_dynamics(rgb1, intensity_target)

    lf0, mf0, hf0, uhf0 = _separate_frequencies_exact(xyb0)
    lf1, mf1, hf1, uhf1 = _separate_frequencies_exact(xyb1)
    h, w = rgb0.shape[1:]

    block_diff_dc = np.zeros((h, w), np.float64)
    for c in range(3):
        d = lf0[c] - lf1[c]
        block_diff_dc += _WMUL[6 + c] * d * d

    block_diff_ac = np.zeros((h, w), np.float64)
    _malta_diff_map(mf0[1], mf1[1], _W_MF_MALTA, _W_MF_MALTA, _NORM1_MF,
                    0.611612573796, _MALTA_LF, block_diff_ac)
    _malta_diff_map(mf0[0], mf1[0], _W_MF_MALTA_X, _W_MF_MALTA_X,
                    _NORM1_MF_X, 0.611612573796, _MALTA_LF, block_diff_ac)
    for c in range(3):
        d = mf0[c] - mf1[c]
        block_diff_ac += _WMUL[3 + c] * d * d

    fa = hf_asymmetry
    _malta_diff_map(uhf0[1], uhf1[1], _W_UHF_MALTA * fa, _W_UHF_MALTA / fa,
                    _NORM1_UHF, 0.39905817637, _MALTA_HF, block_diff_ac)
    _malta_diff_map(uhf0[0], uhf1[0], _W_UHF_MALTA_X * fa,
                    _W_UHF_MALTA_X / fa, _NORM1_UHF_X, 0.39905817637,
                    _MALTA_HF, block_diff_ac)
    _malta_diff_map(hf0[1], hf1[1], _W_HF_MALTA * math.sqrt(fa),
                    _W_HF_MALTA / math.sqrt(fa), _NORM1_HF,
                    0.611612573796, _MALTA_LF, block_diff_ac)
    _malta_diff_map(hf0[0], hf1[0], _W_HF_MALTA_X * math.sqrt(fa),
                    _W_HF_MALTA_X / math.sqrt(fa), _NORM1_HF_X,
                    0.611612573796, _MALTA_LF, block_diff_ac)

    # L2DiffAsymmetric on hf channels
    for c in range(2):
        w_0gt1 = _WMUL[c] * fa * 0.8
        w_0lt1 = _WMUL[c] / fa * 0.8
        v0, v1 = hf0[c], hf1[c]
        d = v0 - v1
        total = w_0gt1 * d * d
        fabs0 = np.abs(v0)
        too_small = 0.4 * fabs0
        too_big = fabs0
        if_neg = np.where(v1 > -too_small, v1 + too_small,
                          np.where(v1 < -too_big, -v1 - too_big, 0.0))
        if_pos = np.where(v1 < too_small, too_small - v1,
                          np.where(v1 > too_big, v1 - too_big, 0.0))
        vv = np.where(v0 < 0, if_neg, if_pos)
        block_diff_ac += total + w_0lt1 * vv * vv

    # Masking
    def combine_masking(hf, uhf):
        xdiff = (uhf[0] + hf[0]) * 2.5
        ydiff = uhf[1] * 0.4 + hf[1] * 0.4
        return np.sqrt(xdiff * xdiff + ydiff * ydiff)

    mask0 = combine_masking(hf0, uhf0)
    mask1 = combine_masking(hf1, uhf1)
    mask = _mask(mask0, mask1, block_diff_ac)

    return np.sqrt(block_diff_dc * _mask_dc_y(mask)
                   + block_diff_ac * _mask_y(mask))


def _subsample2x(rgb: np.ndarray) -> np.ndarray:
    _, h, w = rgb.shape
    hs, ws = (h + 1) // 2, (w + 1) // 2
    out = np.zeros((3, hs, ws), np.float64)
    np.add.at(out, (slice(None),
                    np.arange(h)[:, None] // 2, np.arange(w)[None, :] // 2),
              0.25 * rgb)
    if w & 1:
        out[:, :, -1] *= 2.0
    if h & 1:
        out[:, -1, :] *= 2.0
    return out


def butteraugli_distance(img0: np.ndarray, img1: np.ndarray, *,
                         hf_asymmetry: float = 0.8,
                         intensity_target: float = 80.0,
                         return_diffmap: bool = False):
    """Butteraugli max-norm distance between two (H, W, 3) sRGB images
    (uint8/uint16 or float [0,1]); ButteraugliInterfaceInPlace."""
    def to_linear(img):
        from libjxl_tpu_torch.color.xyb import srgb_to_linear
        if img.dtype == np.uint8:
            img = img.astype(np.float64) / 255.0
        elif img.dtype == np.uint16:
            img = img.astype(np.float64) / 65535.0
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return srgb_to_linear(img[:, :, :3].astype(np.float32)) \
            .astype(np.float64).transpose(2, 0, 1)

    rgb0 = to_linear(img0)
    rgb1 = to_linear(img1)
    if rgb0.shape != rgb1.shape:
        raise ValueError("image size mismatch")
    _, h, w = rgb0.shape
    if h < 8 or w < 8:
        # Small-image path: pad by replication up to 8x8.
        pad_h, pad_w = max(0, 8 - h), max(0, 8 - w)
        rgb0 = np.pad(rgb0, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        rgb1 = np.pad(rgb1, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        dmap = butteraugli_diffmap(
            rgb0, rgb1, hf_asymmetry=hf_asymmetry,
            intensity_target=intensity_target)[:h, :w]
        return (float(dmap.max()), dmap) if return_diffmap \
            else float(dmap.max())

    dmap = butteraugli_diffmap(rgb0, rgb1, hf_asymmetry=hf_asymmetry,
                               intensity_target=intensity_target)
    if h >= 15 and w >= 15:
        sub = butteraugli_diffmap(
            _subsample2x(rgb0), _subsample2x(rgb1),
            hf_asymmetry=hf_asymmetry, intensity_target=intensity_target)
        wgt = 0.5
        dmap = dmap * (1.0 - 0.3 * wgt)
        dmap = dmap + wgt * sub[
            np.arange(h)[:, None] // 2, np.arange(w)[None, :] // 2]
    score = float(dmap.max())
    return (score, dmap) if return_diffmap else score


def butteraugli_pnorm(diffmap: np.ndarray, p: float = 3.0) -> float:
    """ComputeDistanceP (extras/metrics.cc:42-143): the average of the
    p-, 2p- and 4p-norms of the diffmap."""
    d = diffmap.astype(np.float64)
    n = d.size
    v = 0.0
    for i in range(3):
        q = p * (1 << i)
        v += (np.sum(d ** q) / n) ** (1.0 / q)
    return float(v / 3.0)
