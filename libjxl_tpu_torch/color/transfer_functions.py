"""HDR transfer functions (PQ, HLG) and Rec.2408 tone mapping.

Reference: lib/jxl/cms/transfer_functions.h (TF_PQ_Base/TF_HLG_Base,
sign-mirrored unbounded domains) and cms/tone_mapping.h
(Rec2408ToneMapperBase). Vectorized over numpy arrays.
"""

from __future__ import annotations

import numpy as np

# PQ (SMPTE ST 2084) constants.
_M1 = 2610.0 / 16384
_M2 = (2523.0 / 4096) * 128
_C1 = 3424.0 / 4096
_C2 = (2413.0 / 4096) * 32
_C3 = (2392.0 / 4096) * 32

# HLG (ARIB STD-B67) constants.
_A = 0.17883277
_B = 1 - 4 * _A
_C = 0.5599107295
DEFAULT_INTENSITY_TARGET = 255.0


def pq_display_from_encoded(e: np.ndarray,
                            display_intensity_target: float = 10000.0,
                            ) -> np.ndarray:
    """PQ EOTF: encoded [0,1] -> display linear (normalized so that
    1.0 = display_intensity_target nits)."""
    sign = np.sign(e)
    e = np.abs(np.asarray(e, np.float64))
    xp = e ** (1.0 / _M2)
    num = np.maximum(xp - _C1, 0.0)
    den = _C2 - _C3 * xp
    d = (num / den) ** (1.0 / _M1)
    return sign * d * (10000.0 / display_intensity_target)


def pq_encoded_from_display(d: np.ndarray,
                            display_intensity_target: float = 10000.0,
                            ) -> np.ndarray:
    """PQ inverse EOTF."""
    sign = np.sign(d)
    d = np.abs(np.asarray(d, np.float64))
    xp = (d * (display_intensity_target / 10000.0)) ** _M1
    return sign * ((_C1 + xp * _C2) / (1.0 + xp * _C3)) ** _M2


def hlg_display_from_encoded(e: np.ndarray) -> np.ndarray:
    """HLG inverse OETF (system gamma 1, transfer_functions.h OOTF
    note)."""
    sign = np.sign(e)
    e = np.abs(np.asarray(e, np.float64))
    low = e * e / 3.0
    high = (np.exp((e - _C) / _A) + _B) / 12.0
    return sign * np.where(e <= 0.5, low, high)


def hlg_encoded_from_display(d: np.ndarray) -> np.ndarray:
    """HLG OETF."""
    sign = np.sign(d)
    d = np.abs(np.asarray(d, np.float64))
    low = np.sqrt(3.0 * d)
    with np.errstate(invalid="ignore", divide="ignore"):
        high = _A * np.log(np.maximum(12.0 * d - _B, 1e-30)) + _C
    return sign * np.where(d <= 1.0 / 12.0, low, high)


def rec2408_tone_map(rgb: np.ndarray, *,
                     source_range: tuple = (0.0, 10000.0),
                     target_range: tuple = (0.0, 255.0),
                     primaries_luminances: tuple = (0.2627, 0.6780, 0.0593),
                     ) -> np.ndarray:
    """Rec.2408 HDR->SDR tone mapping on (..., 3) linear RGB scaled so
    1.0 = source_range[1] nits (tone_mapping.h Rec2408ToneMapperBase)."""
    rgb = np.asarray(rgb, np.float64)
    r_y, g_y, b_y = primaries_luminances

    def inv_eotf(lum):
        return pq_encoded_from_display(lum, 10000.0)

    pq_min = float(inv_eotf(source_range[0]))
    pq_max = float(inv_eotf(source_range[1]))
    pq_range = pq_max - pq_min
    min_lum = (float(inv_eotf(target_range[0])) - pq_min) / pq_range
    max_lum = (float(inv_eotf(target_range[1])) - pq_min) / pq_range
    ks = 1.5 * max_lum - 0.5
    inv_one_minus_ks = 1.0 / max(1e-6, 1.0 - ks)

    lum = source_range[1] * (r_y * rgb[..., 0] + g_y * rgb[..., 1]
                             + b_y * rgb[..., 2])
    norm_pq = np.minimum(1.0, (inv_eotf(lum) - pq_min) / pq_range)
    t_b = (norm_pq - ks) * inv_one_minus_ks
    t_b2 = t_b * t_b
    t_b3 = t_b2 * t_b
    p = ((2 * t_b3 - 3 * t_b2 + 1) * ks
         + (t_b3 - 2 * t_b2 + t_b) * (1 - ks)
         + (-2 * t_b3 + 3 * t_b2) * max_lum)
    e2 = np.where(norm_pq < ks, norm_pq, p)
    one_minus_e2 = 1 - e2
    e3 = min_lum * one_minus_e2 ** 4 + e2
    e4 = e3 * pq_range + pq_min
    d4 = pq_display_from_encoded(e4, 10000.0)
    new_lum = np.clip(d4, 0.0, target_range[1])
    ratio = new_lum / np.maximum(lum, 1e-6)
    normalizer = source_range[1] / target_range[1]
    mult = ratio * normalizer
    cap = new_lum / target_range[1]
    use_cap = (lum <= 1e-6)[..., None]
    return np.where(use_cap, np.broadcast_to(cap[..., None], rgb.shape),
                    rgb * mult[..., None])


def hlg_ootf_gamma(intensity_target: float) -> float:
    """Rec.2100 HLG system gamma for a given display peak."""
    return 1.2 * 1.111 ** np.log2(intensity_target / 1000.0)


def hlg_ootf(scene: np.ndarray, gamma: float,
             lums=(0.2627, 0.6780, 0.0593)) -> np.ndarray:
    """HLG OOTF: (3, H, W) scene-light -> display-light
    (cms/tone_mapping-inl.h HlgOOTF / stage_from_linear)."""
    y = lums[0] * scene[0] + lums[1] * scene[1] + lums[2] * scene[2]
    mult = np.maximum(y, 1e-12) ** (gamma - 1.0)
    return scene * mult[None]


def hlg_inverse_ootf(display: np.ndarray, gamma: float,
                     lums=(0.2627, 0.6780, 0.0593)) -> np.ndarray:
    """Inverse HLG OOTF: display-light -> scene-light
    (HlgOOTF::ToSceneLight)."""
    y = lums[0] * display[0] + lums[1] * display[1] + lums[2] * display[2]
    mult = np.maximum(y, 1e-12) ** ((1.0 - gamma) / gamma)
    return display * mult[None]
