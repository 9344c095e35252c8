"""Modular encoder heuristics: transform selection (RCT, palette).

Reference: lib/jxl/enc_modular.cc ComputeEncodingData transform ladder
(palette detection via channel color counts, RCT search per effort) and
enc_transforms. Candidate decorrelations are ranked with a vectorized
entropy proxy of clamped-gradient residuals — the same estimate the
reference's EstimateCost performs over sampled pixels.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.modular.codec import Transform, TransformId

# Identity-permutation RCT types: 0=none, 1..5 subtract variants,
# 6=YCoCg (rct.h).
_RCT_CANDIDATES = (0, 1, 2, 3, 4, 5, 6)
_MAX_PALETTE_COLORS = 1024


def _gradient_residual(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    w = np.zeros_like(c)
    w[:, 1:] = c[:, :-1]
    n = np.zeros_like(c)
    n[1:, :] = c[:-1, :]
    n[0, :] = w[0, :]
    nw = np.zeros_like(c)
    nw[1:, 1:] = c[:-1, :-1]
    nw[0] = w[0]
    nw[:, 0] = n[:, 0]
    grad = np.clip(w + n - nw, np.minimum(np.minimum(w, n), nw),
                   np.maximum(np.maximum(w, n), nw))
    return c - grad


def estimate_bits(residual: np.ndarray) -> float:
    """Hybrid-uint-style cost proxy: entropy of the token (bucketed by
    magnitude class) plus the raw mantissa bits."""
    packed = np.abs(residual.ravel()) * 2  # sign bit folded into class
    nbits = np.zeros(packed.shape, np.int64)
    nz = packed > 0
    nbits[nz] = np.int64(np.log2(packed[nz])) + 1
    counts = np.bincount(nbits)
    counts = counts[counts > 0]
    p = counts / counts.sum()
    token_entropy = float(-(p * np.log2(p)).sum()) * residual.size
    raw_bits = float(np.maximum(nbits - 1, 0).sum()) + float(nz.sum())
    return token_entropy + raw_bits


def _rct_channels(chans: list, rct_type: int) -> list:
    """Identity-permutation fwd RCT on raw arrays (enc_rct.cc)."""
    first, snd, thd = (c.astype(np.int64) for c in chans)
    custom = rct_type % 7
    if custom == 0:
        return [first, snd, thd]
    if custom == 6:  # YCoCg
        co = first - thd
        tmp = thd + (co >> 1)
        cg = snd - tmp
        y = tmp + (cg >> 1)
        return [y, co, cg]
    second = custom >> 1
    third = custom & 1
    if second == 1:
        snd = snd - first
    elif second == 2:
        snd = snd - ((first + thd) >> 1)
    if third:
        thd = thd - first
    return [first, snd, thd]


def select_modular_transforms(channels: list, bitdepth: int,
                              ) -> list:
    """Returns the Transform list for a lossless frame: palette when the
    color count is small, otherwise the cheapest RCT candidate."""
    ncolor = len(channels)
    h, w = channels[0].shape
    npix = h * w

    if ncolor >= 3 and all(c.shape == channels[0].shape
                           for c in channels[:3]):
        stacked = np.stack([c.ravel() for c in channels[:3]], axis=1)
        # Cheap pre-check on a sample to avoid a full unique() on
        # clearly continuous-tone images.
        sample = stacked[:: max(1, npix // 4096)]
        if np.unique(sample, axis=0).shape[0] <= _MAX_PALETTE_COLORS:
            nb_colors = np.unique(stacked, axis=0).shape[0]
            if nb_colors <= min(_MAX_PALETTE_COLORS, max(16, npix // 8)):
                return [Transform(id=TransformId.PALETTE, begin_c=0,
                                  num_c=3, nb_colors=int(nb_colors),
                                  nb_deltas=0)]

        best_type, best_cost = 0, None
        for rct_type in _RCT_CANDIDATES:
            try:
                cand = _rct_channels(channels[:3], rct_type)
            except Exception:
                continue
            cost = sum(estimate_bits(_gradient_residual(c)) for c in cand)
            if best_cost is None or cost < best_cost:
                best_type, best_cost = rct_type, cost
        out = []
        if best_type:
            out.append(Transform(id=TransformId.RCT, begin_c=0,
                                 rct_type=best_type))
        # Try stacking squeeze (multi-scale residuals) on top; keep it
        # when the proxy says the residual channels get cheaper.
        # Skip on near-synthetic content (sub-1bpp proxy): the learned
        # MA tree exploits such structure better than squeeze does.
        try:
            if best_cost > 1.0 * npix * 3:
                sq_cost = _squeeze_cost(channels, best_type)
                if sq_cost < best_cost * 0.995:
                    out.append(Transform(id=TransformId.SQUEEZE))
        except Exception:
            pass
        return out
    return []


def _squeeze_cost(channels: list, rct_type: int) -> float:
    from libjxl_tpu_torch.modular import transforms as tx
    from libjxl_tpu_torch.modular.image import ModularImage

    img = ModularImage.from_planes(
        [c.astype(np.int32) for c in channels], 16)
    if rct_type:
        tx.fwd_rct(img, 0, rct_type)
    tx.fwd_squeeze(img, [])
    return sum(estimate_bits(_gradient_residual(ch.data))
               for ch in img.channel if ch.w and ch.h)
