"""Loop filters in plain PyTorch: gaborish 3x3 + the three EPF passes.

Port of libjxl_tpu/ops/filters_tpu.py, whole-frame tensors with the
frame re-padded before every stage. This is the plain version that the
CUDA kernel in ops/epf_cuda.py is held against, and the path that a CPU
tensor takes.

Padding is symmetric (the edge pixel repeats: 'abc' -> 'cba|abc|cba'),
done by indexing with mirrored indices; ``F.pad(mode="reflect")`` does
not repeat the edge pixel and would be wrong here.
"""

from __future__ import annotations

import torch

from libjxl_tpu_torch.pipeline.loop_filters import MIN_SIGMA

DEFAULT_GAB_WEIGHTS = ((0.115169525, 0.061248592),) * 3
DEFAULT_CHANNEL_SCALE = (40.0, 5.0, 3.5)

_PLUS = ((0, 0), (-1, 0), (0, -1), (1, 0), (0, 1))
_EPF0_OFFSETS = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                 (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
_CROSS = ((-1, 0), (0, -1), (0, 1), (1, 0))


def mirror_index(n: int, pad: int, device) -> torch.Tensor:
    """Symmetric-extension source index for each position of an axis of
    length n padded by ``pad`` on both sides (period 2n, so any pad)."""
    i = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def pad_symmetric(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes by ``pad`` with edge-repeating reflection."""
    h, w = img.shape[-2:]
    yi = mirror_index(h, pad, img.device)
    xi = mirror_index(w, pad, img.device)
    return img.index_select(-2, yi).index_select(-1, xi)


def gaborish_weights(gab_weights):
    """(w1, w2) per channel -> normalised (w0, w1, w2) per channel."""
    out = []
    for w1, w2 in gab_weights:
        div = 1.0 + 4 * (float(w1) + float(w2))
        out.append((1.0 / div, float(w1) / div, float(w2) / div))
    return out


def gaborish(img: torch.Tensor, gab_weights) -> torch.Tensor:
    """img: (..., 3, H, W); gab_weights: (3, 2) [w1, w2] per channel."""
    outs = []
    for c, (w0, w1, w2) in enumerate(gaborish_weights(gab_weights)):
        p = pad_symmetric(img[..., c, :, :], 1)
        outs.append(p[..., 1:-1, 1:-1] * w0
                    + (p[..., 1:-1, :-2] + p[..., 1:-1, 2:]
                       + p[..., :-2, 1:-1] + p[..., 2:, 1:-1]) * w1
                    + (p[..., :-2, :-2] + p[..., :-2, 2:]
                       + p[..., 2:, :-2] + p[..., 2:, 2:]) * w2)
    return torch.stack(outs, dim=-3)


def _sad_mul(h: int, w: int, sm: float, bsm: float, device):
    """Per-pixel SAD multiplier: ``bsm`` on the first and last row and
    column of each 8x8 block, ``sm`` elsewhere."""
    xb = torch.arange(w, device=device) % 8
    yb = torch.arange(h, device=device) % 8
    xb = (xb == 0) | (xb == 7)
    yb = (yb == 0) | (yb == 7)
    mul = torch.full((h, w), sm, dtype=torch.float32, device=device)
    mul = torch.where(xb[None, :], bsm, mul)
    return torch.where(yb[:, None], bsm, mul)


def _expand_blocks(block_map: torch.Tensor, h: int, w: int):
    e = block_map.repeat_interleave(8, -2).repeat_interleave(8, -1)
    return e[..., :h, :w]


def _channel_sum(x):
    """(x0 + x1) + x2 over the channel axis -3: one fixed order on every
    device (a reduction kernel may pair the terms differently)."""
    return x[..., 0, :, :] + x[..., 1, :, :] + x[..., 2, :, :]


def _epf_pass(img, inv_sigma_blocks, *, pad, plus, cands, sigma_scale,
              border_sad_mul, channel_scale, single_pixel_sad=False):
    """One EPF pass over the whole frame: every candidate is a shifted
    window of the padded frame; the plus-shaped SAD sums the shared
    channel-scaled difference field at five shifts."""
    h, w = img.shape[-2:]
    sm = sigma_scale * 1.65
    blocks = _expand_blocks(inv_sigma_blocks, h, w)
    inv_sigma = blocks * _sad_mul(h, w, sm, sm * border_sad_mul,
                                  img.device)
    skip = blocks < MIN_SIGMA
    p = pad_symmetric(img, pad)
    scales = torch.tensor(channel_scale, dtype=torch.float32,
                          device=img.device)[:, None, None]
    ext = 1 if plus else 0
    acc = img
    wsum = torch.ones((h, w), dtype=torch.float32, device=img.device)
    for sy, sx in cands:
        at_c = p[..., pad + sy:pad + sy + h, pad + sx:pad + sx + w]
        if single_pixel_sad:
            sad = _channel_sum(torch.abs(at_c - img) * scales)
        else:
            base = p[..., pad - ext:pad + ext + h, pad - ext:pad + ext + w]
            offw = p[..., pad - ext + sy:pad + ext + sy + h,
                     pad - ext + sx:pad + ext + sx + w]
            d = _channel_sum(torch.abs(base - offw) * scales)
            sad = d[..., ext + plus[0][0]:ext + plus[0][0] + h,
                    ext + plus[0][1]:ext + plus[0][1] + w]
            for py, px in plus[1:]:
                sad = sad + d[..., ext + py:ext + py + h,
                              ext + px:ext + px + w]
        wgt = torch.clamp_min(sad * inv_sigma + 1.0, 0.0)
        acc = acc + wgt[..., None, :, :] * at_c
        wsum = wsum + wgt
    return torch.where(skip[..., None, :, :], img,
                       acc / wsum[..., None, :, :])


def apply_loop_filters(img, inv_sigma_blocks, *, epf_iters=2, gab=True,
                       gab_weights=DEFAULT_GAB_WEIGHTS,
                       epf_pass0_sigma_scale=0.9,
                       epf_pass2_sigma_scale=6.5,
                       epf_border_sad_mul=2.0 / 3,
                       epf_channel_scale=DEFAULT_CHANNEL_SCALE):
    """Gaborish + EPF chain (stage order dec_cache.cc:150-170).

    img: (3, H, W) or (N, 3, H, W) float32; inv_sigma_blocks:
    (ceil(H/8), ceil(W/8)) 1/sigma per block (compute_sigma_map), or
    (N, ...) with one map per frame. epf_iters/gab select the stages.
    Each frame of a batch is computed as it would be alone."""
    out = img
    if gab:
        out = gaborish(out, gab_weights)
    common = dict(border_sad_mul=epf_border_sad_mul,
                  channel_scale=epf_channel_scale)
    if epf_iters >= 3:
        out = _epf_pass(out, inv_sigma_blocks, pad=3, plus=_PLUS,
                        cands=_EPF0_OFFSETS,
                        sigma_scale=epf_pass0_sigma_scale, **common)
    if epf_iters >= 1:
        out = _epf_pass(out, inv_sigma_blocks, pad=2, plus=_PLUS,
                        cands=_CROSS, sigma_scale=1.0, **common)
    if epf_iters >= 2:
        out = _epf_pass(out, inv_sigma_blocks, pad=1, plus=None,
                        cands=_CROSS, sigma_scale=epf_pass2_sigma_scale,
                        single_pixel_sad=True, **common)
    return out
