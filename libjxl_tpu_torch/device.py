"""Device resolution, float32 precision settings and the host-feed
staging (``feed_to_torch``).

Every IDCT and colour product runs in full float32: the reference runs
them at ``Precision.HIGHEST`` because TF32 (about three decimal digits)
breaks coefficient exactness. Importing this module turns TF32 off for
matmuls and cuDNN.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_tpu_torch.tpu.feed import big_idct_matrices, family8_matrices
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct.dct import dct_matrix, resample_scales

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA
    is asked for (explicitly or by default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


# Constant tensors per (device, key): the banks are the same for every
# frame, so they cross to the card once.
_CONST_CACHE: dict = {}


def _const(dev: torch.device, key, make):
    k = (str(dev), key)
    t = _CONST_CACHE.get(k)
    if t is None:
        t = make()
        t = tuple(x.to(dev) if torch.is_tensor(x) else x for x in t) \
            if isinstance(t, tuple) else t.to(dev)
        _CONST_CACHE[k] = t
    return t


def _stage(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """One host array -> tensor on ``dev``: through pinned memory and an
    asynchronous copy on the current stream when ``dev`` is a card."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _prune_mat_ids(mat_ids: np.ndarray):
    """Remap 8x8-family bank slots to the slots the frame uses, so the
    masked select runs one matmul per USED slot (reference
    tpu/pipeline.py:537-545). Returns (used_slots, pruned ids int8)."""
    mi = np.maximum(np.asarray(mat_ids), 0)
    used = tuple(int(s) for s in np.unique(mi))
    lut = np.zeros(max(used) + 1, np.int8)
    for i, s in enumerate(used):
        lut[s] = i
    return used, lut[mi]


def feed_to_torch(feed: dict, device) -> dict:
    """The numpy host feed (as either package's ``parse_to_feed`` gives
    it) plus the constant banks -> a dict of tensors on ``device``.

    Keys: ``coeff_nz`` (int32 flat indices, int16 values) or
    ``coeff_img`` (int16, or int32 after an overflow redo),
    ``coeff_shape``, ``mat_ids`` (int64, pruned), ``mat_bank`` (S, 64, 64), ``tables8`` (S, 3, 64), ``raw_quant``
    (int32), ``dc``, ``fx``, ``fb``, ``inv_sigma``, ``biases``,
    ``inv_gs``, ``qmul``, ``big_tables``, ``class_consts`` and either
    ``class_masks`` (dense aligned-tile path) or ``classes`` (gather
    path), plus the host metadata ``image_hw``, ``BW_blocks``, ``lf``.
    """
    dev = resolve_device(device)
    used, mat_ids = _prune_mat_ids(feed["mat_ids"])
    class_keys = tuple(sorted(feed["classes"].keys()))
    masks = feed.get("class_masks")
    dense = masks is not None and set(masks) == set(class_keys)
    t = {
        "image_hw": tuple(int(v) for v in feed["image_hw"]),
        "BW_blocks": int(feed["mat_ids"].shape[1]),
        "coeff_shape": tuple(feed["coeff_img"].shape),
        "lf": feed["lf"],
        "mat_ids": _stage(mat_ids, dev).long(),
        "mat_bank": _const(dev, ("bank", used), lambda: torch.from_numpy(
            np.ascontiguousarray(family8_matrices()[list(used)]))),
        "tables8": _stage(np.asarray(feed["tables8"])[list(used)], dev,
                          np.float32),
        "raw_quant": _stage(feed["raw_quant"], dev, np.int32),
        "dc": _stage(feed["dc"], dev, np.float32),
        "fx": _stage(feed["fx"], dev, np.float32),
        "fb": _stage(feed["fb"], dev, np.float32),
        "inv_sigma": _stage(feed["inv_sigma"], dev, np.float32),
        "biases": _stage(feed["biases"], dev, np.float32),
        "inv_gs": _stage(np.float32(feed["inv_gs"]).reshape(()), dev),
        "qmul": _stage(feed["qmul"], dev, np.float32),
        "big_tables": {k: _stage(feed["big_tables"][k], dev, np.float32)
                       for k in class_keys},
        "class_consts": {k: _const(dev, ("class", k),
                                   lambda k=k: _class_tensors(*k))
                         for k in class_keys},
    }
    nz = feed.get("coeff_nz")
    if nz is not None:
        t["coeff_nz"] = (_stage(nz[0], dev, np.int32),
                         _stage(nz[1], dev, np.int16))
    else:
        t["coeff_img"] = _stage(feed["coeff_img"], dev)
    if dense:
        t["class_masks"] = {k: _stage(masks[k], dev).bool()
                            for k in class_keys}
    else:
        t["classes"] = {k: (_stage(feed["classes"][k][0], dev).long(),
                            _stage(feed["classes"][k][1], dev,
                                   np.float32))
                        for k in class_keys}
    return t


def patch_affine_to_torch(ka, device):
    """The patch fold (K, A) of ``frame.patches.patch_affine``, two
    (3, H, W) float32 planes, on ``device``: staged like the feed's
    arrays (pinned, asynchronous), once per frame. None stays None."""
    if ka is None:
        return None
    dev = resolve_device(device)
    return tuple(_stage(a, dev, np.float32) for a in ka)


def feeds_to_torch(feeds: list, device) -> dict:
    """N host feeds of one coefficient shape, all sparse and on the dense
    class-mask path, -> one dict of tensors on ``device`` with a leading
    batch axis (the batched decode's staging; the caller checks those
    preconditions). Each array is stacked on the host and crosses in one
    pinned copy. The 8x8-family bank is pruned to the union of the
    frames' used slots. A frame that lacks a big-block class gets an
    all-False mask and a zero table for it. The sparse indices are
    offset by frame, so one scatter-add fills the (N, 3, H8, W8) image.

    Keys as ``feed_to_torch`` (``class_masks``, never ``classes``), each
    with a leading N, plus ``coeff_shape`` (N, 3, H8, W8); ``lf``,
    ``image_hw`` and ``BW_blocks`` are the first frame's."""
    dev = resolve_device(device)
    f0 = feeds[0]
    n = len(feeds)
    cshape = tuple(f0["coeff_img"].shape)
    used, mat_ids = _prune_mat_ids(np.stack([f["mat_ids"] for f in feeds]))
    class_keys = tuple(sorted({k for f in feeds
                               for k in (f.get("class_masks") or {})}))
    bh, bw = f0["mat_ids"].shape

    def stack(key, dtype):
        return _stage(np.stack([np.asarray(f[key], dtype) for f in feeds]),
                      dev)

    def class_stack(k):
        tbh, tbw = -(-bh // k[0]), -(-bw // k[1])
        tables = np.zeros((n, 3, k[0] * k[1] * 64), np.float32)
        masks = np.zeros((n, tbh, tbw), np.bool_)
        for i, f in enumerate(feeds):
            if k in (f.get("class_masks") or {}):
                tables[i] = f["big_tables"][k]
                masks[i] = f["class_masks"][k]
        return _stage(tables, dev), _stage(masks, dev)

    numel = int(np.prod(cshape))
    nzi = np.concatenate([f["coeff_nz"][0].astype(np.int64) + i * numel
                          for i, f in enumerate(feeds)])
    nzv = np.concatenate([f["coeff_nz"][1] for f in feeds])
    big = {k: class_stack(k) for k in class_keys}
    return {
        "image_hw": tuple(int(v) for v in f0["image_hw"]),
        "BW_blocks": int(bw),
        "coeff_shape": (n,) + cshape,
        "coeff_nz": (_stage(nzi, dev), _stage(nzv, dev, np.int16)),
        "lf": f0["lf"],
        "mat_ids": _stage(mat_ids, dev).long(),
        "mat_bank": _const(dev, ("bank", used), lambda: torch.from_numpy(
            np.ascontiguousarray(family8_matrices()[list(used)]))),
        "tables8": _stage(np.stack([np.asarray(f["tables8"])[list(used)]
                                    for f in feeds]), dev, np.float32),
        "raw_quant": stack("raw_quant", np.int32),
        "dc": stack("dc", np.float32),
        "fx": stack("fx", np.float32),
        "fb": stack("fb", np.float32),
        "inv_sigma": stack("inv_sigma", np.float32),
        "biases": stack("biases", np.float32),
        "inv_gs": _stage(np.array([f["inv_gs"] for f in feeds],
                                  np.float32), dev),
        "qmul": stack("qmul", np.float32),
        "big_tables": {k: v[0] for k, v in big.items()},
        "class_masks": {k: v[1] for k, v in big.items()},
        "class_consts": {k: _const(dev, ("class", k),
                                   lambda k=k: _class_tensors(*k))
                         for k in class_keys},
    }


def _class_tensors(cy: int, cx: int):
    """Static per-class constants of the big-block LLF and IDCT: (ly, lx,
    mcy, mcx, sy, sx, ih, iw) as in the reference pipeline."""
    ly, lx = acs.coefficient_layout(cy, cx)
    one = np.ones((1, 1), np.float32)
    mcy = dct_matrix(cy).astype(np.float32) if cy > 1 else one
    mcx = dct_matrix(cx).astype(np.float32) if cx > 1 else one
    sy = resample_scales(cy, cy * 8).astype(np.float32)
    sx = resample_scales(cx, cx * 8).astype(np.float32)
    ih, iw = big_idct_matrices(cy, cx)
    return (ly, lx) + tuple(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (mcy, mcx, sy, sx, ih, iw))
