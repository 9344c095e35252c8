"""MA tree learning: greedy CART-style induction over modular properties.

Reference: lib/jxl/modular/encoding/enc_ma.cc (ComputeBestTree — sample
pixels, recursively pick the (property, splitval) cut that minimizes
the summed token-entropy of the best static predictor per side).
This learner is fully vectorized: property planes and per-predictor
residual token classes are precomputed with numpy, split candidates are
property quantiles, and costs come from class histograms.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.modular.predict import (
    P_AVG0, P_GRADIENT, P_LEFT, P_SELECT, P_TOP, P_ZERO,
)
from libjxl_tpu_torch.modular.tree import Tree, TreeNode, leaf

# Properties the learner may split on (vectorizable subset of the 16).
_LEARN_PROPS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)
_PREDICTORS = (P_ZERO, P_LEFT, P_TOP, P_AVG0, P_SELECT, P_GRADIENT)
_MAX_CLASSES = 40
# Cost (bits) of signalling one extra leaf; discourages overfit splits.
_SPLIT_COST = 96.0
# Per-node cap on samples used for the SPLIT SEARCH (histogram costs
# scale with it; the chosen split is then applied to the node's full
# sample set). Mirrors enc_ma.cc's pixel sampling: split quality
# estimates don't need every pixel.
_SEARCH_CAP = 4096


def _shift(c, dy, dx, fill_from=None):
    out = np.empty_like(c)
    if dy > 0:
        out[dy:] = c[:-dy] if dx == 0 else 0
        out[:dy] = 0
    else:
        out[:] = c
    if dx > 0:
        out[:, dx:] = out[:, :-dx].copy() if dy == 0 else out[:, dx:]
    return out


def _neighbor_planes(c: np.ndarray) -> dict:
    """Edge-replicated neighbor planes (context_predict.h:520-535)."""
    c = c.astype(np.int64)
    h, w = c.shape
    west = np.zeros_like(c)
    west[:, 1:] = c[:, :-1]
    west[1:, 0] = c[:-1, 0]          # x==0: left := top
    north = np.zeros_like(c)
    north[1:] = c[:-1]
    north[0] = west[0]
    nw = np.zeros_like(c)
    nw[1:, 1:] = c[:-1, :-1]
    nw[0] = west[0]
    nw[1:, 0] = west[1:, 0]
    ne = np.zeros_like(c)
    ne[1:, :-1] = c[:-1, 1:]
    ne[1:, -1] = north[1:, -1]
    ne[0] = north[0]
    ww = np.zeros_like(c)
    ww[:, 2:] = c[:, :-2]
    ww[:, :2] = west[:, :2]
    nn = np.zeros_like(c)
    nn[2:] = c[:-2]
    nn[:2] = north[:2]
    return {"W": west, "N": north, "NW": nw, "NE": ne, "WW": ww, "NN": nn}


def property_planes(c: np.ndarray, chan_idx: int,
                    stream_id: int = 0) -> dict:
    nb = _neighbor_planes(c)
    west, north, nw, ne = nb["W"], nb["N"], nb["NW"], nb["NE"]
    ww, nn = nb["WW"], nb["NN"]
    grad = west + north - nw
    # props[8] = W - (previous pixel's local gradient); the previous
    # pixel's gradient is grad shifted one to the left (0 at x=0).
    prev_grad = np.zeros_like(grad)
    prev_grad[:, 1:] = grad[:, :-1]
    props = {
        0: np.full(c.shape, chan_idx, np.int64),
        1: np.full(c.shape, stream_id, np.int64),
        2: np.broadcast_to(np.arange(c.shape[0], dtype=np.int64)[:, None],
                           c.shape),
        3: np.broadcast_to(np.arange(c.shape[1], dtype=np.int64)[None, :],
                           c.shape),
        4: np.abs(north),
        5: np.abs(west),
        6: north,
        7: west,
        8: west - prev_grad,
        9: grad,
        10: west - nw,
        11: nw - north,
        12: north - ne,
        13: north - nn,
        14: west - ww,
    }
    return props


def predictor_residuals(c: np.ndarray) -> dict:
    nb = _neighbor_planes(c)
    west, north, nw, ne = nb["W"], nb["N"], nb["NW"], nb["NE"]
    c64 = c.astype(np.int64)
    grad = np.clip(west + north - nw,
                   np.minimum(np.minimum(west, north), nw),
                   np.maximum(np.maximum(west, north), nw))
    select = np.where(np.abs(north - nw) < np.abs(west - nw), west, north)
    return {
        P_ZERO: c64,
        P_LEFT: c64 - west,
        P_TOP: c64 - north,
        # trunc-toward-zero, matching context_predict.h (left+top)/2
        P_AVG0: c64 - (np.sign(west + north)
                       * (np.abs(west + north) >> 1)),
        P_SELECT: c64 - select,
        P_GRADIENT: c64 - grad,
    }


def _token_class(residual: np.ndarray) -> np.ndarray:
    """Hybrid-uint-style magnitude class of the packed residual."""
    packed = np.abs(residual) * 2 - (residual < 0)
    cls = np.zeros(packed.shape, np.uint8)
    nz = packed > 0
    cls[nz] = np.minimum(np.int64(np.log2(packed[nz])) + 1,
                         _MAX_CLASSES - 1)
    return cls


_RAW_BITS = np.maximum(np.arange(_MAX_CLASSES) - 1, 0)


def _cost(class_rows: np.ndarray) -> tuple[float, int]:
    """(bits, best predictor index) for a (npred, n) class matrix.
    One combined bincount covers all predictors at once."""
    k, n = class_rows.shape
    comb = (np.arange(k, dtype=np.int64)[:, None] * _MAX_CLASSES
            + class_rows).ravel()
    counts = np.bincount(comb, minlength=k * _MAX_CLASSES) \
        .reshape(k, _MAX_CLASSES)
    tot = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = np.log2(counts / tot)
    ent = -(counts * np.where(counts > 0, logp, 0.0)).sum(axis=1)
    raw = (_RAW_BITS * counts).sum(axis=1) + counts[:, 1:].sum(axis=1)
    bits = ent + raw
    best_k = int(np.argmin(bits))
    return float(bits[best_k]), best_k


def _wp_residual_classes(c: np.ndarray, stream_id: int
                         ) -> np.ndarray | None:
    """Hybrid-uint classes of the self-correcting weighted predictor's
    residuals, via the native tokenizer with a single-WP-leaf tree (the
    WP state is leaf-independent, so these are the residuals any tree
    using WP at this pixel would code)."""
    try:
        from libjxl_tpu_torch.modular.codec import encode_channels_tokens
        from libjxl_tpu_torch.modular.image import Channel, ModularImage
        from libjxl_tpu_torch.modular.predict import P_WEIGHTED, WPHeader
        img = ModularImage(c.shape[1], c.shape[0], 16, 1)
        img.channel[0] = Channel(np.ascontiguousarray(c, np.int32))
        tree = [leaf(0, P_WEIGHTED)]
        ctx, val = encode_channels_tokens(img, [0], tree, WPHeader(),
                                          stream_id)
    except Exception:
        return None
    packed = np.asarray(val, np.int64)
    cls = np.zeros(packed.shape, np.uint8)
    nz = packed > 0
    cls[nz] = np.minimum(np.int64(np.log2(packed[nz])) + 1,
                         _MAX_CLASSES - 1)
    return cls.reshape(c.shape)


def learn_tree(channels: list, chan_indices: list | None = None,
               max_leaves: int = 64, max_samples: int = 1 << 16,
               stream_ids: list | None = None,
               try_wp: bool = False) -> Tree:
    """Learns an MA tree over the given channel arrays (one per modular
    channel, in stream order). Returns a BFS-serialized tree.

    stream_ids: per-channel modular stream id (property 1), letting one
    global tree specialize per stream kind (DC planes vs AC metadata).
    try_wp: include the self-correcting weighted predictor among the
    leaf-predictor candidates (strong on smooth DC planes)."""
    from libjxl_tpu_torch.modular.predict import P_WEIGHTED
    total_px = sum(c.size for c in channels)
    step = max(1, total_px // max_samples)
    predictors = _PREDICTORS + ((P_WEIGHTED,) if try_wp else ())
    feats = []
    classes = []
    for ci, c in enumerate(channels):
        idx = chan_indices[ci] if chan_indices else ci
        sid = stream_ids[ci] if stream_ids else 0
        if c.size == 0:
            continue
        props = property_planes(c, idx, sid)
        res = predictor_residuals(c)
        # Subsample BEFORE stacking: the stacked full-image feature
        # matrix dominates learn time on megapixel inputs.
        sub = slice(None, None, step)
        f = np.stack([props[p].ravel()[sub] for p in _LEARN_PROPS])
        krows = [_token_class(res[p].ravel()[sub]) for p in _PREDICTORS]
        if try_wp:
            wpc = _wp_residual_classes(c, sid)
            krows.append(wpc.ravel()[sub] if wpc is not None
                         else krows[-1])
        k = np.stack(krows)
        feats.append(f)
        classes.append(k)
    if not feats:
        return [leaf(0, P_GRADIENT)]
    feat = np.concatenate(feats, axis=1)     # (nprops, N)
    cls = np.concatenate(classes, axis=1)    # (npred, N)
    n = feat.shape[1]

    # Recursive greedy induction on index masks.
    nodes = []  # (prop|-1, splitval, left_ref, right_ref, pred)

    k_pred = len(predictors)

    from libjxl_tpu_torch.native import bindings as _nb
    # int32 feature transport: property values are neighbor sums/diffs,
    # so anything from <=30-bit samples fits; wider content (never
    # encoder-produced today) keeps the int64 numpy path.
    use_native = (_nb.available() and feat.size > 0
                  and int(np.abs(feat).max()) < (1 << 31) - 1)

    def build(sel: np.ndarray, depth: int, leaves_left: list) -> dict:
        sub_idx = np.nonzero(sel)[0]
        nsel = len(sub_idx)
        # Split search runs on a strided subsample of the node (cost
        # histograms scale linearly with it); gains are rescaled to the
        # node's full size before the split-cost comparison.
        if nsel > _SEARCH_CAP:
            search_idx = sub_idx[::(nsel + _SEARCH_CAP - 1)
                                 // _SEARCH_CAP]
        else:
            search_idx = sub_idx
        scale = nsel / len(search_idx)
        if use_native:
            # One C call covers base cost + the full (prop, cut) search
            # (same quantiles/cost model as the numpy path below).
            fsel32 = np.ascontiguousarray(feat[:, search_idx]
                                          .astype(np.int32))
            csel8 = np.ascontiguousarray(cls[:, search_idx])
            (base_cost, base_k, gain_n, prop_i, sv_n, lk_n,
             rk_n) = _nb.ma_split_search(fsel32, csel8)
            node = {"pred": predictors[base_k]}
            if depth >= 10 or leaves_left[0] <= 1 or nsel < 64:
                return node
            if prop_i < 0 or gain_n <= _SPLIT_COST / scale:
                return node
            mask = feat[prop_i, sub_idx] > sv_n
            if not mask.any() or mask.all():
                return node
            leaves_left[0] -= 1
            lsel = np.zeros_like(sel)
            lsel[sub_idx[mask]] = True
            rsel = np.zeros_like(sel)
            rsel[sub_idx[~mask]] = True
            node.update(prop=_LEARN_PROPS[prop_i], splitval=sv_n,
                        left=build(lsel, depth + 1, leaves_left),
                        right=build(rsel, depth + 1, leaves_left))
            return node
        base_cost, base_k = _cost(cls[:, search_idx])
        node = {"pred": predictors[base_k]}
        if depth >= 10 or leaves_left[0] <= 1 or nsel < 64:
            return node
        best_gain = _SPLIT_COST / scale
        fsel = feat[:, search_idx]           # (nprops, ns)
        csel = cls[:, search_idx]            # (k_pred, ns)
        ns = len(search_idx)
        nprops = len(_LEARN_PROPS)
        # Candidate cuts: 9 quantile positions per property from one
        # sort; every (prop, cut, predictor, class) count comes from a
        # SINGLE combined bincount, and left/right histograms are
        # prefix sums over the cut buckets. One vectorized cost pass
        # replaces the former per-property numpy-call soup.
        qpos = (np.array([6, 12, 25, 37, 50, 63, 75, 88, 94])
                * (ns - 1)) // 100
        svals = np.sort(fsel, axis=1)
        qs_all = svals[:, qpos]              # (nprops, 9) ascending
        nb = qs_all.shape[1] + 1
        buckets = np.empty((nprops, ns), np.int64)
        for pi in range(nprops):
            # Integer vals/qs: side="left" makes bucket == #{q < v},
            # so vals <= qs[j] <=> bucket <= j.
            buckets[pi] = np.searchsorted(qs_all[pi], fsel[pi],
                                          side="left")
        comb = ((np.arange(nprops, dtype=np.int64)[:, None, None] * nb
                 + buckets[:, None, :]) * k_pred
                + np.arange(k_pred, dtype=np.int64)[None, :, None]) \
            * _MAX_CLASSES + csel[None]
        counts = np.bincount(
            comb.ravel(), minlength=nprops * nb * k_pred * _MAX_CLASSES
        ).reshape(nprops, nb, k_pred, _MAX_CLASSES)
        pref = counts.cumsum(axis=1)
        total = pref[:, -1]
        # Cut j: right side (vals <= qs[j]) = pref[j], left = rest.
        right = pref[:, :-1]
        left = total[:, None] - right
        with np.errstate(divide="ignore", invalid="ignore"):
            def bits(cnts):
                tot = cnts.sum(-1, keepdims=True)
                logp = np.log2(cnts / np.where(tot > 0, tot, 1))
                ent = -(cnts * np.where(cnts > 0, logp, 0.0)).sum(-1)
                return ent + (cnts * _RAW_BITS).sum(-1) \
                    + cnts[..., 1:].sum(-1)
            lbits = bits(left)    # (nprops, ncuts, k_pred)
            rbits = bits(right)
        lsz = left.sum(axis=(2, 3)) // k_pred    # (nprops, ncuts)
        rsz = right.sum(axis=(2, 3)) // k_pred
        valid = (lsz > 0) & (rsz > 0)
        gain = base_cost - lbits.min(axis=2) - rbits.min(axis=2)
        gain[~valid] = -np.inf
        flat = int(np.argmax(gain))
        pi, j = divmod(flat, gain.shape[1])
        if not valid.any() or gain[pi, j] <= best_gain:
            return node
        best = (pi, _LEARN_PROPS[pi], int(qs_all[pi, j]),
                int(lbits[pi, j].argmin()), int(rbits[pi, j].argmin()))
        pi, prop, sv, lk, rk = best
        mask = feat[pi, sub_idx] > sv   # full node, not the subsample
        if not mask.any() or mask.all():
            return node
        leaves_left[0] -= 1
        lsel = np.zeros_like(sel)
        lsel[sub_idx[mask]] = True
        rsel = np.zeros_like(sel)
        rsel[sub_idx[~mask]] = True
        node.update(prop=prop, splitval=sv,
                    left=build(lsel, depth + 1, leaves_left),
                    right=build(rsel, depth + 1, leaves_left))
        return node

    root = build(np.ones(n, bool), 0, [max_leaves])

    # BFS serialization matching dec_ma.cc's layout.
    tree: Tree = []
    queue = [root]
    leaf_id = 0
    while queue:
        nd = queue.pop(0)
        if "prop" in nd:
            tree.append(TreeNode(nd["prop"], nd["splitval"],
                                 len(tree) + len(queue) + 1,
                                 len(tree) + len(queue) + 2))
            queue.append(nd["left"])
            queue.append(nd["right"])
        else:
            tree.append(leaf(leaf_id, nd["pred"]))
            leaf_id += 1
    return tree
