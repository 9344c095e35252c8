"""The device decode of VarDCT frames: host feed -> XYB -> PQ16 /
sRGB8.

Port of libjxl_tpu/tpu/pipeline.py (``decode_xyb2``,
``decode_frame_device2`` with its post stages, and
``decode_frames_device_batched``):
  1. scatter-add the sparse coefficients (progressive passes repeat an
     index, so the scatter must add)
  2. AdjustQuantBias + dequant + CfL, DC into the LLF slot
  3. 8x8-family IDCT as one masked matmul per used bank slot
  4. big/rect classes as dense aligned tiles (or gather/scatter)
  5. gaborish + EPF: the hand-written CUDA kernel (ops/epf_cuda.py)
  6. post stages of one frame: upsampling, the patch affine fold,
     splines, noise (ops/stages.py)
  7. XYB -> PQ16 / sRGB8 (ops/decode_torch.py)
A batch of N frames carries a leading axis through steps 1-5 and 7 in
place of the reference's ``vmap``; the kernel filters it in one launch.
PyTorch runs eagerly, so there is no jit, no static-shape padding of the
sparse coefficients and no program cache.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_tpu_torch.device import (
    feed_to_torch, feeds_to_torch, patch_affine_to_torch, resolve_device,
)
from libjxl_tpu_torch.ops import epf_cuda, stages
from libjxl_tpu_torch.ops.decode_torch import (
    adjust_quant_bias, xyb_to_pq16, xyb_to_srgb8,
)
from libjxl_tpu_torch.pipeline.upsample import _kernels

OUTPUTS = ("srgb8", "pq16", "xyb")


def _family8_select_matmul(cells, ids, mat_bank):
    """(..., 3, N, 64) cells, (..., N) pruned bank ids -> pixel cells of
    the same shape.

    One (N, 64) @ (64, 64) product per used slot on the cells masked to
    that slot's blocks; masked lanes contribute exact zeros, so the sum
    equals a per-block matrix select bit for bit without gathering one
    64x64 matrix per block."""
    if mat_bank.shape[0] == 1:
        return torch.matmul(cells, mat_bank[0])
    acc = torch.zeros_like(cells)
    for s in range(mat_bank.shape[0]):
        mask = (ids == s).to(cells.dtype)[..., None, :, None]
        acc = acc + torch.matmul(cells * mask, mat_bank[s])
    return acc


def _pad_to(x: torch.Tensor, h: int, w: int, value=0) -> torch.Tensor:
    """Pad the last two axes at the end up to (h, w) with ``value``."""
    if x.shape[-2:] == (h, w):
        return x
    out = x.new_full(x.shape[:-2] + (h, w), value)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def decode_xyb2_batched(coeff_img, mat_ids, raw_quant, dc, fx, fb,
                        inv_gs, qmul, tables8, mat_bank, big_tables,
                        classes, biases, BW_blocks, class_masks=None,
                        class_consts=None):
    """Coefficients + control maps of NB frames -> (NB, 3, H, W) float32
    XYB: the reference's ``decode_xyb2`` with a leading batch axis on
    every per-frame input in place of ``vmap``.

    Shapes: coeff_img (NB, 3, H, W); mat_ids, raw_quant, fx, fb
    (NB, BH, BW); dc (NB, 3, BH, BW); inv_gs (NB,); qmul (NB, 3);
    biases (NB, 4); tables8 (NB, S, 3, 64); big_tables {(cy, cx):
    (NB, 3, size)}; class_masks {(cy, cx): (NB, TBH, TBW) bool}.
    ``class_masks``: each big class is decoded by IDCT-ing every aligned
    tile and blending by mask. Otherwise ``classes`` {(cy, cx):
    (anchor_idx, mask)} drives a gather/scatter, for NB = 1 only.
    ``class_consts``: {(cy, cx): (ly, lx, mcy, mcx, sy, sx, ih, iw)} as
    ``feed_to_torch`` builds them."""
    nb, _, H, W = coeff_img.shape
    BH, BW = H // 8, W // 8
    N = BH * BW

    def adjust(q):
        return adjust_quant_bias(q.float(), biases)

    # ---- 8x8-family cells ----
    cells = coeff_img.reshape(nb, 3, BH, 8, BW, 8) \
        .permute(0, 1, 2, 4, 3, 5).reshape(nb, 3, N, 64)
    ids = mat_ids.reshape(nb, N)
    biased = adjust(cells)
    frame = torch.arange(nb, device=ids.device)[:, None]
    w_cells = tables8[frame, ids].permute(0, 2, 1, 3)  # (NB, 3, N, 64)
    scale = inv_gs[:, None] / raw_quant.reshape(nb, N).float()
    dqc = biased * w_cells * scale[:, None, :, None] \
        * qmul[:, :, None, None]
    fxf = fx.reshape(nb, N)[:, :, None]
    fbf = fb.reshape(nb, N)[:, :, None]
    dqc = torch.stack([dqc[:, 0] + fxf * dqc[:, 1], dqc[:, 1],
                       dqc[:, 2] + fbf * dqc[:, 1]], dim=1)
    dqc[..., 0] = dc.reshape(nb, 3, N)
    pix_cells = _family8_select_matmul(dqc, ids, mat_bank)
    pix = pix_cells.reshape(nb, 3, BH, BW, 8, 8) \
        .permute(0, 1, 2, 4, 3, 5).reshape(nb, 3, H, W)

    # ---- big/rect classes: dense aligned-tile path ----
    if class_masks is not None:
        rq_f = raw_quant.float()
        for (cy, cx), m in sorted(class_masks.items()):
            ly, lx, mcy, mcx, sy, sx, ih, iw = class_consts[(cy, cx)]
            table = big_tables[(cy, cx)]               # (NB, 3, size)
            TBH, TBW = -(-BH // cy), -(-BW // cx)
            PH, PW = TBH * cy * 8, TBW * cx * 8
            tiles = _pad_to(coeff_img, PH, PW) \
                .reshape(nb, 3, TBH, cy * 8, TBW, cx * 8) \
                .permute(0, 1, 2, 4, 3, 5)
            grids = adjust(tiles.reshape(nb, 3, TBH, TBW, ly * 8, lx * 8))

            def _anchor(a):
                return _pad_to(a, TBH * cy, TBW * cx, 1)[..., 0::cy, 0::cx]
            scale_e = inv_gs[:, None, None] / _anchor(rq_f)  # (NB, TBH, TBW)
            dqg = grids * table.reshape(nb, 3, 1, 1, ly * 8, lx * 8) \
                * scale_e[:, None, :, :, None, None] \
                * qmul[:, :, None, None, None, None]
            fxe = _anchor(fx)[..., None, None]
            fbe = _anchor(fb)[..., None, None]
            dqg = torch.stack([dqg[:, 0] + fxe * dqg[:, 1], dqg[:, 1],
                               dqg[:, 2] + fbe * dqg[:, 1]], dim=1)
            # LLF from the DC image (LowestFrequenciesFromDC), dense.
            dcs = _pad_to(dc, TBH * cy, TBW * cx) \
                .reshape(nb, 3, TBH, cy, TBW, cx).permute(0, 1, 2, 4, 3, 5)
            llf = torch.einsum("ui,ncabij,vj->ncabuv", mcy, dcs, mcx)
            llf = llf * sy[:, None] * sx[None, :]
            if cy >= cx:
                llf = llf.transpose(-2, -1)
            dqg[..., :ly, :lx] = llf
            if cy >= cx:
                dqg = dqg.transpose(-2, -1)
            blk = torch.einsum("yu,ncabuv,wv->ncabyw", ih, dqg, iw)
            ptiles = _pad_to(pix, PH, PW) \
                .reshape(nb, 3, TBH, cy * 8, TBW, cx * 8) \
                .permute(0, 1, 2, 4, 3, 5)
            merged = torch.where(m[:, None, :, :, None, None], blk, ptiles)
            pix = merged.permute(0, 1, 2, 4, 3, 5) \
                .reshape(nb, 3, PH, PW)[..., :H, :W]
        return pix

    # ---- big/rect classes: gather/scatter fallback (anchors not
    # aligned to the covered size), one frame ----
    if classes:
        if nb != 1:
            raise ValueError("the gather/scatter class path takes one "
                             "frame")
        pix = _gather_classes(
            pix[0], coeff_img[0], dc[0], raw_quant[0], fx[0], fb[0],
            inv_gs[0], qmul[0], biases[0], {k: v[0] for k, v in
                                            big_tables.items()},
            classes, BW_blocks, class_consts)[None]
    return pix


def _gather_classes(pix, coeff_img, dc, raw_quant, fx, fb, inv_gs, qmul,
                    biases, big_tables, classes, BW_blocks, class_consts):
    """The big classes of one frame by gather, IDCT and masked
    scatter-add into (3, H, W) ``pix``."""
    _, H, W = coeff_img.shape
    N = (H // 8) * (W // 8)
    dev = coeff_img.device
    flat_coeff = coeff_img.reshape(3, H * W)
    flat_pix = pix.reshape(3, H * W).clone()
    dc_flat = dc.reshape(3, N)
    rq_flat = raw_quant.reshape(N).float()
    fx_flat = fx.reshape(N)
    fb_flat = fb.reshape(N)
    for (cy, cx), (anchor_idx, mask) in sorted(classes.items()):
        ly, lx, mcy, mcx, sy, sx, ih, iw = class_consts[(cy, cx)]
        table = big_tables[(cy, cx)]               # (3, size)
        aby = anchor_idx // BW_blocks
        abx = anchor_idx % BW_blocks
        base = aby * 8 * W + abx * 8
        cov_lin = torch.from_numpy(
            (np.arange(cy * 8)[:, None] * W
             + np.arange(cx * 8)[None, :]).ravel()).to(dev)
        in_idx = base[:, None, None] \
            + cov_lin.reshape(ly * 8, lx * 8)[None]
        out_idx = base[:, None, None] \
            + cov_lin.reshape(cy * 8, cx * 8)[None]
        grids = adjust_quant_bias(flat_coeff[:, in_idx].float(), biases)
        scale_e = inv_gs / rq_flat[anchor_idx]     # (cap,)
        dqg = grids * table.reshape(3, 1, ly * 8, lx * 8) \
            * scale_e[None, :, None, None] \
            * qmul[:, None, None, None]
        fxe = fx_flat[anchor_idx][:, None, None]
        fbe = fb_flat[anchor_idx][:, None, None]
        dqg = torch.stack([dqg[0] + fxe * dqg[1], dqg[1],
                           dqg[2] + fbe * dqg[1]])
        dci = anchor_idx[:, None, None] + torch.from_numpy(
            np.arange(cy)[:, None] * BW_blocks
            + np.arange(cx)[None, :]).to(dev)[None]
        dcs = dc_flat[:, dci]                      # (3, cap, cy, cx)
        llf = torch.einsum("ui,cnij,vj->cnuv", mcy, dcs, mcx)
        llf = llf * sy[:, None] * sx[None, :]
        if cy >= cx:
            llf = llf.transpose(2, 3)
        dqg[:, :, :ly, :lx] = llf
        if cy >= cx:
            dqg = dqg.transpose(2, 3)
        blk = torch.einsum("yu,cnuv,wv->cnyw", ih, dqg, iw)
        # Masked scatter-add: capacity-padding entries add zero.
        delta = (blk - flat_pix[:, out_idx]) * mask[None, :, None, None]
        flat_pix.index_add_(1, out_idx.reshape(-1), delta.reshape(3, -1))
    return flat_pix.reshape(3, H, W)


def decode_xyb2(coeff_img, mat_ids, raw_quant, dc, fx, fb, inv_gs, qmul,
                tables8, mat_bank, big_tables, classes, biases, BW_blocks,
                class_masks=None, class_consts=None):
    """Coefficients + control maps of one frame -> (3, H, W) float32
    XYB (``decode_xyb2_batched`` with a batch of one; the inputs have no
    batch axis, ``classes`` is as there)."""
    def one(x):
        return x[None]
    return decode_xyb2_batched(
        one(coeff_img), one(mat_ids), one(raw_quant), one(dc), one(fx),
        one(fb), inv_gs.reshape(1), one(qmul), one(tables8), mat_bank,
        {k: one(v) for k, v in big_tables.items()}, classes, one(biases),
        BW_blocks,
        class_masks=(None if class_masks is None else
                     {k: one(v) for k, v in class_masks.items()}),
        class_consts=class_consts)[0]


def dense_coefficients(t: dict) -> torch.Tensor:
    """The (3, H8, W8) (or (N, 3, H8, W8)) coefficient image of a staged
    feed: the sparse (index, value) pairs scatter-ADDED into int32
    (indices repeat across progressive passes), then wrapped to int16 as
    the reference's int16 scatter-add does."""
    if "coeff_img" in t:
        return t["coeff_img"]
    nzi, nzv = t["coeff_nz"]
    shape = t["coeff_shape"]
    acc = torch.zeros(int(np.prod(shape)), dtype=torch.int32,
                      device=nzv.device)
    acc.index_add_(0, nzi, nzv.to(torch.int32))
    return acc.to(torch.int16).reshape(shape)


def loop_filter_params(lf) -> dict:
    """The frame header's loop-filter parameters as keyword arguments of
    ``epf_cuda.apply_loop_filters``."""
    return dict(
        epf_iters=int(lf.epf_iters), gab=bool(lf.gab),
        gab_weights=((lf.gab_x_weight1, lf.gab_x_weight2),
                     (lf.gab_y_weight1, lf.gab_y_weight2),
                     (lf.gab_b_weight1, lf.gab_b_weight2)),
        epf_pass0_sigma_scale=lf.epf_pass0_sigma_scale,
        epf_pass2_sigma_scale=lf.epf_pass2_sigma_scale,
        epf_border_sad_mul=lf.epf_border_sad_mul,
        epf_channel_scale=tuple(lf.epf_channel_scale))


def staged_xyb(t: dict, image_h: int, image_w: int) -> torch.Tensor:
    """Stage A on a feed already on the device (``feed_to_torch``, or
    ``feeds_to_torch`` for a batch): scatter + dequant + CfL + IDCT ->
    contiguous (3, H, W) (or (N, 3, H, W)) XYB, before the loop
    filters."""
    decode = decode_xyb2 if len(t["coeff_shape"]) == 3 \
        else decode_xyb2_batched
    xyb = decode(
        dense_coefficients(t), t["mat_ids"], t["raw_quant"], t["dc"],
        t["fx"], t["fb"], t["inv_gs"], t["qmul"], t["tables8"],
        t["mat_bank"], t["big_tables"], t.get("classes"), t["biases"],
        t["BW_blocks"], class_masks=t.get("class_masks"),
        class_consts=t["class_consts"])
    return xyb[..., :image_h, :image_w].contiguous()


def loop_filters(xyb: torch.Tensor, t: dict) -> torch.Tensor:
    """Gaborish + EPF with the frame header's parameters: the CUDA kernel
    on a card, its plain version on the CPU."""
    lf = loop_filter_params(t["lf"])
    if lf["gab"] or lf["epf_iters"] > 0:
        xyb = epf_cuda.apply_loop_filters(xyb, t["inv_sigma"], **lf)
    return xyb


def output_tail(xyb: torch.Tensor, out: str) -> torch.Tensor:
    if out == "xyb":
        return xyb
    if out == "pq16":
        return xyb_to_pq16(xyb)
    return xyb_to_srgb8(xyb)


# ---------------------------------------------------------------------------
# Post stages (dec_cache.cc order: EPF -> upsampling -> patches ->
# splines -> noise)

POST_STAGES = ("upsample", "patch_affine", "noise", "splines", "final_hw")

_NOISE_DEV_CACHE: dict = {}


def device_noise_planes(h: int, w: int, gd: int, vfi: int,
                        device) -> torch.Tensor:
    """Raw noise planes on ``device``, cached per shape (they do not
    depend on the pixels; see ops/stages.py). The copy is synchronous,
    so any stream may read the cached tensor."""
    dev = torch.device(device)
    key = (str(dev), h, w, gd, vfi)
    if key not in _NOISE_DEV_CACHE:
        planes = torch.from_numpy(
            stages.noise_planes_for(h, w, gd, vfi)).to(dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        _NOISE_DEV_CACHE[key] = planes
    return _NOISE_DEV_CACHE[key]


def check_post(post: dict | None) -> dict:
    """``post`` without empty entries; raises for a stage the port does
    not know."""
    post = {k: v for k, v in (post or {}).items() if v is not None}
    for stage in post:
        if stage not in POST_STAGES:
            raise NotImplementedError(
                f"post stage {stage!r} is not supported by the device "
                "decode path yet")
    return post


def upsample_stage(xyb: torch.Tensor, post: dict) -> torch.Tensor:
    """Learned upsampling, cropped to ``final_hw``. Like the reference,
    the default kernels of the factor are used, not the frame header's
    custom weights."""
    up_n = int(post.get("upsample", 1))
    if up_n == 1:
        return xyb
    h, w = xyb.shape[-2:]
    final_h, final_w = post.get("final_hw", (h * up_n, w * up_n))
    k = torch.from_numpy(_kernels(up_n).astype(np.float32)).to(xyb.device)
    return stages.upsample_image(xyb, up_n, k)[:, :final_h, :final_w]


def patch_stage(xyb: torch.Tensor, ka) -> torch.Tensor:
    """The patch stack folded to one affine map, ``xyb * K + A``, after
    upsampling (``ka``: (K, A) as ``patch_affine_to_torch`` stages
    them, or None)."""
    if ka is None:
        return xyb
    return xyb * ka[0] + ka[1]


def splines_stage(xyb: torch.Tensor, post: dict) -> torch.Tensor:
    args = post.get("splines")
    if args is None:
        return xyb
    return stages.render_splines(xyb, *(torch.from_numpy(a).to(xyb.device)
                                        for a in args))


def noise_stage(xyb: torch.Tensor, post: dict) -> torch.Tensor:
    cfg = post.get("noise")
    if cfg is None:
        return xyb
    lut, ytox, ytob, gd, vfi = cfg
    raw = device_noise_planes(xyb.shape[-2], xyb.shape[-1], int(gd),
                              int(vfi), xyb.device)
    lut = torch.from_numpy(np.asarray(lut, np.float32)).to(xyb.device)
    return stages.add_noise(xyb, raw, lut, float(ytox), float(ytob))


def decode_frame_device2(feed: dict, image_h: int, image_w: int,
                         out: str = "srgb8", device=None,
                         post: dict | None = None) -> torch.Tensor:
    """Host feed -> (3, H, W) tensor on ``device`` (default ``cuda``).

    out: "srgb8" (uint8), "pq16" (uint16 PQ-encoded BT.2100) or "xyb"
    (float32 planes). ``post`` (the feed's ``"post"`` entry, or the one
    ``frame.decode_frame`` assembles on its device route): the
    upsampling factor ``upsample``, ``patch_affine`` (the patch stack
    folded to (K, A), two (3, H, W) float32 planes at the upsampled
    size), ``splines`` (stroke parameters), ``noise`` (lut, ytox, ytob,
    group_dim, frame index) and the output size ``final_hw``, run in the
    reference's order after the loop filters; the output is then
    ``final_hw``. An unknown stage raises."""
    post = check_post(post)
    if out not in OUTPUTS:
        raise ValueError(f"out must be one of {OUTPUTS}, not {out!r}")
    dev = resolve_device(device)
    t = feed_to_torch(feed, dev)
    ka = patch_affine_to_torch(post.get("patch_affine"), dev)
    xyb = loop_filters(staged_xyb(t, image_h, image_w), t)
    xyb = patch_stage(upsample_stage(xyb, post), ka)
    xyb = noise_stage(splines_stage(xyb, post), post)
    return output_tail(xyb, out)


# ---------------------------------------------------------------------------
# Batched decode: N frames of one shape in one pass, one kernel launch


def check_batchable(feeds: list) -> None:
    """Raises ValueError unless the feeds can be decoded as one batch:
    the reference's preconditions (dense class masks, sparse
    coefficients, one coefficient shape and image size, one ``gab`` and
    ``epf_iters``) and two of the port's own: one set of loop-filter
    weights (the port honours custom weights) and no post stage."""
    if not feeds:
        raise ValueError("batch of no frames")
    f0 = feeds[0]
    lf0 = loop_filter_params(f0["lf"])
    for f in feeds:
        if f.get("class_masks") is None and f["classes"]:
            raise ValueError("batch requires dense-mask feeds")
        if f.get("coeff_nz") is None:
            raise ValueError("batch requires sparse feeds")
        if (f["coeff_img"].shape != f0["coeff_img"].shape
                or tuple(f["image_hw"]) != tuple(f0["image_hw"])):
            raise ValueError("batch requires same-shape frames")
        lf = loop_filter_params(f["lf"])
        if (lf["gab"], lf["epf_iters"]) != (lf0["gab"], lf0["epf_iters"]):
            raise ValueError("batch requires same-filter frames")
        if lf != lf0:
            raise ValueError("batch requires one set of loop-filter "
                             "weights")
        if f.get("post"):
            raise ValueError("batch takes no post stages")


def decode_frames_device_batched(feeds: list, image_h: int, image_w: int,
                                 out: str = "srgb8",
                                 device=None) -> torch.Tensor:
    """Decode N same-shape feeds together; returns the (N, 3, H, W)
    output batch on ``device``. Frames may differ in strategies and
    content: a frame that lacks a big-block class gets a zero mask for
    it. The bank is pruned to the union of the frames' used 8x8-family
    slots (the reference keeps the whole bank; the result is the same).
    Raises ValueError when ``check_batchable`` does."""
    check_batchable(feeds)
    if out not in OUTPUTS:
        raise ValueError(f"out must be one of {OUTPUTS}, not {out!r}")
    t = feeds_to_torch(feeds, resolve_device(device))
    return output_tail(loop_filters(staged_xyb(t, image_h, image_w), t),
                       out)
