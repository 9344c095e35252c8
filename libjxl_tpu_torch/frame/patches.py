"""Patch dictionary: rectangles copied from saved reference frames.

Reference: lib/jxl/dec_patch_dictionary.{h,cc} (Decode, PatchBlendMode),
patch_dictionary_internal.h (context numbering, spec C.4.5),
enc_patch_dictionary.cc (encoding side). Patches are decoded from an
ANS stream in LfGlobal and blitted onto the XYB image from reference
frames saved by earlier kReferenceOnly frames.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from libjxl_tpu_torch.base.errors import BitstreamError
from libjxl_tpu_torch.base.signed import pack_signed, unpack_signed

# Context numbering (patch_dictionary_internal.h:12-23).
NUM_REF_PATCH_CTX = 0
REFERENCE_FRAME_CTX = 1
PATCH_SIZE_CTX = 2
PATCH_REFERENCE_POSITION_CTX = 3
PATCH_POSITION_CTX = 4
PATCH_BLEND_MODE_CTX = 5
PATCH_OFFSET_CTX = 6
PATCH_COUNT_CTX = 7
PATCH_ALPHA_CHANNEL_CTX = 8
PATCH_CLAMP_CTX = 9
NUM_PATCH_CONTEXTS = 10

MAX_NUM_REFERENCE_FRAMES = 4


class PatchBlendMode(enum.IntEnum):
    NONE = 0
    REPLACE = 1
    ADD = 2
    MUL = 3
    BLEND_ABOVE = 4
    BLEND_BELOW = 5
    ALPHA_WEIGHTED_ADD_ABOVE = 6
    ALPHA_WEIGHTED_ADD_BELOW = 7


NUM_PATCH_BLEND_MODES = 8


def _uses_alpha(mode: int) -> bool:
    return mode in (PatchBlendMode.BLEND_ABOVE, PatchBlendMode.BLEND_BELOW,
                    PatchBlendMode.ALPHA_WEIGHTED_ADD_ABOVE,
                    PatchBlendMode.ALPHA_WEIGHTED_ADD_BELOW)


def _uses_clamp(mode: int) -> bool:
    return _uses_alpha(mode) or mode == PatchBlendMode.MUL


@dataclasses.dataclass
class PatchRefPosition:
    ref: int
    x0: int
    y0: int
    xsize: int
    ysize: int


@dataclasses.dataclass
class PatchBlending:
    mode: int = PatchBlendMode.NONE
    alpha_channel: int = 0
    clamp: bool = False


@dataclasses.dataclass
class PatchPosition:
    x: int
    y: int
    ref_idx: int


@dataclasses.dataclass
class PatchDictionary:
    ref_positions: list = dataclasses.field(default_factory=list)
    positions: list = dataclasses.field(default_factory=list)
    # blendings[i] has 1 + num_extra_channels entries for positions[i].
    blendings: list = dataclasses.field(default_factory=list)


def decode_patches(br, xsize: int, ysize: int, num_extra_channels: int,
                   reference_frames: list) -> PatchDictionary:
    """PatchDictionary::Decode (dec_patch_dictionary.cc:41-180)."""
    from libjxl_tpu_torch.entropy.codes import SymbolReader, decode_histograms

    codes = decode_histograms(br, NUM_PATCH_CONTEXTS)
    dec = SymbolReader(codes, br)
    d = PatchDictionary()
    num_ref_patch = dec.read(NUM_REF_PATCH_CTX)
    max_ref_patches = 1024 + xsize * ysize // 4
    max_patches = max_ref_patches * 4
    if num_ref_patch > max_ref_patches:
        raise BitstreamError("too many ref patches")
    total = 0
    choose_alpha = num_extra_channels > 1
    for _ in range(num_ref_patch):
        ref = dec.read(REFERENCE_FRAME_CTX)
        if ref >= MAX_NUM_REFERENCE_FRAMES or \
                reference_frames[ref] is None:
            raise BitstreamError("invalid reference frame id")
        rf = reference_frames[ref]
        rh, rw = rf.shape[-2], rf.shape[-1]
        x0 = dec.read(PATCH_REFERENCE_POSITION_CTX)
        y0 = dec.read(PATCH_REFERENCE_POSITION_CTX)
        pxs = dec.read(PATCH_SIZE_CTX) + 1
        pys = dec.read(PATCH_SIZE_CTX) + 1
        if x0 + pxs > rw or y0 + pys > rh:
            raise BitstreamError("patch outside reference frame")
        id_count = dec.read(PATCH_COUNT_CTX) + 1
        total += id_count
        if total > max_patches:
            raise BitstreamError("too many patches")
        ref_idx = len(d.ref_positions)
        for i in range(id_count):
            if i == 0:
                x = dec.read(PATCH_POSITION_CTX)
                y = dec.read(PATCH_POSITION_CTX)
            else:
                dx = unpack_signed(dec.read(PATCH_OFFSET_CTX))
                dy = unpack_signed(dec.read(PATCH_OFFSET_CTX))
                x = d.positions[-1].x + dx
                y = d.positions[-1].y + dy
            if x < 0 or y < 0 or x + pxs > xsize or y + pys > ysize:
                raise BitstreamError("patch outside frame")
            blend = []
            for _j in range(1 + num_extra_channels):
                mode = dec.read(PATCH_BLEND_MODE_CTX)
                if mode >= NUM_PATCH_BLEND_MODES:
                    raise BitstreamError("invalid patch blend mode")
                info = PatchBlending(mode=mode)
                if _uses_alpha(mode) and choose_alpha:
                    info.alpha_channel = dec.read(
                        PATCH_ALPHA_CHANNEL_CTX)
                    if info.alpha_channel >= num_extra_channels:
                        raise BitstreamError("bad patch alpha channel")
                if _uses_clamp(mode):
                    info.clamp = bool(dec.read(PATCH_CLAMP_CTX))
                blend.append(info)
            d.positions.append(PatchPosition(x, y, ref_idx))
            d.blendings.append(blend)
        d.ref_positions.append(
            PatchRefPosition(ref, x0, y0, pxs, pys))
    if not dec.check_final_state():
        raise BitstreamError("bad ANS state in patch dictionary")
    return d


def encode_patches(d: PatchDictionary, num_extra_channels: int, w) -> None:
    """enc_patch_dictionary.cc Encode: same token order as decode."""
    from libjxl_tpu_torch.entropy.codes import build_and_encode_histograms, \
        write_tokens

    tokens = []

    def put(ctx, val):
        tokens.append((ctx, val))

    # Group positions by ref_idx preserving dictionary order.
    put(NUM_REF_PATCH_CTX, len(d.ref_positions))
    choose_alpha = num_extra_channels > 1
    for ref_idx, rp in enumerate(d.ref_positions):
        put(REFERENCE_FRAME_CTX, rp.ref)
        put(PATCH_REFERENCE_POSITION_CTX, rp.x0)
        put(PATCH_REFERENCE_POSITION_CTX, rp.y0)
        put(PATCH_SIZE_CTX, rp.xsize - 1)
        put(PATCH_SIZE_CTX, rp.ysize - 1)
        members = [i for i, p in enumerate(d.positions)
                   if p.ref_idx == ref_idx]
        put(PATCH_COUNT_CTX, len(members) - 1)
        for k, i in enumerate(members):
            p = d.positions[i]
            if k == 0:
                put(PATCH_POSITION_CTX, p.x)
                put(PATCH_POSITION_CTX, p.y)
            else:
                prev = d.positions[members[k - 1]]
                put(PATCH_OFFSET_CTX, pack_signed(p.x - prev.x))
                put(PATCH_OFFSET_CTX, pack_signed(p.y - prev.y))
            for info in d.blendings[i]:
                put(PATCH_BLEND_MODE_CTX, int(info.mode))
                if _uses_alpha(info.mode) and choose_alpha:
                    put(PATCH_ALPHA_CHANNEL_CTX, info.alpha_channel)
                if _uses_clamp(info.mode):
                    put(PATCH_CLAMP_CTX, int(info.clamp))

    arrs = (np.array([t[0] for t in tokens], np.int32),
            np.array([t[1] for t in tokens], np.int64))
    codes = build_and_encode_histograms(NUM_PATCH_CONTEXTS, [arrs], w)
    write_tokens(arrs, codes, w)


def apply_patches(d: PatchDictionary, xyb: np.ndarray,
                  extra_channels: list | None,
                  reference_frames: list) -> None:
    """Blits every patch onto the (3, H, W) XYB image in place
    (dec_patch_dictionary.cc AddOneRow semantics, color channels; extra
    channels blended with their own PatchBlending entries)."""
    nec = len(extra_channels) if extra_channels else 0
    for pos, blend in zip(d.positions, d.blendings):
        rp = d.ref_positions[pos.ref_idx]
        ref = reference_frames[rp.ref]
        src = ref[:, rp.y0:rp.y0 + rp.ysize, rp.x0:rp.x0 + rp.xsize]
        dsl = (slice(pos.y, pos.y + rp.ysize),
               slice(pos.x, pos.x + rp.xsize))
        info = blend[0]
        mode = info.mode
        if mode == PatchBlendMode.NONE:
            pass
        elif mode == PatchBlendMode.REPLACE:
            xyb[(slice(None),) + dsl] = src
        elif mode == PatchBlendMode.ADD:
            xyb[(slice(None),) + dsl] += src
        elif mode == PatchBlendMode.MUL:
            xyb[(slice(None),) + dsl] *= src
        elif mode in (PatchBlendMode.BLEND_ABOVE,
                      PatchBlendMode.BLEND_BELOW):
            if extra_channels and info.alpha_channel < nec:
                a = extra_channels[info.alpha_channel][dsl] \
                    .astype(np.float32)
                if a.max() > 1.0:
                    a = a / a.max()
            else:
                a = np.ones(src.shape[-2:], np.float32)
            if mode == PatchBlendMode.BLEND_BELOW:
                old = xyb[(slice(None),) + dsl]
                xyb[(slice(None),) + dsl] = old * a + src * (1.0 - a)
            else:
                xyb[(slice(None),) + dsl] = \
                    src * a + xyb[(slice(None),) + dsl] * (1.0 - a)
        else:  # alpha-weighted adds
            if extra_channels and info.alpha_channel < nec:
                a = extra_channels[info.alpha_channel][dsl] \
                    .astype(np.float32)
                if a.max() > 1.0:
                    a = a / a.max()
            else:
                a = np.ones(src.shape[-2:], np.float32)
            xyb[(slice(None),) + dsl] += src * a


def apply_patches_band(d: PatchDictionary, xyb_band: np.ndarray,
                       y_off: int, extra_channels: list | None,
                       reference_frames: list) -> None:
    """Band-windowed apply_patches: blits the slice of every patch
    intersecting frame rows [y_off, y_off + band_h) onto the band in
    place. Every blend mode is row-local, so band applications tile
    exactly to the whole-frame result (the low-memory pipeline's
    per-band patch stage; extra-channel alpha sources are sliced with
    the same window)."""
    bh = xyb_band.shape[1]
    nec = len(extra_channels) if extra_channels else 0
    for pos, blend in zip(d.positions, d.blendings):
        rp = d.ref_positions[pos.ref_idx]
        dy0 = max(pos.y, y_off)
        dy1 = min(pos.y + rp.ysize, y_off + bh)
        if dy1 <= dy0:
            continue
        ref = reference_frames[rp.ref]
        sy0 = rp.y0 + (dy0 - pos.y)
        src = ref[:, sy0:sy0 + (dy1 - dy0), rp.x0:rp.x0 + rp.xsize]
        dsl = (slice(dy0 - y_off, dy1 - y_off),
               slice(pos.x, pos.x + rp.xsize))
        info = blend[0]
        mode = info.mode
        if mode == PatchBlendMode.NONE:
            pass
        elif mode == PatchBlendMode.REPLACE:
            xyb_band[(slice(None),) + dsl] = src
        elif mode == PatchBlendMode.ADD:
            xyb_band[(slice(None),) + dsl] += src
        elif mode == PatchBlendMode.MUL:
            xyb_band[(slice(None),) + dsl] *= src
        else:
            # Alpha-sourced modes: with no extra channels alpha is 1.
            if extra_channels and info.alpha_channel < nec:
                a = extra_channels[info.alpha_channel][
                    dy0:dy1, pos.x:pos.x + rp.xsize].astype(np.float32)
                if a.max() > 1.0:
                    a = a / a.max()
            else:
                a = np.ones(src.shape[-2:], np.float32)
            if mode == PatchBlendMode.BLEND_BELOW:
                old = xyb_band[(slice(None),) + dsl]
                xyb_band[(slice(None),) + dsl] = old * a + src * (1.0 - a)
            elif mode == PatchBlendMode.BLEND_ABOVE:
                xyb_band[(slice(None),) + dsl] = \
                    src * a + xyb_band[(slice(None),) + dsl] * (1.0 - a)
            else:  # alpha-weighted adds
                xyb_band[(slice(None),) + dsl] += src * a


def patch_affine(d: PatchDictionary, h: int, w: int,
                 reference_frames: list):
    """Folds the whole patch stack into per-pixel affine coefficients:
    applying every patch in order equals ``xyb * K + A`` (each blend
    mode is affine in the destination, and affine maps compose) —
    the device path applies one fused multiply-add instead of looping
    host-side (dec_patch_dictionary.cc AddOneRow, color channels, no
    extra-channel alpha sources).

    Returns (K, A) float32 (3, h, w), or None when a patch uses an
    alpha-channel source (caller falls back to the host loop)."""
    K = np.ones((3, h, w), np.float32)
    A = np.zeros((3, h, w), np.float32)
    for pos, blend in zip(d.positions, d.blendings):
        rp = d.ref_positions[pos.ref_idx]
        ref = reference_frames[rp.ref]
        src = ref[:, rp.y0:rp.y0 + rp.ysize, rp.x0:rp.x0 + rp.xsize]
        dsl = (slice(None), slice(pos.y, pos.y + rp.ysize),
               slice(pos.x, pos.x + rp.xsize))
        mode = blend[0].mode
        if mode == PatchBlendMode.NONE:
            continue
        if mode == PatchBlendMode.REPLACE:
            k_p, a_p = 0.0, src
        elif mode == PatchBlendMode.ADD:
            k_p, a_p = 1.0, src
        elif mode == PatchBlendMode.MUL:
            k_p, a_p = src, 0.0
        elif mode in (PatchBlendMode.BLEND_ABOVE,
                      PatchBlendMode.BLEND_BELOW):
            if blend[0].alpha_channel >= 0 and mode in (
                    PatchBlendMode.BLEND_ABOVE,
                    PatchBlendMode.BLEND_BELOW):
                # With no extra channels the host path uses alpha == 1.
                if mode == PatchBlendMode.BLEND_BELOW:
                    k_p, a_p = 1.0, 0.0 * src
                else:
                    k_p, a_p = 0.0, src
            else:
                return None
        else:   # alpha-weighted add; alpha == 1 without extra channels
            k_p, a_p = 1.0, src
        # compose: x -> (x*K+A)*k_p + a_p
        K[dsl] = K[dsl] * k_p
        A[dsl] = A[dsl] * k_p + a_p
    return K, A
