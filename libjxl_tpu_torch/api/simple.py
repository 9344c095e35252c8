"""One-shot decode API of the port: ``decode`` and ``decode_all``.

decode(): codestream bytes -> pixels + metadata.
decode_all(): every displayed frame of an animation, blended.

Copy of the decode half of libjxl_tpu/api/simple.py (``DecodeResult``,
``FrameResult``, ``decode``, ``decode_all`` and their helpers) on the
reference's device route, with ``device`` a torch device: VarDCT frames
decode there through ``tpu.pipeline.decode_frame_device2`` (the loop
filters on the CUDA kernel on a card), spot colours mix there and the
animation canvas blends and stays there; the XYB comes back to the host,
which converts it to output pixels, as the reference does. There is no
host-only mode: the JAX package's host decoder is the oracle the tests
hold the port against.

Reference analogue: lib/extras/dec/jxl.cc DecodeImageJXL driving the C
API.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libjxl_tpu_torch.bitstream.bit_io import BitReader
from libjxl_tpu_torch.color.xyb import linear_to_srgb, xyb_to_linear_rgb
from libjxl_tpu_torch.container.boxes import is_container, unpack_container
from libjxl_tpu_torch.device import resolve_device
from libjxl_tpu_torch.frame.decode_frame import decode_frame
from libjxl_tpu_torch.frame.headers import (
    CodecMetadata, read_codestream_headers,
)


@dataclasses.dataclass
class DecodeResult:
    pixels: np.ndarray     # (H, W, C) uint8/uint16 or float32
    metadata: CodecMetadata
    lossless: bool
    preview: np.ndarray | None = None   # decoded preview frame, if any
    # All decoded extra channels as (ExtraChannelInfo, (H, W) array)
    # pairs, in signalling order (alpha included).
    extra: list = dataclasses.field(default_factory=list)

    @property
    def icc(self) -> bytes | None:
        """Embedded ICC profile of the pixel data, if any."""
        return getattr(self.metadata, "icc_profile", None)

    @property
    def is_cmyk(self) -> bool:
        """True when a kBlack extra channel is present (CMYK data;
        color_encoding_internal.h IsCMYK)."""
        return any(int(i.type) == 4 for i, _ in self.extra)

    def to_cmyk(self) -> np.ndarray:
        """(H, W, 4) ink fractions in [0, 1] (C, M, Y, K)."""
        if not self.is_cmyk:
            raise ValueError("no kBlack extra channel")
        maxval = float(np.iinfo(self.pixels.dtype).max) \
            if self.pixels.dtype.kind == "u" else 1.0
        inv = self.pixels[..., :3].astype(np.float32) / maxval
        for info, plane in self.extra:
            if int(info.type) == 4:
                kmax = (1 << info.bit_depth.bits_per_sample) - 1
                k = plane.astype(np.float32) / kmax
                break
        return 1.0 - np.concatenate([inv, k[..., None]], axis=-1)

    def to_srgb(self) -> np.ndarray:
        """Pixels converted to sRGB float32 via the CMS (embedded ICC
        or synthesized enum-space profile; jxl_cms DoColorSpaceTransform
        analogue). CMYK data (kBlack extra channel) converts through
        the embedded CMYK profile, or a naive composite without one."""
        from libjxl_tpu_torch.color import cms
        maxval = float(np.iinfo(self.pixels.dtype).max) \
            if self.pixels.dtype.kind == "u" else 1.0
        px = self.pixels[..., :3].astype(np.float32) / maxval
        if self.is_cmyk:
            inv4 = 1.0 - self.to_cmyk()
            if self.icc is not None and cms.icc_is_cmyk(self.icc) \
                    and cms.available():
                return cms.convert_cmyk_pixels(inv4, self.icc,
                                               cms.srgb_icc())
            return cms.cmyk_to_rgb_naive(inv4)
        ce = self.metadata.m.color_encoding
        src = self.icc if ce.want_icc else cms.synthesize_icc(ce)
        return cms.convert_pixels(px, src, cms.srgb_icc())


@dataclasses.dataclass
class FrameResult:
    pixels: np.ndarray     # (H, W, C) uint8/uint16
    duration: int          # animation ticks (0 for still)


def _apply_orientation(arr: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 -> upright pixels (dec: stage order puts
    orientation last; decode.cc kKeepOrientation=false default)."""
    if orientation == 2:
        return arr[:, ::-1]
    if orientation == 3:
        return arr[::-1, ::-1]
    if orientation == 4:
        return arr[::-1]
    if orientation == 5:
        return arr.transpose(1, 0, 2)
    if orientation == 6:
        return arr.transpose(1, 0, 2)[:, ::-1]
    if orientation == 7:
        return arr.transpose(1, 0, 2)[::-1, ::-1]
    if orientation == 8:
        return arr.transpose(1, 0, 2)[::-1]
    return arr



def _render_spot(color3: np.ndarray, meta, ecs: list,
                 device) -> np.ndarray:
    """Blends spot-color extra channels into (3, H, W) float color
    (render_pipeline/stage_spot.cc: mix = blend * s;
    p = mix * spot_rgb + (1 - mix) * p). All spots mix in one pass on
    the torch ``device`` (ops/stages.py render_spot), as the reference's
    device route runs them (render_spot_tpu); the result comes back to
    the host."""
    spots = [(i, eci) for i, eci in enumerate(meta.m.extra_channel_info)
             if int(eci.type) == 2 and i < len(ecs)]  # SPOT_COLOR
    if not spots:
        return color3
    from libjxl_tpu_torch.ops.stages import render_spot
    mixes = np.stack([
        np.asarray(ecs[i], np.float32)
        / ((1 << eci.bit_depth.bits_per_sample) - 1)
        for i, eci in spots])
    rgba = np.array([eci.spot_color for _, eci in spots], np.float32)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(device)

    return render_spot(on_dev(color3), on_dev(mixes), on_dev(rgba)) \
        .cpu().numpy()


def decode(data: bytes, device=None,
           float_out: bool = False,
           render_spotcolors: bool = True,
           dtype=None) -> DecodeResult:
    """Decode a (possibly containerized) codestream to pixels.

    device: the torch device of the device stages (default ``cuda``;
    raises when there is no card): VarDCT frames decode there, with the
    loop filters on the CUDA kernel on a card, and spot colours mix
    there; modular frames, previews and the output conversion run on
    the host, as in the reference's device route.
    dtype: None (native bit depth), or one of np.uint8/np.uint16/
    np.float16/np.float32 — the JxlPixelFormat data_type surface
    (dec_external_image.h ConvertToExternal)."""
    device = resolve_device(device)
    if dtype is not None:
        dtype = np.dtype(dtype)
        if dtype.kind == "f":
            res = _decode_impl(data, device, True, render_spotcolors)
            px = res.pixels
            if px.dtype.kind == "u":
                # Modular path returns native integers; normalize.
                px = px.astype(np.float64) / np.iinfo(px.dtype).max
            res.pixels = px.astype(dtype)
            return res
        res = decode(data, device=device,
                     render_spotcolors=render_spotcolors)
        if res.pixels.dtype != dtype:
            src_max = float(np.iinfo(res.pixels.dtype).max)
            dst_max = float(np.iinfo(dtype).max)
            res.pixels = np.clip(np.round(
                res.pixels.astype(np.float64) * (dst_max / src_max)),
                0, dst_max).astype(dtype)
        return res
    return _decode_impl(data, device, float_out, render_spotcolors)


def _decode_impl(data: bytes, device,
                 float_out: bool = False,
                 render_spotcolors: bool = True) -> DecodeResult:
    if is_container(data):
        data = unpack_container(data).codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    # Frames start immediately (bit-unaligned); the TOC aligns internally.
    from libjxl_tpu_torch.frame.frame_header import FrameType
    refs: list = [None] * 4
    dcs: list = [None] * 5
    preview = None
    if meta.m.have_preview:
        pframe = decode_frame(r, meta, refs, is_preview=True)
        pcolor, _ = _frame_to_float(pframe, meta)
        bits_p = meta.m.bit_depth.bits_per_sample
        pdtype = np.uint8 if bits_p <= 8 else np.uint16
        pmax = (1 << bits_p) - 1
        preview = np.clip(np.round(pcolor * pmax), 0, pmax).astype(pdtype)
    while True:
        frame = decode_frame(r, meta, refs, dc_frames=dcs, device=device)
        fh = frame.header
        if fh.frame_type == FrameType.DC_FRAME:
            dcs[fh.dc_level] = frame.xyb
            continue
        if fh.save_as_reference is not None and frame.xyb is not None \
                and fh.frame_type == FrameType.REFERENCE_ONLY:
            refs[fh.save_as_reference] = frame.xyb
            continue
        break

    bits = meta.m.bit_depth.bits_per_sample
    dtype = np.uint8 if bits <= 8 else np.uint16
    maxval = (1 << bits) - 1
    if frame.modular_channels is not None:
        from libjxl_tpu_torch.frame.frame_header import ColorTransform
        if frame.header.color_transform == ColorTransform.YCBCR:
            from libjxl_tpu_torch.color.ycbcr import chroma_upsample, ycbcr_to_rgb
            cs = frame.header.chroma_subsampling
            planes = []
            for c in range(3):
                p = frame.modular_channels[c].astype(np.float64) / maxval
                hs, vs = cs.hshift(c), cs.vshift(c)
                if hs or vs:
                    p = chroma_upsample(p, hs, vs, meta.xsize, meta.ysize)
                planes.append(p)
            rgb = ycbcr_to_rgb(planes[0], planes[1], planes[2])
            arr = np.clip(np.round(rgb * maxval), 0, maxval).astype(dtype)
            arr = _apply_orientation(arr.transpose(1, 2, 0),
                                     meta.m.orientation)
            return DecodeResult(pixels=arr, metadata=meta, lossless=False)
        chans = frame.modular_channels
        nec = meta.m.num_extra_channels
        ecinfo = meta.m.extra_channel_info
        ncolor = len(chans) - nec
        keep = ncolor
        if nec and int(ecinfo[0].type) == 0:  # leading alpha -> pixels
            keep += 1
        extra_list = [(ecinfo[i], np.asarray(chans[ncolor + i]))
                      for i in range(nec)]
        spotty = render_spotcolors and ncolor >= 3 and any(
            int(e.type) == 2 for e in ecinfo)
        if spotty:
            color = np.stack([np.asarray(c, np.float32) / maxval
                              for c in chans[:3]])
            color = _render_spot(color, meta,
                                 [a for _, a in extra_list],
                                 device=device)
            for c in range(3):
                chans[c] = np.round(color[c] * maxval).astype(np.int64)
        from libjxl_tpu_torch.native import bindings as _nb
        if (_nb.available()
                and all(isinstance(c, np.ndarray) and c.dtype == np.int32
                        and c.flags.c_contiguous
                        and c.shape == chans[0].shape
                        for c in chans[:keep])):
            arr = _nb.interleave_clip(chans[:keep], maxval, dtype)
        else:
            arr = np.stack(chans[:keep], axis=-1)
            arr = np.clip(arr, 0, maxval).astype(dtype)
        arr = _apply_orientation(arr, meta.m.orientation)
        return DecodeResult(pixels=arr, metadata=meta, lossless=True,
                            preview=preview, extra=extra_list)

    from libjxl_tpu_torch.frame.frame_header import ColorTransform as _CT
    _tf_enum0 = meta.m.color_encoding.tf.transfer_function \
        if not meta.m.color_encoding.tf.have_gamma else None
    from libjxl_tpu_torch.color.color_encoding import TransferFunction as _TF0
    if (frame.header.color_transform != _CT.YCBCR and not float_out
            and not frame.extra_channels
            and _tf_enum0 not in (int(_TF0.PQ), int(_TF0.HLG))):
        # Fused native XYB -> sRGB -> quantized pixels (the whole tail
        # of the hot sRGB decode path in one C++ pass).
        from libjxl_tpu_torch.color.xyb import xyb_to_srgb_px_native
        fused = xyb_to_srgb_px_native(frame.xyb, maxval, dtype)
        if fused is not None:
            fused = _apply_orientation(fused, meta.m.orientation)
            return DecodeResult(pixels=fused, metadata=meta,
                                lossless=False, preview=preview,
                                extra=[])
    if frame.header.color_transform == _CT.YCBCR:
        # VarDCT YCbCr (JPEG transcode): planes are (Cb, Y-128, Cr)/255.
        from libjxl_tpu_torch.color.ycbcr import ycbcr_to_rgb
        srgb = np.clip(ycbcr_to_rgb(frame.xyb[0], frame.xyb[1],
                                    frame.xyb[2]), 0.0, 1.0)
    else:
        linear = xyb_to_linear_rgb(frame.xyb)
        if render_spotcolors and frame.extra_channels:
            linear = _render_spot(linear, meta, frame.extra_channels,
                                  device=device)
        tf_enum = meta.m.color_encoding.tf.transfer_function \
            if not meta.m.color_encoding.tf.have_gamma else None
        from libjxl_tpu_torch.color.color_encoding import TransferFunction as _TF
        if tf_enum == int(_TF.PQ):
            # XYB linear output is in nits/255 units; PQ-encode the
            # absolute signal (TF_PQ, transfer_functions-inl.h:135).
            from libjxl_tpu_torch.color.transfer_functions import (
                pq_encoded_from_display)
            srgb = pq_encoded_from_display(
                linear * (255.0 / 10000.0)).astype(np.float32)
        elif tf_enum == int(_TF.HLG):
            from libjxl_tpu_torch.color.transfer_functions import (
                hlg_encoded_from_display, hlg_inverse_ootf,
                hlg_ootf_gamma)
            it = meta.m.tone_mapping.intensity_target
            disp = linear * (255.0 / it)
            scene = hlg_inverse_ootf(disp.astype(np.float64),
                                     hlg_ootf_gamma(it))
            srgb = hlg_encoded_from_display(scene).astype(np.float32)
        else:
            srgb = linear_to_srgb(linear)
    ecinfo = meta.m.extra_channel_info
    ecs = frame.extra_channels or []
    extra_list = [(ecinfo[i], np.asarray(ecs[i])) for i in range(len(ecs))]
    lead_alpha = ecs and int(ecinfo[0].type) == 0
    if float_out:
        arr = np.clip(srgb, 0.0, 1.0).astype(np.float32).transpose(1, 2, 0)
        if lead_alpha:
            alpha = (np.clip(ecs[0], 0, maxval)
                     .astype(np.float32) / maxval)[:, :, None]
            arr = np.concatenate([arr, alpha], axis=-1)
        arr = _apply_orientation(arr, meta.m.orientation)
        return DecodeResult(pixels=arr, metadata=meta, lossless=False,
                            preview=preview, extra=extra_list)
    arr = np.clip(np.round(srgb * maxval), 0, maxval).astype(dtype)
    arr = arr.transpose(1, 2, 0)
    if lead_alpha:
        alpha = np.clip(ecs[0], 0, maxval).astype(dtype)[:, :, None]
        arr = np.concatenate([arr, alpha], axis=-1)
    arr = _apply_orientation(arr, meta.m.orientation)
    return DecodeResult(pixels=arr, metadata=meta, lossless=False,
                        preview=preview, extra=extra_list)


def _frame_to_float(frame, meta) -> tuple[np.ndarray, np.ndarray | None]:
    """DecodedFrame -> ((H,W,3) sRGB float [0,1], alpha float or None)."""
    bits = meta.m.bit_depth.bits_per_sample
    maxval = (1 << bits) - 1
    if frame.modular_channels is not None:
        chans = frame.modular_channels
        nec = meta.m.num_extra_channels
        ncolor = len(chans) - nec
        color = np.stack(chans[:ncolor], axis=-1).astype(np.float32) / maxval
        if ncolor == 1:
            color = np.repeat(color, 3, axis=2)
        alpha = None
        if nec:
            alpha = chans[ncolor].astype(np.float32) / maxval
        return np.clip(color, 0.0, 1.0), alpha
    # Unclamped sign-symmetric encode: blending happens on these values
    # and only the displayed frame clips (stage_from_linear TF_SRGB).
    from libjxl_tpu_torch.color.xyb import linear_to_srgb_ext
    srgb = linear_to_srgb_ext(xyb_to_linear_rgb(frame.xyb)) \
        .transpose(1, 2, 0)
    alpha = None
    if frame.extra_channels:
        alpha = np.clip(frame.extra_channels[0].astype(np.float32)
                        / maxval, 0.0, 1.0)
    return srgb, alpha


def decode_all(data: bytes, device=None
               ) -> tuple[list[FrameResult], CodecMetadata]:
    """Decode every frame of a (possibly animated) codestream, applying
    frame blending (dec: blending.cc PerformBlending, decode.cc frame
    loop). Returns displayed frames with their tick durations.
    The frames decode on the host, as in the reference; the composition
    canvas stays on the torch ``device`` (default ``cuda``; raises when
    there is no card) between frames and blends there
    (ops/stages.py blend_frame, the stage_blending.cc analogue)."""
    from libjxl_tpu_torch.frame.frame_header import FrameType
    from libjxl_tpu_torch.ops.stages import blend_frame

    device = resolve_device(device)

    if is_container(data):
        data = unpack_container(data).codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    h, w = meta.ysize, meta.xsize
    bits = meta.m.bit_depth.bits_per_sample
    dtype = np.uint8 if bits <= 8 else np.uint16
    maxval = (1 << bits) - 1
    from libjxl_tpu_torch.frame.headers import ExtraChannelType
    has_alpha = any(int(eci.type) == int(ExtraChannelType.ALPHA)
                    for eci in meta.m.extra_channel_info)

    def zeros(*shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=device)

    canvas = zeros(h, w, 3)
    canvas_alpha = zeros(h, w) if has_alpha else None
    # Composed (color, alpha) slots, device tensors; blend_frame never
    # modifies its inputs, so a slot needs no copy.
    comp_refs: list = [None] * 4
    results: list[FrameResult] = []
    refs: list = [None] * 4
    if meta.m.have_preview:
        decode_frame(r, meta, refs, is_preview=True)  # skip preview
    dcs2: list = [None] * 5
    while True:
        frame = decode_frame(r, meta, refs, dc_frames=dcs2)
        fh = frame.header
        if fh.frame_type == FrameType.DC_FRAME:
            dcs2[fh.dc_level] = frame.xyb
            continue
        if fh.frame_type == FrameType.REFERENCE_ONLY:
            if frame.xyb is not None:
                refs[fh.save_as_reference] = frame.xyb
            continue
        color, alpha = _frame_to_float(frame, meta)
        # Per-spec composition: a blending frame reads its background
        # from reference slot blending_info.source (frame_header.h),
        # NOT from an implicit running canvas; the result is stored
        # back when the frame can be referenced (CanBeReferenced).
        mode = int(fh.blending_info.mode)
        src_slot = int(fh.blending_info.source)
        if mode == 0:
            canvas = zeros(h, w, 3)
            canvas_alpha = zeros(h, w) if has_alpha else None
        else:
            bg = comp_refs[src_slot]
            canvas = bg[0] if bg is not None else zeros(h, w, 3)
            canvas_alpha = bg[1] if bg is not None else \
                (zeros(h, w) if has_alpha else None)
            if canvas_alpha is None and has_alpha:
                canvas_alpha = zeros(h, w)
        canvas, canvas_alpha = blend_frame(
            canvas, canvas_alpha, color, alpha, mode,
            fh.frame_origin_x0, fh.frame_origin_y0)
        can_ref = (not fh.is_last
                   and (fh.animation_frame.duration == 0
                        or fh.save_as_reference != 0))
        if can_ref:
            comp_refs[int(fh.save_as_reference)] = (canvas, canvas_alpha)
        if fh.frame_type == FrameType.REGULAR:
            shown = np.clip(np.round(canvas.cpu().numpy() * maxval), 0,
                            maxval).astype(dtype)
            if canvas_alpha is not None:
                a8 = np.clip(np.round(canvas_alpha.cpu().numpy() * maxval),
                             0, maxval).astype(dtype)
                shown = np.concatenate([shown, a8[:, :, None]], axis=-1)
            results.append(FrameResult(
                pixels=_apply_orientation(shown, meta.m.orientation),
                duration=fh.animation_frame.duration))
        if fh.is_last:
            break
    return results, meta
