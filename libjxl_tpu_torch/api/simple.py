"""One-shot API of the port.

encode(): (H, W, 3) or (H, W) arrays -> .jxl codestream bytes.
decode(): codestream bytes -> pixels + metadata.
decode_all(): every displayed frame of an animation, blended.
encode_animation(), encode_streaming(): animations and chunked encode.

Copy of libjxl_tpu/api/simple.py, on the reference's device routes with
``device`` a torch device (default ``cuda``, raising without a card):
- ``encode`` (with ``_butteraugli_qf_iteration`` and
  ``_encode_modular_lossy``) runs the VarDCT frames that the
  reference's ``encode(img, device=True)`` sends to its device route
  through the port's stages (``frame/encode_frame.py``,
  ``ops/encode.py``) on ``device``; the DC frame, the preview, the patch
  and dot sheets stay on the host, as in the reference. The quant-field
  iteration of effort 8 and above decodes its trial streams on the
  host, as the reference's does;
- ``decode`` decodes VarDCT frames through
  ``tpu.pipeline.decode_frame_device2`` (the loop filters on the CUDA
  kernel on a card), spot colours mix there and the animation canvas
  blends and stays there; the XYB comes back to the host, which converts
  it to output pixels, as the reference does. There is no host-only
  mode: the JAX package's host decoder is the oracle the tests hold the
  port against;
- ``encode_animation`` runs on the host, as the reference's does, and
  takes no device; ``encode_streaming`` encodes its chunks on the host
  and passes ``device`` only to the one-shot ``encode`` of a
  single-group image.

Reference analogue: lib/extras/enc/jxl.cc EncodeImageJXL /
lib/extras/dec/jxl.cc DecodeImageJXL driving the C API.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
from libjxl_tpu_torch.color.color_encoding import ColorEncoding
from libjxl_tpu_torch.color.xyb import (
    linear_rgb_to_xyb, linear_to_srgb, srgb_to_linear, xyb_to_linear_rgb,
)
from libjxl_tpu_torch.container.boxes import is_container, pack_container, \
    unpack_container
from libjxl_tpu_torch.device import resolve_device
from libjxl_tpu_torch.frame.decode_frame import decode_frame
from libjxl_tpu_torch.frame.encode_frame import (
    encode_modular_frame, encode_vardct_frame,
)
from libjxl_tpu_torch.frame.headers import (
    BitDepth, CodecMetadata, read_codestream_headers, write_codestream_headers,
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


def encode(image: np.ndarray, *, distance: float = 1.0,
           lossless: bool = False, container: bool = False,
           progressive: bool = False, noise=None,
           resampling: int = 1, effort: int = 7,
           dots: bool = False, patches: bool = True,
           preview: bool = False,
           dc_frame: bool = False, hdr: str | None = None,
           icc: bytes | None = None,
           photon_noise_iso: float | None = None,
           extra_channels: list | None = None,
           color_encoding=None, cmyk: bool = False,
           modular: bool = False, group_order: bool | tuple = False,
           already_downsampled: bool = False, epf: int = -1,
           device=None, chroma_subsampling: str | None = None,
           aux_out=None, debug_dir: str | None = None) -> bytes:
    """Encode an sRGB image array to a JPEG XL codestream.

    image: (H, W, 3) or (H, W); uint8, uint16 or float in [0, 1].
    distance: butteraugli target for the lossy path (0 => lossless).
    effort: >= 8 enables the butteraugli-guided quant-field iteration
    (enc_heuristics FindBestQuantization analogue, ~3x encode time).
    extra_channels: additional named channels beyond the in-image
    alpha, each {"type": "alpha"|"depth"|"spot_color"|"black"|
    "thermal"|"cfa"|"optional", "data": (H, W) uint array,
    "name": str, "spot_color": (r, g, b, blend)} — the
    JxlEncoderSetExtraChannelInfo surface (encode.cc:1003).
    device: the torch device of the VarDCT stages (default ``cuda``;
    raises when there is no card). The frames that the reference's
    ``device=True`` sends to its device route run there; the DC frame,
    the preview, the patch and dot sheets and the host-only modes stay
    on the host, as in the reference.
    """
    device = resolve_device(device)
    if distance == 0:
        lossless = True
    if chroma_subsampling is not None:
        # 420/422 YCbCr VarDCT (DCT8X8, RAW quant tables, optional
        # gaborish/EPF + progressive); see encode_ycbcr_vardct_frame.
        if lossless:
            raise ValueError("chroma_subsampling is a lossy VarDCT mode")
        if chroma_subsampling not in ("420", "422"):
            raise ValueError("chroma_subsampling must be '420' or '422'")
        from libjxl_tpu_torch.frame.encode_frame import encode_ycbcr_vardct_frame
        img = np.asarray(image)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("chroma_subsampling expects (H, W, 3) uint8")
        meta = CodecMetadata()
        meta.size.set(img.shape[1], img.shape[0])
        meta.m.bit_depth = BitDepth.uint(8)
        meta.m.xyb_encoded = False
        meta.m.color_encoding = ColorEncoding.srgb(is_gray=False)
        writer = BitWriter()
        write_codestream_headers(meta, writer)
        encode_ycbcr_vardct_frame(img, meta, writer, distance=distance,
                                  subsampling=chroma_subsampling,
                                  epf=epf, progressive=progressive)
        writer.align_to_byte()
        data = writer.get_bytes()
        if container:
            data = pack_container(data)
        return data
    if modular and not lossless:
        # Lossy modular (cjxl -m with -d > 0): RCT + full squeeze,
        # post-squeeze residuals snapped to quality-scaled multiples
        # (enc_modular.cc:980 "responsive" mode).
        return _encode_modular_lossy(image, distance, container)
    if cmyk:
        # CMYK input: (H, W, 4) ink fractions (or uint8/16). The JXL
        # convention stores inverted samples (1.0 = white / no ink,
        # jxl_cms.cc:260) as 3 color channels + a kBlack extra channel.
        if image.ndim != 3 or image.shape[2] != 4:
            raise ValueError("cmyk=True expects an (H, W, 4) image")
        if image.dtype.kind == "u":
            mv = np.iinfo(image.dtype).max
            inv = (mv - image.astype(np.int64)).astype(image.dtype)
        else:
            inv = (1.0 - image).astype(image.dtype)
        extra_channels = list(extra_channels or [])
        extra_channels.insert(0, {"type": "black", "data": inv[:, :, 3],
                                  "name": "K"})
        image = np.ascontiguousarray(inv[:, :, :3])
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, nchan = image.shape
    has_alpha = nchan in (2, 4)
    if image.dtype == np.uint8:
        bits = 8
        scale = 255.0
    elif image.dtype == np.uint16:
        bits = 16
        scale = 65535.0
    else:
        bits = 8 if not lossless else 16
        scale = 1.0

    meta = CodecMetadata()
    if already_downsampled and resampling != 1:
        # ALREADY_DOWNSAMPLED: the supplied pixels are at the coded
        # (1/N) resolution; the image header carries the full size
        # (encode.h JXL_ENC_FRAME_SETTING_ALREADY_DOWNSAMPLED).
        meta.size.set(w * resampling, h * resampling)
    else:
        meta.size.set(w, h)
    meta.m.bit_depth = BitDepth.uint(bits)
    if hdr is not None:
        # HDR signalling: BT.2100 primaries + PQ/HLG transfer and the
        # matching intensity/tone targets (image_metadata ToneMapping).
        from libjxl_tpu_torch.color.color_encoding import (
            Primaries, TransferFunction)
        ce = ColorEncoding.srgb(is_gray=False)
        ce.primaries = int(Primaries.BT2100)
        ce.tf.have_gamma = False
        ce.tf.transfer_function = int(
            TransferFunction.PQ if hdr.lower() == "pq"
            else TransferFunction.HLG)
        meta.m.color_encoding = ce
        meta.m.tone_mapping.intensity_target =             10000.0 if hdr.lower() == "pq" else 1000.0
        meta.m.tone_mapping.all_default = False
    if color_encoding is not None:
        # cjxl -x color_space= hint: samples are in the described
        # space (lib/extras color hints; lossless passthrough only —
        # the lossy path's XYB transform assumes sRGB input).
        if isinstance(color_encoding, str):
            from libjxl_tpu_torch.color.color_description import (
                parse_color_description)
            color_encoding = parse_color_description(color_encoding)
        if not lossless:
            raise ValueError(
                "color_encoding hints require lossless=True; use hdr= "
                "or icc= for the lossy path")
        color_encoding.all_default = False
        meta.m.color_encoding = color_encoding
    if icc is not None:
        # Embedded ICC: samples are in the profile's space
        # (color_encoding want_icc + compressed-ICC payload).
        meta.m.color_encoding.want_icc = True
        meta.m.color_encoding.all_default = False
        meta.icc_profile = icc
    if has_alpha:
        meta.m.set_alpha_bits(bits)
    ec_planes: list = []
    if extra_channels:
        from libjxl_tpu_torch.frame.headers import (
            BitDepth as _BD, ExtraChannelInfo, ExtraChannelType)
        type_names = {
            "alpha": ExtraChannelType.ALPHA,
            "depth": ExtraChannelType.DEPTH,
            "spot_color": ExtraChannelType.SPOT_COLOR,
            "selection_mask": ExtraChannelType.SELECTION_MASK,
            "black": ExtraChannelType.BLACK,
            "cfa": ExtraChannelType.CFA,
            "thermal": ExtraChannelType.THERMAL,
            "optional": ExtraChannelType.OPTIONAL,
        }
        for spec in extra_channels:
            ctype = spec.get("type", "optional")
            if isinstance(ctype, str):
                ctype = type_names[ctype.lower()]
            plane = np.asarray(spec["data"])
            if plane.shape != (h, w):
                raise ValueError("extra channel shape mismatch")
            ec_bits = int(spec.get("bits", bits))
            eci = ExtraChannelInfo(all_default=False, type=int(ctype),
                                   bit_depth=_BD.uint(ec_bits),
                                   name=spec.get("name", ""))
            if "spot_color" in spec:
                eci.spot_color = tuple(float(x)
                                       for x in spec["spot_color"])
            meta.m.extra_channel_info.append(eci)
            ec_planes.append(plane.astype(np.int32))
        meta.m.all_default = False
    pw_img = None
    if preview and not lossless:
        div = max(1, (max(h, w) + 127) // 128)
        ph, pw_ = max(1, h // div), max(1, w // div)
        meta.m.have_preview = True
        meta.m.preview_size.div8 = False
        meta.m.preview_size.ysize_raw = ph
        meta.m.preview_size.ratio = 0
        meta.m.preview_size.xsize_raw = pw_
        pimg = image[:h - h % div or h, :w - w % div or w, :3]
        hh, ww = (h // div) * div, (w // div) * div
        pw_img = image[:hh, :ww, :min(3, image.shape[2])].astype(np.float32)
        pw_img = pw_img.reshape(ph, div, pw_, div, -1).mean((1, 3))
    writer = BitWriter()
    if lossless:
        meta.m.xyb_encoded = False
        if hdr is None and icc is None and color_encoding is None:
            meta.m.color_encoding = ColorEncoding.srgb(
                is_gray=(nchan - (1 if has_alpha else 0)) == 1)
        if image.dtype not in (np.uint8, np.uint16):
            raise ValueError("lossless encode expects integer samples")
        write_codestream_headers(meta, writer)
        ncolor = nchan - 1 if has_alpha else nchan
        channels = [image[:, :, c].astype(np.int32) for c in range(ncolor)]
        if has_alpha:
            channels.append(image[:, :, -1].astype(np.int32))
        channels.extend(ec_planes)
        pos0 = writer.bits_written
        if effort <= 3:
            # Fast-lossless path (fjxl analogue): fixed YCoCg + fixed
            # gradient tree, no search.
            from libjxl_tpu_torch.modular.codec import Transform, TransformId
            transforms = [Transform(id=TransformId.RCT, begin_c=0,
                                    rct_type=6)] if ncolor >= 3 else []
            # Prefix codes at e<=2 (enc_fast_lossless.cc uses prefix
            # over ANS: cheaper build, forward native emission); no
            # LZ77 trial at e1.
            encode_modular_frame(channels, meta, writer,
                                 transforms=transforms, learn_tree=False,
                                 use_prefix=effort <= 2,
                                 try_lz77=effort > 1)
        else:
            from libjxl_tpu_torch.frame.enc_modular_heuristics import (
                select_modular_transforms)
            transforms = select_modular_transforms(channels, bits)
            encode_modular_frame(channels, meta, writer,
                                 transforms=transforms)
        if aux_out is not None:
            aux_out.add("modular_global", writer.bits_written - pos0)
    else:
        meta.m.xyb_encoded = True
        write_codestream_headers(meta, writer)
        ncolor = nchan - 1 if has_alpha else nchan
        srgb = image[:, :, :min(ncolor, 3)].astype(np.float32) / scale
        if ncolor == 1:
            srgb = np.repeat(srgb, 3, axis=2)
        if hdr is not None:
            # HDR: apply the signalled transfer function; XYB input is
            # linear light in nits/255 units (enc_xyb.cc
            # ComputePremulAbsorb: mul = intensity_target / 255).
            from libjxl_tpu_torch.color.transfer_functions import (
                hlg_display_from_encoded, hlg_ootf, hlg_ootf_gamma,
                pq_display_from_encoded)
            it = meta.m.tone_mapping.intensity_target
            enc01 = srgb.transpose(2, 0, 1).astype(np.float64)
            if hdr.lower() == "pq":
                linear = (pq_display_from_encoded(enc01)
                          * (10000.0 / 255.0)).astype(np.float32)
            else:
                scene = hlg_display_from_encoded(enc01)
                disp = hlg_ootf(scene, hlg_ootf_gamma(it))
                linear = (disp * (it / 255.0)).astype(np.float32)
        elif image.dtype == np.uint8 and scale == 255.0:
            from libjxl_tpu_torch.color.xyb import (srgb8_to_xyb_native,
                                              srgb_to_linear_u8)
            src = image[:, :, :min(ncolor, 3)]
            if ncolor == 1:
                src = np.repeat(src, 3, axis=2)
            xyb = srgb8_to_xyb_native(src)
            linear = None if xyb is not None \
                else srgb_to_linear_u8(src).transpose(2, 0, 1)
        else:
            linear = srgb_to_linear(srgb).transpose(2, 0, 1)
        if linear is not None:
            xyb = linear_rgb_to_xyb(linear)
        extra = [image[:, :, -1].astype(np.int32)] if has_alpha else []
        extra = (extra + ec_planes) or None
        if photon_noise_iso:
            # JXL_ENC_FRAME_SETTING_PHOTON_NOISE: ISO-based grain model
            # (enc_photon_noise.cc SimulatePhotonNoise).
            from libjxl_tpu_torch.frame.noise import simulate_photon_noise
            noise = simulate_photon_noise(w, h, photon_noise_iso)
        elif noise == "auto":
            from libjxl_tpu_torch.frame.noise import estimate_noise
            lut = estimate_noise(xyb)
            noise = float(lut.mean()) if lut is not None else None
        frame_kwargs = dict(distance=distance, extra_channels=extra,
                            pass_shifts=[2, 0] if progressive else None,
                            noise=noise, resampling=resampling,
                            ar_sharpness=effort >= 6, effort=effort,
                            aux_out=aux_out, debug_dir=debug_dir,
                            group_order_center=group_order or None,
                            already_downsampled=already_downsampled,
                            epf=epf, device=device)
        if dc_frame and resampling == 1:
            # 1:8 DC frame (kUseDcFrame): encode the 8x-downsampled
            # image as a kDCFrame, then reference it from the main
            # frame (dec_frame.cc dc_frames).
            # The main frame stores the DC of the gaborish-inverted
            # planes, so the DC frame must carry that same signal.
            from libjxl_tpu_torch.frame.adaptive_quant import gaborish_inverse
            inv = gaborish_inverse(xyb)
            _, fy, fx = inv.shape
            py, px = (-fy) % 8, (-fx) % 8
            pimg2 = np.pad(inv, ((0, 0), (0, py), (0, px)), mode="edge")
            dc_img = pimg2.reshape(3, (fy + py) // 8, 8,
                                   (fx + px) // 8, 8).mean((2, 4))
            # Encode once standalone (identical alignment) to learn the
            # decoded DC the main frame must assume.
            # DC deserves near-lossless coding (it becomes every
            # block's mean); cost is tiny at 1/64th the pixels.
            dc_dist = max(0.02, 0.04 * distance)
            trial = BitWriter()
            write_codestream_headers(meta, trial)
            encode_vardct_frame(dc_img, meta, trial, distance=dc_dist,
                                dc_frame_level=1)
            from libjxl_tpu_torch.frame.decode_frame import decode_frame
            tr = BitReader(trial.get_bytes())
            read_codestream_headers(tr)
            decoded_dc = decode_frame(tr, meta).xyb
            encode_vardct_frame(dc_img, meta, writer, distance=dc_dist,
                                dc_frame_level=1)
            frame_kwargs["external_dc"] = decoded_dc
        if pw_img is not None:
            scale_p = 255.0 if bits == 8 else 65535.0
            psrgb = pw_img / scale_p
            if psrgb.shape[2] == 1:
                psrgb = np.repeat(psrgb, 3, axis=2)
            pxyb = linear_rgb_to_xyb(
                srgb_to_linear(psrgb.astype(np.float32)).transpose(2, 0, 1))
            encode_vardct_frame(pxyb, meta, writer, distance=max(
                distance, 1.0), is_preview=True)
        if patches and resampling == 1 and not has_alpha:
            # Text-like patch dictionary for screenshot/UI content
            # (enc_patch_dictionary.cc:620 FindBestPatchDictionary).
            from libjxl_tpu_torch.frame.text_patches import (
                build_text_patch_sheet, find_text_like_patches)
            found = find_text_like_patches(xyb)
            if found:
                sheet, pd, cleaned = build_text_patch_sheet(xyb, found)
                sh, sw = sheet.shape[1:]
                if sh <= xyb.shape[1] and sw <= xyb.shape[2]:
                    canvas = np.zeros_like(xyb)
                    canvas[:, :sh, :sw] = sheet
                    encode_vardct_frame(canvas, meta, writer,
                                        distance=min(distance, 0.1),
                                        save_as_reference=1)
                    xyb = cleaned
                    frame_kwargs["patches"] = pd
                    dots = False
        if dots and resampling == 1:
            from libjxl_tpu_torch.frame.dots import build_dot_sheet, detect_dots
            dot_list, cleaned = detect_dots(xyb, distance)
            if dot_list:
                sheet, pd = build_dot_sheet(xyb, dot_list)
                canvas = np.zeros_like(xyb)
                sh, sw = sheet.shape[1:]
                if sh <= canvas.shape[1] and sw <= canvas.shape[2]:
                    canvas[:, :sh, :sw] = sheet
                    encode_vardct_frame(canvas, meta, writer,
                                        distance=min(distance, 0.3),
                                        save_as_reference=1)
                    xyb = cleaned
                    frame_kwargs["patches"] = pd
        qf_adjust = None
        if effort >= 8 and resampling == 1 and noise is None:
            # e8 -> 2 refinement iterations, e9 -> 3, e10 (the
            # kGlacier/kTectonicPlate-class exhaustive tier,
            # common.h:42-71) -> 5 with a finer step.
            iters = {8: 2, 9: 3}.get(effort, 5)
            qf_adjust = _butteraugli_qf_iteration(
                image, srgb, xyb, meta, writer, distance, frame_kwargs,
                iterations=iters, fine=effort >= 10)
        encode_vardct_frame(xyb, meta, writer, qf_adjust=qf_adjust,
                            **frame_kwargs)
    writer.align_to_byte()
    data = writer.get_bytes()
    return pack_container(data) if container else data


def _butteraugli_qf_iteration(image, srgb, xyb, meta, header_writer,
                              distance, frame_kwargs,
                              iterations: int = 2,
                              fine: bool = False) -> np.ndarray:
    """Iteratively refines a per-8x8-block quant-field multiplier so
    the decoded butteraugli error tracks the target distance
    (enc_heuristics.cc FindBestQuantization's role). ``fine`` (the
    effort-10 tier) takes smaller, better-damped steps so the extra
    iterations converge instead of oscillating."""
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.metrics.butteraugli import butteraugli_diffmap

    h, w = srgb.shape[:2]
    by, bx = (h + 7) // 8, (w + 7) // 8
    adjust = np.ones((by + 4, bx + 4), np.float32)
    ref_linear = srgb_to_linear(srgb).transpose(2, 0, 1).astype(np.float64)
    header_bytes_writer = BitWriter()
    # Re-create the headers so trial streams are self-contained.
    write_codestream_headers(meta, header_bytes_writer)
    best = (np.inf, adjust.copy())   # (measured overshoot, field)
    for _ in range(iterations + 1):
        trial = BitWriter()
        write_codestream_headers(meta, trial)
        encode_vardct_frame(xyb, meta, trial,
                            qf_adjust=adjust, **frame_kwargs)
        trial.align_to_byte()
        # The host decode, as the reference's (device=False).
        res = _decode_impl(trial.get_bytes(), None)
        dec_srgb = res.pixels[:, :, :3].astype(np.float32) / \
            (255.0 if res.pixels.dtype == np.uint8 else 65535.0)
        dec_linear = srgb_to_linear(dec_srgb).transpose(2, 0, 1) \
            .astype(np.float64)
        dmap = butteraugli_diffmap(ref_linear, dec_linear)
        # Per-block 90th-percentile error vs the target distance.
        pb, qb = by * 8 - h, bx * 8 - w
        dpad = np.pad(dmap, ((0, pb), (0, qb)), mode="edge")
        blocks = dpad.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3) \
            .reshape(by, bx, 64)
        err = np.quantile(blocks, 0.9, axis=-1)
        step_exp, step_lim = (0.35, 1.12) if fine else (0.6, 1.3)
        ratio = np.clip((err / max(distance, 1e-6)) ** step_exp,
                        1 / step_lim, step_lim)
        # Keep the step monotone toward the target: while the global
        # distance overshoots, blocks may only get finer (and vice
        # versa) — per-block relaxation otherwise trades bits away from
        # the blocks that set the max norm (FindBestQuantization's
        # one-sided update, enc_adaptive_quantization.cc:929).
        global_err = float(dmap.max())
        # Track the best MEASURED field: the loop's last update would
        # otherwise ship unmeasured, and an overshooting step could
        # leave e8 worse than the e7 baseline.
        score = max(global_err - distance, 0.0) * 4.0 + global_err
        if score < best[0]:
            best = (score, adjust.copy())
        if global_err > distance:
            ratio = np.maximum(ratio, 1.0)
        elif global_err < 0.9 * distance:
            ratio = np.minimum(ratio, 1.0)
        adjust[:by, :bx] = np.clip(adjust[:by, :bx] * ratio, 0.4, 2.5)
    return best[1]



def _encode_modular_lossy(image: np.ndarray, distance: float,
                          container: bool) -> bytes:
    from libjxl_tpu_torch.frame.encode_frame import encode_modular_frame
    from libjxl_tpu_torch.modular.codec import Transform, TransformId

    if image.ndim == 2:
        image = image[:, :, None]
    h, w, nchan = image.shape
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError("modular encode expects integer samples")
    bits = 8 if image.dtype == np.uint8 else 16
    meta = CodecMetadata()
    meta.size.set(w, h)
    meta.m.bit_depth = BitDepth.uint(bits)
    meta.m.xyb_encoded = False
    meta.m.color_encoding = ColorEncoding.srgb(is_gray=nchan == 1)
    writer = BitWriter()
    write_codestream_headers(meta, writer)
    channels = [image[:, :, c].astype(np.int32)
                for c in range(min(nchan, 3))]
    transforms = []
    if len(channels) >= 3:
        transforms.append(Transform(id=TransformId.RCT, begin_c=0,
                                    rct_type=6))
    transforms.append(Transform(id=TransformId.SQUEEZE, squeezes=[]))
    encode_modular_frame(channels, meta, writer, transforms=transforms,
                         lossy_distance=distance)
    writer.align_to_byte()
    data = writer.get_bytes()
    return pack_container(data) if container else data


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


def encode_animation(frames: list, *, durations: list | None = None,
                     tps: tuple = (10, 1), distance: float = 1.0,
                     lossless: bool = False, num_loops: int = 0,
                     blend: bool = False) -> bytes:
    """Encode a list of (H, W, C) uint8/uint16 frames as an animation.

    durations: per-frame tick counts (default 1 tick each);
    tps: (numerator, denominator) ticks per second.
    blend=True composes frames 1.. over the canvas with alpha
    (BlendMode.BLEND; lossy path only) instead of replacing it."""
    if not frames:
        raise ValueError("need at least one frame")
    first = frames[0]
    if durations is None:
        durations = [1] * len(frames)
    if first.ndim == 2:
        frames = [f[:, :, None] for f in frames]
        first = frames[0]
    h, w, nchan = first.shape
    has_alpha = nchan in (2, 4)
    bits = 16 if first.dtype == np.uint16 else 8
    scale = 65535.0 if bits == 16 else 255.0

    meta = CodecMetadata()
    meta.size.set(w, h)
    meta.m.bit_depth = BitDepth.uint(bits)
    meta.m.have_animation = True
    meta.m.animation.tps_numerator = tps[0]
    meta.m.animation.tps_denominator = tps[1]
    meta.m.animation.num_loops = num_loops
    if has_alpha:
        meta.m.set_alpha_bits(bits)

    writer = BitWriter()
    ncolor = nchan - 1 if has_alpha else nchan
    if lossless:
        meta.m.xyb_encoded = False
        meta.m.color_encoding = ColorEncoding.srgb(is_gray=(ncolor == 1))
        write_codestream_headers(meta, writer)
        from libjxl_tpu_torch.modular.codec import Transform, TransformId
        for i, img in enumerate(frames):
            channels = [img[:, :, c].astype(np.int32) for c in range(nchan)]
            transforms = []
            if ncolor >= 3:
                transforms = [Transform(id=TransformId.RCT, begin_c=0,
                                        rct_type=6)]
            encode_modular_frame(channels, meta, writer,
                                 transforms=transforms,
                                 is_last=(i == len(frames) - 1),
                                 duration=durations[i])
    else:
        meta.m.xyb_encoded = True
        write_codestream_headers(meta, writer)
        for i, img in enumerate(frames):
            srgb = img[:, :, :min(ncolor, 3)].astype(np.float32) / scale
            if ncolor == 1:
                srgb = np.repeat(srgb, 3, axis=2)
            xyb = linear_rgb_to_xyb(srgb_to_linear(srgb).transpose(2, 0, 1))
            extra = [img[:, :, -1].astype(np.int32)] if has_alpha else None
            from libjxl_tpu_torch.frame.frame_header import BlendMode
            last = i == len(frames) - 1
            bm = int(BlendMode.BLEND) if blend and i > 0 else None
            # Blended animations chain through reference slot 1: every
            # non-last frame stores there (CanBeReferenced needs
            # save_as_reference != 0 for duration > 0 frames) and every
            # blended frame reads its background from it.
            encode_vardct_frame(xyb, meta, writer, distance=distance,
                                is_last=last,
                                extra_channels=extra,
                                duration=durations[i],
                                blend_mode=bm,
                                blend_source=1 if bm is not None else 0,
                                save_slot=1 if blend and not last
                                else None)
    writer.align_to_byte()
    return writer.get_bytes()


def encode_streaming(get_chunk, xsize: int, ysize: int, *,
                     distance: float = 1.0, device=None) -> bytes:
    """Chunked VarDCT encode with bounded pixel memory.

    `get_chunk(x0, y0, w, h)` must return the (h, w, 3) uint8 (or
    float [0,1]) sRGB tile; it is called once per 2048x2048 DC-group
    chunk. Mirrors JxlEncoderAddChunkedFrame / the reference's
    streaming encode mode (lib/jxl/enc_frame.cc:2047). The chunks are
    encoded on the host, as in the reference; ``device`` (default
    ``cuda``) is the torch device of the one-shot encode that a
    single-group image takes instead."""
    from libjxl_tpu_torch.frame.streaming_encode import (
        encode_streaming as _impl)
    return _impl(get_chunk, xsize, ysize, distance=distance, device=device)
