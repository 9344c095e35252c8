"""Frame decoder: sections, LfGlobal/DC/ACGlobal/AC wiring.

Reference: lib/jxl/dec_frame.cc (FrameDecoder: InitFrame,
ProcessSections, ProcessDCGlobal/DCGroup/ACGlobal/ACGroup), dec_group.cc
(section split per group), toc.h section numbering.

Copy of libjxl_tpu/frame/decode_frame.py with three changes:
- ``device="feed"`` returns the host feed of one VarDCT frame, and
  carries upsampling, noise and splines in it as its ``"post"`` entry;
  features the feed cannot carry (modular frames, chroma subsampling,
  extra channels, patches, splines together with upsampling, a spline
  wider than the device window) raise NotImplementedError instead of
  being dropped;
- a torch device runs the device decode through the port's
  ``tpu.pipeline.decode_frame_device2`` (the loop filters on the CUDA
  kernel on a card) and brings the XYB back to the host, as the
  reference brings its device result back;
- ``device`` is None, ``"feed"`` or a torch device: the reference's
  ``True``/``False`` and its v1 feed (``"feed_v1"``) are not taken.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjxl_tpu_torch.base.errors import BitstreamError, UnsupportedError
from libjxl_tpu_torch.base.frame_dimensions import FrameDimensions
from libjxl_tpu_torch.base.rect import Rect
from libjxl_tpu_torch.bitstream.bit_io import BitReader
from libjxl_tpu_torch.bitstream.fields import bundle_read
from libjxl_tpu_torch.bitstream.toc import num_toc_entries, read_toc
from libjxl_tpu_torch.frame.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags, FrameHeader, FrameType,
)
from libjxl_tpu_torch.frame.headers import CodecMetadata
from libjxl_tpu_torch.frame.modular_frame import (
    ModularFrameDecoder, stream_modular_ac, stream_modular_dc,
)
from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
from libjxl_tpu_torch.vardct.coeff_order import decode_coeff_orders, read_used_orders
from libjxl_tpu_torch.vardct.group import decode_group_coeffs
from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices
from libjxl_tpu_torch.vardct.quantizer import Quantizer
from libjxl_tpu_torch.vardct.reconstruct import (
    b_qm_multiplier, reconstruct_group, x_qm_multiplier,
)


@dataclasses.dataclass
class DecodedFrame:
    header: FrameHeader
    # For VarDCT/XYB frames: (3, H, W) float32 XYB (before color txfm).
    # For modular frames: the modular image channels as int32 planes.
    xyb: np.ndarray | None = None
    modular_channels: list | None = None
    extra_channels: list | None = None
    bits_consumed: int = 0
    feed: dict | None = None   # device-feed mode (device="feed")


def _unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not supported by the device decode path yet")


def decode_frame(r: BitReader, metadata: CodecMetadata,
                 reference_frames: list | None = None,
                 is_preview: bool = False,
                 dc_frames: list | None = None,
                 device=None) -> DecodedFrame:
    """Decode one frame from `r` (positioned after image headers).

    reference_frames: 4 slots of saved (3, H, W) XYB planes used by
    patches; dc_frames: 5 slots of saved DC-level frames
    (dec_frame.cc reference_frames_ / passes_state dc_frames).
    device: None decodes on the host; ``"feed"`` returns the host feed of
    a VarDCT frame; a torch device decodes VarDCT frames there and
    returns host XYB (raising for ``cuda`` without a card). Modular and
    chroma-subsampled frames decode on the host on every route but the
    feed's, which raises for them."""
    feed_only = device == "feed"
    if device is not None and not feed_only:
        from libjxl_tpu_torch.device import resolve_device
        device = resolve_device(device)
    fh = FrameHeader(nonserialized_metadata=metadata)
    fh.nonserialized_is_preview = is_preview
    bundle_read(r, fh)
    if fh.frame_type not in (FrameType.REGULAR, FrameType.REFERENCE_ONLY,
                             FrameType.DC_FRAME,
                             FrameType.SKIP_PROGRESSIVE):
        raise UnsupportedError(f"unknown frame type {fh.frame_type}")
    # kSkipProgressive decodes exactly like a regular frame; the flag
    # only suppresses progressive previews (dec_frame.cc).
    if reference_frames is None:
        reference_frames = [None] * 4
    if dc_frames is None:
        dc_frames = [None] * 5
    external_dc = None
    if fh.flags & FrameFlags.USE_DC_FRAME:
        external_dc = dc_frames[fh.dc_level + 1]
        if external_dc is None:
            raise BitstreamError("kUseDcFrame without a saved DC frame")

    fd = fh.to_frame_dimensions()

    num_passes = fh.passes.num_passes
    toc_entries = num_toc_entries(fd.num_groups, fd.num_dc_groups, num_passes)
    sizes, offsets = read_toc(toc_entries, r)
    r.align_to_byte()
    base = r.bits_consumed // 8
    data = r._data  # section slicing over the same buffer

    def section_reader(idx: int) -> BitReader:
        start = base + offsets[idx]
        end = start + sizes[idx]
        return BitReader(data[start:end])

    frame_end_bits = (base + (max(o + s for o, s in zip(offsets, sizes))
                              if sizes else 0)) * 8

    single = (toc_entries == 1)
    if single:
        seq = BitReader(data[base + offsets[0]:base + offsets[0] + sizes[0]])

        def get(idx):
            return seq
    else:
        def get(idx):
            return section_reader(idx)

    mfd = ModularFrameDecoder(fd)
    is_vardct = fh.encoding == FrameEncoding.VARDCT
    cs = fh.chroma_subsampling
    sub_shifts = None
    if is_vardct and not cs.is_444():
        sub_shifts = [(cs.hshift(c), cs.vshift(c)) for c in range(3)]
    if feed_only:
        if not is_vardct:
            raise _unsupported("modular frame")
        if sub_shifts is not None:
            raise _unsupported("chroma subsampling")
        if metadata.m.num_extra_channels:
            raise _unsupported("extra channels")

    # ---- LfGlobal (section 0) ----
    lf = get(0)
    # Image features come first (dec_frame.cc ProcessDCGlobal:272-300).
    patch_dict = None
    if fh.flags & FrameFlags.PATCHES:
        if feed_only:
            raise _unsupported("patches")
        from libjxl_tpu_torch.frame.patches import decode_patches
        patch_dict = decode_patches(lf, fd.xsize_padded, fd.ysize_padded,
                                    metadata.m.num_extra_channels,
                                    reference_frames)
    splines = None
    if fh.flags & FrameFlags.SPLINES:
        if feed_only and fh.upsampling != 1:
            raise _unsupported("splines together with upsampling")
        from libjxl_tpu_torch.frame.splines import decode_splines
        splines = decode_splines(lf, fd.xsize * fd.ysize)
    noise_lut = None
    if fh.flags & FrameFlags.NOISE:
        from libjxl_tpu_torch.frame.noise import decode_noise
        noise_lut = decode_noise(lf)
    matrices = DequantMatrices()
    matrices.decode_dc(lf)
    quantizer = Quantizer(matrices)
    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()
    if is_vardct:
        quantizer.decode(lf)
        ctx_map.decode(lf)
        cmap.decode_dc(lf)
    mfd.decode_global_info(lf, fh, metadata)

    # ---- DC groups ----
    dc_data = {}
    ac_meta = {}
    for g in range(fd.num_dc_groups):
        br = get(1 + g) if not single else seq
        if is_vardct and external_dc is None:
            qdc, extra_precision = mfd.decode_vardct_dc(
                g, br, metadata.m.bit_depth.bits_per_sample,
                shifts=sub_shifts)
            dc_data[g] = (qdc, extra_precision)
        rect = fd.dc_group_rect(g)
        mrect = Rect(rect.x0 * 8, rect.y0 * 8, fd.dc_group_dim,
                     fd.dc_group_dim)
        mfd.decode_group(mrect, br, 3, 1000, stream_modular_dc(g, fd))
        if is_vardct:
            ac_meta[g] = mfd.decode_ac_metadata(
                g, br, metadata.m.bit_depth.bits_per_sample)

    if not is_vardct:
        # ---- Modular AC groups ----
        for p in range(num_passes):
            min_s, max_s = fh.passes.downsampling_bracket(p)
            for g in range(fd.num_groups):
                br = get(2 + fd.num_dc_groups + p * fd.num_groups + g) \
                    if not single else seq
                # UNCLIPPED group rect: per-channel clamping comes from
                # the channel dims (dec_frame.cc ProcessACGroup mrect is
                # group_dim x group_dim); clipping to image size here
                # floor-truncates odd-width squeezed channels and LOSES
                # their last column/row.
                mrect = fd.group_rect(g)
                prect = Rect(mrect.x0, mrect.y0, fd.group_dim,
                             fd.group_dim)
                mfd.decode_group(prect, br, min_s, max_s,
                                 stream_modular_ac(g, p, fd))
        gi = mfd.finalize()
        r.seek_bits(frame_end_bits)
        from libjxl_tpu_torch.frame.frame_header import ColorTransform
        if fh.color_transform == ColorTransform.XYB:
            # Lossy-modular / DC frames in XYB: channels are stored as
            # Y, X, (B-Y) quantized by the DC quant steps
            # (dec_modular.cc:581-631 "XYB is encoded as YX(B-Y)").
            chans = [c.data for c in gi.channel]
            dcq = matrices.dc_quant
            xyb = np.empty((3, chans[0].shape[0], chans[0].shape[1]),
                           np.float32)
            xyb[0] = chans[1].astype(np.float32) * dcq[0]
            xyb[1] = chans[0].astype(np.float32) * dcq[1]
            xyb[2] = (chans[2] + chans[0]).astype(np.float32) * dcq[2]
            extra = None
            if metadata.m.num_extra_channels:
                extra = [c.data for c in gi.channel[3:]]
            return DecodedFrame(header=fh, xyb=xyb, extra_channels=extra)
        return DecodedFrame(header=fh,
                            modular_channels=[c.data for c in gi.channel])

    # ---- Dequantize DC, assemble full maps ----
    mul_dc = quantizer.mul_dc()
    cfl_fac = cmap.dc_factors()
    if sub_shifts is None and external_dc is not None:
        dc_full = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks),
                           np.float32)
        h_dc = min(external_dc.shape[1], fd.ysize_blocks)
        w_dc = min(external_dc.shape[2], fd.xsize_blocks)
        dc_full[:, :h_dc, :w_dc] = external_dc[:, :h_dc, :w_dc]
    elif sub_shifts is None:
        dc_full = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks),
                           np.float32)
        quant_dc_full = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                                 np.int32)
        for g, (qdc, extra_precision) in dc_data.items():
            rect = fd.dc_group_rect(g)
            mul = 1.0 / (1 << extra_precision)
            y = qdc[1] * (mul_dc[1] * mul)
            x = qdc[0] * (mul_dc[0] * mul) + cfl_fac[0] * y
            b = qdc[2] * (mul_dc[2] * mul) + cfl_fac[2] * y
            sl = rect.slices()
            dc_full[0][sl] = x
            dc_full[1][sl] = y
            dc_full[2][sl] = b
            quant_dc_full[sl] = qdc[1]

        if not (fh.flags & FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING):
            from libjxl_tpu_torch.vardct.dc_smoothing import \
                adaptive_dc_smoothing
            dc_full = adaptive_dc_smoothing(dc_full, mul_dc)

    # Assemble strategy/qf/cmap maps.
    strategies = np.full((fd.ysize_blocks, fd.xsize_blocks), -1, np.int32)
    raw_quant = np.ones((fd.ysize_blocks, fd.xsize_blocks), np.int32)
    sharpness = np.zeros((fd.ysize_blocks, fd.xsize_blocks), np.int32)
    tiles_x = (fd.xsize_blocks + 7) // 8
    tiles_y = (fd.ysize_blocks + 7) // 8
    ytox_map = np.zeros((tiles_y, tiles_x), np.int32)
    ytob_map = np.zeros((tiles_y, tiles_x), np.int32)
    used_acs = 0
    for g, meta in ac_meta.items():
        rect = fd.dc_group_rect(g)
        sl = rect.slices()
        strategies[sl] = meta["strategies"]
        raw_quant[sl] = meta["raw_quant"]
        sharpness[sl] = meta["epf"]
        cr = Rect(rect.x0 >> 3, rect.y0 >> 3, (rect.xsize + 7) >> 3,
                  (rect.ysize + 7) >> 3)
        ytox_map[cr.slices()] = meta["ytox"]
        ytob_map[cr.slices()] = meta["ytob"]
        for s in np.unique(meta["strategies"]):
            if s >= 0:
                used_acs |= 1 << int(s)

    # ---- ACGlobal ----
    acg = get(1 + fd.num_dc_groups) if not single else seq
    matrices.decode(acg, mfd)
    num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
        if fd.num_groups > 1 else 0
    num_histograms = 1 + (acg.read(num_histo_bits) if num_histo_bits else 0)
    from libjxl_tpu_torch.entropy.codes import decode_histograms, SymbolReader
    num_contexts = num_histograms * ctx_map.num_ac_contexts()
    # Per-pass coefficient orders + histograms (dec_frame.cc:396-413).
    pass_orders, pass_codes = [], []
    for _p in range(num_passes):
        used_orders = read_used_orders(acg)
        pass_orders.append(decode_coeff_orders(used_orders, used_acs, acg))
        pass_codes.append(decode_histograms(acg, num_contexts))

    if sub_shifts is not None:
        out = _decode_ac_subsampled(
            fh, fd, get, quantizer, ctx_map, pass_orders,
            pass_codes, num_histograms, dc_data, raw_quant,
            sub_shifts, sharpness=sharpness)
        out = out[:, :fd.ysize, :fd.xsize]
        r.seek_bits(frame_end_bits)
        return DecodedFrame(header=fh, xyb=out)

    # ---- AC groups ----
    # Decoder-side dm multipliers are the INVERSE of the encoder's qm
    # multipliers (dec_cache.h:161: pow(1/1.25, x_qm_scale - 2)).
    x_mul = 1.0 / x_qm_multiplier(fh.x_qm_scale)
    b_mul = 1.0 / b_qm_multiplier(fh.b_qm_scale)
    out = np.zeros((3, fd.ysize_padded, fd.xsize_padded), np.float32)
    histo_bits = (num_histograms - 1).bit_length() if num_histograms > 1 \
        else 0
    from libjxl_tpu_torch.vardct.group_native import (
        flatten_orders, native_decode_ac_multi, native_decode_group,
        pass_order_offsets, prepare_blocks, prepare_frame,
        scatter_blocks_to_frame, scatter_flat_to_frame)
    group_blocks: list = [None] * fd.num_groups

    # Frame-direct device path: the native decoder writes coefficients
    # straight into the int16 frame image (no per-group intermediates),
    # all groups of a pass decoded in one interleaved native call.
    # Progressive passes accumulate coefficients << shift in place.
    use_frame_path = device is not None and not single
    # Host frame path: same dense interleaved decode, then ONE native
    # call reconstructs the whole frame (fused dequant + CfL + LLF +
    # IDCT + scatter) — no per-block Python objects on the hot path.
    # Only taken over the per-group runner loop when the stock serial
    # runner is active (a custom/multi-worker runner keeps receiving
    # per-group items).
    host_frame_path = False
    if device is None:
        from libjxl_tpu_torch.parallel.runner import ThreadRunner, get_runner
        _runner = get_runner()
        if single or (isinstance(_runner, ThreadRunner)
                      and _runner.num_workers == 1):
            try:
                from libjxl_tpu_torch.native.bindings import get_lib
                host_frame_path = get_lib() is not None
            except Exception:
                host_frame_path = False
        use_frame_path = use_frame_path or host_frame_path
    coeff_frame = mat_ids_frame = None
    pass_flat_caches = [None] * num_passes
    nz_sink = None
    if use_frame_path:
        coeff_frame = np.zeros(
            (3, fd.ysize_blocks * 8, fd.xsize_blocks * 8), np.int16)
        mat_ids_frame = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                                 np.int8)
        # Sparse transfer sink: the native decoder appends each nonzero
        # coefficient contribution; a device scatter-add rebuilds the
        # frame from ~6 bytes/nonzero instead of shipping the dense
        # int16 image (2 B/px x 3) over the host->device link. Host
        # reconstruction reads the dense frame directly — no sink.
        if device is not None:
            nz_cap = max(1 << 16, coeff_frame.size // 8)
            nz_sink = (np.empty(nz_cap, np.int32),
                       np.empty(nz_cap, np.int16),
                       np.zeros(1, np.int64))
    # (pass, group) -> (bit pos after the histogram selector, ctx_offset),
    # kept so an int16-overflow redo can resume without re-reading them.
    sel_pos: dict = {}

    def _flat_cache(p: int):
        if pass_flat_caches[p] is None:
            pass_flat_caches[p] = flatten_orders(pass_orders[p])
        return pass_flat_caches[p]

    def _read_selector(p: int, g: int):
        br = get(2 + fd.num_dc_groups + p * fd.num_groups + g)
        cur_histogram = br.read(histo_bits) if histo_bits else 0
        if cur_histogram >= num_histograms:
            raise BitstreamError("invalid histogram selector")
        sel_pos[(p, g)] = (br.bits_consumed,
                           cur_histogram * ctx_map.num_ac_contexts())
        return br

    def _mfd_group(p: int, g: int, br) -> None:
        min_s, max_s = fh.passes.downsampling_bracket(p)
        mrect = fd.group_rect(g)
        prect = Rect(mrect.x0, mrect.y0, fd.group_dim, fd.group_dim)
        mfd.decode_group(prect, br, min_s, max_s,
                         stream_modular_ac(g, p, fd))

    def process_ac_group_frame_pass(p: int, g: int, br=None,
                                    do_mfd: bool = True) -> None:
        """Per-group fallback of the interleaved frame path: flat int32
        decode accumulated into the (promoted) coefficient frame."""
        nonlocal coeff_frame
        shift = fh.passes.shift[p]
        orders = pass_orders[p]
        ac_codes = pass_codes[p]
        if br is None:
            br = get(2 + fd.num_dc_groups + p * fd.num_groups + g)
            br.seek_bits(sel_pos[(p, g)][0])
        ctx_offset = sel_pos[(p, g)][1]
        brect = fd.block_group_rect(g)
        sl = brect.slices()
        prep = prepare_blocks(strategies[sl], raw_quant[sl], ctx_map,
                              orders, flat_cache=_flat_cache(p))
        if coeff_frame.dtype == np.int16:
            # The fallback only serves rare streams (prefix codes, LZ77
            # in AC, int16 overflow): run the whole frame in int32.
            coeff_frame = coeff_frame.astype(np.int32)
        if nz_sink is not None:
            nz_sink[2][0] = -1  # sparse sink no longer complete
        flat = native_decode_group(
            br.raw_data, br.bits_consumed, ac_codes, brect.xsize,
            brect.ysize, prep, ctx_map, ctx_offset, as_blocks=False)
        if flat is not None:
            buf, pos = flat
            scatter_flat_to_frame(buf, prep, coeff_frame, mat_ids_frame,
                                  brect.y0, brect.x0, shift,
                                  accumulate=True)
            br.seek_bits(pos)
        else:
            reader = SymbolReader(ac_codes, br)
            blocks = decode_group_coeffs(
                reader, brect.xsize, brect.ysize, strategies[sl],
                raw_quant[sl], orders, ctx_map, ctx_offset)
            if not reader.check_final_state():
                raise BitstreamError("bad ANS state in AC group")
            scatter_blocks_to_frame(blocks, coeff_frame, mat_ids_frame,
                                    brect.y0, brect.x0, shift,
                                    accumulate=True)
        if do_mfd:
            _mfd_group(p, g, br)

    frame_prep_cache: list = [None]

    def _frame_prep():
        if frame_prep_cache[0] is None:
            frame_prep_cache[0] = prepare_frame(strategies, raw_quant,
                                                ctx_map, fd)
        return frame_prep_cache[0]

    # Passes decoded sparse-only: their coefficients exist ONLY in the
    # nz sink (the dense frame was never touched — no RMW misses, no
    # 50 MB first-touch). If anything later needs the dense frame, the
    # sunk passes are re-decoded densely first.
    sink_passes: list = []

    def _materialize_sunk() -> None:
        if not sink_passes:
            return
        if nz_sink is not None:
            nz_sink[2][0] = -1
        for q in list(sink_passes):
            for g in range(fd.num_groups):
                process_ac_group_frame_pass(q, g, do_mfd=False)
        sink_passes.clear()

    def process_ac_pass_multi(p: int) -> bool:
        """All AC groups of pass p through the interleaved native
        decoder. Returns False when the native path cannot serve the
        pass (prefix codes / LZ77 / promoted frame / no native lib)."""
        nonlocal coeff_frame
        ac_codes = pass_codes[p]
        if ac_codes.use_prefix_code or ac_codes.lz77.enabled \
                or coeff_frame.dtype != np.int16:
            return False
        fprep = _frame_prep()
        flat_orders, blk_oo = pass_order_offsets(
            fprep, pass_orders[p], coeff_frame.shape[2])
        sections, ctx_offs, brs = [], [], []
        for g in range(fd.num_groups):
            br = _read_selector(p, g)
            sections.append((br.raw_data, br.bits_consumed))
            ctx_offs.append(sel_pos[(p, g)][1])
            brs.append(br)
        res = native_decode_ac_multi(
            sections, ac_codes, fprep, flat_orders, blk_oo, ctx_offs,
            fh.passes.shift[p], ctx_map.num_ctxs, coeff_frame,
            mat_ids_frame, set_mat_ids=(p == 0), nz_sink=nz_sink,
            sink_only=nz_sink is not None)
        if res is None:
            return False
        if isinstance(res, tuple):
            # int16 contribution overflow (-12) or sink capacity hit
            # (-13): promote to int32, zero, and redo the coefficients
            # of passes 0..p per group densely (their modular
            # sub-streams are untouched by the redo; only the current
            # pass still needs its modular decode).
            coeff_frame = np.zeros(coeff_frame.shape, np.int32)
            mat_ids_frame[:] = 0
            sink_passes.clear()
            for q in range(p + 1):
                for g in range(fd.num_groups):
                    process_ac_group_frame_pass(q, g, do_mfd=(q == p))
            return True
        if nz_sink is not None:
            sink_passes.append(p)
        for g, endpos in enumerate(res):
            brs[g].seek_bits(endpos)
            _mfd_group(p, g, brs[g])
        return True

    def process_ac_group(p: int, g: int) -> None:
        shift = fh.passes.shift[p]
        min_s, max_s = fh.passes.downsampling_bracket(p)
        orders = pass_orders[p]
        ac_codes = pass_codes[p]
        br = get(2 + fd.num_dc_groups + p * fd.num_groups + g) \
            if not single else seq
        brect = fd.block_group_rect(g)
        cur_histogram = br.read(histo_bits) if histo_bits else 0
        if cur_histogram >= num_histograms:
            raise BitstreamError("invalid histogram selector")
        ctx_offset = cur_histogram * ctx_map.num_ac_contexts()
        sl = brect.slices()
        prep = prepare_blocks(strategies[sl], raw_quant[sl], ctx_map,
                              orders)
        # Device feed v2 + single pass: keep the native decoder's flat
        # coefficient buffer (no per-block objects on the hot path).
        want_flat = device is not None and num_passes == 1 and shift == 0
        native = native_decode_group(br.raw_data, br.bits_consumed,
                                     ac_codes, brect.xsize, brect.ysize,
                                     prep, ctx_map, ctx_offset,
                                     as_blocks=not want_flat)
        if native is not None:
            blocks, new_pos = native
            br.seek_bits(new_pos)
            if want_flat:
                mrect0 = fd.group_rect(g)
                prect0 = Rect(mrect0.x0, mrect0.y0, fd.group_dim,
                              fd.group_dim)
                mfd.decode_group(prect0, br, min_s, max_s,
                                 stream_modular_ac(g, p, fd))
                group_blocks[g] = ("flat", blocks, prep)
                return
        else:
            reader = SymbolReader(ac_codes, br)
            blocks = decode_group_coeffs(
                reader, brect.xsize, brect.ysize, strategies[sl],
                raw_quant[sl], orders, ctx_map, ctx_offset)
            if not reader.check_final_state():
                raise BitstreamError("bad ANS state in AC group")
        # Modular stream of this AC group for this pass's shift
        # bracket (dec_frame.cc:512-530).
        mrect = fd.group_rect(g)
        prect = Rect(mrect.x0, mrect.y0, fd.group_dim, fd.group_dim)
        mfd.decode_group(prect, br, min_s, max_s,
                         stream_modular_ac(g, p, fd))
        # Accumulate pass coefficients: coeff += decoded << shift
        # (dec_group.cc DecodeACVarBlock shift param).
        if group_blocks[g] is None:
            if shift:
                for blk in blocks:
                    np.left_shift(blk.coeffs, shift, out=blk.coeffs)
            group_blocks[g] = blocks
        else:
            for acc, blk in zip(group_blocks[g], blocks):
                acc.coeffs += blk.coeffs << shift

    def reconstruct_one(g: int) -> None:
        brect = fd.block_group_rect(g)
        sl = brect.slices()
        pix = reconstruct_group(
            group_blocks[g], brect.xsize, brect.ysize, quantizer,
            raw_quant[sl],
            dc_full[:, brect.y0:brect.y1, brect.x0:brect.x1], cmap,
            ytox_map, ytob_map, brect.x0, brect.y0, x_mul, b_mul)
        out[:, brect.y0 * 8:brect.y0 * 8 + brect.ysize * 8,
            brect.x0 * 8:brect.x0 * 8 + brect.xsize * 8] = pix

    # Device path: host entropy decode of all sections, then the device
    # pipeline handles dequant/CfL/IDCT/filters/color (SURVEY §7).
    if device is not None:
        if use_frame_path:
            for p in range(num_passes):
                if not process_ac_pass_multi(p):
                    _materialize_sunk()
                    for g in range(fd.num_groups):
                        br = _read_selector(p, g)
                        process_ac_group_frame_pass(p, g, br=br)
        else:
            for p in range(num_passes):
                for g in range(fd.num_groups):
                    process_ac_group(p, g)
        from libjxl_tpu_torch.pipeline.loop_filters import compute_sigma_map
        from libjxl_tpu_torch.vardct.reconstruct import DEFAULT_QUANT_BIAS
        lfp0 = fh.loop_filter
        if lfp0.gab or lfp0.epf_iters > 0:
            inv_sigma = compute_sigma_map(
                lfp0, raw_quant, sharpness,
                quantizer.global_scale_float).astype(np.float32)
        else:
            inv_sigma = np.zeros_like(raw_quant, dtype=np.float32)
        if use_frame_path:
            if nz_sink is None or nz_sink[2][0] < 0:
                _materialize_sunk()   # dense frame will be the source
            from libjxl_tpu_torch.tpu.feed import build_feed3
            feed = build_feed3(coeff_frame, mat_ids_frame, fd, strategies,
                               raw_quant, dc_full, quantizer, cmap,
                               ytox_map, ytob_map, x_mul, b_mul,
                               DEFAULT_QUANT_BIAS)
            if nz_sink is not None and nz_sink[2][0] >= 0 \
                    and coeff_frame.dtype == np.int16:
                ncur = int(nz_sink[2][0])
                feed["coeff_nz"] = (nz_sink[0][:ncur].copy(),
                                    nz_sink[1][:ncur].copy())
        else:
            from libjxl_tpu_torch.tpu.feed import build_feed2
            feed = build_feed2(group_blocks, fd, strategies, raw_quant,
                               dc_full, quantizer, cmap, ytox_map,
                               ytob_map, x_mul, b_mul, DEFAULT_QUANT_BIAS)
        feed["inv_sigma"] = inv_sigma
        feed["lf"] = lfp0
        feed["image_hw"] = (fd.ysize, fd.xsize)
        if feed_only:
            post = _post_stages(fh, fd, splines, noise_lut, cmap)
            if post:
                feed["post"] = post
            r.seek_bits(frame_end_bits)
            return DecodedFrame(header=fh, feed=feed)
        from libjxl_tpu_torch.tpu.pipeline import decode_frame_device2
        # Run upsampling + noise as device post-stages when no
        # host-only feature (patches/splines/extra channels) needs the
        # base-resolution image in between (dec_cache.cc stage order:
        # EPF -> upsampling -> patches -> splines -> noise).
        post = {}
        spline_args = None
        patch_ka = None
        if splines is not None \
                and not metadata.m.num_extra_channels \
                and fh.upsampling == 1:
            # Splines render at base resolution; huge-sigma strokes
            # (params None) fall back to the host renderer.
            from libjxl_tpu_torch.ops.stages import spline_stroke_params
            spline_args = spline_stroke_params(splines, cmap)
        if patch_dict is not None \
                and not metadata.m.num_extra_channels:
            # Fold the patch stack into per-pixel affine (K, A) at the
            # post-upsampling resolution; alpha-sourced blends fall
            # back to the host loop (patch_affine returns None).
            from libjxl_tpu_torch.frame.patches import patch_affine
            patch_ka = patch_affine(patch_dict, fd.ysize_upsampled,
                                    fd.xsize_upsampled,
                                    reference_frames)
        host_features = (
            (patch_dict is not None and patch_ka is None)
            or (splines is not None and spline_args is None)
            or metadata.m.num_extra_channels)
        if not host_features:
            if fh.upsampling != 1:
                post["upsample"] = fh.upsampling
            if patch_ka is not None:
                post["patch_affine"] = patch_ka
            if spline_args is not None:
                post["splines"] = spline_args
            if noise_lut is not None:
                post["noise"] = (noise_lut, cmap.base_correlation_x,
                                 cmap.base_correlation_b, fd.group_dim, 1)
            if post:
                post["final_hw"] = (fd.ysize_upsampled,
                                    fd.xsize_upsampled)
        xyb_dev = decode_frame_device2(feed, fd.ysize, fd.xsize, out="xyb",
                                       device=device, post=post)
        xyb_dev = xyb_dev.cpu().numpy()
        if post:
            # Device output is final (already upsampled / noised).
            r.seek_bits(frame_end_bits)
            return DecodedFrame(header=fh, xyb=xyb_dev)
        out = np.zeros((3, fd.ysize_padded, fd.xsize_padded), np.float32)
        out[:, :fd.ysize, :fd.xsize] = xyb_dev
        # Filters already ran on device; skip the host filter stage.
        lfp_device_done = True
    else:
        lfp_device_done = False

    # AC group sections are independent (own TOC entries + ANS states):
    # run them on a thread pool like the reference's ThreadPool::Run
    # (base/data_parallel.h); the native decoder releases the GIL.
    if device is None and host_frame_path:
        # Dense interleaved decode of all groups per pass, then one
        # native whole-frame reconstruction call.
        from libjxl_tpu_torch.vardct.reconstruct import (
            native_reconstruct_frame)
        for p in range(num_passes):
            if single:
                # Sequential sections: per-group frame-pass decode from
                # the one shared reader.
                for g in range(fd.num_groups):
                    cur = seq.read(histo_bits) if histo_bits else 0
                    if cur >= num_histograms:
                        raise BitstreamError("invalid histogram selector")
                    sel_pos[(p, g)] = (seq.bits_consumed,
                                       cur * ctx_map.num_ac_contexts())
                    process_ac_group_frame_pass(p, g, br=seq)
            elif not process_ac_pass_multi(p):
                for g in range(fd.num_groups):
                    br = _read_selector(p, g)
                    process_ac_group_frame_pass(p, g, br=br)
        if not native_reconstruct_frame(
                coeff_frame, strategies, raw_quant, dc_full, quantizer,
                cmap, ytox_map, ytob_map, x_mul, b_mul, out):
            # Native lib vanished mid-flight: rebuild per-block lists
            # from the dense frame via the feed consumer and fall back.
            raise BitstreamError("native reconstruction unavailable")
    elif device is None:
        parallel = (not single) and fd.num_groups > 1
        from libjxl_tpu_torch.parallel.runner import ThreadRunner, get_runner
        runner = get_runner()
        # Frame-level batching bypasses the per-group runner calls ONLY
        # for the stock single-worker pool — a custom installed runner
        # (embedder scheduler) must keep receiving every item.
        stock_serial = (isinstance(runner, ThreadRunner)
                        and runner.num_workers == 1)

        def reconstruct_frame_level() -> None:
            # One batched reconstruction across ALL groups: per-strategy
            # pooling amortizes the dequant/IDCT fixed costs that a
            # per-group pass pays num_groups x strategies times.
            from libjxl_tpu_torch.vardct.group import CoeffBlock
            all_blocks = []
            for g in range(fd.num_groups):
                brect = fd.block_group_rect(g)
                for b in group_blocks[g]:
                    all_blocks.append(CoeffBlock(
                        brect.x0 + b.bx, brect.y0 + b.by, b.strategy,
                        b.coeffs))
            pix = reconstruct_group(
                all_blocks, fd.xsize_blocks, fd.ysize_blocks, quantizer,
                raw_quant, dc_full, cmap, ytox_map, ytob_map, 0, 0,
                x_mul, b_mul)
            out[:, :fd.ysize_blocks * 8, :fd.xsize_blocks * 8] = pix

        if parallel and not stock_serial:
            for p in range(num_passes):
                runner.run(lambda g, p=p: process_ac_group(p, g),
                           fd.num_groups)
            runner.run(reconstruct_one, fd.num_groups)
        else:
            for p in range(num_passes):
                for g in range(fd.num_groups):
                    process_ac_group(p, g)
            if fd.num_groups > 1 and not single:
                reconstruct_frame_level()
            else:
                for g in range(fd.num_groups):
                    reconstruct_one(g)

    # Loop filters (gaborish/EPF) — applied when enabled, on the image
    # region only: the pipeline mirrors at image bounds, not at the
    # padded buffer edge (low_memory_render_pipeline.cc ApplyXMirroring).
    lfp = fh.loop_filter
    if (lfp.gab or lfp.epf_iters > 0) and not lfp_device_done:
        from libjxl_tpu_torch.pipeline.loop_filters import apply_loop_filters
        filtered = apply_loop_filters(
            np.ascontiguousarray(out[:, :fd.ysize, :fd.xsize]), lfp,
            raw_quant, strategies, quantizer, fd, sharpness=sharpness)
        out[:, :fd.ysize, :fd.xsize] = filtered

    # Upsampling precedes patches/splines/noise
    # (dec_cache.cc stage order: EPF -> upsampling -> patches -> ...).
    if fh.upsampling != 1:
        from libjxl_tpu_torch.pipeline.upsample import upsample_image
        out = upsample_image(out[:, :fd.ysize, :fd.xsize], fh.upsampling)

    extra = None
    if metadata.m.num_extra_channels:
        gi = mfd.finalize()
        extra = [c.data for c in gi.channel]
        # Per-channel extra-channel upsampling (stage_upsampling over
        # the EC planes; frame_header extra_channel_upsampling).
        ecups = fh.extra_channel_upsampling or []
        for i, up in enumerate(ecups):
            if up != 1 and i < len(extra):
                from libjxl_tpu_torch.pipeline.upsample import upsample_plane
                ec = upsample_plane(
                    extra[i].astype(np.float32), up)
                extra[i] = np.round(
                    ec[:fd.ysize_upsampled, :fd.xsize_upsampled]
                ).astype(extra[i].dtype)

    # Patches before noise (dec_cache.cc stage order: EPF -> patches ->
    # splines -> noise).
    if patch_dict is not None:
        from libjxl_tpu_torch.frame.patches import apply_patches
        apply_patches(patch_dict, out, extra, reference_frames)

    if splines is not None:
        from libjxl_tpu_torch.frame.splines import render_splines
        render_splines(splines, out, cmap)

    if noise_lut is not None:
        from libjxl_tpu_torch.frame.noise import add_noise
        out = add_noise(out, noise_lut, cmap, fd)

    out = out[:, :fd.ysize_upsampled, :fd.xsize_upsampled]
    r.seek_bits(frame_end_bits)
    return DecodedFrame(header=fh, xyb=out, extra_channels=extra)


def _decode_ac_subsampled(fh, fd, get, quantizer, ctx_map, pass_orders,
                          pass_codes, num_histograms, dc_data, raw_quant,
                          shifts, sharpness=None):
    """Chroma-subsampled VarDCT decode: all DCT8X8, per-channel planes
    reconstructed at coded resolution, progressive passes accumulated
    per channel, then triangle-upsampled
    (stage_chroma_upsampling.cc) and loop-filtered at full resolution
    (dec_cache.cc stage order: chroma upsample -> gaborish -> EPF,
    before the YCbCr color stage)."""
    from libjxl_tpu_torch.color.ycbcr import chroma_upsample
    from libjxl_tpu_torch.entropy.codes import SymbolReader
    from libjxl_tpu_torch.vardct.dct import idct_matrix
    from libjxl_tpu_torch.vardct.group import decode_group_coeffs_subsampled
    from libjxl_tpu_torch.vardct.quantizer import adjust_quant_bias

    num_passes = len(pass_codes)
    histo_bits = (num_histograms - 1).bit_length() \
        if num_histograms > 1 else 0
    mul_dc = quantizer.mul_dc()
    table8 = quantizer.dequant.table(0)  # (3, 8, 8) DCT8X8

    # Per-channel coded-resolution pixel planes + DC planes.
    planes = []
    dcs = []
    for c in range(3):
        h, v = shifts[c]
        cw = -(-fd.xsize_blocks // (1 << h))
        ch = -(-fd.ysize_blocks // (1 << v))
        planes.append(np.zeros((ch * 8, cw * 8), np.float32))
        dcs.append(np.zeros((ch, cw), np.float32))
    for g, (qdc, extra_precision) in dc_data.items():
        rect = fd.dc_group_rect(g)
        mul = 1.0 / (1 << extra_precision)
        for c in range(3):
            h, v = shifts[c]
            y0, x0 = rect.y0 >> v, rect.x0 >> h
            arr = qdc[c] * (mul_dc[c] * mul)
            dcs[c][y0:y0 + arr.shape[0], x0:x0 + arr.shape[1]] = arr

    i8 = idct_matrix(8).astype(np.float32)
    for g in range(fd.num_groups):
        brect = fd.block_group_rect(g)
        sl = brect.slices()
        coeffs = None
        for p in range(num_passes):
            br = get(2 + fd.num_dc_groups + p * fd.num_groups + g)
            cur_histogram = br.read(histo_bits) if histo_bits else 0
            if cur_histogram >= num_histograms:
                raise BitstreamError("invalid histogram selector")
            ctx_offset = cur_histogram * ctx_map.num_ac_contexts()
            reader = SymbolReader(pass_codes[p], br)
            pc = decode_group_coeffs_subsampled(
                reader, brect.xsize, brect.ysize, raw_quant[sl],
                pass_orders[p], ctx_map, ctx_offset, shifts)
            if not reader.check_final_state():
                raise BitstreamError("bad ANS state in AC group")
            shift = fh.passes.shift[p]
            if coeffs is None:
                coeffs = [c_ << shift for c_ in pc]
            else:
                for c_ in range(3):
                    coeffs[c_] += pc[c_] << shift
        for c in range(3):
            h, v = shifts[c]
            cc = coeffs[c]
            sbh, sbw, _ = cc.shape
            # Dequant: bias + table + per-block scale (luma-position qf).
            sby = np.arange(sbh)
            sbx = np.arange(sbw)
            rq = raw_quant[sl][np.minimum((sby << v)[:, None],
                                          brect.ysize - 1),
                               np.minimum((sbx << h)[None, :],
                                          brect.xsize - 1)]
            scale = (quantizer.inv_global_scale
                     / rq.astype(np.float32))[..., None]
            x = cc.reshape(sbh, sbw, 64).astype(np.float32)
            stacked = np.broadcast_to(x, (1,) + x.shape)
            biased = adjust_quant_bias(
                x[None].repeat(3, 0))[c]
            dq = biased * table8[c].ravel()[None, None, :] * scale
            gy0, gx0 = brect.y0 >> v, brect.x0 >> h
            dq = dq.reshape(sbh, sbw, 8, 8)
            dq[:, :, 0, 0] = dcs[c][gy0:gy0 + sbh, gx0:gx0 + sbw]
            # Stored coefficients are transposed (square-DCT convention).
            pix = np.einsum("yu,abvu,wv->aybw", i8, dq, i8,
                            optimize=True).reshape(sbh * 8, sbw * 8)
            planes[c][gy0 * 8:gy0 * 8 + sbh * 8,
                      gx0 * 8:gx0 * 8 + sbw * 8] = pix

    h_img, w_img = fd.ysize, fd.xsize
    out = np.zeros((3, h_img, w_img), np.float32)
    for c in range(3):
        h, v = shifts[c]
        if h or v:
            cw = -(-w_img // (1 << h))
            chh = -(-h_img // (1 << v))
            out[c] = chroma_upsample(planes[c][:chh, :cw], h, v,
                                     w_img, h_img)
        else:
            out[c] = planes[c][:h_img, :w_img]

    # Loop filters run at full resolution AFTER chroma upsampling and
    # before the color stage (dec_cache.cc builds HChromaUps/VChromaUps
    # first, then gaborish, then EPF).
    lfp = fh.loop_filter
    if lfp.gab or lfp.epf_iters > 0:
        from libjxl_tpu_torch.pipeline.loop_filters import apply_loop_filters
        strategies = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                              np.int32)
        out = apply_loop_filters(
            np.ascontiguousarray(out), lfp, raw_quant, strategies,
            quantizer, fd, sharpness=sharpness)
    return out


def _post_stages(fh, fd, splines, noise_lut, cmap) -> dict:
    """The device post stages of the frame, as the reference's device
    branch assembles them (above), in the form
    ``tpu.pipeline.decode_frame_device2(post=...)`` takes, for the feed
    route; empty when the frame has none."""
    post = {}
    if fh.upsampling != 1:
        post["upsample"] = fh.upsampling
    if splines is not None:
        from libjxl_tpu_torch.ops.stages import (
            SPLINE_R, spline_stroke_params,
        )
        args = spline_stroke_params(splines, cmap)
        if args is None:
            raise _unsupported(
                f"a spline stroke wider than {SPLINE_R} pixels")
        post["splines"] = args
    if noise_lut is not None:
        post["noise"] = (noise_lut, cmap.base_correlation_x,
                         cmap.base_correlation_b, fd.group_dim, 1)
    if post:
        post["final_hw"] = (fd.ysize_upsampled, fd.xsize_upsampled)
    return post
