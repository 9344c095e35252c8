"""Low-memory row-streaming decode: O(group-row) peak memory.

Analogue of lib/jxl/render_pipeline/low_memory_render_pipeline.h: the
frame is decoded one 256-px group row (band) at a time — AC group
coefficients are freed as soon as their band renders, and every post
stage runs band-wise with real-neighbor halos:

  loop filters (16-px unfiltered halo) -> learned upsampling (2-px
  filtered halo) -> patches -> splines -> noise (2-px noise halo)

each windowed so band outputs tile bit-exactly to the one-shot
decoder (tests/test_low_memory.py compares both). Peak memory is two
unfiltered pixel bands + the DC/control maps instead of the
whole-frame float buffers (a 16K x 16K image: ~100 MB instead of
~3 GB).

Profile: VarDCT 4:4:4 XYB without extra channels; multi-pass
(progressive), upsampling, patches, splines and noise all stream.
Leading REFERENCE_ONLY / DC frames decode one-shot (they are retained
whole, exactly as the reference keeps reference_frames_) and the final
visible frame streams. Other streams raise NotSupported and callers
fall back to the one-shot decoder.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.frame.incremental import (
    IncrementalFrameDecoder, NotSupported,
)

_HALO = 16   # px; >= total gaborish+EPF support, block aligned
_UPH = 2     # filtered rows of context the 5x5 upsampler needs


def decode_low_memory(data: bytes, callback) -> tuple:
    """Decode `data` (codestream or container), invoking
    ``callback(y0, rows)`` with consecutive (h, W, 3) uint8 sRGB bands.
    Returns (height, width)."""
    from libjxl_tpu_torch.api.simple import is_container, unpack_container
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.bitstream.fields import bundle_read
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.frame_header import FrameHeader, FrameType
    from libjxl_tpu_torch.frame.headers import read_codestream_headers

    if is_container(data):
        data = unpack_container(data).codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    if not meta.m.xyb_encoded or meta.m.num_extra_channels:
        raise NotSupported("low-memory profile is XYB color only")

    # Leading reference / DC frames decode one-shot and are retained
    # whole (reference semantics); the last frame streams.
    refs: list = [None] * 4
    dcs: list = [None] * 5
    while True:
        start_bits = r.bits_consumed
        fh_probe = FrameHeader(nonserialized_metadata=meta)
        bundle_read(r, fh_probe)
        is_final = (fh_probe.frame_type == FrameType.REGULAR
                    and fh_probe.is_last)
        r.seek_bits(start_bits)
        if is_final:
            break
        frame = decode_frame(r, meta, refs, dc_frames=dcs)
        fh_p = frame.header
        if fh_p.frame_type == FrameType.DC_FRAME:
            dcs[fh_p.dc_level] = frame.xyb
        elif fh_p.save_as_reference is not None and frame.xyb is not None:
            refs[fh_p.save_as_reference] = frame.xyb

    inc = IncrementalFrameDecoder(meta)
    inc.reference_frames = refs
    if not inc.init(data, r.bits_consumed):
        raise NotSupported("truncated input")
    fh, fd = inc.fh, inc.fd
    if inc._modular:
        raise NotSupported("modular frame outside low-memory profile")
    from libjxl_tpu_torch.frame.frame_header import BlendMode
    if fh.blending_info.mode != BlendMode.REPLACE \
            or fh.custom_size_or_origin:
        raise NotSupported("blended/cropped final frame outside "
                           "low-memory profile")
    num_passes = fh.passes.num_passes

    if inc._single:
        # One-section frame (small image): all sections share one
        # sequential reader; memory is bounded by the single group
        # anyway.
        r1 = inc._section(data, 0)
        inc._decode_lf_global(r1)
        for g in range(fd.num_dc_groups):
            inc._decode_dc_group(r1, g)
        inc._assemble_maps()
        inc._decode_ac_global(r1)
        seq_reader = r1
    else:
        inc._decode_lf_global(inc._section(data, 0))
        for g in range(fd.num_dc_groups):
            inc._decode_dc_group(inc._section(data, 1 + g), g)
        inc._assemble_maps()
        inc._decode_ac_global(inc._section(data, 1 + fd.num_dc_groups))
        seq_reader = None

    from libjxl_tpu_torch.color.xyb import linear_to_srgb, xyb_to_linear_rgb
    from libjxl_tpu_torch.pipeline.loop_filters import apply_loop_filters
    from libjxl_tpu_torch.vardct.reconstruct import (
        b_qm_multiplier, reconstruct_group, x_qm_multiplier,
    )

    x_mul = 1.0 / x_qm_multiplier(fh.x_qm_scale)
    b_mul = 1.0 / b_qm_multiplier(fh.b_qm_scale)
    gd = fd.group_dim
    groups_x = -(-fd.xsize // gd)
    groups_y = -(-fd.ysize // gd)
    W = fd.xsize
    n_up = fh.upsampling
    Wu = fd.xsize_upsampled
    Hu = fd.ysize_upsampled
    lfp = fh.loop_filter
    use_filters = lfp.gab or lfp.epf_iters > 0

    def render_band(row: int) -> np.ndarray:
        """Decode + reconstruct one unfiltered band (3, bh, W),
        accumulating every progressive pass, freeing coefficients."""
        y0 = row * gd
        bh = min(gd, fd.ysize - y0)
        band = np.zeros((3, bh, W), np.float32)
        for gx in range(groups_x):
            g = row * groups_x + gx
            for p in range(num_passes):
                if seq_reader is not None:
                    inc._decode_ac_group(seq_reader, p, g)
                else:
                    idx = 2 + fd.num_dc_groups + p * fd.num_groups + g
                    inc._decode_ac_group(inc._section(data, idx), p, g)
            blocks = inc._group_blocks[g]
            brect = fd.block_group_rect(g)
            sl = brect.slices()
            # Same fused native kernel as the one-shot decoder
            # (block-local math -> bit-identical bands); numpy fallback.
            from libjxl_tpu_torch.vardct.reconstruct import (
                native_reconstruct_group)
            pix = native_reconstruct_group(
                blocks, brect, inc.quantizer, inc.raw_quant[sl],
                inc.dc_full[:, brect.y0:brect.y1, brect.x0:brect.x1],
                inc.cmap, inc.ytox_map, inc.ytob_map, x_mul, b_mul)
            if pix is None:
                pix = reconstruct_group(
                    blocks, brect.xsize, brect.ysize, inc.quantizer,
                    inc.raw_quant[sl],
                    inc.dc_full[:, brect.y0:brect.y1, brect.x0:brect.x1],
                    inc.cmap, inc.ytox_map, inc.ytob_map, brect.x0,
                    brect.y0, x_mul, b_mul)
            inc._group_blocks[g] = None   # free coefficients
            x0 = gx * gd
            w_ = min(gd, W - x0)
            band[:, :, x0:x0 + w_] = pix[:, :bh, :w_]
        return band

    def emit(xyb_rows: np.ndarray, y0u: int) -> None:
        # Same fused native tail as api.simple.decode so band outputs
        # are bit-identical to the one-shot decoder's pixels.
        from libjxl_tpu_torch.color.xyb import xyb_to_srgb_px_native
        fused = xyb_to_srgb_px_native(
            np.ascontiguousarray(xyb_rows, np.float32), 255, np.uint8)
        if fused is not None:
            callback(y0u, fused)
            return
        srgb = linear_to_srgb(xyb_to_linear_rgb(xyb_rows))
        rows = np.clip(np.round(srgb * 255.0), 0, 255).astype(np.uint8)
        callback(y0u, rows.transpose(1, 2, 0))

    def post_and_emit(fband, y0, at_top, at_bot):
        """Upsample + features + emit one FILTERED band. fband carries
        _UPH extra filtered context rows on interior edges."""
        top_ctx = 0 if at_top else _UPH
        h = fband.shape[1] - top_ctx - (0 if at_bot else _UPH)
        if n_up != 1:
            from libjxl_tpu_torch.pipeline.upsample import upsample_image
            # The upsampler's symmetric padding only leaks into output
            # rows derived from the context rows themselves; the band
            # region is exact (true frame edges keep the mirror).
            up = upsample_image(fband, n_up)
            out = up[:, top_ctx * n_up:(top_ctx + h) * n_up]
            out = np.ascontiguousarray(out[:, :, :Wu])
        else:
            out = np.ascontiguousarray(
                fband[:, top_ctx:top_ctx + h, :Wu])
        y0u = y0 * n_up
        out = out[:, :max(0, Hu - y0u)]
        if out.shape[1] == 0:
            return
        if inc.patch_dict is not None:
            from libjxl_tpu_torch.frame.patches import apply_patches_band
            apply_patches_band(inc.patch_dict, out, y0u, None, refs)
        if inc.splines is not None:
            from libjxl_tpu_torch.frame.splines import render_splines
            render_splines(inc.splines, out, inc.cmap, y_off=y0u)
        if inc.noise_lut is not None:
            from libjxl_tpu_torch.frame.noise import add_noise_band
            add_noise_band(out, y0u, inc.noise_lut, inc.cmap, fd)
        emit(out, y0u)

    def filter_band(band, y0, top_tail, bot_head):
        """Filter one band with real-neighbor halos; returns the
        filtered band EXTENDED by _UPH valid context rows on interior
        edges (the rows sit >= _HALO - _UPH >= filter support away from
        the concatenation boundary, so they match the whole-frame
        filter output)."""
        if not use_filters:
            parts = []
            if top_tail is not None:
                parts.append(top_tail[:, -_UPH:])
            parts.append(band)
            if bot_head is not None:
                parts.append(bot_head[:, :_UPH])
            return np.concatenate(parts, axis=1)
        parts = []
        top_h = 0
        if top_tail is not None:
            parts.append(top_tail)
            top_h = top_tail.shape[1]
        parts.append(band)
        if bot_head is not None:
            parts.append(bot_head)
        ext = np.ascontiguousarray(np.concatenate(parts, axis=1))
        by0 = (y0 - top_h) // 8
        rq = inc.raw_quant[by0:by0 + ext.shape[1] // 8 + 1]
        sh = inc.sharpness[by0:by0 + ext.shape[1] // 8 + 1]
        st = inc.strategies[by0:by0 + ext.shape[1] // 8 + 1]
        filt = apply_loop_filters(ext, lfp, rq, st, inc.quantizer, fd,
                                  sharpness=sh)
        lo = top_h - (_UPH if top_tail is not None else 0)
        hi = top_h + band.shape[1] + \
            (_UPH if bot_head is not None else 0)
        return filt[:, lo:hi]

    prev_band = None       # unfiltered band r-1 (3, h, W)
    prev_tail = None       # last _HALO unfiltered rows of band r-2
    prev_y0 = 0

    for row in range(groups_y):
        band = render_band(row)
        if prev_band is not None:
            fband = filter_band(prev_band, prev_y0, prev_tail,
                                band[:, :_HALO])
            post_and_emit(fband, prev_y0, prev_tail is None, False)
            prev_tail = prev_band[:, -_HALO:].copy()
        prev_band, prev_y0 = band, row * gd
    fband = filter_band(prev_band, prev_y0, prev_tail, None)
    post_and_emit(fband, prev_y0, prev_tail is None, True)
    return Hu, Wu
