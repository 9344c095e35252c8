"""Streaming (chunked) VarDCT encoding with bounded pixel memory.

Reference: lib/jxl/enc_frame.cc:2047 EncodeFrameStreaming — the image is
encoded one 2048x2048 DC-group chunk at a time; pixel state never
exceeds one chunk. The TOC carries a permutation
(enc_frame.cc:1869 ComputePermutationForStreaming) so sections appear in
the stream in chunk order: LfGlobal, then each DC group followed by its
AC groups, with ACGlobal last. Each chunk's AC groups select their own
histogram cluster set (the per-AC-group histogram index), so entropy
coding finalizes per chunk; the combined ACGlobal is assembled at the
end from the per-chunk clusterings (enc_frame.cc:1252).

Copy of libjxl_tpu/frame/streaming_encode.py. The chunks are encoded on
the host, as in the reference, so a multi-chunk stream is the
reference's byte for byte. One difference (reference line numbers):
``encode_streaming`` takes ``device`` (new argument) and passes it only
to the one-shot ``encode`` of a single-group image (:94-95), which runs
the VarDCT stages on that torch device (default ``cuda``).
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.base.frame_dimensions import FrameDimensions
from libjxl_tpu_torch.bitstream.bit_io import BitWriter
from libjxl_tpu_torch.frame.frame_header import (
    FrameEncoding, FrameFlags, FrameHeader,
)
from libjxl_tpu_torch.frame.headers import CodecMetadata, write_codestream_headers
from libjxl_tpu_torch.frame.modular_frame import ModularFrameEncoder
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices
from libjxl_tpu_torch.vardct.quantizer import (
    GLOBAL_SCALE_DENOM, QUANT_MAX, Quantizer,
)

_DC_GROUP_DIM = 2048


def streaming_permutation(fd) -> list[int]:
    """ComputePermutationForStreaming (enc_frame.cc:1869), single pass:
    permutation[old_index] = stream position."""
    num_sections = 2 + fd.num_dc_groups + fd.num_groups
    perm = [0] * num_sections
    new_ix = 0
    perm[0] = new_ix
    new_ix += 1
    gx_n = (fd.xsize_blocks * 8 + 255) // 256
    gy_n = (fd.ysize_blocks * 8 + 255) // 256
    dgx_n = (fd.xsize_blocks * 8 + _DC_GROUP_DIM - 1) // _DC_GROUP_DIM
    dgy_n = (fd.ysize_blocks * 8 + _DC_GROUP_DIM - 1) // _DC_GROUP_DIM
    for dy in range(dgy_n):
        for dx in range(dgx_n):
            dc_ix = dy * dgx_n + dx
            perm[1 + dc_ix] = new_ix
            new_ix += 1
            for gy in range(dy * 8, min(gy_n, dy * 8 + 8)):
                for gx in range(dx * 8, min(gx_n, dx * 8 + 8)):
                    g = gy * gx_n + gx
                    perm[2 + fd.num_dc_groups + g] = new_ix
                    new_ix += 1
    perm[1 + fd.num_dc_groups] = new_ix
    new_ix += 1
    assert new_ix == num_sections
    return perm


def encode_streaming(get_chunk, xsize: int, ysize: int, *,
                     distance: float = 1.0,
                     metadata: CodecMetadata | None = None,
                     device=None) -> bytes:
    """Encode a large image one DC-group chunk at a time.

    get_chunk(x0, y0, w, h) -> (h, w, 3) uint8 sRGB pixels. Pixel
    memory is bounded to one 2048x2048 chunk; only compressed section
    bytes accumulate. device: the torch device of the one-shot encode
    of a single-group image (default ``cuda``); the chunks of a larger
    image are encoded on the host.
    """
    from libjxl_tpu_torch.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    from libjxl_tpu_torch.entropy.codes import (
        HybridUintConfig, build_chunk_codes, write_histogram_sets,
        write_tokens)
    from libjxl_tpu_torch.frame.adaptive_quant import initial_quant_dc as aq_dc
    from libjxl_tpu_torch.frame.encode_frame import compute_vardct_encoding
    from libjxl_tpu_torch.vardct.coeff_order import write_used_orders
    from libjxl_tpu_torch.vardct.group import tokenize_group_coeffs

    if metadata is None:
        from libjxl_tpu_torch.color.color_encoding import ColorEncoding
        from libjxl_tpu_torch.frame.headers import BitDepth
        metadata = CodecMetadata()
        metadata.size.set(xsize, ysize)
        metadata.m.bit_depth = BitDepth.uint(8)
        metadata.m.xyb_encoded = True
        metadata.m.color_encoding = ColorEncoding.srgb(is_gray=False)

    if xsize <= 256 and ysize <= 256:
        # Single-group frames use the one-section TOC layout; nothing
        # to stream — the one-shot encoder is already bounded-memory.
        from libjxl_tpu_torch.api.simple import encode as _oneshot
        return _oneshot(np.asarray(get_chunk(0, 0, xsize, ysize)),
                        distance=distance, device=device)
    w = BitWriter()
    write_codestream_headers(metadata, w)

    fh = FrameHeader(nonserialized_metadata=metadata)
    fh.encoding = FrameEncoding.VARDCT
    fh.flags = int(FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING)
    # Chunk independence: gaborish-inverse would need cross-chunk
    # borders (the reference pads by kBlockDim; we disable it instead).
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 2
    fd = fh.to_frame_dimensions()

    # One fixed quantizer for the whole frame (streaming skips the
    # global FindBestQuantizer): scale sized for the AQ field's range.
    from libjxl_tpu_torch.frame.adaptive_quant import K_AC_QUANT
    matrices = DequantMatrices()
    quantizer = Quantizer(matrices)
    max_qf = 2.4 * K_AC_QUANT / max(distance, 0.1)
    quantizer.global_scale = max(1, min(
        int(max_qf * GLOBAL_SCALE_DENOM / (QUANT_MAX - 1) + 0.5), 1 << 15))
    scale = quantizer.global_scale / GLOBAL_SCALE_DENOM
    quantizer.quant_dc = int(np.clip(round(aq_dc(distance) / scale),
                                     1, 1 << 16))
    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()

    dgx_n = (fd.xsize_padded + _DC_GROUP_DIM - 1) // _DC_GROUP_DIM
    dgy_n = (fd.ysize_padded + _DC_GROUP_DIM - 1) // _DC_GROUP_DIM
    num_dc_groups = dgx_n * dgy_n
    assert num_dc_groups == fd.num_dc_groups
    nctx = ctx_map.num_ac_contexts()
    uint_config = HybridUintConfig(4, 2, 0)

    # LfGlobal section.
    lf = BitWriter()
    matrices.encode_dc(lf)
    quantizer.encode(lf)
    ctx_map.encode(lf)
    cmap.encode_dc(lf)
    mfe_probe = ModularFrameEncoder(fd)
    mfe_probe.encode_global_info(lf)
    lf.align_to_byte()

    sections: dict[int, bytes] = {0: bytes(lf._bytes)}
    context_maps, counts_sets = [], []
    bitdepth = metadata.m.bit_depth.bits_per_sample

    orders = {}
    for s in range(acs.NUM_STRATEGIES):
        ord_b = acs.STRATEGY_ORDER[s]
        for c in range(3):
            orders[(ord_b, c)] = acs.natural_coeff_order(s)

    # ACGlobal count field width (keyed on num_groups) vs the per-
    # AC-group selector width (keyed on the histogram-set count):
    # dec_frame reads ceil_log2(num_groups) bits for the count and
    # ceil_log2(num_histograms) bits per selector.
    histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
        if fd.num_groups > 1 else 0
    sel_bits = (num_dc_groups - 1).bit_length() if num_dc_groups > 1 else 0

    gx_n = (fd.xsize_padded + 255) // 256
    for dgy in range(dgy_n):
        for dgx in range(dgx_n):
            dc_ix = dgy * dgx_n + dgx
            x0, y0 = dgx * _DC_GROUP_DIM, dgy * _DC_GROUP_DIM
            cw = min(_DC_GROUP_DIM, xsize - x0)
            ch = min(_DC_GROUP_DIM, ysize - y0)
            chunk = np.asarray(get_chunk(x0, y0, cw, ch))
            if chunk.dtype == np.uint8:
                srgb = chunk.astype(np.float32) / 255.0
            else:
                srgb = chunk.astype(np.float32)
            xyb = linear_rgb_to_xyb(
                srgb_to_linear(srgb).transpose(2, 0, 1))
            fdc = FrameDimensions.make(cw, ch)
            pad_y = fdc.ysize_padded - ch
            pad_x = fdc.xsize_padded - cw
            planes = np.pad(xyb, ((0, 0), (0, pad_y), (0, pad_x)),
                            mode="edge")
            enc = compute_vardct_encoding(planes, fdc, fh, distance,
                                          quantizer=quantizer)

            # DC section for this chunk.
            sw = BitWriter()
            mfe = ModularFrameEncoder(fdc)
            rect = fdc.dc_group_rect(0)
            mfe.encode_vardct_dc(sw, enc["qdc"], bitdepth)
            epf = np.full((rect.ysize, rect.xsize), 4, np.int32)
            mfe.encode_ac_metadata(sw, rect, enc["ytox_map"],
                                   enc["ytob_map"], enc["strategies"],
                                   enc["raw_quant"], epf, bitdepth)
            sw.align_to_byte()
            sections[1 + dc_ix] = bytes(sw._bytes)

            # Tokenize + entropy-code this chunk's AC groups with its
            # own histogram cluster (selector = chunk index).
            group_tokens = []
            for g in range(fdc.num_groups):
                brect = fdc.block_group_rect(g)
                sl = brect.slices()
                tokens = []
                tokenize_group_coeffs(enc["blocks_per_group"][g],
                                      brect.xsize, brect.ysize,
                                      enc["raw_quant"][sl], orders,
                                      ctx_map, tokens)
                group_tokens.append(tokens)
            codes, cmap_local, counts = build_chunk_codes(
                nctx, group_tokens, uint_config)
            context_maps.append(cmap_local)
            counts_sets.append(counts)

            for g in range(fdc.num_groups):
                lgy, lgx = divmod(g, fdc.xsize_groups)
                ggx = dgx * 8 + lgx
                ggy = dgy * 8 + lgy
                gg = ggy * fd.xsize_groups + ggx
                sw = BitWriter()
                if sel_bits:
                    sw.write(sel_bits, dc_ix)
                write_tokens(group_tokens[g], codes, sw)
                sw.align_to_byte()
                sections[2 + num_dc_groups + gg] = bytes(sw._bytes)

    # ACGlobal: dequant matrices + histogram-set count + orders +
    # the combined per-chunk clustered histograms.
    ag = BitWriter()
    matrices.encode(ag)
    if histo_bits:
        ag.write(histo_bits, num_dc_groups - 1)
    write_used_orders(0, ag)
    write_histogram_sets(ag, context_maps, counts_sets, uint_config)
    ag.align_to_byte()
    sections[1 + num_dc_groups] = bytes(ag._bytes)

    # Frame header + permuted TOC + sections in stream order.
    from libjxl_tpu_torch.bitstream.fields import bundle_write
    from libjxl_tpu_torch.bitstream.toc import write_toc
    bundle_write(fh, w)
    perm = streaming_permutation(fd)
    n = len(perm)
    stream_order = [0] * n
    for old_ix, new_ix in enumerate(perm):
        stream_order[new_ix] = old_ix
    sizes_stream = [len(sections[old_ix]) for old_ix in stream_order]
    # write_toc takes sizes in PERMUTED (stream) order plus the
    # permutation mapping stream position -> canonical index.
    write_toc(sizes_stream, w, permutation=perm)
    w.align_to_byte()
    for old_ix in stream_order:
        w.append_bytes(sections[old_ix])
    return w.get_bytes()
