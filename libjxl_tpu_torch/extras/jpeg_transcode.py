"""JPEG -> JXL transcoding (coefficient-preserving, pixel-approximate).

Reference: lib/jxl/jpeg/* + lib/extras (cjxl -j). The JPEG's quantized
DCT coefficients are carried VERBATIM into a VarDCT YCbCr frame: the
RAW quant-matrix mode stores the JPEG quant tables (rescaled into the
jxl scaled-DCT convention), the DC coefficients ride the VarDCT DC
stream with matching custom dc_quant steps, and chroma-from-luma is
signalled off. Reconstruction goes through the normal float decode
path, so output pixels match a libjpeg decode to within ~1 intensity
level (the bit-exact `jbrd` reconstruction path is future work).

Only 4:4:4 baseline JPEGs take the coefficient path; subsampled inputs
raise (re-encode from pixels instead).
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.extras.jpeg_parser import JpegError, parse_jpeg


def _jxl_from_jpeg_scale() -> np.ndarray:
    """(8, 8) ratio between jxl scaled-DCT and orthonormal JPEG DCT
    coefficients: jxl_coef = jpeg_dequant_coef * S."""
    from libjxl_tpu_torch.vardct.dct import dct2d

    # Orthonormal JPEG IDCT basis matrix.
    u = np.arange(8)
    a = np.cos((2 * u[:, None] + 1) * u[None, :] * np.pi / 16)
    a *= np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[None, :]
    s = np.zeros((8, 8))
    for uu in range(8):
        for vv in range(8):
            f = np.zeros((8, 8))
            f[uu, vv] = 1.0
            block = a @ f @ a.T     # JPEG IDCT of a single coefficient
            s[uu, vv] = dct2d(block)[uu, vv]
    return s


def _channel_modes(components) -> list:
    """JPEG sampling factors -> YCbCrChromaSubsampling channel_mode
    triple for (Cb, Y, Cr) VarDCT planes (frame_header.h kHShift/
    kVShift: mode0=(0,0), 1=(1,1), 2=(1,0), 3=(0,1))."""
    hmax = max(c.h_samp for c in components)
    vmax = max(c.v_samp for c in components)
    hv_to_mode = {(0, 0): 0, (1, 1): 1, (1, 0): 2, (0, 1): 3}
    modes = []
    for comp in (components[1], components[0], components[2]):
        hs = (hmax // comp.h_samp).bit_length() - 1
        vs = (vmax // comp.v_samp).bit_length() - 1
        need_h = (hmax.bit_length() - 1) - hs
        need_v = (vmax.bit_length() - 1) - vs
        mode = hv_to_mode.get((need_h, need_v))
        if mode is None:
            raise JpegError(f"unsupported sampling {comp.h_samp}x"
                            f"{comp.v_samp}")
        modes.append(mode)
    return modes


def transcode_jpeg(data: bytes) -> bytes:
    """Baseline JPEG bytes (4:4:4 / 4:2:0 / 4:2:2 / gray) -> JXL
    codestream bytes."""
    from libjxl_tpu_torch.api.simple import CodecMetadata
    from libjxl_tpu_torch.bitstream.bit_io import BitWriter
    from libjxl_tpu_torch.color.color_encoding import ColorEncoding
    from libjxl_tpu_torch.entropy.codes import (
        build_and_encode_histograms, write_tokens,
    )
    from libjxl_tpu_torch.frame.encode_frame import _emit_sections
    from libjxl_tpu_torch.frame.frame_header import (
        ColorTransform, FrameEncoding, FrameFlags, FrameHeader,
    )
    from libjxl_tpu_torch.frame.headers import (
        BitDepth, write_codestream_headers,
    )
    from libjxl_tpu_torch.frame.modular_frame import ModularFrameEncoder
    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
    from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
    from libjxl_tpu_torch.vardct.coeff_order import write_used_orders
    from libjxl_tpu_torch.vardct.group import tokenize_group_coeffs_subsampled
    from libjxl_tpu_torch.vardct.quant_weights import (
        MODE_RAW, DequantMatrices, QuantEncoding,
    )
    from libjxl_tpu_torch.vardct.quantizer import Quantizer

    jd = parse_jpeg(data)
    if len(jd.components) not in (1, 3):
        raise JpegError("only YCbCr / grayscale JPEGs supported")
    if any(c.h_samp > 2 or c.v_samp > 2 for c in jd.components):
        raise JpegError("sampling factors above 2 unsupported")
    if len(jd.components) == 1:
        import dataclasses as _dc
        luma = jd.components[0]
        for _ in range(2):
            c = _dc.replace(luma)
            c.coeffs = np.zeros_like(luma.coeffs)
            jd.components.append(c)

    modes = _channel_modes(jd.components)
    is_444 = all(m == 0 for m in modes) or len(set(modes)) == 1

    meta = CodecMetadata()
    meta.size.set(jd.width, jd.height)
    meta.m.bit_depth = BitDepth.uint(8)
    meta.m.xyb_encoded = False
    meta.m.color_encoding = ColorEncoding.srgb(is_gray=False)
    w = BitWriter()
    write_codestream_headers(meta, w)

    fh = FrameHeader(nonserialized_metadata=meta)
    fh.encoding = FrameEncoding.VARDCT
    fh.color_transform = ColorTransform.YCBCR
    if not is_444:
        fh.chroma_subsampling.channel_mode = modes
    fh.flags = int(FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    fd = fh.to_frame_dimensions()
    cs = fh.chroma_subsampling
    shifts = [(cs.hshift(c), cs.vshift(c)) for c in range(3)]

    # The RAW table carries the JPEG quant values VERBATIM (transposed
    # into the jxl layout) with denominator 1/(8*255); decoders validate
    # exactly this (enc_frame.cc:837-871, dec_frame.cc:440-446).
    den = 1.0 / (8.0 * 255.0)
    # VarDCT plane order for YCbCr: (Cb, Y, Cr) (stage_ycbcr.cc rows).
    comp_for_plane = [jd.components[1], jd.components[0],
                      jd.components[2]]
    qraw = np.zeros((3, 64), np.int64)
    dc_quant = np.zeros(3, np.float32)
    for p, comp in enumerate(comp_for_plane):
        q = jd.quant_tables[comp.quant_idx].reshape(8, 8)
        qraw[p] = q.astype(np.int64).T.ravel()
        dc_quant[p] = q[0, 0] / (8.0 * 255.0)

    matrices = DequantMatrices()
    matrices.encodings[0] = QuantEncoding(MODE_RAW, qraw_table=qraw,
                                          qraw_den=den)
    matrices.dc_quant = dc_quant
    matrices.inv_dc_quant = 1.0 / dc_quant
    quantizer = Quantizer(matrices, quant_dc=1, global_scale=1 << 16)
    ctx_map = BlockCtxMap()
    cmap = ColorCorrelation()
    cmap.base_correlation_b = 0.0  # no CfL for YCbCr content

    by, bx = fd.ysize_blocks, fd.xsize_blocks
    strategies = np.zeros((by, bx), np.int32)
    raw_quant = np.ones((by, bx), np.int32)
    # Per-plane coefficient arrays at each channel's coded block dims.
    coeff_planes = []
    dc_planes = []
    for p, comp in enumerate(comp_for_plane):
        h, v = shifts[p]
        cw = -(-bx // (1 << h))
        chh = -(-by // (1 << v))
        cc = np.zeros((chh, cw, 64), np.int32)
        cbh, cbw = comp.coeffs.shape[:2]
        src = comp.coeffs[:min(chh, cbh), :min(cw, cbw)]
        # Transpose each 8x8 block into the jxl stored layout.
        cc[:min(chh, cbh), :min(cw, cbw)] = (
            src.reshape(src.shape[0], src.shape[1], 8, 8)
            .transpose(0, 1, 3, 2).reshape(src.shape[0], src.shape[1], 64))
        dc_planes.append(cc[:, :, 0].copy())
        cc[:, :, 0] = 0  # DC rides the DC stream
        coeff_planes.append(cc)

    orders = {}
    ord_b = acs.STRATEGY_ORDER[acs.DCT8X8]
    for c in range(3):
        orders[(ord_b, c)] = acs.natural_coeff_order(acs.DCT8X8)
    group_tokens = []
    for g in range(fd.num_groups):
        brect = fd.block_group_rect(g)
        sl = brect.slices()
        gcoeffs = []
        for p in range(3):
            h, v = shifts[p]
            gcoeffs.append(coeff_planes[p][brect.y0 >> v:, brect.x0 >> h:])
        tokens = []
        tokenize_group_coeffs_subsampled(
            gcoeffs, brect.xsize, brect.ysize, raw_quant[sl], orders,
            ctx_map, tokens, shifts)
        group_tokens.append(tokens)

    mfe = ModularFrameEncoder(fd)
    holder = {}

    def write_lf_global(sw):
        matrices.encode_dc(sw)
        quantizer.encode(sw)
        ctx_map.encode(sw)
        cmap.encode_dc(sw)
        mfe.encode_global_info(sw)

    def write_dc_group(sw, g):
        rect = fd.dc_group_rect(g)
        qdc_g = []
        for p in range(3):
            h, v = shifts[p]
            y0, x0 = rect.y0 >> v, rect.x0 >> h
            hh = -(-rect.ysize // (1 << v))
            ww = -(-rect.xsize // (1 << h))
            qdc_g.append(dc_planes[p][y0:y0 + hh, x0:x0 + ww])
        if is_444:
            mfe.encode_vardct_dc(sw, np.stack(qdc_g), 8)
        else:
            mfe.encode_vardct_dc(sw, qdc_g, 8, shifts=shifts)
        sl = rect.slices()
        cr_w = (rect.xsize + 7) >> 3
        cr_h = (rect.ysize + 7) >> 3
        zeros = np.zeros((cr_h, cr_w), np.int32)
        epf = np.full((rect.ysize, rect.xsize), 4, np.int32)
        mfe.encode_ac_metadata(sw, rect, zeros, zeros, strategies[sl],
                               raw_quant[sl], epf, 8)

    def write_ac_global(sw):
        matrices.encode(sw)
        num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
            if fd.num_groups > 1 else 0
        if num_histo_bits:
            sw.write(num_histo_bits, 0)
        write_used_orders(0, sw)
        holder["codes"] = build_and_encode_histograms(
            ctx_map.num_ac_contexts(), group_tokens, sw)

    def write_ac_group(sw, g):
        write_tokens(group_tokens[g], holder["codes"], sw)

    parts = [write_lf_global]
    parts += [(lambda g: (lambda sw: write_dc_group(sw, g)))(g)
              for g in range(fd.num_dc_groups)]
    parts += [write_ac_global]
    parts += [(lambda g: (lambda sw: write_ac_group(sw, g)))(g)
              for g in range(fd.num_groups)]
    _emit_sections(w, fh, fd, parts)
    w.align_to_byte()
    return w.get_bytes()


def transcode_jxl_to_jpeg(data: bytes) -> bytes:
    """JXL codestream (JPEG-transcode profile: VarDCT YCbCr, RAW quant
    table) -> baseline JPEG with the original DCT coefficients.

    jpg -> jxl -> jpg round-trips carry coefficients verbatim, so the
    regenerated JPEG decodes to the same pixels as the original (the
    bytes differ: standard Huffman tables are used; byte-exactness
    needs jbrd metadata)."""
    from libjxl_tpu_torch.base.errors import BitstreamError
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.bitstream.fields import bundle_read
    from libjxl_tpu_torch.bitstream.toc import num_toc_entries, read_toc
    from libjxl_tpu_torch.container.boxes import is_container, unpack_container
    from libjxl_tpu_torch.entropy.codes import SymbolReader, decode_histograms
    from libjxl_tpu_torch.extras.jpeg_parser import JpegComponent, JpegData
    from libjxl_tpu_torch.extras.jpeg_writer import write_jpeg
    from libjxl_tpu_torch.frame.decode_frame import ModularFrameDecoder
    from libjxl_tpu_torch.frame.frame_header import (
        ColorTransform, FrameEncoding, FrameHeader,
    )
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    from libjxl_tpu_torch.frame.modular_frame import (
        stream_modular_ac, stream_modular_dc,
    )
    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
    from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
    from libjxl_tpu_torch.vardct.coeff_order import (
        decode_coeff_orders, read_used_orders,
    )
    from libjxl_tpu_torch.vardct.group import decode_group_coeffs_subsampled
    from libjxl_tpu_torch.vardct.quant_weights import MODE_RAW, DequantMatrices
    from libjxl_tpu_torch.vardct.quantizer import Quantizer

    if is_container(data):
        data = unpack_container(data).codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    fh = FrameHeader(nonserialized_metadata=meta)
    bundle_read(r, fh)
    if fh.encoding != FrameEncoding.VARDCT or \
            fh.color_transform != ColorTransform.YCBCR:
        raise JpegError("not a JPEG-transcoded JXL (need VarDCT YCbCr)")
    fd = fh.to_frame_dimensions()
    cs = fh.chroma_subsampling
    shifts = [(cs.hshift(c), cs.vshift(c)) for c in range(3)]
    is_444 = cs.is_444()

    toc_entries = num_toc_entries(fd.num_groups, fd.num_dc_groups, 1)
    sizes, offsets = read_toc(toc_entries, r)
    r.align_to_byte()
    base = r.bits_consumed // 8

    single = (toc_entries == 1)
    seq = BitReader(data[base + offsets[0]:base + offsets[0] + sizes[0]]) \
        if single else None

    def get(idx):
        if single:
            return seq
        start = base + offsets[idx]
        return BitReader(data[start:start + sizes[idx]])

    mfd = ModularFrameDecoder(fd)
    lf = get(0)
    matrices = DequantMatrices()
    matrices.decode_dc(lf)
    quantizer = Quantizer(matrices)
    quantizer.decode(lf)
    ctx_map = BlockCtxMap()
    ctx_map.decode(lf)
    cmap = ColorCorrelation()
    cmap.decode_dc(lf)
    mfd.decode_global_info(lf, fh, meta)

    from libjxl_tpu_torch.base.rect import Rect
    dc_data = {}
    raw_quant = np.ones((fd.ysize_blocks, fd.xsize_blocks), np.int32)
    tiles_x = (fd.xsize_blocks + 7) // 8
    tiles_y = (fd.ysize_blocks + 7) // 8
    ytox_map = np.zeros((tiles_y, tiles_x), np.int32)
    ytob_map = np.zeros((tiles_y, tiles_x), np.int32)
    for g in range(fd.num_dc_groups):
        br = get(1 + g)
        qdc, _ep = mfd.decode_vardct_dc(
            g, br, meta.m.bit_depth.bits_per_sample,
            shifts=None if is_444 else shifts)
        dc_data[g] = qdc
        rect = fd.dc_group_rect(g)
        mrect = Rect(rect.x0 * 8, rect.y0 * 8, fd.dc_group_dim,
                     fd.dc_group_dim)
        mfd.decode_group(mrect, br, 3, 1000, stream_modular_dc(g, fd))
        m = mfd.decode_ac_metadata(g, br,
                                   meta.m.bit_depth.bits_per_sample)
        raw_quant[rect.slices()] = m["raw_quant"]
        cr = Rect(rect.x0 >> 3, rect.y0 >> 3, (rect.xsize + 7) >> 3,
                  (rect.ysize + 7) >> 3)
        ytox_map[cr.slices()] = m["ytox"]
        ytob_map[cr.slices()] = m["ytob"]

    acg = get(1 + fd.num_dc_groups)
    matrices.decode(acg, mfd)
    enc0 = matrices.encodings[0]
    if enc0.mode != MODE_RAW:
        raise JpegError("JXL does not carry RAW (JPEG) quant tables")
    num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
        if fd.num_groups > 1 else 0
    num_histograms = 1 + (acg.read(num_histo_bits) if num_histo_bits
                          else 0)
    used_orders = read_used_orders(acg)
    orders = decode_coeff_orders(used_orders, 1, acg)
    codes = decode_histograms(acg,
                              num_histograms * ctx_map.num_ac_contexts())
    histo_bits = (num_histograms - 1).bit_length() \
        if num_histograms > 1 else 0

    planes = []
    for c in range(3):
        h, v = shifts[c]
        cw = -(-fd.xsize_blocks // (1 << h))
        ch = -(-fd.ysize_blocks // (1 << v))
        planes.append(np.zeros((ch, cw, 64), np.int32))
    for g in range(fd.num_groups):
        br = get(2 + fd.num_dc_groups + g)
        brect = fd.block_group_rect(g)
        cur = br.read(histo_bits) if histo_bits else 0
        ctx_offset = cur * ctx_map.num_ac_contexts()
        reader = SymbolReader(codes, br)
        gcoeffs = decode_group_coeffs_subsampled(
            reader, brect.xsize, brect.ysize, raw_quant[brect.slices()],
            orders, ctx_map, ctx_offset, shifts)
        if not reader.check_final_state():
            raise BitstreamError("bad ANS state in AC group")
        for c in range(3):
            h, v = shifts[c]
            gy0, gx0 = brect.y0 >> v, brect.x0 >> h
            sbh, sbw, _ = gcoeffs[c].shape
            planes[c][gy0:gy0 + sbh, gx0:gx0 + sbw] = gcoeffs[c]
    for g, qdc in dc_data.items():
        rect = fd.dc_group_rect(g)
        for c in range(3):
            h, v = shifts[c]
            y0, x0 = rect.y0 >> v, rect.x0 >> h
            arr = qdc[c] if not is_444 else qdc[c]
            planes[c][y0:y0 + arr.shape[0], x0:x0 + arr.shape[1], 0] = arr

    # Integer chroma-from-luma reconstruction for 4:4:4 JPEG streams
    # (dec_group.cc:240-258 scaled_qtable + :381-417 fixed-point CfL).
    if is_444 and (ytox_map.any() or ytob_map.any()):
        P = 11  # kCFLFixedPointPrecision
        qjxl = enc0.qraw_table  # (3, 64), jxl transposed layout
        by_, bx_ = planes[1].shape[:2]
        y_plane = planes[1].astype(np.int64)
        for c in (0, 2):
            cmap_vals = ytox_map if c == 0 else ytob_map
            if not cmap_vals.any():
                continue
            # scaled_qtable in the jxl (transposed) layout to match the
            # stored coefficient blocks.
            ratio = ((1 << P) * qjxl[1].astype(np.int64)) // \
                qjxl[c].astype(np.int64)
            # RatioJPEG: C integer division truncates toward zero
            # (kDefaultColorFactor = 84).
            num = cmap_vals.astype(np.int64) * (1 << P)
            scale = np.where(num >= 0, num // 84, -((-num) // 84))
            # per-block tile lookup
            ty = np.arange(by_) // 8
            tx = np.arange(bx_) // 8
            sc = scale[ty[:, None], tx[None, :]]           # (by, bx)
            cs_ = ((ratio[None, None, :] * sc[..., None] +
                    (1 << (P - 1))) >> P)                  # (by,bx,64)
            cfl = ((y_plane * cs_ + (1 << (P - 1))) >> P)
            dc_keep = planes[c][..., 0].copy()   # DC is not CfL-corrected
            planes[c] = (planes[c].astype(np.int64) + cfl).astype(np.int32)
            planes[c][..., 0] = dc_keep

    # Recover the JPEG quant tables from the RAW encoding.
    s = _jxl_from_jpeg_scale().ravel()
    den = enc0.qraw_den
    qtabs = []
    for c in range(3):
        # qraw_table is in the jxl transposed layout; s is symmetric.
        q = np.round(enc0.qraw_table[c].reshape(8, 8).T.ravel()
                     * den * 255.0 / s).astype(np.int32)
        q[0] = int(round(matrices.dc_quant[c] * 255.0 / s[0]))
        qtabs.append(np.maximum(1, q))

    hmax = 1 << max(h for h, _ in shifts)
    vmax = 1 << max(v for _, v in shifts)
    jd = JpegData(width=meta.xsize, height=meta.ysize)
    # JPEG component order Y, Cb, Cr = planes 1, 0, 2.
    plane_order = (1, 0, 2)
    uniq = {}
    for ci, p in enumerate(plane_order):
        key = qtabs[p].tobytes()
        if key not in uniq:
            uniq[key] = len(uniq)
            jd.quant_tables[uniq[key]] = qtabs[p]
        h, v = shifts[p]
        comp = JpegComponent(ci + 1, hmax >> h, vmax >> v, uniq[key])
        # Transpose each 8x8 block back to the JPEG layout.
        pl = planes[p]
        comp.coeffs = (pl.reshape(pl.shape[0], pl.shape[1], 8, 8)
                       .transpose(0, 1, 3, 2)
                       .reshape(pl.shape[0], pl.shape[1], 64))
        jd.components.append(comp)
    return write_jpeg(jd)


def _make_jbrd(data: bytes) -> bytes | None:
    """Spec jbrd payload (Bundle-serialized JPEGData + Brotli blobs,
    lib/jxl/jpeg/enc_jpeg_data.cc) for the original JPEG bytes; None
    when the JPEG uses features outside the reconstructible profile."""
    from libjxl_tpu_torch.extras import jbrd as _jbrd

    try:
        jd = _jbrd.parse_jpeg_full(data)
        return _jbrd.encode_jbrd(jd)
    except _jbrd.JbrdError:
        return None


def transcode_jpeg_container(data: bytes) -> bytes:
    """JPEG -> JXL container with a spec `jbrd` reconstruction box so
    the EXACT original bytes can be regenerated (by this decoder or any
    conformant one, e.g. libjxl djxl)."""
    from libjxl_tpu_torch.container.boxes import pack_container

    codestream = transcode_jpeg(data)
    return pack_container(codestream, jpeg_reconstruction=_make_jbrd(data))


def reconstruct_jpeg(container: bytes) -> bytes:
    """JXL container with a spec `jbrd` box -> byte-exact original
    JPEG (dec_jpeg_data.cc + dec_jpeg_data_writer.cc semantics)."""
    from libjxl_tpu_torch.container.boxes import unpack_container
    from libjxl_tpu_torch.extras import jbrd as _jbrd

    content = unpack_container(container)
    if content.jpeg_reconstruction is None:
        # No reconstruction data: fall back to standard-table output.
        return transcode_jxl_to_jpeg(content.codestream)
    exif = content.exif[4:] if content.exif else None  # strip tiff offset
    xmp = content.xml[0] if content.xml else None
    jd = _jbrd.decode_jbrd(content.jpeg_reconstruction,
                           icc_profile=None, exif=exif, xmp=xmp)

    # Coefficients + quant values come from the VarDCT codestream.
    planes = _extract_planes(content.codestream)   # (Cb, Y, Cr), JPEG layout
    qtabs = _extract_qtabs(content.codestream)     # natural order, per plane
    meta_w, meta_h = _codestream_size(content.codestream)
    shifts = _codestream_shifts(content.codestream)
    jd.width, jd.height = meta_w, meta_h
    max_h = max(h for h, _ in shifts)
    max_v = max(v for _, v in shifts)
    ncomp = len(jd.components)
    plane_for_comp = [1] if ncomp == 1 else [1, 0, 2]
    for ci, comp in enumerate(jd.components):
        p = plane_for_comp[ci]
        h, v = shifts[p]
        comp.h_samp = (1 << max_h) >> h
        comp.v_samp = (1 << max_v) >> v
    hmax, vmax = jd.max_samp()
    mcus_x = -(-jd.width // (8 * hmax))
    mcus_y = -(-jd.height // (8 * vmax))
    for ci, comp in enumerate(jd.components):
        p = plane_for_comp[ci]
        comp.width_in_blocks = mcus_x * comp.h_samp
        comp.height_in_blocks = mcus_y * comp.v_samp
        plane = planes[p]
        cc = np.zeros((comp.height_in_blocks, comp.width_in_blocks, 64),
                      np.int32)
        bh = min(cc.shape[0], plane.shape[0])
        bw = min(cc.shape[1], plane.shape[1])
        cc[:bh, :bw] = plane[:bh, :bw]
        comp.coeffs = cc.reshape(-1, 64)
        jd.quant[comp.quant_idx].values = qtabs[p]
    return _jbrd.write_jpeg_full(jd)


def _codestream_size(codestream: bytes):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    meta = read_codestream_headers(BitReader(codestream))
    return meta.xsize, meta.ysize


def _codestream_shifts(codestream: bytes):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.bitstream.fields import bundle_read
    from libjxl_tpu_torch.frame.frame_header import FrameHeader
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    r = BitReader(codestream)
    meta = read_codestream_headers(r)
    fh = FrameHeader(nonserialized_metadata=meta)
    bundle_read(r, fh)
    cs = fh.chroma_subsampling
    return [(cs.hshift(c), cs.vshift(c)) for c in range(3)]


def _extract_qtabs(codestream: bytes) -> list:
    """Natural-order JPEG quant tables per plane (Cb, Y, Cr)."""
    jpeg = transcode_jxl_to_jpeg(codestream)
    from libjxl_tpu_torch.extras.jpeg_parser import parse_jpeg
    jd = parse_jpeg(jpeg)
    return [np.asarray(jd.quant_tables[c.quant_idx], np.int32)
            for c in ([jd.components[1], jd.components[0],
                       jd.components[2]] if len(jd.components) == 3
                      else [jd.components[0]] * 3)]


def _extract_planes(codestream: bytes) -> list:
    """Quantized coefficient planes (Cb, Y, Cr) from a JPEG-transcoded
    JXL codestream (shared core of transcode_jxl_to_jpeg)."""
    import io as _io
    # Reuse transcode_jxl_to_jpeg's plumbing by parsing to JpegData.
    jpeg = transcode_jxl_to_jpeg(codestream)
    jd = parse_jpeg(jpeg)
    if len(jd.components) == 3:
        return [jd.components[1].coeffs[..., :],
                jd.components[0].coeffs[..., :],
                jd.components[2].coeffs[..., :]]
    c = jd.components[0].coeffs
    return [np.zeros_like(c), c, np.zeros_like(c)]
