"""Incremental (section-granular) frame decoding with partial flush.

Mirrors lib/jxl/dec_frame.cc FrameDecoder::ProcessSections/Flush: input
may arrive byte-by-byte; every section (LfGlobal, DC groups, ACGlobal,
AC group x pass) is decoded exactly once, as soon as its bytes are
complete — O(n) total work for n input bytes. ``flush()`` renders the
best partial image from the passes received so far (groups with no AC
yet render from DC/LLF, like dec_frame.cc:735-780 force_draw).

Covers VarDCT regular frames without chroma subsampling (the
progressive profile); other frame types fall back to the one-shot
decoder in the API layer.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.base.errors import JxlError
from libjxl_tpu_torch.base.rect import Rect
from libjxl_tpu_torch.bitstream.bit_io import BitReader
from libjxl_tpu_torch.bitstream.fields import bundle_read
from libjxl_tpu_torch.bitstream.toc import num_toc_entries, read_toc
from libjxl_tpu_torch.frame.frame_header import (
    FrameEncoding, FrameFlags, FrameHeader, FrameType,
)
from libjxl_tpu_torch.frame.modular_frame import (
    ModularFrameDecoder, stream_modular_ac, stream_modular_dc,
)
from libjxl_tpu_torch.vardct.ac_context import BlockCtxMap
from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
from libjxl_tpu_torch.vardct.coeff_order import (
    decode_coeff_orders, read_used_orders,
)
from libjxl_tpu_torch.vardct.group import CoeffBlock
from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices
from libjxl_tpu_torch.vardct.quantizer import Quantizer
from libjxl_tpu_torch.vardct.reconstruct import (
    b_qm_multiplier, reconstruct_group, x_qm_multiplier,
)


class NotSupported(Exception):
    """Frame outside the incremental profile; use the one-shot path."""


class IncrementalFrameDecoder:
    def __init__(self, metadata):
        self.meta = metadata
        self.fh: FrameHeader | None = None
        self.fd = None
        self._inited = False
        self._done_sections: set = set()
        self._lf_done = False
        self._acglobal_done = False
        self._dc_data: dict = {}
        self._ac_meta: dict = {}
        self._group_blocks: list = []
        self._group_pass_done: set = set()
        self._maps_ready = False
        # Saved reference frames for patches (callers that track them —
        # the streaming Decoder — install theirs; dec_frame.cc
        # reference_frames_).
        self.reference_frames: list = [None] * 4

    # -- header + TOC ----------------------------------------------------

    def init(self, codestream: bytes, start_bit: int) -> bool:
        """Parse FrameHeader + TOC once enough bytes are available.
        Returns True when initialized."""
        if self._inited:
            return True
        try:
            r = BitReader(codestream)
            r.seek_bits(start_bit)
            fh = FrameHeader(nonserialized_metadata=self.meta)
            bundle_read(r, fh)
            fd = fh.to_frame_dimensions()
            entries = num_toc_entries(fd.num_groups, fd.num_dc_groups,
                                      fh.passes.num_passes)
            sizes, offsets = read_toc(entries, r)
            r.align_to_byte()
        except JxlError:
            return False
        if fh.frame_type not in (FrameType.REGULAR,
                                 FrameType.REFERENCE_ONLY):
            raise NotSupported("frame type outside incremental profile")
        self._modular = fh.encoding == FrameEncoding.MODULAR
        if self._modular:
            # Modular profile: plain (non-XYB) frames, no upsampling —
            # section-at-a-time decode with O(n) accounting; transforms
            # invert at finalize.
            from libjxl_tpu_torch.frame.frame_header import ColorTransform
            if fh.color_transform != ColorTransform.NONE \
                    or fh.upsampling != 1:
                raise NotSupported("modular frame outside profile")
        elif fh.encoding != FrameEncoding.VARDCT \
                or not fh.chroma_subsampling.is_444() \
                or (fh.flags & FrameFlags.USE_DC_FRAME):
            raise NotSupported("frame outside incremental profile")
        self.fh, self.fd = fh, fd
        self._single = entries == 1
        base = r.bits_consumed // 8
        self._base = base
        self._ranges = [(base + o, base + o + s)
                        for o, s in zip(offsets, sizes)]
        self._frame_end = max(e for _, e in self._ranges) if sizes else base
        self._group_blocks = [None] * fd.num_groups
        self._inited = True
        return True

    @property
    def frame_end_byte(self) -> int:
        return self._frame_end

    def _section(self, codestream: bytes, idx: int) -> BitReader:
        s, e = self._ranges[idx]
        return BitReader(codestream[s:e])

    def _have(self, avail: int, idx: int) -> bool:
        return avail >= self._ranges[idx][1]

    # -- section decoding --------------------------------------------------

    def _decode_lf_global(self, r: BitReader) -> None:
        meta, fh, fd = self.meta, self.fh, self.fd
        self.patch_dict = None
        if fh.flags & FrameFlags.PATCHES:
            from libjxl_tpu_torch.frame.patches import decode_patches
            self.patch_dict = decode_patches(
                r, fd.xsize_padded, fd.ysize_padded,
                meta.m.num_extra_channels, self.reference_frames)
        self.splines = None
        if fh.flags & FrameFlags.SPLINES:
            from libjxl_tpu_torch.frame.splines import decode_splines
            self.splines = decode_splines(r, fd.xsize * fd.ysize)
        self.noise_lut = None
        if fh.flags & FrameFlags.NOISE:
            from libjxl_tpu_torch.frame.noise import decode_noise
            self.noise_lut = decode_noise(r)
        self.matrices = DequantMatrices()
        self.matrices.decode_dc(r)
        self.quantizer = Quantizer(self.matrices)
        self.ctx_map = BlockCtxMap()
        self.cmap = ColorCorrelation()
        if not self._modular:
            self.quantizer.decode(r)
            self.ctx_map.decode(r)
            self.cmap.decode_dc(r)
        self.mfd = ModularFrameDecoder(self.fd)
        self.mfd.decode_global_info(r, fh, meta)
        self._lf_done = True

    def _decode_dc_group(self, r: BitReader, g: int) -> None:
        fd, meta = self.fd, self.meta
        if self._modular:
            rect = fd.dc_group_rect(g)
            mrect = Rect(rect.x0 * 8, rect.y0 * 8, fd.dc_group_dim,
                         fd.dc_group_dim)
            self.mfd.decode_group(mrect, r, 3, 1000,
                                  stream_modular_dc(g, fd))
            self._dc_data[g] = True
            return
        qdc, extra_precision = self.mfd.decode_vardct_dc(
            g, r, meta.m.bit_depth.bits_per_sample, shifts=None)
        self._dc_data[g] = (qdc, extra_precision)
        rect = fd.dc_group_rect(g)
        mrect = Rect(rect.x0 * 8, rect.y0 * 8, fd.dc_group_dim,
                     fd.dc_group_dim)
        self.mfd.decode_group(mrect, r, 3, 1000, stream_modular_dc(g, fd))
        self._ac_meta[g] = self.mfd.decode_ac_metadata(
            g, r, meta.m.bit_depth.bits_per_sample)

    def _assemble_maps(self) -> None:
        fh, fd = self.fh, self.fd
        mul_dc = self.quantizer.mul_dc()
        cfl_fac = self.cmap.dc_factors()
        dc_full = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks),
                           np.float32)
        for g, (qdc, extra_precision) in self._dc_data.items():
            rect = fd.dc_group_rect(g)
            mul = 1.0 / (1 << extra_precision)
            y = qdc[1] * (mul_dc[1] * mul)
            x = qdc[0] * (mul_dc[0] * mul) + cfl_fac[0] * y
            b = qdc[2] * (mul_dc[2] * mul) + cfl_fac[2] * y
            sl = rect.slices()
            dc_full[0][sl] = x
            dc_full[1][sl] = y
            dc_full[2][sl] = b
        if not (fh.flags & FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING):
            from libjxl_tpu_torch.vardct.dc_smoothing import adaptive_dc_smoothing
            dc_full = adaptive_dc_smoothing(dc_full, mul_dc)
        self.dc_full = dc_full

        BH, BW = fd.ysize_blocks, fd.xsize_blocks
        self.strategies = np.full((BH, BW), -1, np.int32)
        self.raw_quant = np.ones((BH, BW), np.int32)
        self.sharpness = np.zeros((BH, BW), np.int32)
        tiles_x, tiles_y = (BW + 7) // 8, (BH + 7) // 8
        self.ytox_map = np.zeros((tiles_y, tiles_x), np.int32)
        self.ytob_map = np.zeros((tiles_y, tiles_x), np.int32)
        self.used_acs = 0
        for g, m in self._ac_meta.items():
            rect = fd.dc_group_rect(g)
            sl = rect.slices()
            self.strategies[sl] = m["strategies"]
            self.raw_quant[sl] = m["raw_quant"]
            self.sharpness[sl] = m["epf"]
            cr = Rect(rect.x0 >> 3, rect.y0 >> 3, (rect.xsize + 7) >> 3,
                      (rect.ysize + 7) >> 3)
            self.ytox_map[cr.slices()] = m["ytox"]
            self.ytob_map[cr.slices()] = m["ytob"]
            for s in np.unique(m["strategies"]):
                if s >= 0:
                    self.used_acs |= 1 << int(s)
        self._maps_ready = True

    def _decode_ac_global(self, r: BitReader) -> None:
        fh, fd = self.fh, self.fd
        if self._modular:
            self._acglobal_done = True
            return
        if not self._maps_ready:
            self._assemble_maps()
        self.matrices.decode(r, self.mfd)
        num_histo_bits = max((fd.num_groups - 1).bit_length(), 0) \
            if fd.num_groups > 1 else 0
        self.num_histograms = 1 + (r.read(num_histo_bits)
                                   if num_histo_bits else 0)
        from libjxl_tpu_torch.entropy.codes import decode_histograms
        num_contexts = self.num_histograms * self.ctx_map.num_ac_contexts()
        self.pass_orders, self.pass_codes = [], []
        for _p in range(fh.passes.num_passes):
            used_orders = read_used_orders(r)
            self.pass_orders.append(
                decode_coeff_orders(used_orders, self.used_acs, r))
            self.pass_codes.append(decode_histograms(r, num_contexts))
        self._acglobal_done = True

    def _decode_ac_group(self, r: BitReader, p: int, g: int) -> None:
        if self._modular:
            fh, fd = self.fh, self.fd
            min_s, max_s = fh.passes.downsampling_bracket(p)
            mrect = fd.group_rect(g)
            prect = Rect(mrect.x0, mrect.y0, fd.group_dim, fd.group_dim)
            self.mfd.decode_group(prect, r, min_s, max_s,
                                  stream_modular_ac(g, p, fd))
            self._group_pass_done.add((p, g))
            return
        from libjxl_tpu_torch.base.errors import BitstreamError
        from libjxl_tpu_torch.entropy.codes import SymbolReader
        from libjxl_tpu_torch.vardct.group import decode_group_coeffs
        from libjxl_tpu_torch.vardct.group_native import (
            native_decode_group, prepare_blocks)
        fh, fd = self.fh, self.fd
        shift = fh.passes.shift[p]
        min_s, max_s = fh.passes.downsampling_bracket(p)
        brect = fd.block_group_rect(g)
        histo_bits = (self.num_histograms - 1).bit_length() \
            if self.num_histograms > 1 else 0
        cur = r.read(histo_bits) if histo_bits else 0
        if cur >= self.num_histograms:
            raise BitstreamError("invalid histogram selector")
        ctx_offset = cur * self.ctx_map.num_ac_contexts()
        sl = brect.slices()
        prep = prepare_blocks(self.strategies[sl], self.raw_quant[sl],
                              self.ctx_map, self.pass_orders[p])
        native = native_decode_group(r.raw_data, r.bits_consumed,
                                     self.pass_codes[p], brect.xsize,
                                     brect.ysize, prep, self.ctx_map,
                                     ctx_offset)
        if native is not None:
            blocks, new_pos = native
            r.seek_bits(new_pos)
        else:
            reader = SymbolReader(self.pass_codes[p], r)
            blocks = decode_group_coeffs(
                reader, brect.xsize, brect.ysize, self.strategies[sl],
                self.raw_quant[sl], self.pass_orders[p], self.ctx_map,
                ctx_offset)
            if not reader.check_final_state():
                raise BitstreamError("bad ANS state in AC group")
        mrect = fd.group_rect(g)
        prect = Rect(mrect.x0, mrect.y0, fd.group_dim, fd.group_dim)
        self.mfd.decode_group(prect, r, min_s, max_s,
                              stream_modular_ac(g, p, fd))
        if self._group_blocks[g] is None:
            if shift:
                for blk in blocks:
                    np.left_shift(blk.coeffs, shift, out=blk.coeffs)
            self._group_blocks[g] = blocks
        else:
            for acc, blk in zip(self._group_blocks[g], blocks):
                acc.coeffs += blk.coeffs << shift
        self._group_pass_done.add((p, g))

    # -- the driver ---------------------------------------------------------

    def process_available(self, codestream: bytes) -> int:
        """Decode every not-yet-decoded section whose bytes are complete.
        Returns the number of sections newly decoded."""
        if not self._inited:
            return 0
        fd, fh = self.fd, self.fh
        avail = len(codestream)
        if self._single:
            # One-section frame: all-or-nothing.
            if 0 in self._done_sections or not self._have(avail, 0):
                return 0
            r = self._section(codestream, 0)
            self._decode_lf_global(r)
            for g in range(fd.num_dc_groups):
                self._decode_dc_group(r, g)
            self._decode_ac_global(r)
            for p in range(fh.passes.num_passes):
                for g in range(fd.num_groups):
                    self._decode_ac_group(r, p, g)
            self._done_sections.add(0)
            return 1
        new = 0
        if not self._lf_done:
            if not self._have(avail, 0):
                return new
            self._decode_lf_global(self._section(codestream, 0))
            self._done_sections.add(0)
            new += 1
        for g in range(fd.num_dc_groups):
            idx = 1 + g
            if idx in self._done_sections:
                continue
            if self._have(avail, idx):
                self._decode_dc_group(self._section(codestream, idx), g)
                self._done_sections.add(idx)
                new += 1
        if len(self._dc_data) < fd.num_dc_groups:
            return new
        acg_idx = 1 + fd.num_dc_groups
        if not self._acglobal_done:
            if not self._have(avail, acg_idx):
                return new
            self._decode_ac_global(self._section(codestream, acg_idx))
            self._done_sections.add(acg_idx)
            new += 1
        for p in range(fh.passes.num_passes):
            for g in range(fd.num_groups):
                idx = acg_idx + 1 + p * fd.num_groups + g
                if idx in self._done_sections:
                    continue
                # Passes accumulate in order per group.
                if p > 0 and (p - 1, g) not in self._group_pass_done:
                    continue
                if self._have(avail, idx):
                    self._decode_ac_group(
                        self._section(codestream, idx), p, g)
                    self._done_sections.add(idx)
                    new += 1
        return new

    @property
    def complete(self) -> bool:
        if not self._inited:
            return False
        if self._single:
            return 0 in self._done_sections
        total = 2 + self.fd.num_dc_groups \
            + self.fh.passes.num_passes * self.fd.num_groups
        return len(self._done_sections) == total

    @property
    def can_flush(self) -> bool:
        return self._acglobal_done and not self._modular

    @property
    def is_modular(self) -> bool:
        return self._modular

    def finalize_modular(self) -> list:
        """Channels of a completed modular frame (transform inverses
        run here, mirroring ModularFrameDecoder.finalize)."""
        assert self.complete and self._modular
        gi = self.mfd.finalize()
        return [c.data for c in gi.channel]

    def num_passes_done(self, g: int) -> int:
        return sum(1 for (p, gg) in self._group_pass_done if gg == g)

    def _render(self, force: bool) -> np.ndarray:
        """Render from the sections decoded so far (dec_frame.cc Flush:
        groups without AC draw from DC/LLF)."""
        fh, fd = self.fh, self.fd
        x_mul = 1.0 / x_qm_multiplier(fh.x_qm_scale)
        b_mul = 1.0 / b_qm_multiplier(fh.b_qm_scale)
        out = np.zeros((3, fd.ysize_padded, fd.xsize_padded), np.float32)
        if self._render_native(out, force, x_mul, b_mul):
            pass
        else:
            self._render_groups(out, force, x_mul, b_mul)
        lfp = fh.loop_filter
        if lfp.gab or lfp.epf_iters > 0:
            from libjxl_tpu_torch.pipeline.loop_filters import apply_loop_filters
            filtered = apply_loop_filters(
                np.ascontiguousarray(out[:, :fd.ysize, :fd.xsize]), lfp,
                self.raw_quant, self.strategies, self.quantizer, fd,
                sharpness=self.sharpness)
            out[:, :fd.ysize, :fd.xsize] = filtered
        # Upsampling precedes patches/splines/noise (dec_cache.cc stage
        # order: EPF -> upsampling -> patches -> splines -> noise).
        if fh.upsampling != 1:
            from libjxl_tpu_torch.pipeline.upsample import upsample_image
            out = upsample_image(out[:, :fd.ysize, :fd.xsize],
                                 fh.upsampling)
        if self.patch_dict is not None:
            from libjxl_tpu_torch.frame.patches import apply_patches
            apply_patches(self.patch_dict, out, None,
                          self.reference_frames)
        if self.splines is not None:
            from libjxl_tpu_torch.frame.splines import render_splines
            render_splines(self.splines, out, self.cmap)
        if self.noise_lut is not None:
            from libjxl_tpu_torch.frame.noise import add_noise
            out = add_noise(out, self.noise_lut, self.cmap, fd)
        return out[:, :fd.ysize_upsampled, :fd.xsize_upsampled]

    def _render_native(self, out, force, x_mul, b_mul) -> bool:
        """Whole-frame native reconstruction from a dense coefficient
        frame scattered from the per-group block lists — the SAME fused
        kernel the one-shot decoder uses, so incremental output stays
        bit-identical to decode() regardless of section arrival order."""
        from libjxl_tpu_torch.vardct.group_native import scatter_blocks_to_frame
        from libjxl_tpu_torch.vardct.reconstruct import native_reconstruct_frame
        fd = self.fd
        coeff = np.zeros(
            (3, fd.ysize_blocks * 8, fd.xsize_blocks * 8), np.int32)
        mat_ids = np.zeros((fd.ysize_blocks, fd.xsize_blocks), np.int8)
        for g in range(fd.num_groups):
            blocks = self._group_blocks[g]
            brect = fd.block_group_rect(g)
            if blocks is None:
                if not force:
                    return False  # partial without force: old loop
                continue  # zero coefficients = DC/LLF-only render
            scatter_blocks_to_frame(blocks, coeff, mat_ids,
                                    brect.y0, brect.x0, 0)
        return native_reconstruct_frame(
            coeff, self.strategies, self.raw_quant, self.dc_full,
            self.quantizer, self.cmap, self.ytox_map, self.ytob_map,
            x_mul, b_mul, out)

    def _render_groups(self, out, force, x_mul, b_mul) -> None:
        fh, fd = self.fh, self.fd
        for g in range(fd.num_groups):
            brect = fd.block_group_rect(g)
            sl = brect.slices()
            blocks = self._group_blocks[g]
            if blocks is None:
                if not force:
                    continue
                # force_draw: zero-AC blocks render DC/LLF only.
                blocks = []
                strat = self.strategies[sl]
                from libjxl_tpu_torch.vardct import ac_strategy as acs
                for by in range(brect.ysize):
                    for bx in range(brect.xsize):
                        s = int(strat[by, bx])
                        if s < 0:
                            continue
                        cx, cy = acs.covered_blocks(s)
                        blocks.append(CoeffBlock(
                            bx=bx, by=by, strategy=s,
                            coeffs=np.zeros((3, cx * cy * 64), np.int32)))
            pix = reconstruct_group(
                blocks, brect.xsize, brect.ysize, self.quantizer,
                self.raw_quant[sl],
                self.dc_full[:, brect.y0:brect.y1, brect.x0:brect.x1],
                self.cmap, self.ytox_map, self.ytob_map, brect.x0,
                brect.y0, x_mul, b_mul)
            out[:, brect.y0 * 8:brect.y0 * 8 + brect.ysize * 8,
                brect.x0 * 8:brect.x0 * 8 + brect.xsize * 8] = pix

    def flush(self) -> np.ndarray | None:
        """Partial image from the passes received so far, or None when
        DC/ACGlobal haven't arrived yet (decode.h JxlDecoderFlushImage)."""
        if not self.can_flush:
            return None
        return self._render(force=True)

    def finalize(self) -> np.ndarray:
        assert self.complete
        return self._render(force=False)
