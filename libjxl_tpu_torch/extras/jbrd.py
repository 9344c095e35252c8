"""Spec-compliant JPEG reconstruction data (`jbrd` box) codec.

Implements the JPEG XL JPEG-bitstream-reconstruction format used by
libjxl: a Bundle-serialized ``JPEGData`` structure followed by a
Brotli-compressed stream carrying the raw APP/COM/inter-marker/tail
bytes.

Reference:
  lib/jxl/jpeg/jpeg_data.{h,cc}   (JPEGData::VisitFields bit layout)
  lib/jxl/jpeg/enc_jpeg_data_reader.cc (lossless JPEG parse incl.
      padding bits, reset points, extra zero runs)
  lib/jxl/jpeg/dec_jpeg_data_writer.cc (marker-order-driven bit-exact
      JPEG re-serialization)
  lib/jxl/jpeg/enc_jpeg_data.cc / dec_jpeg_data.cc (Brotli framing)

Scope: sequential (baseline) and progressive JPEGs, 8-bit precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjxl_tpu_torch.base.errors import BitstreamError
from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
from libjxl_tpu_torch.bitstream.fields import (
    Bits, BitsOffset, U32Enc, Val, read_u32, write_u32)

KJPEG_NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int32)

APP_UNKNOWN = 0
APP_ICC = 1
APP_EXIF = 2
APP_XMP = 3

_ICC_TAG = b"ICC_PROFILE\x00"
_EXIF_TAG = b"Exif\x00\x00"
_XMP_TAG = b"http://ns.adobe.com/xap/1.0/\x00"


class JbrdError(BitstreamError):
    pass


@dataclasses.dataclass
class SpecQuantTable:
    values: np.ndarray          # 64 int32, natural (row-major) order
    precision: int = 0          # 0 = 8-bit, 1 = 16-bit
    index: int = 0              # Tq field from the DQT marker
    is_last: bool = True        # last table within its DQT segment


@dataclasses.dataclass
class SpecHuffmanCode:
    counts: list                # 17 entries; sentinel +1 at max length
    values: list                # symbols, ending with 256 sentinel
    slot_id: int = 0            # (is_ac << 4) | id
    is_last: bool = True


@dataclasses.dataclass
class SpecScanComponent:
    comp_idx: int = 0
    dc_tbl_idx: int = 0
    ac_tbl_idx: int = 0


@dataclasses.dataclass
class SpecScanInfo:
    Ss: int = 0
    Se: int = 63
    Ah: int = 0
    Al: int = 0
    components: list = dataclasses.field(default_factory=list)
    last_needed_pass: int = 0
    reset_points: list = dataclasses.field(default_factory=list)
    extra_zero_runs: list = dataclasses.field(
        default_factory=list)      # [(block_idx, num_runs)]

    @property
    def num_components(self) -> int:
        return len(self.components)


@dataclasses.dataclass
class SpecComponent:
    id: int = 1
    h_samp: int = 1
    v_samp: int = 1
    quant_idx: int = 0          # position in the quant LIST
    width_in_blocks: int = 0
    height_in_blocks: int = 0
    coeffs: np.ndarray | None = None    # (h*w, 64) int32, natural order


@dataclasses.dataclass
class SpecJPEGData:
    width: int = 0
    height: int = 0
    marker_order: list = dataclasses.field(default_factory=list)
    app_data: list = dataclasses.field(default_factory=list)
    app_marker_type: list = dataclasses.field(default_factory=list)
    com_data: list = dataclasses.field(default_factory=list)
    quant: list = dataclasses.field(default_factory=list)
    components: list = dataclasses.field(default_factory=list)
    huffman_code: list = dataclasses.field(default_factory=list)
    scan_info: list = dataclasses.field(default_factory=list)
    restart_interval: int = 0
    inter_marker_data: list = dataclasses.field(default_factory=list)
    tail_data: bytes = b""
    padding_bits: list = dataclasses.field(default_factory=list)
    has_zero_padding_bit: bool = False

    def max_samp(self):
        hmax = max(c.h_samp for c in self.components)
        vmax = max(c.v_samp for c in self.components)
        return hmax, vmax

    def calculate_mcu_size(self, scan: SpecScanInfo):
        """jpeg_data.cc CalculateMcuSize."""
        interleaved = scan.num_components > 1
        base = self.components[scan.components[0].comp_idx]
        h_group = 1 if interleaved else base.h_samp
        v_group = 1 if interleaved else base.v_samp
        hmax, vmax = self.max_samp()
        mcus_per_row = -(-(self.width * h_group) // (8 * hmax))
        mcu_rows = -(-(self.height * v_group) // (8 * vmax))
        return mcus_per_row, mcu_rows


# ---------------------------------------------------------------------------
# Lossless JPEG parse (enc_jpeg_data_reader.cc)

class _BitReaderState:
    """MSB-first entropy reader with 0xFF00 unstuffing, padding-bit
    capture and byte give-back (enc_jpeg_data_reader.cc BitReaderState)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.len = len(data)
        self.reset(pos)

    def reset(self, pos: int):
        self.pos = pos
        self.val = 0
        self.bits_left = 0
        self.next_marker_pos = self.len

    def _next_byte(self) -> int:
        # Mirrors BitReaderState::GetNextByte: 0xFF00 unstuffing; any
        # 0xFF followed by a nonzero byte marks the end of the scan.
        if self.pos >= self.next_marker_pos:
            self.pos += 1
            return 0
        c = self.data[self.pos] if self.pos < self.len else 0
        self.pos += 1
        if c == 0xFF:
            escape = self.data[self.pos] if self.pos < self.len else 1
            if escape == 0:
                self.pos += 1
            else:
                self.next_marker_pos = self.pos - 1
        return c

    def _fill(self):
        if self.bits_left <= 16:
            while self.bits_left <= 56:
                self.val = ((self.val << 8) | self._next_byte()) \
                    & 0xFFFFFFFFFFFFFFFF
                self.bits_left += 8

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.val >> (self.bits_left - n)) & ((1 << n) - 1)
        self.bits_left -= n
        return v

    def read_symbol(self, lut) -> int:
        """Huffman symbol via (length, code) dict."""
        self._fill()
        acc = 0
        for length in range(1, 17):
            acc = (acc << 1) | ((self.val >> (self.bits_left - 1)) & 1)
            self.bits_left -= 1
            sym = lut.get((length, acc))
            if sym is not None:
                return sym
        raise JbrdError("invalid JPEG Huffman code")

    def finish_stream(self, jd: SpecJPEGData) -> int:
        """Record padding bits and give back unused bytes; returns the
        stream position where parsing continues."""
        npad = self.bits_left & 7
        if npad > 0:
            padmask = (1 << npad) - 1
            padbits = (self.val >> (self.bits_left - npad)) & padmask
            if padbits != padmask:
                jd.has_zero_padding_bit = True
            for i in range(npad - 1, -1, -1):
                jd.padding_bits.append((padbits >> i) & 1)
        unused = self.bits_left >> 3
        pos = self.pos
        while unused > 0:
            pos -= 1
            if pos < self.next_marker_pos and self.data[pos] == 0 \
                    and self.data[pos - 1] == 0xFF:
                pos -= 1
            unused -= 1
        if pos > self.next_marker_pos:
            raise JbrdError("unexpected end of scan")
        return pos


def _build_lut(counts, values):
    """Canonical JPEG Huffman (length, code) -> symbol mapping."""
    lut = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length]):
            lut[(length, code)] = values[k]
            k += 1
            code += 1
        code <<= 1
    return lut


def _huff_extend(x: int, s: int) -> int:
    half = 1 << (s - 1)
    return x if x >= half else x - (1 << s) + 1


def parse_jpeg_full(data: bytes) -> SpecJPEGData:
    """Parses a JPEG into the complete SpecJPEGData needed for
    bit-exact reconstruction (enc_jpeg_data_reader.cc ReadJpeg)."""
    if data[:2] != b"\xff\xd8":
        raise JbrdError("not a JPEG (missing SOI)")
    jd = SpecJPEGData()
    pos = 2
    dc_luts: dict = {}
    ac_luts: dict = {}
    is_progressive = False
    found_sof = False
    seen_dri = False

    def seg_at(p):
        if p + 4 > len(data):
            raise JbrdError("truncated segment")
        seglen = (data[p] << 8) | data[p + 1]
        if p + seglen > len(data):
            raise JbrdError("truncated segment")
        return data[p + 2:p + seglen], p + seglen

    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise JbrdError("inter-marker data not supported")
        marker = data[pos + 1]
        if marker == 0x00 or 0xD0 <= marker <= 0xD7:
            raise JbrdError("unexpected stuffing/restart at marker level")
        jd.marker_order.append(marker)
        pos += 2
        if marker == 0xD9:  # EOI
            jd.tail_data = bytes(data[pos:])
            break
        if 0xE0 <= marker <= 0xEF:      # APPn
            seg, nxt = seg_at(pos)
            blob = bytes([marker]) + data[pos:nxt]
            jd.app_data.append(blob)
            jd.app_marker_type.append(APP_UNKNOWN)
            pos = nxt
        elif marker == 0xFE:            # COM
            seg, nxt = seg_at(pos)
            jd.com_data.append(bytes([marker]) + data[pos:nxt])
            pos = nxt
        elif marker == 0xDB:            # DQT
            seg, nxt = seg_at(pos)
            p = 0
            entries = []
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq > 1:
                    raise JbrdError("bad DQT precision")
                p += 1
                n = 64 * (2 if pq else 1)
                raw = seg[p:p + n]
                vals_zz = (np.frombuffer(raw, ">u2") if pq
                           else np.frombuffer(raw, np.uint8)
                           ).astype(np.int32)
                table = np.zeros(64, np.int32)
                table[KJPEG_NATURAL_ORDER] = vals_zz
                entries.append(SpecQuantTable(values=table, precision=pq,
                                              index=tq, is_last=False))
                p += n
            if not entries:
                raise JbrdError("empty DQT")
            entries[-1].is_last = True
            jd.quant.extend(entries)
            pos = nxt
        elif marker in (0xC0, 0xC1, 0xC2):   # SOF0/1/2
            is_progressive = marker == 0xC2
            found_sof = True
            seg, nxt = seg_at(pos)
            if seg[0] != 8:
                raise JbrdError("only 8-bit JPEGs supported")
            jd.height = (seg[1] << 8) | seg[2]
            jd.width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                qpos = next((k for k, q in enumerate(jd.quant)
                             if q.index == tq), None)
                if qpos is None:
                    raise JbrdError("component references missing DQT")
                jd.components.append(SpecComponent(
                    id=cid, h_samp=hv >> 4, v_samp=hv & 15, quant_idx=qpos))
            hmax, vmax = jd.max_samp()
            mcus_x = -(-jd.width // (8 * hmax))
            mcus_y = -(-jd.height // (8 * vmax))
            for c in jd.components:
                c.width_in_blocks = mcus_x * c.h_samp
                c.height_in_blocks = mcus_y * c.v_samp
                c.coeffs = np.zeros(
                    (c.width_in_blocks * c.height_in_blocks, 64), np.int32)
            pos = nxt
        elif marker == 0xC4:            # DHT
            seg, nxt = seg_at(pos)
            p = 0
            entries = []
            while p < len(seg):
                slot = seg[p]
                counts = [0] + list(seg[p + 1:p + 17])
                total = sum(counts)
                values = list(seg[p + 17:p + 17 + total])
                p += 17 + total
                # Append the EOI sentinel (jpeg_data.h: counts get +1 at
                # the max length; values end with 256).
                max_len = max((i for i in range(17) if counts[i]), default=0)
                counts2 = list(counts)
                if total > 0:
                    counts2[max_len] += 1
                hc = SpecHuffmanCode(counts=counts2, values=values + [256],
                                     slot_id=slot, is_last=False)
                entries.append(hc)
                lut = _build_lut(counts, values)
                if slot & 0x10:
                    ac_luts[slot & 0xF] = lut
                else:
                    dc_luts[slot & 0xF] = lut
            if not entries:
                raise JbrdError("empty DHT")
            entries[-1].is_last = True
            jd.huffman_code.extend(entries)
            pos = nxt
        elif marker == 0xDD:            # DRI
            seg, nxt = seg_at(pos)
            jd.restart_interval = (seg[0] << 8) | seg[1]
            seen_dri = True
            pos = nxt
        elif marker == 0xDA:            # SOS
            if not found_sof:
                raise JbrdError("SOS before SOF")
            seg, nxt = seg_at(pos)
            ns = seg[0]
            scan = SpecScanInfo()
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next(k for k, c in enumerate(jd.components)
                          if c.id == cid)
                scan.components.append(SpecScanComponent(
                    comp_idx=ci, dc_tbl_idx=tt >> 4, ac_tbl_idx=tt & 15))
            scan.Ss = seg[1 + 2 * ns]
            scan.Se = seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            scan.Ah, scan.Al = ahal >> 4, ahal & 15
            if not is_progressive:
                scan.Ss, scan.Se, scan.Ah, scan.Al = 0, 63, 0, 0
            jd.scan_info.append(scan)
            pos = _parse_scan(data, nxt, jd, scan, dc_luts, ac_luts,
                              is_progressive,
                              jd.restart_interval if seen_dri else 0)
        else:
            raise JbrdError(f"unsupported marker 0x{marker:02x}")
    else:
        raise JbrdError("missing EOI")
    if not jd.scan_info:
        raise JbrdError("no scans")
    return jd


def _parse_scan(data, pos, jd, scan, dc_luts, ac_luts, progressive,
                restart_interval) -> int:
    """Entropy-decode one scan, recording reset points / extra zero runs
    / padding bits (enc_jpeg_data_reader.cc ProcessScan)."""
    br = _BitReaderState(data, pos)
    mcus_per_row, mcu_rows = jd.calculate_mcu_size(scan)
    interleaved = scan.num_components > 1
    Ss, Se, Ah, Al = scan.Ss, scan.Se, scan.Ah, scan.Al
    if not progressive:
        Ss, Se, Ah, Al = 0, 63, 0, 0
    eobrun = 0
    last_dc = [0] * len(jd.components)
    restarts_to_go = restart_interval
    next_restart = 0
    block_scan_index = 0
    for mcu_y in range(mcu_rows):
        for mcu_x in range(mcus_per_row):
            if restart_interval > 0 and restarts_to_go == 0:
                if eobrun > 0:
                    raise JbrdError("end-of-block run across restart")
                p = br.finish_stream(jd)
                if p + 2 > len(data) or data[p] != 0xFF or \
                        data[p + 1] != 0xD0 + next_restart:
                    raise JbrdError("missing restart marker")
                br.reset(p + 2)
                next_restart = (next_restart + 1) & 7
                restarts_to_go = restart_interval
                last_dc = [0] * len(jd.components)
            for si in scan.components:
                c = jd.components[si.comp_idx]
                nby = c.v_samp if interleaved else 1
                nbx = c.h_samp if interleaved else 1
                for iy in range(nby):
                    for ix in range(nbx):
                        by = mcu_y * nby + iy
                        bx = mcu_x * nbx + ix
                        bidx = by * c.width_in_blocks + bx
                        coeffs = c.coeffs[bidx]
                        reset_state = False
                        nzr = 0
                        if Ah == 0:
                            eobrun, reset_state, nzr = _decode_dct_block(
                                br, dc_luts.get(si.dc_tbl_idx),
                                ac_luts.get(si.ac_tbl_idx), Ss, Se, Al,
                                eobrun, last_dc, si.comp_idx, coeffs)
                        else:
                            eobrun, reset_state = _refine_dct_block(
                                br, ac_luts.get(si.ac_tbl_idx),
                                Ss, Se, Al, eobrun, coeffs)
                        if reset_state:
                            scan.reset_points.append(block_scan_index)
                        if nzr > 0:
                            scan.extra_zero_runs.append(
                                (block_scan_index, nzr))
                        block_scan_index += 1
            restarts_to_go -= 1
    if eobrun > 0:
        raise JbrdError("end-of-block run too long")
    return br.finish_stream(jd)


def _decode_dct_block(br, dc_lut, ac_lut, Ss, Se, Al, eobrun, last_dc,
                      comp_idx, coeffs):
    Am = 1 << Al
    eobrun_allowed = Ss > 0
    reset_state = False
    if Ss == 0:
        s = br.read_symbol(dc_lut)
        if s >= 12:
            raise JbrdError("invalid DC symbol")
        diff = _huff_extend(br.read_bits(s), s) if s > 0 else 0
        coeff = diff + last_dc[comp_idx]
        coeffs[0] = coeff * Am
        last_dc[comp_idx] = coeff
        Ss = 1
    if Ss > Se:
        return eobrun, reset_state, 0
    if eobrun > 0:
        return eobrun - 1, reset_state, 0
    nzr = 0
    k = Ss
    while k <= Se:
        sr = br.read_symbol(ac_lut)
        r, s = sr >> 4, sr & 15
        if s > 0:
            k += r
            if k > Se:
                raise JbrdError("out-of-band coefficient")
            if s + Al >= 12:
                raise JbrdError("AC value out of range")
            coeffs[KJPEG_NATURAL_ORDER[k]] = \
                _huff_extend(br.read_bits(s), s) * Am
            nzr = 0
            k += 1
        elif r == 15:
            k += 16
            nzr += 1
        else:
            if eobrun_allowed and k == Ss and eobrun == 0:
                reset_state = True
            eobrun = 1 << r
            if r > 0:
                if not eobrun_allowed:
                    raise JbrdError("EOB run crossing DC coeff")
                eobrun += br.read_bits(r)
            break
    return eobrun - 1, reset_state, nzr


def _refine_dct_block(br, ac_lut, Ss, Se, Al, eobrun, coeffs):
    """Exact mirror of RefineDCTBlock (enc_jpeg_data_reader.cc)."""
    Am = 1 << Al
    eobrun_allowed = Ss > 0
    reset_state = False
    if Ss == 0:
        s = br.read_bits(1)
        coeffs[0] = int(coeffs[0]) | (s * Am)
        Ss = 1
    if Ss > Se:
        return eobrun, reset_state
    p1, m1 = Am, -Am
    k = Ss
    in_zero_run = False
    if eobrun <= 0:
        while k <= Se:
            sr = br.read_symbol(ac_lut)
            r, s = sr >> 4, sr & 15
            if s:
                if s != 1:
                    raise JbrdError("invalid refinement symbol")
                s = p1 if br.read_bits(1) else m1
                in_zero_run = False
            else:
                if r != 15:
                    if eobrun_allowed and k == Ss and eobrun == 0:
                        reset_state = True
                    eobrun = 1 << r
                    if r > 0:
                        if not eobrun_allowed:
                            raise JbrdError("EOB run crossing DC coeff")
                        eobrun += br.read_bits(r)
                    break
                in_zero_run = True
            while True:
                pos_n = int(KJPEG_NATURAL_ORDER[k])
                thiscoef = int(coeffs[pos_n])
                if thiscoef != 0:
                    if br.read_bits(1):
                        if (thiscoef & p1) == 0:
                            thiscoef += p1 if thiscoef >= 0 else m1
                    coeffs[pos_n] = thiscoef
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > Se:
                    break
            if s:
                if k > Se:
                    raise JbrdError("out-of-band coefficient")
                coeffs[int(KJPEG_NATURAL_ORDER[k])] = s
            k += 1
    if in_zero_run:
        raise JbrdError("extra zero run before end-of-block")
    if eobrun > 0:
        while k <= Se:
            pos_n = int(KJPEG_NATURAL_ORDER[k])
            thiscoef = int(coeffs[pos_n])
            if thiscoef != 0:
                if br.read_bits(1):
                    if (thiscoef & p1) == 0:
                        thiscoef += p1 if thiscoef >= 0 else m1
                coeffs[pos_n] = thiscoef
            k += 1
    return eobrun - 1, reset_state


# ---------------------------------------------------------------------------
# Bundle serialization (jpeg_data.cc JPEGData::VisitFields)

_APP_TYPE_ENC = U32Enc(Val(0), Val(1), BitsOffset(1, 2), BitsOffset(2, 4))
_NUM_QUANT_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_NUM_COMP_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_NUM_HUFF_ENC = U32Enc(Val(4), BitsOffset(3, 2), BitsOffset(4, 10),
                       BitsOffset(6, 26))
_HUFF_COUNT_ENC = U32Enc(Val(0), Val(1), BitsOffset(3, 2), Bits(8))
_HUFF_VALUE_ENC = U32Enc(Bits(2), BitsOffset(2, 4), BitsOffset(4, 8),
                         BitsOffset(8, 1))
_NUM_SCAN_COMP_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_LAST_PASS_ENC = U32Enc(Val(0), Val(1), Val(2), BitsOffset(3, 3))
_NUM_RESET_ENC = U32Enc(Val(0), BitsOffset(2, 1), BitsOffset(4, 4),
                        BitsOffset(16, 20))
_BLOCK_IDX_ENC = U32Enc(Val(0), BitsOffset(3, 1), BitsOffset(5, 9),
                        BitsOffset(28, 41))
_NUM_ZERO_RUN_ENC = U32Enc(Val(1), BitsOffset(2, 2), BitsOffset(4, 5),
                           BitsOffset(8, 20))
_TAIL_LEN_ENC = U32Enc(Val(0), BitsOffset(8, 1), BitsOffset(16, 257),
                       BitsOffset(22, 65793))


def serialize_jpeg_data(jd: SpecJPEGData, w: BitWriter) -> None:
    is_gray = len(jd.components) == 1
    w.write_bool(is_gray)
    if not jd.marker_order or jd.marker_order[-1] != 0xD9:
        raise JbrdError("marker order must end with EOI")
    num_intermarker = sum(1 for m in jd.marker_order if m == 0xFF)
    for marker in jd.marker_order:
        w.write(6, (marker - 0xC0) & 0x3F)
    for i, app in enumerate(jd.app_data):
        write_u32(_APP_TYPE_ENC, jd.app_marker_type[i], w)
        w.write(16, len(app) - 1)
    for com in jd.com_data:
        w.write(16, len(com) - 1)
    write_u32(_NUM_QUANT_ENC, len(jd.quant), w)
    for i, q in enumerate(jd.quant):
        w.write(1, q.precision)
        w.write(2, q.index)
        w.write_bool(q.is_last)
    ids = [c.id for c in jd.components]
    if ids == [1]:
        ctype = 0  # kGray
    elif ids == [1, 2, 3]:
        ctype = 1  # kYCbCr
    elif ids == [ord("R"), ord("G"), ord("B")]:
        ctype = 2  # kRGB
    else:
        ctype = 3  # kCustom
    w.write(2, ctype)
    if ctype == 3:
        write_u32(_NUM_COMP_ENC, len(jd.components), w)
        for c in jd.components:
            w.write(8, c.id)
    for c in jd.components:
        w.write(2, c.quant_idx)
    write_u32(_NUM_HUFF_ENC, len(jd.huffman_code), w)
    for hc in jd.huffman_code:
        w.write_bool(bool(hc.slot_id & 0x10))
        w.write(2, hc.slot_id & 0xF)
        w.write_bool(hc.is_last)
        for i in range(17):
            write_u32(_HUFF_COUNT_ENC, hc.counts[i], w)
        num_symbols = sum(hc.counts)
        if num_symbols:
            if hc.values[num_symbols - 1] != 256:
                raise JbrdError("huffman values must end with the EOI "
                                "sentinel")
            for i in range(num_symbols):
                write_u32(_HUFF_VALUE_ENC, hc.values[i], w)
    for scan in jd.scan_info:
        write_u32(_NUM_SCAN_COMP_ENC, scan.num_components, w)
        w.write(6, scan.Ss)
        w.write(6, scan.Se)
        w.write(4, scan.Al)
        w.write(4, scan.Ah)
        for sc in scan.components:
            w.write(2, sc.comp_idx)
            w.write(2, sc.ac_tbl_idx)
            w.write(2, sc.dc_tbl_idx)
        write_u32(_LAST_PASS_ENC, scan.last_needed_pass, w)
    if 0xDD in jd.marker_order:
        w.write(16, jd.restart_interval)
    for scan in jd.scan_info:
        write_u32(_NUM_RESET_ENC, len(scan.reset_points), w)
        last = -1
        for b in scan.reset_points:
            write_u32(_BLOCK_IDX_ENC, b - last - 1, w)
            last = b
        write_u32(_NUM_RESET_ENC, len(scan.extra_zero_runs), w)
        last = -1
        for b, n in scan.extra_zero_runs:
            write_u32(_NUM_ZERO_RUN_ENC, n, w)
            write_u32(_BLOCK_IDX_ENC, b - last - 1, w)
            last = b
    if num_intermarker != len(jd.inter_marker_data):
        raise JbrdError("inter-marker count mismatch")
    for blob in jd.inter_marker_data:
        w.write(16, len(blob))
    write_u32(_TAIL_LEN_ENC, len(jd.tail_data), w)
    w.write_bool(jd.has_zero_padding_bit)
    if jd.has_zero_padding_bit:
        w.write(24, len(jd.padding_bits))
        for b in jd.padding_bits:
            w.write_bool(bool(b))


def deserialize_jpeg_data(r: BitReader) -> SpecJPEGData:
    jd = SpecJPEGData()
    is_gray = r.read_bool()
    n_app = n_com = n_scans = n_intermarker = 0
    has_dri = False
    while True:
        marker = (r.read(6) + 0xC0) & 0xFF
        jd.marker_order.append(marker)
        if 0xE0 <= marker <= 0xEF:
            n_app += 1
        if marker == 0xFE:
            n_com += 1
        if marker == 0xDA:
            n_scans += 1
        if marker == 0xFF:
            n_intermarker += 1
        if marker == 0xDD:
            has_dri = True
        if marker == 0xD9:
            break
        if len(jd.marker_order) > 16384:
            raise JbrdError("too many markers")
    if n_scans == 0:
        raise JbrdError("no scans")
    app_sizes = []
    for _ in range(n_app):
        t = read_u32(_APP_TYPE_ENC, r)
        if t > 3:
            raise JbrdError("unknown app marker type")
        jd.app_marker_type.append(t)
        app_sizes.append(r.read(16) + 1)
    jd.app_data = [bytearray(sz) for sz in app_sizes]
    com_sizes = [r.read(16) + 1 for _ in range(n_com)]
    jd.com_data = [bytearray(sz) for sz in com_sizes]
    num_quant = read_u32(_NUM_QUANT_ENC, r)
    if num_quant == 4:
        raise JbrdError("invalid number of quant tables")
    for i in range(num_quant):
        prec = r.read(1)
        idx = r.read(2)
        is_last = r.read_bool()
        jd.quant.append(SpecQuantTable(values=np.zeros(64, np.int32),
                                       precision=prec, index=idx,
                                       is_last=is_last))
    ctype = r.read(2)
    if ctype == 0:
        ids = [1]
    elif ctype == 1:
        ids = [1, 2, 3]
    elif ctype == 2:
        ids = [ord("R"), ord("G"), ord("B")]
    else:
        n = read_u32(_NUM_COMP_ENC, r)
        if n not in (1, 3):
            raise JbrdError("invalid number of components")
        ids = [r.read(8) for _ in range(n)]
    jd.components = [SpecComponent(id=i) for i in ids]
    for c in jd.components:
        c.quant_idx = r.read(2)
        if c.quant_idx >= len(jd.quant):
            raise JbrdError("invalid quant index")
    num_huff = read_u32(_NUM_HUFF_ENC, r)
    for _ in range(num_huff):
        is_ac = r.read_bool()
        hid = r.read(2)
        is_last = r.read_bool()
        counts = [read_u32(_HUFF_COUNT_ENC, r) for _ in range(17)]
        num_symbols = sum(counts)
        values = []
        if num_symbols > 257:
            raise JbrdError("huffman code too large")
        for _ in range(num_symbols):
            values.append(read_u32(_HUFF_VALUE_ENC, r))
        if num_symbols and values[-1] != 256:
            raise JbrdError("missing EOI sentinel in huffman values")
        jd.huffman_code.append(SpecHuffmanCode(
            counts=counts, values=values,
            slot_id=(0x10 if is_ac else 0) | hid, is_last=is_last))
    for _ in range(n_scans):
        scan = SpecScanInfo()
        ns = read_u32(_NUM_SCAN_COMP_ENC, r)
        if ns >= 4:
            raise JbrdError("invalid scan components")
        scan.Ss = r.read(6)
        scan.Se = r.read(6)
        scan.Al = r.read(4)
        scan.Ah = r.read(4)
        for _ in range(ns):
            sc = SpecScanComponent()
            sc.comp_idx = r.read(2)
            if sc.comp_idx >= len(jd.components):
                raise JbrdError("invalid scan component index")
            sc.ac_tbl_idx = r.read(2)
            sc.dc_tbl_idx = r.read(2)
            scan.components.append(sc)
        scan.last_needed_pass = read_u32(_LAST_PASS_ENC, r)
        jd.scan_info.append(scan)
    if has_dri:
        jd.restart_interval = r.read(16)
    for scan in jd.scan_info:
        nrp = read_u32(_NUM_RESET_ENC, r)
        last = -1
        for _ in range(nrp):
            b = read_u32(_BLOCK_IDX_ENC, r) + last + 1
            if b >= (3 << 26):
                raise JbrdError("invalid block id")
            scan.reset_points.append(b)
            last = b
        nzr = read_u32(_NUM_RESET_ENC, r)
        last = -1
        for _ in range(nzr):
            n = read_u32(_NUM_ZERO_RUN_ENC, r)
            b = read_u32(_BLOCK_IDX_ENC, r) + last + 1
            if n > 4 or b > (3 << 26):
                raise JbrdError("invalid extra zero run")
            scan.extra_zero_runs.append((b, n))
            last = b
    inter_sizes = [r.read(16) for _ in range(n_intermarker)]
    jd.inter_marker_data = [bytearray(sz) for sz in inter_sizes]
    tail_len = read_u32(_TAIL_LEN_ENC, r)
    jd.tail_data = bytearray(tail_len)
    jd.has_zero_padding_bit = r.read_bool()
    if jd.has_zero_padding_bit:
        nbit = r.read(24)
        jd.padding_bits = [1 if r.read_bool() else 0 for _ in range(nbit)]
    del is_gray
    return jd


# ---------------------------------------------------------------------------
# jbrd payload: bundle + brotli(blobs)

def encode_jbrd(jd: SpecJPEGData, quality: int = 9) -> bytes:
    """EncodeJPEGData (enc_jpeg_data.cc:286-345)."""
    from libjxl_tpu_torch.extras import brotli
    w = BitWriter()
    serialize_jpeg_data(jd, w)
    w.align_to_byte()
    head = bytes(w._bytes)
    blobs = bytearray()
    for i, app in enumerate(jd.app_data):
        if jd.app_marker_type[i] == APP_UNKNOWN:
            blobs += bytes(app)
    for com in jd.com_data:
        blobs += bytes(com)
    for blob in jd.inter_marker_data:
        blobs += bytes(blob)
    blobs += bytes(jd.tail_data)
    return head + brotli.compress(bytes(blobs), quality=quality)


def decode_jbrd(payload: bytes, icc_profile: bytes | None = None,
                exif: bytes | None = None,
                xmp: bytes | None = None) -> SpecJPEGData:
    """DecodeJPEGData (dec_jpeg_data.cc) including typed app-marker
    reconstruction from the decoded ICC profile / container blobs."""
    from libjxl_tpu_torch.extras import brotli
    r = BitReader(payload)
    jd = deserialize_jpeg_data(r)
    r.align_to_byte()
    consumed = r.bits_consumed // 8
    try:
        tail = brotli.decompress(bytes(payload[consumed:]))
    except ValueError as e:
        raise JbrdError(f"bad brotli blob stream: {e}") from e
    off = 0

    def take(n):
        nonlocal off
        if off + n > len(tail):
            raise JbrdError("not enough brotli data")
        b = tail[off:off + n]
        off += n
        return b

    num_icc = 0
    icc_pos = 0
    for i, marker in enumerate(jd.app_data):
        t = jd.app_marker_type[i]
        if t == APP_UNKNOWN:
            data = take(len(marker))
            marker[:] = data
            if marker[1] * 256 + marker[2] + 1 != len(marker):
                raise JbrdError("incorrect marker size")
            continue
        size_m1 = len(marker) - 1
        marker[1] = size_m1 >> 8
        marker[2] = size_m1 & 0xFF
        if t == APP_ICC:
            if len(marker) < 17:
                raise JbrdError("ICC marker too short")
            marker[0] = 0xE2
            marker[3:15] = _ICC_TAG
            num_icc += 1
            marker[15] = num_icc
            if icc_profile is None:
                raise JbrdError("jbrd needs the decoded ICC profile")
            chunk = icc_profile[icc_pos:icc_pos + len(marker) - 17]
            if len(chunk) != len(marker) - 17:
                raise JbrdError("ICC profile too short for markers")
            marker[17:] = chunk
            icc_pos += len(chunk)
        elif t == APP_EXIF:
            if exif is None:
                raise JbrdError("jbrd needs the Exif box payload")
            marker[0] = 0xE1
            marker[3:3 + len(_EXIF_TAG)] = _EXIF_TAG
            body = exif
            if len(marker) - 3 - len(_EXIF_TAG) != len(body):
                raise JbrdError("Exif size mismatch")
            marker[3 + len(_EXIF_TAG):] = body
        elif t == APP_XMP:
            if xmp is None:
                raise JbrdError("jbrd needs the xml box payload")
            marker[0] = 0xE1
            marker[3:3 + len(_XMP_TAG)] = _XMP_TAG
            if len(marker) - 3 - len(_XMP_TAG) != len(xmp):
                raise JbrdError("XMP size mismatch")
            marker[3 + len(_XMP_TAG):] = xmp
    for i, marker in enumerate(jd.app_data):
        if jd.app_marker_type[i] == APP_ICC:
            marker[16] = num_icc
    for com in jd.com_data:
        data = take(len(com))
        com[:] = data
        if com[1] * 256 + com[2] + 1 != len(com):
            raise JbrdError("incorrect COM size")
    for blob in jd.inter_marker_data:
        blob[:] = take(len(blob))
    jd.tail_data = bytes(take(len(jd.tail_data)))
    if off != len(tail):
        raise JbrdError("excess data in brotli stream")
    return jd


# ---------------------------------------------------------------------------
# JPEG re-serialization (dec_jpeg_data_writer.cc)

class _JpegBitWriterMSB:
    """MSB-first bit writer with 0xFF stuffing."""

    def __init__(self, out: bytearray):
        self.out = out
        self.acc = 0
        self.nbits = 0

    def write(self, nbits: int, value: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.nbits -= 8
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.nbits) - 1

    def jump_to_byte_boundary(self, pad_iter) -> None:
        n = (-self.nbits) % 8   # pad bits needed to reach a byte boundary
        if n == 0:
            return
        if pad_iter is None:
            bits = (1 << n) - 1
        else:
            bits = 0
            for _ in range(n):
                try:
                    bit = next(pad_iter)
                except StopIteration:
                    raise JbrdError("ran out of padding bits")
                bits = (bits << 1) | (bit & 1)
        self.write(n, bits)


def _emission_lut(hc: SpecHuffmanCode):
    """symbol -> (code, length) for emission; drops the 256 sentinel
    (dec_jpeg_data_writer BuildHuffmanCodeTable semantics: the sentinel
    count at max length is removed)."""
    counts = list(hc.counts)
    max_len = max((i for i in range(17) if counts[i]), default=0)
    if sum(counts) == 0:
        return {}
    counts[max_len] -= 1
    values = hc.values[:sum(counts)]
    lut = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length]):
            lut[values[k]] = (code, length)
            k += 1
            code += 1
        code <<= 1
    return lut


class _DCTCodingState:
    """Progressive EOB-run buffering (dec_jpeg_data_writer.cc
    DCTCodingState)."""

    def __init__(self):
        self.eob_run = 0
        self.cur_ac_huff = None
        self.refinement_bits = []

    def flush(self, bw):
        if self.eob_run > 0:
            nbits = self.eob_run.bit_length() - 1
            symbol = nbits << 4
            code, length = self.cur_ac_huff[symbol]
            bw.write(length, code)
            if nbits > 0:
                bw.write(nbits, self.eob_run & ((1 << nbits) - 1))
            self.eob_run = 0
        for bit in self.refinement_bits:
            bw.write(1, bit)
        self.refinement_bits = []

    def buffer_eob(self, ac_lut, refinement_bits, bw):
        if self.eob_run == 0:
            self.cur_ac_huff = ac_lut
        self.eob_run += 1
        if refinement_bits:
            self.refinement_bits.extend(refinement_bits)
        # 0x7FFF is the maximum EOB run length storable in 14 bits.
        if self.eob_run == 0x7FFF or len(self.refinement_bits) > 64 * 32:
            self.flush(bw)


def write_jpeg_full(jd: SpecJPEGData) -> bytes:
    """Bit-exact JPEG serialization from SpecJPEGData
    (dec_jpeg_data_writer.cc WriteJpeg)."""
    out = bytearray(b"\xff\xd8")
    dht_index = 0
    dqt_index = 0
    app_index = 0
    com_index = 0
    inter_index = 0
    scan_index = 0
    seen_dri = False
    is_progressive = False
    dc_emit: dict = {}
    ac_emit: dict = {}
    pad_iter = iter(jd.padding_bits) if jd.has_zero_padding_bit else None

    for marker in jd.marker_order:
        if marker in (0xC0, 0xC1, 0xC2):
            is_progressive = marker == 0xC2
            ncomp = len(jd.components)
            payload = bytearray()
            payload += bytes([8])
            payload += jd.height.to_bytes(2, "big")
            payload += jd.width.to_bytes(2, "big")
            payload.append(ncomp)
            for c in jd.components:
                payload.append(c.id)
                payload.append((c.h_samp << 4) | c.v_samp)
                payload.append(jd.quant[c.quant_idx].index)
            out += bytes([0xFF, marker]) + \
                (len(payload) + 2).to_bytes(2, "big") + payload
            hmax, vmax = jd.max_samp()
            mcus_x = -(-jd.width // (8 * hmax))
            mcus_y = -(-jd.height // (8 * vmax))
            for c in jd.components:
                c.width_in_blocks = mcus_x * c.h_samp
                c.height_in_blocks = mcus_y * c.v_samp
        elif marker == 0xC4:
            payload = bytearray()
            while True:
                if dht_index >= len(jd.huffman_code):
                    raise JbrdError("DHT marker without tables")
                hc = jd.huffman_code[dht_index]
                dht_index += 1
                total = sum(hc.counts)
                if total == 0:
                    break  # empty DHT marker
                lut = _emission_lut(hc)
                if hc.slot_id & 0x10:
                    ac_emit[hc.slot_id & 0xF] = lut
                else:
                    dc_emit[hc.slot_id & 0xF] = lut
                max_len = max(i for i in range(17) if hc.counts[i])
                payload.append(hc.slot_id)
                for i in range(1, 17):
                    payload.append(hc.counts[i] - (1 if i == max_len else 0))
                payload += bytes(hc.values[:total - 1])
                if hc.is_last:
                    break
            out += bytes([0xFF, 0xC4]) + \
                (len(payload) + 2).to_bytes(2, "big") + payload
        elif marker == 0xDB:
            payload = bytearray()
            while True:
                if dqt_index >= len(jd.quant):
                    raise JbrdError("DQT marker without tables")
                q = jd.quant[dqt_index]
                dqt_index += 1
                payload.append((q.precision << 4) | q.index)
                zz = q.values[KJPEG_NATURAL_ORDER]
                for v in zz:
                    v = int(v)
                    if q.precision:
                        payload.append((v >> 8) & 0xFF)
                    payload.append(v & 0xFF)
                if q.is_last:
                    break
            out += bytes([0xFF, 0xDB]) + \
                (len(payload) + 2).to_bytes(2, "big") + payload
        elif marker == 0xDD:
            seen_dri = True
            out += bytes([0xFF, 0xDD, 0, 4,
                          jd.restart_interval >> 8,
                          jd.restart_interval & 0xFF])
        elif 0xE0 <= marker <= 0xEF:
            out += b"\xff" + bytes(jd.app_data[app_index])
            app_index += 1
        elif marker == 0xFE:
            out += b"\xff" + bytes(jd.com_data[com_index])
            com_index += 1
        elif marker == 0xFF:
            out += bytes(jd.inter_marker_data[inter_index])
            inter_index += 1
        elif marker == 0xDA:
            scan = jd.scan_info[scan_index]
            scan_index += 1
            _encode_scan(jd, scan, out, dc_emit, ac_emit,
                         jd.restart_interval if seen_dri else 0,
                         is_progressive, pad_iter)
        elif marker == 0xD9:
            out += b"\xff\xd9"
            out += bytes(jd.tail_data)
        else:
            raise JbrdError(f"cannot serialize marker 0x{marker:02x}")
    return bytes(out)


def _encode_scan(jd, scan, out, dc_emit, ac_emit, restart_interval,
                 is_progressive, pad_iter):
    # SOS header
    payload = bytearray([scan.num_components])
    for sc in scan.components:
        payload.append(jd.components[sc.comp_idx].id)
        payload.append((sc.dc_tbl_idx << 4) | sc.ac_tbl_idx)
    payload += bytes([scan.Ss, scan.Se, (scan.Ah << 4) | scan.Al])
    out += bytes([0xFF, 0xDA]) + \
        (len(payload) + 2).to_bytes(2, "big") + payload

    bw = _JpegBitWriterMSB(out)
    cs = _DCTCodingState()
    mcus_per_row, mcu_rows = jd.calculate_mcu_size(scan)
    interleaved = scan.num_components > 1
    Al = scan.Al if is_progressive else 0
    Ss = scan.Ss if is_progressive else 0
    Se = scan.Se if is_progressive else 63
    refinement = is_progressive and scan.Ah > 0
    last_dc = [0] * len(jd.components)
    restarts_to_go = restart_interval
    next_restart = 0
    block_scan_index = 0
    rp = scan.reset_points
    rp_pos = 0
    ezr = scan.extra_zero_runs
    ezr_pos = 0
    for mcu_y in range(mcu_rows):
        for mcu_x in range(mcus_per_row):
            if restart_interval > 0 and restarts_to_go == 0:
                cs.flush(bw)
                bw.jump_to_byte_boundary(pad_iter)
                assert bw.nbits == 0
                out += bytes([0xFF, 0xD0 + next_restart])
                next_restart = (next_restart + 1) & 7
                restarts_to_go = restart_interval
                last_dc = [0] * len(jd.components)
            for sc in scan.components:
                c = jd.components[sc.comp_idx]
                dc_lut = dc_emit.get(sc.dc_tbl_idx)
                ac_lut = ac_emit.get(sc.ac_tbl_idx)
                nby = c.v_samp if interleaved else 1
                nbx = c.h_samp if interleaved else 1
                for iy in range(nby):
                    for ix in range(nbx):
                        by = mcu_y * nby + iy
                        bx = mcu_x * nbx + ix
                        bidx = by * c.width_in_blocks + bx
                        if rp_pos < len(rp) and \
                                block_scan_index == rp[rp_pos]:
                            cs.flush(bw)
                            rp_pos += 1
                        nzr = 0
                        if ezr_pos < len(ezr) and \
                                block_scan_index == ezr[ezr_pos][0]:
                            nzr = ezr[ezr_pos][1]
                            ezr_pos += 1
                        coeffs = c.coeffs[bidx]
                        if not is_progressive:
                            _encode_block_sequential(
                                coeffs, dc_lut, ac_lut, nzr, last_dc,
                                sc.comp_idx, bw)
                        elif not refinement:
                            _encode_block_progressive(
                                coeffs, dc_lut, ac_lut, Ss, Se, Al, nzr,
                                cs, last_dc, sc.comp_idx, bw)
                        else:
                            _encode_refinement_bits(
                                coeffs, ac_lut, Ss, Se, Al, cs, bw)
                        block_scan_index += 1
            restarts_to_go -= 1
    cs.flush(bw)
    bw.jump_to_byte_boundary(pad_iter)


def _encode_block_sequential(coeffs, dc_lut, ac_lut, num_zero_runs,
                             last_dc, comp_idx, bw):
    temp2 = int(coeffs[0])
    diff = temp2 - last_dc[comp_idx]
    last_dc[comp_idx] = temp2
    dc_nbits = abs(diff).bit_length()
    code, length = dc_lut[dc_nbits]
    bw.write(length, code)
    if dc_nbits:
        # Negative values are stored one's-complemented (diff - 1).
        val = diff if diff >= 0 else diff - 1
        bw.write(dc_nbits, val & ((1 << dc_nbits) - 1))
    r = 0
    for k in range(1, 64):
        temp = int(coeffs[KJPEG_NATURAL_ORDER[k]])
        if temp == 0:
            r += 1
            continue
        if temp < 0:
            ac_nbits = (-temp).bit_length()
            val = (temp - 1) & ((1 << ac_nbits) - 1)
        else:
            ac_nbits = temp.bit_length()
            val = temp & ((1 << ac_nbits) - 1)
        while r > 15:
            code, length = ac_lut[0xF0]
            bw.write(length, code)
            r -= 16
        symbol = (r << 4) + ac_nbits
        code, length = ac_lut[symbol]
        bw.write(length, code)
        bw.write(ac_nbits, val)
        r = 0
    for _ in range(num_zero_runs):
        code, length = ac_lut[0xF0]
        bw.write(length, code)
        r -= 16
    if r > 0:
        code, length = ac_lut[0]
        bw.write(length, code)


def _encode_block_progressive(coeffs, dc_lut, ac_lut, Ss, Se, Al,
                              num_zero_runs, cs, last_dc, comp_idx, bw):
    eob_run_allowed = Ss > 0
    if Ss == 0:
        temp2 = int(coeffs[0]) >> Al
        temp = temp2 - last_dc[comp_idx]
        last_dc[comp_idx] = temp2
        temp2 = temp
        if temp < 0:
            temp = -temp
            temp2 = temp2 - 1
        nbits = temp.bit_length()
        code, length = dc_lut[nbits]
        bw.write(length, code)
        if nbits:
            bw.write(nbits, temp2 & ((1 << nbits) - 1))
        Ss = 1
    if Ss > Se:
        return
    r = 0
    for k in range(Ss, Se + 1):
        temp = int(coeffs[KJPEG_NATURAL_ORDER[k]])
        if temp == 0:
            r += 1
            continue
        if temp < 0:
            temp = -temp
            temp >>= Al
            temp2 = ~temp
        else:
            temp >>= Al
            temp2 = temp
        if temp == 0:
            r += 1
            continue
        cs.flush(bw)
        while r > 15:
            code, length = ac_lut[0xF0]
            bw.write(length, code)
            r -= 16
        nbits = temp.bit_length()
        symbol = (r << 4) + nbits
        code, length = ac_lut[symbol]
        bw.write(length, code)
        bw.write(nbits, temp2 & ((1 << nbits) - 1))
        r = 0
    if num_zero_runs > 0:
        cs.flush(bw)
        for _ in range(num_zero_runs):
            code, length = ac_lut[0xF0]
            bw.write(length, code)
            r -= 16
    if r > 0:
        cs.buffer_eob(ac_lut, None, bw)
        if not eob_run_allowed:
            cs.flush(bw)


def _encode_refinement_bits(coeffs, ac_lut, Ss, Se, Al, cs, bw):
    eob_run_allowed = Ss > 0
    if Ss == 0:
        bw.write(1, (int(coeffs[0]) >> Al) & 1)
        Ss = 1
    if Ss > Se:
        return
    abs_values = {}
    eob = 0
    for k in range(Ss, Se + 1):
        av = abs(int(coeffs[KJPEG_NATURAL_ORDER[k]])) >> Al
        abs_values[k] = av
        if av == 1:
            eob = k
    r = 0
    refinement_bits = []
    for k in range(Ss, Se + 1):
        if abs_values[k] == 0:
            r += 1
            continue
        while r > 15 and k <= eob:
            cs.flush(bw)
            code, length = ac_lut[0xF0]
            bw.write(length, code)
            r -= 16
            for bit in refinement_bits:
                bw.write(1, bit)
            refinement_bits = []
        if abs_values[k] > 1:
            refinement_bits.append(abs_values[k] & 1)
            continue
        cs.flush(bw)
        symbol = (r << 4) + 1
        new_bit = 0 if int(coeffs[KJPEG_NATURAL_ORDER[k]]) < 0 else 1
        code, length = ac_lut[symbol]
        bw.write(length, code)
        bw.write(1, new_bit)
        for bit in refinement_bits:
            bw.write(1, bit)
        refinement_bits = []
        r = 0
    if r > 0 or refinement_bits:
        cs.buffer_eob(ac_lut, refinement_bits, bw)
        if not eob_run_allowed:
            cs.flush(bw)
