"""Baseline JPEG bitstream parser: markers, Huffman-coded DCT blocks.

Reference: lib/jxl/jpeg/dec_jpeg_data_writer.cc + jpeg_data.{h,cc}
describe the JPEG structures libjxl re-emits for bit-exact
reconstruction; this parser extracts the pieces the JXL transcode path
needs — quant tables, per-component subsampling, and the quantized DCT
coefficient planes (baseline sequential, 8-bit, Huffman).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libjxl_tpu_torch.base.errors import JxlError


class JpegError(JxlError):
    pass


# JPEG zig-zag order (natural order index for each coded position).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)


@dataclasses.dataclass
class JpegComponent:
    component_id: int
    h_samp: int
    v_samp: int
    quant_idx: int
    dc_table: int = 0
    ac_table: int = 0
    coeffs: np.ndarray | None = None    # (blocks_y, blocks_x, 64) natural


@dataclasses.dataclass
class JpegData:
    width: int = 0
    height: int = 0
    quant_tables: dict = dataclasses.field(default_factory=dict)
    components: list = dataclasses.field(default_factory=list)
    restart_interval: int = 0
    progressive: bool = False
    # Byte-exact reconstruction support (single-scan baseline): the
    # original bytes up to the start of the entropy-coded data, the
    # bytes after it (EOI + trailers), and the raw Huffman table
    # definitions in force for the scan.
    header_blob: bytes | None = None
    trailer_blob: bytes | None = None
    dc_specs: dict = dataclasses.field(default_factory=dict)
    ac_specs: dict = dataclasses.field(default_factory=dict)
    num_scans: int = 0


class _HuffTable:
    def __init__(self, counts, values):
        # Canonical code -> value lookup keyed by (length, code).
        self.lut = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lut[(length, code)] = values[k]
                code += 1
                k += 1
            code <<= 1


class _BitReaderMSB:
    """JPEG entropy-coded segment reader (MSB first, 0xFF00 unstuffing)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.nbits = 0
        self.marker_hit = False

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.bitbuf = (self.bitbuf << 8) | 0
                self.nbits += 8
                continue
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = self.data[self.pos + 1] if self.pos + 1 < \
                    len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:
                    # restart marker: caller resets via reset()
                    self.marker_hit = True
                    self.bitbuf = (self.bitbuf << 8)
                    self.nbits += 8
                    continue
                else:
                    self.marker_hit = True
                    self.bitbuf = (self.bitbuf << 8)
                    self.nbits += 8
                    continue
            else:
                self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.bitbuf >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        self.bitbuf &= (1 << self.nbits) - 1
        return v

    def read_huffman(self, table: _HuffTable) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read(1)
            v = table.lut.get((length, code))
            if v is not None:
                return v
        raise JpegError("invalid huffman code")

    def align_restart(self):
        """Skips to just past the next restart marker."""
        self.bitbuf = 0
        self.nbits = 0
        self.marker_hit = False
        while self.pos + 1 < len(self.data):
            if self.data[self.pos] == 0xFF and \
                    0xD0 <= self.data[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise JpegError("missing restart marker")


def _extend(v: int, n: int) -> int:
    """JPEG T.81 EXTEND: map n-bit magnitude to signed value."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def parse_jpeg(data: bytes) -> JpegData:
    """Parses a baseline/progressive JPEG into coefficients + tables."""
    try:
        return _parse_jpeg_inner(data)
    except JpegError:
        raise
    except (IndexError, ValueError, KeyError, StopIteration) as e:
        raise JpegError(f"malformed JPEG: {type(e).__name__}") from e


def _parse_jpeg_inner(data: bytes) -> JpegData:
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")
    jd = JpegData()
    dc_tables: dict = {}
    ac_tables: dict = {}
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise JpegError("marker expected")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                n = 64 * (2 if pq else 1)
                raw = seg[p:p + n]
                if pq:
                    vals = np.frombuffer(raw, ">u2").astype(np.int32)
                else:
                    vals = np.frombuffer(raw, np.uint8).astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = vals
                jd.quant_tables[tq] = table
                p += n
        elif marker in (0xC0, 0xC1):  # SOF0/1 baseline
            jd.height = (seg[1] << 8) | seg[2]
            jd.width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                jd.components.append(JpegComponent(
                    cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC2:  # SOF2 progressive
            jd.progressive = True
            jd.height = (seg[1] << 8) | seg[2]
            jd.width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                jd.components.append(JpegComponent(
                    cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                total = sum(counts)
                values = list(seg[p + 17:p + 17 + total])
                table = _HuffTable(counts, values)
                (dc_tables if tc == 0 else ac_tables)[th] = table
                (jd.dc_specs if tc == 0 else jd.ac_specs)[th] = \
                    (counts, values)
                p += 17 + total
        elif marker == 0xDD:  # DRI
            jd.restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            comp_order = []
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next(c for c in jd.components
                            if c.component_id == cid)
                comp.dc_table = tt >> 4
                comp.ac_table = tt & 15
                comp_order.append(comp)
            ss = seg[1 + 2 * ns]
            se = seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            pos = pos + seglen
            jd.num_scans += 1
            if jd.num_scans == 1:
                jd.header_blob = bytes(data[:pos])
            if jd.progressive:
                pos = _decode_progressive_scan(
                    data, pos, jd, comp_order, dc_tables, ac_tables,
                    ss, se, ah, al)
            else:
                pos = _decode_scan(data, pos, jd, comp_order, dc_tables,
                                   ac_tables)
            continue
        pos += seglen
    if not jd.components or jd.components[0].coeffs is None:
        raise JpegError("no image data decoded")
    return jd


def find_entropy_end(data: bytes, start: int) -> int:
    """Position of the first real marker after an entropy segment."""
    p = start
    while p + 1 < len(data) and not (
            data[p] == 0xFF and data[p + 1] != 0x00
            and not (0xD0 <= data[p + 1] <= 0xD7)):
        p += 1
    return p


def _decode_scan(data, pos, jd, comps, dc_tables, ac_tables) -> int:
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    mcux = -(-jd.width // (8 * hmax))
    mcuy = -(-jd.height // (8 * vmax))
    for c in jd.components:
        bw = mcux * c.h_samp
        bh = mcuy * c.v_samp
        c.coeffs = np.zeros((bh, bw, 64), np.int32)
    br = _BitReaderMSB(data, pos)
    preds = {c.component_id: 0 for c in comps}
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if jd.restart_interval and mcu_count and \
                    mcu_count % jd.restart_interval == 0:
                br.align_restart()
                preds = {c.component_id: 0 for c in comps}
            for c in comps:
                for by in range(c.v_samp):
                    for bx in range(c.h_samp):
                        block = np.zeros(64, np.int32)
                        s = br.read_huffman(dc_tables[c.dc_table])
                        diff = _extend(br.read(s), s)
                        preds[c.component_id] += diff
                        block[0] = preds[c.component_id]
                        k = 1
                        while k < 64:
                            rs = br.read_huffman(ac_tables[c.ac_table])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                raise JpegError("coefficient overflow")
                            block[ZIGZAG[k]] = _extend(br.read(s), s)
                            k += 1
                        c.coeffs[my * c.v_samp + by,
                                 mx * c.h_samp + bx] = block
            mcu_count += 1
    # Find position after the scan (next marker).
    p = br.pos
    while p + 1 < len(data) and not (data[p] == 0xFF
                                     and data[p + 1] != 0x00
                                     and not (0xD0 <= data[p + 1] <= 0xD7)):
        p += 1
    return p


def _alloc_coeffs(jd):
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    mcux = -(-jd.width // (8 * hmax))
    mcuy = -(-jd.height // (8 * vmax))
    for c in jd.components:
        if c.coeffs is None:
            c.coeffs = np.zeros((mcuy * c.v_samp, mcux * c.h_samp, 64),
                                np.int32)
    return mcux, mcuy


def _comp_block_dims(jd, c):
    """Nominal (non-interleaved) block dims of a component (T.81 A.2.4)."""
    hmax = max(cc.h_samp for cc in jd.components)
    vmax = max(cc.v_samp for cc in jd.components)
    w = -(-jd.width * c.h_samp // hmax)
    h = -(-jd.height * c.v_samp // vmax)
    return -(-w // 8), -(-h // 8)


def _skip_to_next_marker(data, pos):
    while pos + 1 < len(data) and not (
            data[pos] == 0xFF and data[pos + 1] != 0x00
            and not (0xD0 <= data[pos + 1] <= 0xD7)):
        pos += 1
    return pos


def _decode_progressive_scan(data, pos, jd, comps, dc_tables, ac_tables,
                             ss, se, ah, al) -> int:
    """One progressive scan (T.81 G.2): DC first/refine, AC first/refine
    with EOB runs."""
    _alloc_coeffs(jd)
    br = _BitReaderMSB(data, pos)
    ri = jd.restart_interval

    if ss == 0:
        # DC scan (interleaved over all scan components).
        hmax = max(c.h_samp for c in jd.components)
        vmax = max(c.v_samp for c in jd.components)
        mcux = -(-jd.width // (8 * hmax))
        mcuy = -(-jd.height // (8 * vmax))
        preds = {c.component_id: 0 for c in comps}
        n = 0
        for my in range(mcuy):
            for mx in range(mcux):
                if ri and n and n % ri == 0:
                    br.align_restart()
                    preds = {c.component_id: 0 for c in comps}
                for c in comps:
                    for by in range(c.v_samp):
                        for bx in range(c.h_samp):
                            blk = c.coeffs[my * c.v_samp + by,
                                           mx * c.h_samp + bx]
                            if ah == 0:
                                s_ = br.read_huffman(
                                    dc_tables[c.dc_table])
                                diff = _extend(br.read(s_), s_)
                                preds[c.component_id] += diff
                                blk[0] = preds[c.component_id] << al
                            else:
                                if br.read(1):
                                    blk[0] |= (1 << al)
                n += 1
        return _skip_to_next_marker(data, br.pos)

    # AC scan: single component, non-interleaved.
    c = comps[0]
    bw, bh = _comp_block_dims(jd, c)
    table = ac_tables[c.ac_table]
    eobrun = 0
    n = 0
    for by in range(bh):
        for bx in range(bw):
            if ri and n and n % ri == 0:
                br.align_restart()
                eobrun = 0
            n += 1
            blk = c.coeffs[by, bx]
            if ah == 0:
                # First AC scan for this band.
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = br.read_huffman(table)
                    r, s_ = rs >> 4, rs & 15
                    if s_ == 0:
                        if r < 15:
                            eobrun = (1 << r) - 1
                            if r:
                                eobrun += br.read(r)
                            break
                        k += 16
                        continue
                    k += r
                    if k > se:
                        raise JpegError("AC band overflow")
                    blk[ZIGZAG[k]] = _extend(br.read(s_), s_) << al
                    k += 1
            else:
                # Refinement scan (T.81 G.2.2.3).
                p1 = 1 << al
                m1 = -1 << al
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = br.read_huffman(table)
                        r, s_ = rs >> 4, rs & 15
                        if s_ == 0:
                            if r < 15:
                                eobrun = (1 << r)
                                if r:
                                    eobrun += br.read(r)
                                break
                            # r == 15: skip 16 zero-history coeffs
                            newval = 0
                        else:
                            newval = p1 if br.read(1) else m1
                        # Advance past r zero-history coefficients,
                        # applying correction bits to nonzero ones.
                        while k <= se:
                            z = ZIGZAG[k]
                            if blk[z] != 0:
                                if br.read(1) and (blk[z] & p1) == 0:
                                    blk[z] += p1 if blk[z] >= 0 else m1
                            else:
                                if r == 0:
                                    if s_ != 0:
                                        blk[z] = newval
                                    k += 1
                                    break
                                r -= 1
                            k += 1
                if eobrun > 0:
                    # Correction bits for the remainder of the band.
                    while k <= se:
                        z = ZIGZAG[k]
                        if blk[z] != 0:
                            if br.read(1) and (blk[z] & p1) == 0:
                                blk[z] += p1 if blk[z] >= 0 else m1
                        k += 1
                    eobrun -= 1
    return _skip_to_next_marker(data, br.pos)


def parse_jpeg_header(blob: bytes) -> JpegData:
    """Parses marker segments only (no entropy decode) — used to
    re-instantiate the original file structure from jbrd metadata.
    `blob` must end right after an SOS segment."""
    if blob[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG header blob")
    jd = JpegData()
    pos = 2
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            raise JpegError("marker expected")
        marker = blob[pos + 1]
        pos += 2
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (blob[pos] << 8) | blob[pos + 1]
        seg = blob[pos + 2:pos + seglen]
        if marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                n = 64 * (2 if pq else 1)
                raw = seg[p:p + n]
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8) \
                    .astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = vals
                jd.quant_tables[tq] = table
                p += n
        elif marker in (0xC0, 0xC1):
            jd.height = (seg[1] << 8) | seg[2]
            jd.width = (seg[3] << 8) | seg[4]
            for i in range(seg[5]):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                jd.components.append(JpegComponent(
                    cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                total = sum(counts)
                values = list(seg[p + 17:p + 17 + total])
                (jd.dc_specs if tc == 0 else jd.ac_specs)[th] = \
                    (counts, values)
                p += 17 + total
        elif marker == 0xDD:
            jd.restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:
            ns = seg[0]
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next(c for c in jd.components
                            if c.component_id == cid)
                comp.dc_table = tt >> 4
                comp.ac_table = tt & 15
            return jd
        pos += seglen
    raise JpegError("no SOS in header blob")
