"""Baseline JPEG writer: emits a valid JPEG from JpegData coefficients.

Reference: lib/jxl/jpeg/dec_jpeg_data_writer.cc (the reference's
JPEG-reemission path). Uses the T.81 Annex K typical Huffman tables, so
output files are valid JPEGs carrying the exact input coefficients
(bit-exact file reconstruction additionally needs the jbrd metadata,
which records the original tables/markers — future work).
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.extras.jpeg_parser import ZIGZAG, JpegData

# T.81 Annex K.3 typical Huffman tables: (bits[16], values).
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _build_codes(bits, values):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriterMSB:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.n -= 8
            self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            pad = 8 - self.n
            self.write((1 << pad) - 1, pad)


def _magnitude(v: int) -> tuple[int, int]:
    """(nbits, raw bits) per T.81: negatives coded as v-1 complements."""
    if v == 0:
        return 0, 0
    a = abs(v)
    n = a.bit_length()
    raw = v if v > 0 else v + (1 << n) - 1
    return n, raw


def write_jpeg(jd: JpegData) -> bytes:
    """JpegData (coefficients + quant tables) -> baseline JPEG bytes."""
    out = bytearray(b"\xff\xd8")

    def seg(marker, payload):
        out.extend(b"\xff" + bytes([marker]))
        out.extend((len(payload) + 2).to_bytes(2, "big"))
        out.extend(payload)

    # DQT
    for tq, table in sorted(jd.quant_tables.items()):
        zz = table[ZIGZAG]
        if zz.max() > 255:
            seg(0xDB, bytes([0x10 | tq])
                + b"".join(int(v).to_bytes(2, "big") for v in zz))
        else:
            seg(0xDB, bytes([tq]) + bytes(int(v) for v in zz))
    # SOF0
    ncomp = len(jd.components)
    sof = bytearray([8]) + jd.height.to_bytes(2, "big") \
        + jd.width.to_bytes(2, "big") + bytes([ncomp])
    for c in jd.components:
        sof += bytes([c.component_id, (c.h_samp << 4) | c.v_samp,
                      c.quant_idx])
    seg(0xC0, bytes(sof))
    # DHT (Annex K tables: luma = id 0, chroma = id 1)
    for tc, tid, (bits, values) in ((0, 0, _DC_LUMA), (0, 1, _DC_CHROMA),
                                    (1, 0, _AC_LUMA), (1, 1, _AC_CHROMA)):
        seg(0xC4, bytes([(tc << 4) | tid]) + bytes(bits) + bytes(values))
    dc_codes = [_build_codes(*_DC_LUMA), _build_codes(*_DC_CHROMA)]
    ac_codes = [_build_codes(*_AC_LUMA), _build_codes(*_AC_CHROMA)]
    # SOS (interleaved)
    sos = bytearray([ncomp])
    for i, c in enumerate(jd.components):
        tid = 0 if i == 0 else 1
        sos += bytes([c.component_id, (tid << 4) | tid])
    sos += bytes([0, 63, 0])
    seg(0xDA, bytes(sos))

    bw = _BitWriterMSB()
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    mcux = -(-jd.width // (8 * hmax))
    mcuy = -(-jd.height // (8 * vmax))
    preds = [0] * ncomp
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, c in enumerate(jd.components):
                tid = 0 if ci == 0 else 1
                for by in range(c.v_samp):
                    for bx in range(c.h_samp):
                        blk = c.coeffs[my * c.v_samp + by,
                                       mx * c.h_samp + bx]
                        dc = int(blk[0])
                        n, raw = _magnitude(dc - preds[ci])
                        preds[ci] = dc
                        code, length = dc_codes[tid][n]
                        bw.write(code, length)
                        if n:
                            bw.write(raw, n)
                        run = 0
                        for k in range(1, 64):
                            v = int(blk[ZIGZAG[k]])
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                code, length = ac_codes[tid][0xF0]
                                bw.write(code, length)
                                run -= 16
                            n, raw = _magnitude(v)
                            code, length = ac_codes[tid][(run << 4) | n]
                            bw.write(code, length)
                            bw.write(raw, n)
                            run = 0
                        if run:
                            code, length = ac_codes[tid][0x00]
                            bw.write(code, length)
    bw.flush()
    out.extend(bw.out)
    out.extend(b"\xff\xd9")
    return bytes(out)


def write_entropy_baseline(jd: JpegData, dc_specs: dict, ac_specs: dict,
                           ) -> bytes:
    """Re-encodes the (single, interleaved) baseline scan's entropy
    data with the ORIGINAL Huffman tables — byte-identical to standard
    encoders' output for the same coefficients."""
    dc_codes = {k: _build_codes(*v) for k, v in dc_specs.items()}
    ac_codes = {k: _build_codes(*v) for k, v in ac_specs.items()}
    bw = _BitWriterMSB()
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    mcux = -(-jd.width // (8 * hmax))
    mcuy = -(-jd.height // (8 * vmax))
    preds = [0] * len(jd.components)
    ri = jd.restart_interval
    n = 0
    rst = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if ri and n and n % ri == 0:
                bw.flush()
                bw.out.extend(b"\xff" + bytes([0xD0 + (rst & 7)]))
                rst += 1
                preds = [0] * len(jd.components)
            n += 1
            for ci, c in enumerate(jd.components):
                dct = dc_codes[c.dc_table]
                act = ac_codes[c.ac_table]
                for by in range(c.v_samp):
                    for bx in range(c.h_samp):
                        blk = c.coeffs[my * c.v_samp + by,
                                       mx * c.h_samp + bx]
                        dc = int(blk[0])
                        nb, raw = _magnitude(dc - preds[ci])
                        preds[ci] = dc
                        code, length = dct[nb]
                        bw.write(code, length)
                        if nb:
                            bw.write(raw, nb)
                        run = 0
                        for k in range(1, 64):
                            v = int(blk[ZIGZAG[k]])
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                code, length = act[0xF0]
                                bw.write(code, length)
                                run -= 16
                            nb, raw = _magnitude(v)
                            code, length = act[(run << 4) | nb]
                            bw.write(code, length)
                            bw.write(raw, nb)
                            run = 0
                        if run:
                            code, length = act[0x00]
                            bw.write(code, length)
    bw.flush()
    return bytes(bw.out)
