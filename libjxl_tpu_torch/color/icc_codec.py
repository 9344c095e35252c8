"""Compressed ICC profile codec.

Reference: lib/jxl/icc_codec.cc (ICCReader/UnpredictICC),
icc_codec_common.{h,cc} (header prediction, byte-kind ANS contexts,
linear predictors), enc_icc_codec.cc (PredictICC; this encoder uses the
simple valid subset: predicted header residuals + a single Insert
command, which the decoder's command machine accepts).
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.base.errors import BitstreamError, NotEnoughBytesError
from libjxl_tpu_torch.bitstream.fields import read_u64, write_u64

ICC_HEADER_SIZE = 128
NUM_ICC_CONTEXTS = 41
_PREAMBLE = 20

_INITIAL_HEADER = bytes([0] * 8 + [4, 0, 0, 0]) + b"mntr" + b"RGB XYZ " \
    + bytes(12) + b"acsp" + bytes(28) \
    + bytes([0, 0, 246, 214, 0, 1, 0, 0, 0, 0, 211, 45]) + bytes(48)

assert len(_INITIAL_HEADER) == ICC_HEADER_SIZE

_TAG_STRINGS = [b"cprt", b"wtpt", b"bkpt", b"rXYZ", b"gXYZ", b"bXYZ",
                b"kXYZ", b"rTRC", b"gTRC", b"bTRC", b"kTRC", b"chad",
                b"desc", b"chrm", b"dmnd", b"dmdd", b"lumi"]
_TYPE_STRINGS = [b"XYZ ", b"desc", b"text", b"mluc", b"para", b"curv",
                 b"sf32", b"gbd "]
_CMD_TAG_UNKNOWN = 1
_CMD_TAG_TRC = 2
_CMD_TAG_XYZ = 3
_CMD_TAG_STRING_FIRST = 4
_CMD_INSERT = 1
_CMD_SHUFFLE2 = 2
_CMD_SHUFFLE4 = 3
_CMD_PREDICT = 4
_CMD_XYZ = 10
_CMD_TYPE_START = 16
_FLAG_BIT_OFFSET = 64
_FLAG_BIT_SIZE = 128

_SIZE_TAGS = {b"rXYZ", b"gXYZ", b"bXYZ", b"kXYZ", b"wtpt", b"bkpt",
              b"lumi"}


def _byte_kind1(b: int) -> int:
    if 0x61 <= b <= 0x7A or 0x41 <= b <= 0x5A:
        return 0
    if 0x30 <= b <= 0x39 or b in (0x2E, 0x2C):
        return 1
    if b == 0:
        return 2
    if b == 1:
        return 3
    if b < 16:
        return 4
    if b == 255:
        return 6
    if b > 240:
        return 5
    return 7


def _byte_kind2(b: int) -> int:
    if 0x61 <= b <= 0x7A or 0x41 <= b <= 0x5A:
        return 0
    if 0x30 <= b <= 0x39 or b in (0x2E, 0x2C):
        return 1
    if b < 16:
        return 2
    if b > 240:
        return 3
    return 4


def _ans_context(i: int, b1: int, b2: int) -> int:
    if i <= 128:
        return 0
    return 1 + _byte_kind1(b1) + _byte_kind2(b2) * 8


def _decode_varint(data: bytes, pos: int, end: int | None = None,
                   ) -> tuple[int, int]:
    end = len(data) if end is None else end
    ret = 0
    for i in range(9):
        if pos >= end:
            raise BitstreamError("truncated varint")
        b = data[pos]
        pos += 1
        ret |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return ret, pos
    if pos >= end:
        raise BitstreamError("truncated varint")
    b = data[pos]
    pos += 1
    if b & 0x80 or b & 0x7E:
        raise BitstreamError("varint too large")
    ret |= (b & 1) << 63
    return ret, pos


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _shuffle(data: bytearray, width: int) -> bytearray:
    """icc_codec.cc Shuffle: interleave columns of a
    ceil(size/width)-row matrix."""
    size = len(data)
    height = (size + width - 1) // width
    result = bytearray(size)
    s = 0
    j = 0
    for i in range(size):
        result[i] = data[j]
        j += height
        if j >= size:
            s += 1
            j = s
    return result


def _predict_header(icc: bytearray, header: bytearray, pos: int) -> None:
    size = len(icc)
    if pos == 8 and size >= 8:
        header[80:84] = icc[4:8]
    if pos == 41 and size >= 41:
        if icc[40] == ord("A"):
            header[41:44] = b"PPL"
        if icc[40] == ord("M"):
            header[41:44] = b"SFT"
    if pos == 42 and size >= 42:
        if icc[40:42] == b"SG":
            header[42:44] = b"I "
        if icc[40:42] == b"SU":
            header[42:44] = b"NW"


def _predict_value(p1: int, p2: int, p3: int, order: int) -> int:
    if order == 0:
        return p1
    if order == 1:
        return 2 * p1 - p2
    return 3 * p1 - 3 * p2 + p3


def _linear_predict(data: bytearray, start: int, i: int, stride: int,
                    width: int, order: int) -> int:
    pos = start + i
    if width == 1:
        return _predict_value(data[pos - stride], data[pos - 2 * stride],
                              data[pos - 3 * stride], order) & 0xFF
    if width == 2:
        p = start + (i & ~1)

        def rd(o):
            return (data[p - stride * o] << 8) + data[p - stride * o + 1]
        pred = _predict_value(rd(1), rd(2), rd(3), order) & 0xFFFF
        return (pred & 255) if (i & 1) else ((pred >> 8) & 255)
    p = start + (i & ~3)

    def rd4(o):
        q = p - stride * o
        if q + 4 > pos:
            chunk = bytes(data[q:min(q + 4, pos)])
            chunk += b"\x00" * (4 - len(chunk))
        else:
            chunk = bytes(data[q:q + 4])
        return int.from_bytes(chunk, "big")
    pred = _predict_value(rd4(1), rd4(2), rd4(3), order) & 0xFFFFFFFF
    shift = 3 - (i & 3)
    return (pred >> (shift * 8)) & 255


def unpredict_icc(enc: bytes) -> bytes:
    """UnpredictICC (icc_codec.cc:119-336)."""
    pos = 0
    osize, pos = _decode_varint(enc, pos)
    csize, pos = _decode_varint(enc, pos)
    if osize >= 1 << 32 or csize >= 1 << 32:
        raise BitstreamError("ICC size out of range")
    cpos = pos
    if pos + csize > len(enc):
        raise BitstreamError("ICC commands out of bounds")
    commands_end = cpos + csize
    pos = commands_end

    result = bytearray()
    header = bytearray(_INITIAL_HEADER)
    header[0:4] = int(osize).to_bytes(4, "big")
    for i in range(ICC_HEADER_SIZE + 1):
        if len(result) == osize:
            if cpos != commands_end or pos != len(enc):
                raise BitstreamError("ICC: unused data")
            return bytes(result)
        if i == ICC_HEADER_SIZE:
            break
        _predict_header(result, header, i)
        if pos >= len(enc):
            raise BitstreamError("ICC out of bounds")
        result.append((enc[pos] + header[i]) & 0xFF)
        pos += 1
    if cpos >= commands_end:
        raise BitstreamError("ICC out of bounds")

    # Tag list
    numtags, cpos = _decode_varint(enc, cpos, commands_end)
    if numtags != 0:
        numtags -= 1
        result += int(numtags).to_bytes(4, "big")
        prevtagstart = ICC_HEADER_SIZE + numtags * 12
        prevtagsize = 0
        while True:
            if len(result) > osize:
                raise BitstreamError("ICC result too large")
            if cpos > commands_end:
                raise BitstreamError("ICC out of bounds")
            if cpos == commands_end:
                break
            command = enc[cpos]
            cpos += 1
            tagcode = command & 63
            if tagcode == 0:
                break
            elif tagcode == _CMD_TAG_UNKNOWN:
                if pos + 4 > len(enc):
                    raise BitstreamError("ICC out of bounds")
                tag = enc[pos:pos + 4]
                pos += 4
            elif tagcode == _CMD_TAG_TRC:
                tag = b"rTRC"
            elif tagcode == _CMD_TAG_XYZ:
                tag = b"rXYZ"
            else:
                idx = tagcode - _CMD_TAG_STRING_FIRST
                if idx >= len(_TAG_STRINGS):
                    raise BitstreamError("unknown ICC tagcode")
                tag = _TAG_STRINGS[idx]
            result += tag
            tagsize = prevtagsize
            if tag in _SIZE_TAGS:
                tagsize = 20
            if command & _FLAG_BIT_OFFSET:
                tagstart, cpos = _decode_varint(enc, cpos, commands_end)
            else:
                tagstart = prevtagstart + prevtagsize
            result += int(tagstart).to_bytes(4, "big")
            if command & _FLAG_BIT_SIZE:
                tagsize, cpos = _decode_varint(enc, cpos, commands_end)
            result += int(tagsize).to_bytes(4, "big")
            prevtagstart, prevtagsize = tagstart, tagsize
            if tagcode == _CMD_TAG_TRC:
                for t in (b"gTRC", b"bTRC"):
                    result += t + int(tagstart).to_bytes(4, "big") \
                        + int(tagsize).to_bytes(4, "big")
            if tagcode == _CMD_TAG_XYZ:
                result += b"gXYZ" + int(tagstart + tagsize).to_bytes(4, "big") \
                    + int(tagsize).to_bytes(4, "big")
                result += b"bXYZ" \
                    + int(tagstart + 2 * tagsize).to_bytes(4, "big") \
                    + int(tagsize).to_bytes(4, "big")

    # Main content
    while True:
        if len(result) > osize:
            raise BitstreamError("ICC result too large")
        if cpos > commands_end:
            raise BitstreamError("ICC out of bounds")
        if cpos == commands_end:
            break
        command = enc[cpos]
        cpos += 1
        if command == _CMD_INSERT:
            num, cpos = _decode_varint(enc, cpos, commands_end)
            if pos + num > len(enc):
                raise BitstreamError("ICC out of bounds")
            result += enc[pos:pos + num]
            pos += num
        elif command in (_CMD_SHUFFLE2, _CMD_SHUFFLE4):
            num, cpos = _decode_varint(enc, cpos, commands_end)
            if pos + num > len(enc):
                raise BitstreamError("ICC out of bounds")
            width = 2 if command == _CMD_SHUFFLE2 else 4
            result += _shuffle(bytearray(enc[pos:pos + num]), width)
            pos += num
        elif command == _CMD_PREDICT:
            if cpos + 2 > commands_end:
                raise BitstreamError("ICC out of bounds")
            flags = enc[cpos]
            cpos += 1
            width = (flags & 3) + 1
            if width == 3:
                raise BitstreamError("invalid ICC predict width")
            order = (flags & 12) >> 2
            if order == 3:
                raise BitstreamError("invalid ICC predict order")
            stride = width
            if flags & 16:
                stride, cpos = _decode_varint(enc, cpos, commands_end)
                if stride < width:
                    raise BitstreamError("invalid ICC stride")
            if not result or ((len(result) - 1) >> 2) < stride:
                raise BitstreamError("invalid ICC stride")
            num, cpos = _decode_varint(enc, cpos, commands_end)
            if pos + num > len(enc):
                raise BitstreamError("ICC out of bounds")
            shuffled = bytearray(enc[pos:pos + num])
            if width > 1:
                shuffled = _shuffle(shuffled, width)
            start = len(result)
            for i in range(num):
                predicted = _linear_predict(result, start, i, stride,
                                            width, order)
                result.append((predicted + shuffled[i]) & 0xFF)
            pos += num
        elif command == _CMD_XYZ:
            result += b"XYZ " + bytes(4)
            if pos + 12 > len(enc):
                raise BitstreamError("ICC out of bounds")
            result += enc[pos:pos + 12]
            pos += 12
        elif _CMD_TYPE_START <= command < _CMD_TYPE_START + len(_TYPE_STRINGS):
            result += _TYPE_STRINGS[command - _CMD_TYPE_START] + bytes(4)
        else:
            raise BitstreamError("unknown ICC command")

    if pos != len(enc) or len(result) != osize:
        raise BitstreamError("ICC: wrong final size")
    return bytes(result)


def predict_icc(icc: bytes) -> bytes:
    """Simple valid PredictICC: header residuals + numtags=0 + one
    Insert command covering the body (encoder freedom subset)."""
    osize = len(icc)
    header = bytearray(_INITIAL_HEADER)
    header[0:4] = int(osize).to_bytes(4, "big")
    data = bytearray()
    result = bytearray()
    for i in range(min(ICC_HEADER_SIZE, osize)):
        _predict_header(result, header, i)
        data.append((icc[i] - header[i]) & 0xFF)
        result.append(icc[i])
    commands = bytearray()
    if osize > ICC_HEADER_SIZE:
        # Profiles that fit in the header section use an empty command
        # stream (the header loop reaches osize and terminates).
        commands += _encode_varint(0)  # numtags = 0: no tag machinery
        commands.append(_CMD_INSERT)
        commands += _encode_varint(osize - ICC_HEADER_SIZE)
        data += icc[ICC_HEADER_SIZE:]
    return bytes(_encode_varint(osize) + _encode_varint(len(commands))
                 + commands + data)


# Symbols between the end-of-input checks of ``read_icc``
# (ANSSymbolReader::kMaxCheckpointInterval).
_CHECKPOINT_INTERVAL = 512


def read_icc(r) -> bytes:
    """ICCReader::Init/Process (icc_codec.cc:339-423). Like
    ICCReader::Process, the symbol loop checks every
    ``_CHECKPOINT_INTERVAL`` symbols that it has not read past the end
    of the input (CheckEOI), so a short input that declares a large
    encoded size fails at once instead of decoding zero bits for up to
    2^28 symbols."""
    from libjxl_tpu_torch.entropy.codes import SymbolReader, decode_histograms

    enc_size = read_u64(r)
    if enc_size > 1 << 28:
        raise BitstreamError("encoded ICC too large")
    codes = decode_histograms(r, NUM_ICC_CONTEXTS)
    dec = SymbolReader(codes, r)
    out = bytearray(enc_size)
    b1 = b2 = 0
    for i in range(enc_size):
        if i % _CHECKPOINT_INTERVAL == 0 and r.overread:
            raise NotEnoughBytesError("ICC: input ends inside the "
                                      "encoded profile")
        v = dec.read(_ans_context(i, b1, b2))
        if v > 255:
            raise BitstreamError("invalid ICC byte")
        out[i] = v
        b2 = b1
        b1 = v
    if not dec.check_final_state():
        raise BitstreamError("bad ANS state in ICC")
    return unpredict_icc(bytes(out))


def write_icc(icc: bytes, w) -> None:
    from libjxl_tpu_torch.entropy.codes import build_and_encode_histograms, \
        write_tokens

    enc = predict_icc(icc)
    write_u64(len(enc), w)
    ctx = np.zeros(len(enc), np.int32)
    val = np.zeros(len(enc), np.int64)
    b1 = b2 = 0
    for i, byte in enumerate(enc):
        ctx[i] = _ans_context(i, b1, b2)
        val[i] = byte
        b2 = b1
        b1 = byte
    arrs = (ctx, val)
    codes = build_and_encode_histograms(NUM_ICC_CONTEXTS, [arrs], w)
    write_tokens(arrs, codes, w)
