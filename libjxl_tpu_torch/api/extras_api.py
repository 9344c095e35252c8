"""Standalone extras APIs: compressed ICC and HDR gain-map bundles.

Reference: lib/extras/compressed_icc.cc (JxlICCProfileEncode/Decode)
and lib/extras/gain_map.cc (JxlGainMapWriteBundle/ReadBundle,
include/jxl/gain_map.h:63-86).

Copy of libjxl_tpu/api/extras_api.py with imports rewritten to the
port; host only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import struct

from libjxl_tpu_torch.base.errors import BitstreamError
from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter


def icc_profile_encode(icc: bytes) -> bytes:
    """Compress an ICC profile with the JPEG XL ICC codec
    (JxlICCProfileEncode)."""
    from libjxl_tpu_torch.color.icc_codec import write_icc
    w = BitWriter()
    write_icc(icc, w)
    w.align_to_byte()
    return bytes(w._bytes)


def icc_profile_decode(data: bytes) -> bytes:
    """Decompress a JPEG XL compressed ICC profile
    (JxlICCProfileDecode)."""
    from libjxl_tpu_torch.color.icc_codec import read_icc
    return read_icc(BitReader(data))


@dataclasses.dataclass
class GainMapBundle:
    """JxlGainMapBundle analogue (include/jxl/gain_map.h:63-86)."""
    jhgm_version: int = 0
    gain_map_metadata: bytes = b""       # XMP ISO 21496-1 metadata
    color_encoding: object | None = None  # ColorEncoding or None
    alt_icc: bytes = b""                 # compressed alternate ICC
    gain_map: bytes = b""                # naked JPEG XL codestream


def gain_map_write_bundle(bundle: GainMapBundle) -> bytes:
    """Serialize a gain-map bundle (JxlGainMapWriteBundle; the payload
    of a `jhgm` box)."""
    from libjxl_tpu_torch.bitstream.fields import bundle_write

    ce_bytes = b""
    if bundle.color_encoding is not None:
        w = BitWriter()
        bundle_write(bundle.color_encoding, w)
        w.align_to_byte()
        ce_bytes = bytes(w._bytes)
    if len(ce_bytes) > 255:
        raise BitstreamError("color encoding too large")
    if len(bundle.gain_map_metadata) > 0xFFFF:
        raise BitstreamError("gain map metadata too large")
    out = bytearray()
    out.append(bundle.jhgm_version & 0xFF)
    out += struct.pack(">H", len(bundle.gain_map_metadata))
    out += bundle.gain_map_metadata
    out.append(len(ce_bytes))
    out += ce_bytes
    out += struct.pack(">I", len(bundle.alt_icc))
    out += bundle.alt_icc
    out += bundle.gain_map
    return bytes(out)


def gain_map_read_bundle(data: bytes) -> GainMapBundle:
    """Parse a gain-map bundle (JxlGainMapReadBundle)."""
    from libjxl_tpu_torch.bitstream.fields import bundle_read
    from libjxl_tpu_torch.color.color_encoding import ColorEncoding

    if len(data) < 8:
        raise BitstreamError("gain map bundle too short")
    pos = 0
    version = data[pos]
    pos += 1
    meta_size = struct.unpack(">H", data[pos:pos + 2])[0]
    pos += 2
    meta = bytes(data[pos:pos + meta_size])
    if len(meta) != meta_size:
        raise BitstreamError("truncated gain map metadata")
    pos += meta_size
    ce_size = data[pos]
    pos += 1
    ce = None
    if ce_size:
        ce_bytes = data[pos:pos + ce_size]
        if len(ce_bytes) != ce_size:
            raise BitstreamError("truncated color encoding")
        ce = ColorEncoding()
        bundle_read(BitReader(bytes(ce_bytes)), ce)
        pos += ce_size
    icc_size = struct.unpack(">I", data[pos:pos + 4])[0]
    pos += 4
    icc = bytes(data[pos:pos + icc_size])
    if len(icc) != icc_size:
        raise BitstreamError("truncated alt ICC")
    pos += icc_size
    gain_map = bytes(data[pos:])
    return GainMapBundle(jhgm_version=version, gain_map_metadata=meta,
                         color_encoding=ce, alt_icc=icc,
                         gain_map=gain_map)
