"""ctypes bindings to the system libjxl shared library (v0.7 ABI).

This is the *independent* JPEG XL implementation used as a differential
conformance oracle: streams produced by ``libjxl_tpu_torch`` are
decoded here, and streams produced here are decoded by
``libjxl_tpu_torch``.  None of the codec logic in this repo depends on
it — it exists purely so that the conformance suite proves real
ISO/IEC 18181 interop instead of self-consistency.

ABI layout follows the public stable C API headers
(reference ``lib/include/jxl/decode.h:136-325``,
``codestream_header.h:95-262``, ``encode.h:132-330``,
``color_encoding.h:22-110``, ``types.h:46-57``); the structs used here
are unchanged between libjxl 0.7 and 0.13 (trailing padding reserved for
compatibility).

Copy of libjxl_tpu/extras/refjxl.py, unchanged but for the package's
name above and this paragraph. It is an oracle on the host, not a
device path: ``available()`` is False where no system libjxl is
installed, and callers report that.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Library loading

_LIB_CANDIDATES = (
    "libjxl.so.0.7",
    "libjxl.so.0",
    "libjxl.so",
)

_THREADS_CANDIDATES = (
    "libjxl_threads.so.0.7",
    "libjxl_threads.so.0",
    "libjxl_threads.so",
)


def _load(candidates):
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


_jxl = _load(_LIB_CANDIDATES)
_jxl_threads = _load(_THREADS_CANDIDATES)


def available() -> bool:
    """True when a system libjxl is present to differential-test against."""
    return _jxl is not None


class RefJxlError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Enums / constants (values from the stable public headers)

JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_NEED_MORE_INPUT = 2
JXL_DEC_NEED_PREVIEW_OUT_BUFFER = 3
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
JXL_DEC_JPEG_NEED_MORE_OUTPUT = 6
JXL_DEC_BOX_NEED_MORE_OUTPUT = 7
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_COLOR_ENCODING = 0x100
JXL_DEC_PREVIEW_IMAGE = 0x200
JXL_DEC_FRAME = 0x400
JXL_DEC_FULL_IMAGE = 0x1000
JXL_DEC_JPEG_RECONSTRUCTION = 0x2000
JXL_DEC_BOX = 0x4000

JXL_TYPE_FLOAT = 0
JXL_TYPE_UINT8 = 2
JXL_TYPE_UINT16 = 3
JXL_TYPE_FLOAT16 = 5

JXL_NATIVE_ENDIAN = 0
JXL_LITTLE_ENDIAN = 1

JXL_ENC_SUCCESS = 0
JXL_ENC_ERROR = 1
JXL_ENC_NEED_MORE_OUTPUT = 2

# JxlEncoderFrameSettingId (encode.h:132-330)
JXL_ENC_FRAME_SETTING_EFFORT = 0
JXL_ENC_FRAME_SETTING_DECODING_SPEED = 1
JXL_ENC_FRAME_SETTING_RESAMPLING = 2
JXL_ENC_FRAME_SETTING_NOISE = 6
JXL_ENC_FRAME_SETTING_DOTS = 7
JXL_ENC_FRAME_SETTING_PATCHES = 8
JXL_ENC_FRAME_SETTING_EPF = 9
JXL_ENC_FRAME_SETTING_GABORISH = 10
JXL_ENC_FRAME_SETTING_MODULAR = 11
JXL_ENC_FRAME_SETTING_RESPONSIVE = 16
JXL_ENC_FRAME_SETTING_PROGRESSIVE_AC = 17
JXL_ENC_FRAME_SETTING_QPROGRESSIVE_AC = 18
JXL_ENC_FRAME_SETTING_PROGRESSIVE_DC = 19
JXL_ENC_FRAME_SETTING_GROUP_ORDER = 13
JXL_ENC_FRAME_SETTING_PALETTE_COLORS = 22
JXL_ENC_FRAME_SETTING_LOSSY_PALETTE = 23
JXL_ENC_FRAME_SETTING_COLOR_TRANSFORM = 24
JXL_ENC_FRAME_SETTING_MODULAR_COLOR_SPACE = 25
JXL_ENC_FRAME_SETTING_MODULAR_GROUP_SIZE = 26
JXL_ENC_FRAME_SETTING_MODULAR_PREDICTOR = 27

JXL_COLOR_SPACE_RGB = 0
JXL_COLOR_SPACE_GRAY = 1

JXL_ORIENT_IDENTITY = 1


# ---------------------------------------------------------------------------
# Structs

class JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),
        ("endianness", ctypes.c_int),
        ("align", ctypes.c_size_t),
    ]


class JxlPreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", ctypes.c_uint32), ("ysize", ctypes.c_uint32)]


class JxlAnimationHeader(ctypes.Structure):
    _fields_ = [
        ("tps_numerator", ctypes.c_uint32),
        ("tps_denominator", ctypes.c_uint32),
        ("num_loops", ctypes.c_uint32),
        ("have_timecodes", ctypes.c_int),
    ]


class JxlBasicInfo(ctypes.Structure):
    # codestream_header.h:95-262 — layout frozen since 0.7.
    _fields_ = [
        ("have_container", ctypes.c_int),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int),
        ("have_preview", ctypes.c_int),
        ("have_animation", ctypes.c_int),
        ("orientation", ctypes.c_int),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int),
        ("preview", JxlPreviewHeader),
        ("animation", JxlAnimationHeader),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 100),
    ]


class JxlColorEncoding(ctypes.Structure):
    # color_encoding.h:114-180
    _fields_ = [
        ("color_space", ctypes.c_int),
        ("white_point", ctypes.c_int),
        ("white_point_xy", ctypes.c_double * 2),
        ("primaries", ctypes.c_int),
        ("primaries_red_xy", ctypes.c_double * 2),
        ("primaries_green_xy", ctypes.c_double * 2),
        ("primaries_blue_xy", ctypes.c_double * 2),
        ("transfer_function", ctypes.c_int),
        ("gamma", ctypes.c_double),
        ("rendering_intent", ctypes.c_int),
    ]


def _setup_prototypes(lib):
    P = ctypes.POINTER
    lib.JxlDecoderCreate.restype = ctypes.c_void_p
    lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderSubscribeEvents.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlDecoderSetInput.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_size_t]
    lib.JxlDecoderCloseInput.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderGetBasicInfo.argtypes = [ctypes.c_void_p, P(JxlBasicInfo)]
    lib.JxlDecoderImageOutBufferSize.argtypes = [
        ctypes.c_void_p, P(JxlPixelFormat), P(ctypes.c_size_t)]
    lib.JxlDecoderSetImageOutBuffer.argtypes = [
        ctypes.c_void_p, P(JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t]
    lib.JxlDecoderReleaseInput.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderReleaseInput.restype = ctypes.c_size_t
    lib.JxlDecoderSetJPEGBuffer.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_size_t]
    lib.JxlDecoderReleaseJPEGBuffer.restype = ctypes.c_size_t
    lib.JxlDecoderReleaseJPEGBuffer.argtypes = [ctypes.c_void_p]
    lib.JxlDecoderGetICCProfileSize.argtypes = [
        ctypes.c_void_p, P(JxlPixelFormat), ctypes.c_int, P(ctypes.c_size_t)]
    lib.JxlDecoderGetColorAsICCProfile.argtypes = [
        ctypes.c_void_p, P(JxlPixelFormat), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.JxlDecoderVersion.restype = ctypes.c_uint32

    lib.JxlEncoderCreate.restype = ctypes.c_void_p
    lib.JxlEncoderCreate.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderDestroy.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderUseContainer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlEncoderStoreJPEGMetadata.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlEncoderSetCodestreamLevel.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlEncoderInitBasicInfo.argtypes = [P(JxlBasicInfo)]
    lib.JxlEncoderSetBasicInfo.argtypes = [ctypes.c_void_p, P(JxlBasicInfo)]
    lib.JxlEncoderSetColorEncoding.argtypes = [ctypes.c_void_p,
                                               P(JxlColorEncoding)]
    lib.JxlEncoderFrameSettingsCreate.restype = ctypes.c_void_p
    lib.JxlEncoderFrameSettingsCreate.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_void_p]
    lib.JxlEncoderSetFrameDistance.argtypes = [ctypes.c_void_p,
                                               ctypes.c_float]
    lib.JxlEncoderSetFrameLossless.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.JxlEncoderFrameSettingsSetOption.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
    lib.JxlEncoderAddImageFrame.argtypes = [
        ctypes.c_void_p, P(JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t]
    lib.JxlEncoderAddJPEGFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.JxlEncoderCloseInput.argtypes = [ctypes.c_void_p]
    lib.JxlEncoderProcessOutput.argtypes = [
        ctypes.c_void_p, P(ctypes.POINTER(ctypes.c_uint8)), P(ctypes.c_size_t)]
    lib.JxlColorEncodingSetToSRGB.argtypes = [P(JxlColorEncoding),
                                              ctypes.c_int]
    lib.JxlColorEncodingSetToLinearSRGB.argtypes = [P(JxlColorEncoding),
                                                    ctypes.c_int]
    lib.JxlEncoderVersion.restype = ctypes.c_uint32

    # Butteraugli comparator (independent metric oracle)
    lib.JxlButteraugliApiCreate.restype = ctypes.c_void_p
    lib.JxlButteraugliApiCreate.argtypes = [ctypes.c_void_p]
    lib.JxlButteraugliApiDestroy.argtypes = [ctypes.c_void_p]
    lib.JxlButteraugliApiSetIntensityTarget.argtypes = [ctypes.c_void_p,
                                                        ctypes.c_float]
    lib.JxlButteraugliApiSetHFAsymmetry.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_float]
    lib.JxlButteraugliCompute.restype = ctypes.c_void_p
    lib.JxlButteraugliCompute.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        P(JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t,
        P(JxlPixelFormat), ctypes.c_void_p, ctypes.c_size_t]
    lib.JxlButteraugliResultGetDistance.restype = ctypes.c_float
    lib.JxlButteraugliResultGetDistance.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_float]
    lib.JxlButteraugliResultGetMaxDistance.restype = ctypes.c_float
    lib.JxlButteraugliResultGetMaxDistance.argtypes = [ctypes.c_void_p]
    lib.JxlButteraugliResultDestroy.argtypes = [ctypes.c_void_p]


if _jxl is not None:
    _setup_prototypes(_jxl)
    if _jxl_threads is not None:
        _jxl_threads.JxlThreadParallelRunnerCreate.restype = ctypes.c_void_p


def version() -> tuple[int, int, int]:
    v = _jxl.JxlDecoderVersion()
    return (v // 1000000, (v // 1000) % 1000, v % 1000)


# ---------------------------------------------------------------------------
# Decode

@dataclass
class RefDecodeResult:
    pixels: np.ndarray          # (H, W, C) float32 in [0,1] (or uint8/16)
    info: dict = field(default_factory=dict)
    icc: bytes | None = None
    jpeg: bytes | None = None


def _info_dict(bi: JxlBasicInfo) -> dict:
    return dict(
        xsize=bi.xsize, ysize=bi.ysize,
        bits_per_sample=bi.bits_per_sample,
        exponent_bits_per_sample=bi.exponent_bits_per_sample,
        num_color_channels=bi.num_color_channels,
        num_extra_channels=bi.num_extra_channels,
        alpha_bits=bi.alpha_bits,
        uses_original_profile=bool(bi.uses_original_profile),
        have_animation=bool(bi.have_animation),
        orientation=bi.orientation,
        intensity_target=bi.intensity_target,
    )


def decode(data: bytes, *, dtype: str = "float32",
           num_channels: int | None = None,
           want_icc: bool = False) -> RefDecodeResult:
    """Decode a .jxl stream with the system libjxl.

    Returns interleaved pixels of the first frame.  ``dtype`` selects the
    requested output format ('float32', 'uint8', 'uint16').
    """
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    dec = _jxl.JxlDecoderCreate(None)
    if not dec:
        raise RefJxlError("JxlDecoderCreate failed")
    try:
        events = JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE
        if want_icc:
            events |= JXL_DEC_COLOR_ENCODING
        if _jxl.JxlDecoderSubscribeEvents(dec, events) != JXL_DEC_SUCCESS:
            raise RefJxlError("SubscribeEvents failed")
        buf = ctypes.create_string_buffer(data, len(data))
        _jxl.JxlDecoderSetInput(dec, buf, len(data))
        _jxl.JxlDecoderCloseInput(dec)

        bi = JxlBasicInfo()
        out = None
        icc = None
        jxl_type = {"float32": JXL_TYPE_FLOAT, "uint8": JXL_TYPE_UINT8,
                    "uint16": JXL_TYPE_UINT16}[dtype]
        np_dtype = {"float32": np.float32, "uint8": np.uint8,
                    "uint16": np.uint16}[dtype]
        fmt = None
        while True:
            status = _jxl.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise RefJxlError("reference decoder reported JXL_DEC_ERROR")
            if status == JXL_DEC_NEED_MORE_INPUT:
                raise RefJxlError("reference decoder ran out of input")
            if status == JXL_DEC_BASIC_INFO:
                if _jxl.JxlDecoderGetBasicInfo(dec, ctypes.byref(bi)) != 0:
                    raise RefJxlError("GetBasicInfo failed")
                nch = num_channels
                if nch is None:
                    nch = bi.num_color_channels + (1 if bi.alpha_bits else 0)
                fmt = JxlPixelFormat(nch, jxl_type, JXL_LITTLE_ENDIAN, 0)
            elif status == JXL_DEC_COLOR_ENCODING:
                sz = ctypes.c_size_t()
                # target = JXL_COLOR_PROFILE_TARGET_DATA (1)
                if _jxl.JxlDecoderGetICCProfileSize(
                        dec, ctypes.byref(fmt), 1, ctypes.byref(sz)) == 0:
                    icc_buf = ctypes.create_string_buffer(sz.value)
                    _jxl.JxlDecoderGetColorAsICCProfile(
                        dec, ctypes.byref(fmt), 1, icc_buf, sz.value)
                    icc = icc_buf.raw
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                sz = ctypes.c_size_t()
                if _jxl.JxlDecoderImageOutBufferSize(
                        dec, ctypes.byref(fmt), ctypes.byref(sz)) != 0:
                    raise RefJxlError("ImageOutBufferSize failed")
                out = np.empty(sz.value, dtype=np.uint8)
                if _jxl.JxlDecoderSetImageOutBuffer(
                        dec, ctypes.byref(fmt),
                        out.ctypes.data_as(ctypes.c_void_p), sz.value) != 0:
                    raise RefJxlError("SetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                continue
            elif status == JXL_DEC_SUCCESS:
                break
            else:
                raise RefJxlError(f"unexpected decoder status {status}")
        if out is None:
            raise RefJxlError("no image produced")
        pixels = out.view(np_dtype).reshape(bi.ysize, bi.xsize,
                                            fmt.num_channels)
        return RefDecodeResult(pixels=pixels, info=_info_dict(bi), icc=icc)
    finally:
        _jxl.JxlDecoderDestroy(dec)


def decode_to_jpeg(data: bytes) -> bytes:
    """Reconstruct the original JPEG from a transcoded .jxl (jbrd path)."""
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    dec = _jxl.JxlDecoderCreate(None)
    try:
        events = (JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE |
                  JXL_DEC_JPEG_RECONSTRUCTION)
        _jxl.JxlDecoderSubscribeEvents(dec, events)
        buf = ctypes.create_string_buffer(data, len(data))
        _jxl.JxlDecoderSetInput(dec, buf, len(data))
        _jxl.JxlDecoderCloseInput(dec)

        jpeg_buf = bytearray(1 << 16)
        used = 0
        have_recon = False
        Buf = ctypes.c_uint8 * len(jpeg_buf)

        def set_buf():
            arr = Buf.from_buffer(jpeg_buf)
            _jxl.JxlDecoderSetJPEGBuffer(
                dec, ctypes.addressof(arr) + used, len(jpeg_buf) - used)

        bi = JxlBasicInfo()
        fmt = JxlPixelFormat(3, JXL_TYPE_UINT8, JXL_LITTLE_ENDIAN, 0)
        pixels = None
        while True:
            status = _jxl.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise RefJxlError("reference decoder error")
            if status == JXL_DEC_BASIC_INFO:
                _jxl.JxlDecoderGetBasicInfo(dec, ctypes.byref(bi))
            elif status == JXL_DEC_JPEG_RECONSTRUCTION:
                have_recon = True
                set_buf()
            elif status == JXL_DEC_JPEG_NEED_MORE_OUTPUT:
                remaining = _jxl.JxlDecoderReleaseJPEGBuffer(dec)
                used = len(jpeg_buf) - remaining
                new = bytearray(len(jpeg_buf) * 2)
                new[:used] = jpeg_buf[:used]
                jpeg_buf = new
                Buf = ctypes.c_uint8 * len(jpeg_buf)
                set_buf()
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                sz = ctypes.c_size_t()
                _jxl.JxlDecoderImageOutBufferSize(dec, ctypes.byref(fmt),
                                                  ctypes.byref(sz))
                pixels = np.empty(sz.value, dtype=np.uint8)
                _jxl.JxlDecoderSetImageOutBuffer(
                    dec, ctypes.byref(fmt),
                    pixels.ctypes.data_as(ctypes.c_void_p), sz.value)
            elif status == JXL_DEC_FULL_IMAGE:
                continue
            elif status == JXL_DEC_SUCCESS:
                break
            else:
                raise RefJxlError(f"unexpected status {status}")
        if not have_recon:
            raise RefJxlError("stream carries no JPEG reconstruction data")
        remaining = _jxl.JxlDecoderReleaseJPEGBuffer(dec)
        used = len(jpeg_buf) - remaining
        return bytes(jpeg_buf[:used])
    finally:
        _jxl.JxlDecoderDestroy(dec)


# ---------------------------------------------------------------------------
# Encode

def _drain_encoder(enc) -> bytes:
    chunks = []
    avail = 1 << 16
    while True:
        buf = (ctypes.c_uint8 * avail)()
        next_out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        avail_c = ctypes.c_size_t(avail)
        status = _jxl.JxlEncoderProcessOutput(
            enc, ctypes.byref(next_out), ctypes.byref(avail_c))
        produced = avail - avail_c.value
        chunks.append(bytes(bytearray(buf)[:produced]))
        if status == JXL_ENC_SUCCESS:
            break
        if status == JXL_ENC_NEED_MORE_OUTPUT:
            avail *= 2
            continue
        raise RefJxlError("JxlEncoderProcessOutput failed")
    return b"".join(chunks)


def encode(image: np.ndarray, *, distance: float = 1.0, effort: int = 7,
           lossless: bool = False, container: bool = False,
           options: dict | None = None) -> bytes:
    """Encode pixels to .jxl with the system libjxl.

    ``image``: (H, W), (H, W, 1), (H, W, 3) or (H, W, 4); uint8, uint16
    or float32 (nominal [0,1] sRGB).
    ``options``: extra {frame_setting_id: int} pairs
    (see JXL_ENC_FRAME_SETTING_*).
    """
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    if image.dtype == np.uint8:
        jxl_type, bits, exp = JXL_TYPE_UINT8, 8, 0
    elif image.dtype == np.uint16:
        jxl_type, bits, exp = JXL_TYPE_UINT16, 16, 0
    elif image.dtype == np.float32:
        jxl_type, bits, exp = JXL_TYPE_FLOAT, 32, 8
    else:
        raise ValueError(f"unsupported dtype {image.dtype}")
    image = np.ascontiguousarray(image)

    enc = _jxl.JxlEncoderCreate(None)
    if not enc:
        raise RefJxlError("JxlEncoderCreate failed")
    try:
        if container:
            _jxl.JxlEncoderUseContainer(enc, 1)
        bi = JxlBasicInfo()
        _jxl.JxlEncoderInitBasicInfo(ctypes.byref(bi))
        bi.xsize, bi.ysize = w, h
        bi.bits_per_sample = bits
        bi.exponent_bits_per_sample = exp
        gray = c <= 2
        bi.num_color_channels = 1 if gray else 3
        has_alpha = c in (2, 4)
        if has_alpha:
            bi.num_extra_channels = 1
            bi.alpha_bits = bits
            bi.alpha_exponent_bits = exp
        bi.uses_original_profile = 1 if lossless else 0
        if _jxl.JxlEncoderSetBasicInfo(enc, ctypes.byref(bi)) != 0:
            raise RefJxlError("SetBasicInfo failed")
        ce = JxlColorEncoding()
        _jxl.JxlColorEncodingSetToSRGB(ctypes.byref(ce), 1 if gray else 0)
        if _jxl.JxlEncoderSetColorEncoding(enc, ctypes.byref(ce)) != 0:
            raise RefJxlError("SetColorEncoding failed")
        fs = _jxl.JxlEncoderFrameSettingsCreate(enc, None)
        if lossless:
            _jxl.JxlEncoderSetFrameLossless(fs, 1)
        else:
            _jxl.JxlEncoderSetFrameDistance(fs, ctypes.c_float(distance))
        _jxl.JxlEncoderFrameSettingsSetOption(
            fs, JXL_ENC_FRAME_SETTING_EFFORT, effort)
        for key, val in (options or {}).items():
            _jxl.JxlEncoderFrameSettingsSetOption(fs, key, int(val))
        fmt = JxlPixelFormat(c, jxl_type, JXL_LITTLE_ENDIAN, 0)
        if _jxl.JxlEncoderAddImageFrame(
                fs, ctypes.byref(fmt),
                image.ctypes.data_as(ctypes.c_void_p), image.nbytes) != 0:
            raise RefJxlError("AddImageFrame failed")
        _jxl.JxlEncoderCloseInput(enc)
        return _drain_encoder(enc)
    finally:
        _jxl.JxlEncoderDestroy(enc)


def encode_jpeg(jpeg_bytes: bytes, *, effort: int = 7) -> bytes:
    """Losslessly transcode a JPEG to .jxl (with jbrd reconstruction box)."""
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    enc = _jxl.JxlEncoderCreate(None)
    try:
        _jxl.JxlEncoderUseContainer(enc, 1)
        if _jxl.JxlEncoderStoreJPEGMetadata(enc, 1) != 0:
            raise RefJxlError("StoreJPEGMetadata failed")
        fs = _jxl.JxlEncoderFrameSettingsCreate(enc, None)
        _jxl.JxlEncoderFrameSettingsSetOption(
            fs, JXL_ENC_FRAME_SETTING_EFFORT, effort)
        if _jxl.JxlEncoderAddJPEGFrame(fs, jpeg_bytes, len(jpeg_bytes)) != 0:
            raise RefJxlError("AddJPEGFrame failed")
        _jxl.JxlEncoderCloseInput(enc)
        return _drain_encoder(enc)
    finally:
        _jxl.JxlEncoderDestroy(enc)


# ---------------------------------------------------------------------------
# Butteraugli oracle

def butteraugli_distance(ref: np.ndarray, dis: np.ndarray,
                         *, intensity_target: float = 80.0,
                         pnorm: float | None = None) -> float:
    """Butteraugli distance per the system libjxl implementation.

    Returns the max-norm distance by default; pass ``pnorm`` for the
    ComputeDistanceP-style norm instead.
    ``ref``/``dis``: (H, W, 3) float32 sRGB in [0,1] or uint8.
    """
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    if ref.shape != dis.shape:
        raise ValueError("shape mismatch")
    if ref.ndim == 2:
        ref, dis = ref[..., None], dis[..., None]
    h, w, c = ref.shape

    def prep(a):
        if a.dtype == np.uint8:
            return np.ascontiguousarray(a), JXL_TYPE_UINT8
        return np.ascontiguousarray(a.astype(np.float32)), JXL_TYPE_FLOAT

    ref_c, t_ref = prep(ref)
    dis_c, t_dis = prep(dis)
    api = _jxl.JxlButteraugliApiCreate(None)
    try:
        if intensity_target:
            _jxl.JxlButteraugliApiSetIntensityTarget(
                api, ctypes.c_float(intensity_target))
        fmt_ref = JxlPixelFormat(c, t_ref, JXL_LITTLE_ENDIAN, 0)
        fmt_dis = JxlPixelFormat(c, t_dis, JXL_LITTLE_ENDIAN, 0)
        res = _jxl.JxlButteraugliCompute(
            api, w, h,
            ctypes.byref(fmt_ref), ref_c.ctypes.data_as(ctypes.c_void_p),
            ref_c.nbytes,
            ctypes.byref(fmt_dis), dis_c.ctypes.data_as(ctypes.c_void_p),
            dis_c.nbytes)
        if not res:
            raise RefJxlError("JxlButteraugliCompute failed")
        try:
            if pnorm is not None:
                return float(_jxl.JxlButteraugliResultGetDistance(
                    res, ctypes.c_float(pnorm)))
            return float(_jxl.JxlButteraugliResultGetMaxDistance(res))
        finally:
            _jxl.JxlButteraugliResultDestroy(res)
    finally:
        _jxl.JxlButteraugliApiDestroy(api)


def decode_frames(data: bytes, *, dtype: str = "uint8",
                  num_channels: int | None = None) -> list:
    """Decode EVERY displayed (coalesced) frame of an animation with
    the system libjxl — the per-frame oracle for decode_all interop
    (JXL_DEC_FULL_IMAGE fires once per composed frame)."""
    if _jxl is None:
        raise RefJxlError("system libjxl not available")
    dec = _jxl.JxlDecoderCreate(None)
    if not dec:
        raise RefJxlError("JxlDecoderCreate failed")
    try:
        events = JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE
        if _jxl.JxlDecoderSubscribeEvents(dec, events) != JXL_DEC_SUCCESS:
            raise RefJxlError("SubscribeEvents failed")
        buf = ctypes.create_string_buffer(data, len(data))
        _jxl.JxlDecoderSetInput(dec, buf, len(data))
        _jxl.JxlDecoderCloseInput(dec)

        bi = JxlBasicInfo()
        jxl_type = {"float32": JXL_TYPE_FLOAT, "uint8": JXL_TYPE_UINT8,
                    "uint16": JXL_TYPE_UINT16}[dtype]
        np_dtype = {"float32": np.float32, "uint8": np.uint8,
                    "uint16": np.uint16}[dtype]
        fmt = None
        out = None
        frames: list = []
        while True:
            status = _jxl.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise RefJxlError("reference decoder reported ERROR")
            if status == JXL_DEC_NEED_MORE_INPUT:
                raise RefJxlError("reference decoder ran out of input")
            if status == JXL_DEC_BASIC_INFO:
                if _jxl.JxlDecoderGetBasicInfo(dec, ctypes.byref(bi)) != 0:
                    raise RefJxlError("GetBasicInfo failed")
                nch = num_channels
                if nch is None:
                    nch = bi.num_color_channels + (1 if bi.alpha_bits
                                                   else 0)
                fmt = JxlPixelFormat(nch, jxl_type, JXL_LITTLE_ENDIAN, 0)
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                sz = ctypes.c_size_t()
                if _jxl.JxlDecoderImageOutBufferSize(
                        dec, ctypes.byref(fmt), ctypes.byref(sz)) != 0:
                    raise RefJxlError("ImageOutBufferSize failed")
                out = np.empty(sz.value, dtype=np.uint8)
                if _jxl.JxlDecoderSetImageOutBuffer(
                        dec, ctypes.byref(fmt),
                        out.ctypes.data_as(ctypes.c_void_p),
                        sz.value) != 0:
                    raise RefJxlError("SetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                frames.append(out.view(np_dtype).reshape(
                    bi.ysize, bi.xsize, fmt.num_channels).copy())
            elif status == JXL_DEC_SUCCESS:
                break
            else:
                raise RefJxlError(f"unexpected decoder status {status}")
        return frames
    finally:
        _jxl.JxlDecoderDestroy(dec)
