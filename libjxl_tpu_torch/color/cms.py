"""Color management over the system lcms2 (like the reference's
jxl_cms, lib/jxl/cms/jxl_cms.cc which runs skcms/lcms2 underneath).

Provides:
  * ICC synthesis for enum color encodings (primaries/white point/
    transfer function -> ICC bytes), the analogue of
    ColorEncoding::CreateICC / MaybeCreateProfile;
  * arbitrary ICC-to-ICC pixel transforms (DoColorSpaceTransform).

Falls back gracefully (available() == False) when liblcms2 is absent.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lcms = None
for _name in ("liblcms2.so.2", "liblcms2.so"):
    try:
        _lcms = ctypes.CDLL(_name)
        break
    except OSError:
        continue


def available() -> bool:
    return _lcms is not None


# lcms2.h pixel-type macro expansion: TYPE_RGB_FLT
_TYPE_RGB_FLT = (1 << 22) | (4 << 16) | (3 << 3) | 4
INTENT_PERCEPTUAL = 0
INTENT_RELATIVE_COLORIMETRIC = 1


class _CIExyY(ctypes.Structure):
    _fields_ = [("x", ctypes.c_double), ("y", ctypes.c_double),
                ("Y", ctypes.c_double)]


class _CIExyYTRIPLE(ctypes.Structure):
    _fields_ = [("Red", _CIExyY), ("Green", _CIExyY), ("Blue", _CIExyY)]


if _lcms is not None:
    _lcms.cmsOpenProfileFromMem.restype = ctypes.c_void_p
    _lcms.cmsOpenProfileFromMem.argtypes = [ctypes.c_char_p,
                                            ctypes.c_uint32]
    _lcms.cmsCloseProfile.argtypes = [ctypes.c_void_p]
    _lcms.cmsCreateTransform.restype = ctypes.c_void_p
    _lcms.cmsCreateTransform.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32]
    _lcms.cmsDeleteTransform.argtypes = [ctypes.c_void_p]
    _lcms.cmsDoTransform.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_uint32]
    _lcms.cmsCreateRGBProfile.restype = ctypes.c_void_p
    _lcms.cmsCreateRGBProfile.argtypes = [
        ctypes.POINTER(_CIExyY), ctypes.POINTER(_CIExyYTRIPLE),
        ctypes.POINTER(ctypes.c_void_p)]
    _lcms.cmsBuildGamma.restype = ctypes.c_void_p
    _lcms.cmsBuildGamma.argtypes = [ctypes.c_void_p, ctypes.c_double]
    _lcms.cmsBuildParametricToneCurve.restype = ctypes.c_void_p
    _lcms.cmsBuildParametricToneCurve.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
    _lcms.cmsBuildTabulatedToneCurveFloat.restype = ctypes.c_void_p
    _lcms.cmsBuildTabulatedToneCurveFloat.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)]
    _lcms.cmsFreeToneCurve.argtypes = [ctypes.c_void_p]
    _lcms.cmsSaveProfileToMem.restype = ctypes.c_int
    _lcms.cmsSaveProfileToMem.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    _lcms.cmsCreate_sRGBProfile.restype = ctypes.c_void_p


def _tone_curve(tf) -> ctypes.c_void_p:
    """lcms tone curve for a jxl CustomTransferFunction."""
    from libjxl_tpu_torch.color.color_encoding import TransferFunction as TF
    if tf.have_gamma:
        return _lcms.cmsBuildGamma(None, 1.0 / max(tf.gamma, 1e-7))
    t = tf.transfer_function
    if t == int(TF.LINEAR):
        return _lcms.cmsBuildGamma(None, 1.0)
    if t == int(TF.SRGB):
        params = (ctypes.c_double * 5)(2.4, 1 / 1.055, 0.055 / 1.055,
                                       1 / 12.92, 0.04045)
        return _lcms.cmsBuildParametricToneCurve(None, 4, params)
    if t == int(TF.BT709):
        params = (ctypes.c_double * 5)(1 / 0.45, 1 / 1.099, 0.099 / 1.099,
                                       1 / 4.5, 0.081)
        return _lcms.cmsBuildParametricToneCurve(None, 4, params)
    if t == int(TF.DCI):
        return _lcms.cmsBuildGamma(None, 2.6)
    # PQ / HLG: tabulated EOTF (display-relative), 4096 entries.
    from libjxl_tpu_torch.color.transfer_functions import (
        hlg_display_from_encoded, pq_display_from_encoded)
    xs = np.linspace(0.0, 1.0, 4096)
    if t == int(TF.PQ):
        ys = pq_display_from_encoded(xs, 10000.0)
    elif t == int(TF.HLG):
        ys = hlg_display_from_encoded(xs)
    else:
        raise ValueError(f"unsupported transfer function {t}")
    table = np.clip(ys, 0.0, 1.0).astype(np.float32)
    return _lcms.cmsBuildTabulatedToneCurveFloat(
        None, 4096, table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def synthesize_icc(color_encoding) -> bytes:
    """ICC profile bytes for an enum ColorEncoding (the jxl_cms
    MaybeCreateProfile analogue, built through lcms2)."""
    if _lcms is None:
        raise RuntimeError("liblcms2 not available")
    wx, wy = color_encoding.white_point_xy()
    (rx, ry), (gx, gy), (bx, by) = color_encoding.primaries_xy()
    wp = _CIExyY(wx, wy, 1.0)
    prim = _CIExyYTRIPLE(_CIExyY(rx, ry, 1.0), _CIExyY(gx, gy, 1.0),
                         _CIExyY(bx, by, 1.0))
    curve = _tone_curve(color_encoding.tf)
    curves = (ctypes.c_void_p * 3)(curve, curve, curve)
    prof = _lcms.cmsCreateRGBProfile(ctypes.byref(wp), ctypes.byref(prim),
                                     curves)
    if not prof:
        _lcms.cmsFreeToneCurve(curve)
        raise RuntimeError("cmsCreateRGBProfile failed")
    try:
        size = ctypes.c_uint32(0)
        _lcms.cmsSaveProfileToMem(prof, None, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        if not _lcms.cmsSaveProfileToMem(prof, buf, ctypes.byref(size)):
            raise RuntimeError("cmsSaveProfileToMem failed")
        return buf.raw[:size.value]
    finally:
        _lcms.cmsCloseProfile(prof)
        _lcms.cmsFreeToneCurve(curve)


def srgb_icc() -> bytes:
    """The lcms built-in sRGB profile, serialized."""
    if _lcms is None:
        raise RuntimeError("liblcms2 not available")
    prof = _lcms.cmsCreate_sRGBProfile()
    try:
        size = ctypes.c_uint32(0)
        _lcms.cmsSaveProfileToMem(prof, None, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        _lcms.cmsSaveProfileToMem(prof, buf, ctypes.byref(size))
        return buf.raw[:size.value]
    finally:
        _lcms.cmsCloseProfile(prof)


def convert_pixels(pixels: np.ndarray, src_icc: bytes, dst_icc: bytes,
                   intent: int = INTENT_RELATIVE_COLORIMETRIC,
                   ) -> np.ndarray:
    """(H, W, 3) float32 pixels in src_icc -> dst_icc
    (jxl_cms.cc DoColorSpaceTransform)."""
    if _lcms is None:
        raise RuntimeError("liblcms2 not available")
    src = _lcms.cmsOpenProfileFromMem(src_icc, len(src_icc))
    dst = _lcms.cmsOpenProfileFromMem(dst_icc, len(dst_icc))
    if not src or not dst:
        raise ValueError("invalid ICC profile")
    try:
        # cmsFLAGS_HIGHRESPRECALC: accuracy over speed (matches the
        # reference's use of lcms for correctness-critical conversion).
        xf = _lcms.cmsCreateTransform(src, _TYPE_RGB_FLT, dst,
                                      _TYPE_RGB_FLT, intent, 0x0400)
        if not xf:
            raise ValueError("cmsCreateTransform failed")
        try:
            inp = np.ascontiguousarray(pixels, np.float32)
            out = np.empty_like(inp)
            n = inp.shape[0] * inp.shape[1]
            _lcms.cmsDoTransform(xf, inp.ctypes.data_as(ctypes.c_void_p),
                                 out.ctypes.data_as(ctypes.c_void_p), n)
            return out
        finally:
            _lcms.cmsDeleteTransform(xf)
    finally:
        _lcms.cmsCloseProfile(src)
        _lcms.cmsCloseProfile(dst)


# lcms2.h TYPE_CMYK_FLT: FLOAT_SH(1)|COLORSPACE_SH(PT_CMYK)|CHANNELS_SH(4)|BYTES_SH(4)
_TYPE_CMYK_FLT = (1 << 22) | (6 << 16) | (4 << 3) | 4


def icc_is_cmyk(icc: bytes) -> bool:
    """ICC header data color space signature == 'CMYK' (the check
    jxl_cms.cc:1044 does via skcms data_color_space)."""
    return len(icc) >= 20 and icc[16:20] == b"CMYK"


def convert_cmyk_pixels(pixels: np.ndarray, src_icc: bytes,
                        dst_icc: bytes,
                        intent: int = INTENT_RELATIVE_COLORIMETRIC,
                        ) -> np.ndarray:
    """(H, W, 4) JXL-convention CMYK (1.0 = white / no ink) in src_icc
    -> (H, W, 3) RGB in dst_icc. Mirrors jxl_cms.cc:260: lcms wants
    0 = white, 100 = max ink, so samples map via 100 - 100*v."""
    if _lcms is None:
        raise RuntimeError("liblcms2 not available")
    src = _lcms.cmsOpenProfileFromMem(src_icc, len(src_icc))
    dst = _lcms.cmsOpenProfileFromMem(dst_icc, len(dst_icc))
    if not src or not dst:
        raise ValueError("invalid ICC profile")
    try:
        xf = _lcms.cmsCreateTransform(src, _TYPE_CMYK_FLT, dst,
                                      _TYPE_RGB_FLT, intent, 0x0400)
        if not xf:
            raise ValueError("cmsCreateTransform failed (CMYK)")
        try:
            inp = 100.0 - 100.0 * np.ascontiguousarray(pixels, np.float32)
            inp = np.ascontiguousarray(inp, np.float32)
            h, w = inp.shape[:2]
            out = np.empty((h, w, 3), np.float32)
            _lcms.cmsDoTransform(xf, inp.ctypes.data_as(ctypes.c_void_p),
                                 out.ctypes.data_as(ctypes.c_void_p),
                                 h * w)
            return out
        finally:
            _lcms.cmsDeleteTransform(xf)
    finally:
        _lcms.cmsCloseProfile(src)
        _lcms.cmsCloseProfile(dst)


def cmyk_to_rgb_naive(pixels: np.ndarray) -> np.ndarray:
    """Profile-less composite for JXL-convention CMYK (1.0 = white):
    rgb = stored_cmy * stored_k (equivalent to (1-C)(1-K) in ink
    fractions)."""
    return np.clip(pixels[..., :3] * pixels[..., 3:4], 0.0, 1.0)
