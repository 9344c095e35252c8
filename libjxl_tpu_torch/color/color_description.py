"""Color-description string parser: "RGB_D65_SRG_Rel_SRG" etc.

Reference: lib/extras/dec/color_description.cc ParseDescription — the
cjxl `-x color_space=` hint format: underscore-separated tokens
ColorSpace_WhitePoint_Primaries_RenderingIntent_TransferFunction with
aliases ("sRGB", "DisplayP3", "Adobe98", "ProPhoto") and custom
"x;y"-pair chromaticities / "g<gamma>" transfer functions.
"""

from __future__ import annotations

from libjxl_tpu_torch.base.errors import JxlError
from libjxl_tpu_torch.color.color_encoding import (
    ColorEncoding, ColorSpace, Customxy, Primaries, RenderingIntent,
    TransferFunction, WhitePoint,
)

_ALIASES = {
    "sRGB": "RGB_D65_SRG_Rel_SRG",
    "DisplayP3": "RGB_D65_DCI_Rel_SRG",
    "Adobe98": "RGB_D65_Ado_Rel_Ado",
    "ProPhoto": "RGB_D50_Pro_Rel_Pro",
}

_COLOR_SPACES = {"RGB": ColorSpace.RGB, "Gra": ColorSpace.GRAY,
                 "XYB": ColorSpace.XYB, "CS?": ColorSpace.UNKNOWN}
_WHITE_POINTS = {"D65": WhitePoint.D65, "Cst": WhitePoint.CUSTOM,
                 "EER": WhitePoint.E, "DCI": WhitePoint.DCI}
_PRIMARIES = {"SRG": Primaries.SRGB, "Cst": Primaries.CUSTOM,
              "202": Primaries.BT2100, "DCI": Primaries.P3}
_INTENTS = {"Per": RenderingIntent.PERCEPTUAL,
            "Rel": RenderingIntent.RELATIVE,
            "Sat": RenderingIntent.SATURATION,
            "Abs": RenderingIntent.ABSOLUTE}
_TFS = {"709": TransferFunction.BT709, "TF?": TransferFunction.UNKNOWN,
        "Lin": TransferFunction.LINEAR, "SRG": TransferFunction.SRGB,
        "PeQ": TransferFunction.PQ, "DCI": TransferFunction.DCI,
        "HLG": TransferFunction.HLG}

GAMMA_MUL = 10_000_000


def _xy_pairs(token: str, n: int) -> list[float]:
    parts = token.split(";")
    if len(parts) != n:
        raise JxlError(f"expected {n} ';'-separated values: {token!r}")
    try:
        return [float(p) for p in parts]
    except ValueError as e:
        raise JxlError(f"bad number in {token!r}") from e


def parse_color_description(description: str) -> ColorEncoding:
    """ParseDescription (color_description.cc:251)."""
    if description in _ALIASES:
        description = _ALIASES[description]
    tokens = description.split("_")
    it = iter(tokens)

    def next_token(what):
        try:
            return next(it)
        except StopIteration:
            raise JxlError(f"missing {what} in {description!r}") from None

    ce = ColorEncoding()
    ce.all_default = False
    tok = next_token("color space")
    if tok not in _COLOR_SPACES:
        raise JxlError(f"unknown ColorSpace {tok!r}")
    ce.color_space = _COLOR_SPACES[tok]

    # White point (implicit D65 for XYB).
    if ce.color_space != ColorSpace.XYB:
        tok = next_token("white point")
        if tok in _WHITE_POINTS:
            ce.white_point = _WHITE_POINTS[tok]
        elif tok == "D50":
            ce.white_point = WhitePoint.CUSTOM
            ce.white = Customxy.from_float(0.345669, 0.358496)
        else:
            ce.white_point = WhitePoint.CUSTOM
            x, y = _xy_pairs(tok, 2)
            ce.white = Customxy.from_float(x, y)

    # Primaries (none for gray/XYB).
    if ce.has_primaries:
        tok = next_token("primaries")
        if tok in _PRIMARIES:
            ce.primaries = _PRIMARIES[tok]
        elif tok == "Ado":
            ce.primaries = Primaries.CUSTOM
            ce.red = Customxy.from_float(0.6400, 0.3300)
            ce.green = Customxy.from_float(0.2100, 0.7100)
            ce.blue = Customxy.from_float(0.1500, 0.0600)
        elif tok == "Pro":
            ce.primaries = Primaries.CUSTOM
            ce.red = Customxy.from_float(0.734699, 0.265301)
            ce.green = Customxy.from_float(0.159597, 0.840403)
            ce.blue = Customxy.from_float(0.036598, 0.000105)
        else:
            ce.primaries = Primaries.CUSTOM
            v = _xy_pairs(tok, 6)
            ce.red = Customxy.from_float(v[0], v[1])
            ce.green = Customxy.from_float(v[2], v[3])
            ce.blue = Customxy.from_float(v[4], v[5])

    tok = next_token("rendering intent")
    if tok not in _INTENTS:
        raise JxlError(f"unknown RenderingIntent {tok!r}")
    ce.rendering_intent = _INTENTS[tok]

    # Transfer function (implicit gamma 1/3 for XYB).
    if ce.color_space == ColorSpace.XYB:
        ce.tf.have_gamma = True
        ce.tf.gamma = round(GAMMA_MUL / 3)
    else:
        tok = next_token("transfer function")
        if tok in _TFS:
            ce.tf.have_gamma = False
            ce.tf.transfer_function = _TFS[tok]
        elif tok == "Ado":
            ce.tf.have_gamma = True
            ce.tf.gamma = round(GAMMA_MUL * 256.0 / 563.0)
        elif tok == "Pro":
            ce.tf.have_gamma = True
            ce.tf.gamma = round(GAMMA_MUL / 1.8)
        elif tok.startswith("g"):
            try:
                g = float(tok[1:])
            except ValueError as e:
                raise JxlError(f"invalid gamma {tok!r}") from e
            ce.tf.have_gamma = True
            ce.tf.gamma = round(GAMMA_MUL * g)
        else:
            raise JxlError(f"invalid transfer function {tok!r}")
    return ce


def describe_color_encoding(ce: ColorEncoding) -> str:
    """ColorEncoding Description (inverse; color_encoding Description)."""
    def rev(d, v, default="Cst"):
        for k, val in d.items():
            if val == v:
                return k
        return default

    parts = [rev(_COLOR_SPACES, ce.color_space)]
    if ce.color_space != ColorSpace.XYB:
        if ce.white_point == WhitePoint.CUSTOM:
            x, y = ce.white.as_float()
            parts.append(f"{x:g};{y:g}")
        else:
            parts.append(rev(_WHITE_POINTS, ce.white_point))
    if ce.has_primaries:
        if ce.primaries == Primaries.CUSTOM:
            vals = [*ce.red.as_float(), *ce.green.as_float(),
                    *ce.blue.as_float()]
            parts.append(";".join(f"{v:g}" for v in vals))
        else:
            parts.append(rev(_PRIMARIES, ce.primaries))
    parts.append(rev(_INTENTS, ce.rendering_intent, "Rel"))
    if ce.color_space != ColorSpace.XYB:
        if ce.tf.have_gamma:
            parts.append(f"g{ce.tf.gamma / GAMMA_MUL:g}")
        else:
            parts.append(rev(_TFS, ce.tf.transfer_function, "TF?"))
    return "_".join(parts)
