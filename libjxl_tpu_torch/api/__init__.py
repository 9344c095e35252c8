"""Public API of the port (libjxl_tpu.api without the animation and
streaming encoders)."""

from libjxl_tpu_torch.api.simple import (  # noqa: F401
    DecodeResult, FrameResult, decode, decode_all, encode,
)

__all__ = ["encode", "decode", "decode_all", "DecodeResult", "FrameResult"]
