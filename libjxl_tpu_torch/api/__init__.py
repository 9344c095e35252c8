"""Public decode API of the port (the decode half of libjxl_tpu.api)."""

from libjxl_tpu_torch.api.simple import (  # noqa: F401
    DecodeResult, FrameResult, decode, decode_all,
)

__all__ = ["decode", "decode_all", "DecodeResult", "FrameResult"]
