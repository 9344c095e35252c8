"""Public API of the port (libjxl_tpu.api's one-shot layer; the
streaming encoder object lives in api/encoder.py)."""

from libjxl_tpu_torch.api.simple import (  # noqa: F401
    DecodeResult, FrameResult, decode, decode_all, encode, encode_animation,
    encode_streaming,
)


def decode_low_memory(data, callback):
    """Row-streaming decode with O(group-row) peak memory, on the host;
    see frame/low_memory.py (low_memory_render_pipeline analogue)."""
    from libjxl_tpu_torch.frame.low_memory import decode_low_memory as _impl
    return _impl(data, callback)


__all__ = ["decode", "encode", "decode_all", "encode_animation",
           "encode_streaming", "decode_low_memory", "DecodeResult",
           "FrameResult"]
