"""libjxl_tpu_torch: the PyTorch/CUDA port of libjxl_tpu.

The host side (container, headers, entropy coding, the encoder's
heuristics, the native C++ library) is a copy of the JAX package's host
modules; the device side (dequant, IDCT, loop filters, output transfer,
and the encoder's adaptive quant, AC-strategy search, forward DCTs, CfL
fit and quantization) is PyTorch, with the gaborish + EPF chain as a
hand-written CUDA kernel for Hopper. The port imports nothing of
``jax`` or ``libjxl_tpu``.

Entry points, all on ``cuda`` unless the caller passes another device
(and raising when there is no card):
- ``encode(image)`` -> codestream bytes, the VarDCT stages on the
  device (the JAX package's ``encode(image, device=True)``);
- ``decode(data)`` -> ``DecodeResult`` (pixels on the host, as the JAX
  package's ``decode(data, device=True)``) and ``decode_all(data)`` ->
  the displayed frames of an animation, blended on the device;
- ``decode_device(data, out="pq16")`` -> a (3, H, W) tensor on the
  device, for the single VarDCT frames of the feed path;
- ``DecodePipeline`` and ``decode_batch`` for sustained decode.
"""

from libjxl_tpu_torch.api.simple import (  # noqa: F401
    DecodeResult, FrameResult, decode, decode_all, encode,
)
from libjxl_tpu_torch.tpu.batch_decode import (  # noqa: F401
    DecodePipeline, decode_batch, decode_device, parse_to_feed,
)

__all__ = ["DecodePipeline", "DecodeResult", "FrameResult", "decode",
           "decode_all", "decode_batch", "decode_device", "encode",
           "parse_to_feed"]
__version__ = "0.1.0"
