"""Quality metrics: PSNR, max abs error, SSIMULACRA2, butteraugli.

Reference: lib/extras/metrics.{h,cc}, tools/ssimulacra2.cc,
lib/jxl/butteraugli/. Used by the encoder's quality loop (butteraugli,
effort 8 and above) and by the command-line tools (``benchmark_xl``,
``butteraugli_main``, ``ssimulacra2_main``). All are host numpy, as in
the JAX package.
"""

from libjxl_tpu_torch.metrics.butteraugli import (  # noqa: F401
    butteraugli_diffmap, butteraugli_distance,
)
from libjxl_tpu_torch.metrics.simple import max_abs_error, psnr
from libjxl_tpu_torch.metrics.ssimulacra2 import ssimulacra2

__all__ = ["psnr", "max_abs_error", "ssimulacra2", "butteraugli_diffmap",
           "butteraugli_distance"]
