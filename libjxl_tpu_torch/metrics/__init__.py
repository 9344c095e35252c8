"""Quality metrics: butteraugli.

Reference: lib/jxl/butteraugli/. Used by the encoder's quality loop
(effort 8 and above). The JAX package's metrics module also holds PSNR
and SSIMULACRA2, which the port's encoder does not use.
"""

from libjxl_tpu_torch.metrics.butteraugli import (  # noqa: F401
    butteraugli_diffmap, butteraugli_distance,
)

__all__ = ["butteraugli_diffmap", "butteraugli_distance"]
