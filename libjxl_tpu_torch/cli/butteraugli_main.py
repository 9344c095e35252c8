"""butteraugli_main: psychovisual distance between two images.

Reference: tools/butteraugli_main.cc. Usage:
    python -m libjxl_tpu_torch.cli.butteraugli_main orig.png distorted.png
       [--pnorm P] [--intensity_target N]

Copy of libjxl_tpu/cli/butteraugli_main.py. Host numpy, as in the
reference. Difference: PIL is not imported here; the images are read by
``extras/codecs.py:load_rgb8``, so PNM and PFM inputs need no PIL and
other formats go through PIL as in the reference.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="butteraugli", description=__doc__)
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--pnorm", type=float, default=None,
                   help="also print the p-norm of the diffmap")
    p.add_argument("--intensity_target", type=float, default=80.0)
    args = p.parse_args(argv)

    from libjxl_tpu_torch.extras.codecs import load_rgb8
    from libjxl_tpu_torch.metrics.butteraugli import (
        butteraugli_distance, butteraugli_pnorm,
    )

    a = load_rgb8(args.image1)
    b = load_rgb8(args.image2)
    score, dmap = butteraugli_distance(
        a, b, intensity_target=args.intensity_target, return_diffmap=True)
    print(f"{score:.8f}")
    if args.pnorm is not None:
        print(f"{args.pnorm}-norm: {butteraugli_pnorm(dmap, args.pnorm):.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
