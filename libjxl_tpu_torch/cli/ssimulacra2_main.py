"""ssimulacra2: perceptual quality score between two images.

Reference: tools/ssimulacra2_main.cc. Usage:
    python -m libjxl_tpu_torch.cli.ssimulacra2_main orig.png distorted.png

Copy of libjxl_tpu/cli/ssimulacra2_main.py. Host numpy, as in the
reference. Difference: PIL is not imported here; the images are read by
``extras/codecs.py:load_rgb8``, so PNM and PFM inputs need no PIL and
other formats go through PIL as in the reference.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssimulacra2", description=__doc__)
    p.add_argument("original")
    p.add_argument("distorted")
    args = p.parse_args(argv)

    from libjxl_tpu_torch.extras.codecs import load_rgb8

    from libjxl_tpu_torch.metrics import ssimulacra2

    a = load_rgb8(args.original)
    b = load_rgb8(args.distorted)
    if a.shape != b.shape:
        print("image size mismatch", file=sys.stderr)
        return 1
    print(f"{ssimulacra2(a, b):.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
