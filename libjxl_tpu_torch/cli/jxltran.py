"""jxltran: lossless .jxl transformations (container pack/extract).

Reference: tools/jxltran.cc — wraps a bare codestream into the ISOBMFF
container or strips the container down to the raw codestream, without
re-encoding any pixels. Usage:
    python -m libjxl_tpu_torch.cli.jxltran in.jxl out.jxl [--strip|--pack]

Copy of libjxl_tpu/cli/jxltran.py with imports rewritten to the port:
container boxes only, on the host.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jxltran", description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--strip", action="store_true",
                      help="container -> bare codestream")
    mode.add_argument("--pack", action="store_true",
                      help="bare codestream -> container")
    p.add_argument("--jxlp", type=int, default=0, metavar="N",
                   help="when packing, split codestream into N jxlp boxes")
    args = p.parse_args(argv)

    from libjxl_tpu_torch.container.boxes import (
        is_container, pack_container, unpack_container,
    )

    with open(args.input, "rb") as f:
        data = f.read()

    if args.strip or (not args.pack and is_container(data)):
        content = unpack_container(data)
        out = content.codestream
        print(f"extracted codestream: {len(out)} bytes"
              + (f" (+exif {len(content.exif)})" if content.exif else ""))
    else:
        codestream = unpack_container(data).codestream \
            if is_container(data) else data
        out = pack_container(codestream, split=args.jxlp)
        print(f"packed container: {len(out)} bytes "
              f"({len(codestream)} codestream)")

    with open(args.output, "wb") as f:
        f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
