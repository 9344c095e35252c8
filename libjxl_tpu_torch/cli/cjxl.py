"""cjxl: encode PNG/PPM/JPEG images to JPEG XL.

Reference: tools/cjxl_main.cc. Usage:
    python -m libjxl_tpu_torch.cli.cjxl input.ppm output.jxl [-d DIST] [-q Q]
        [--device cpu]

Copy of libjxl_tpu/cli/cjxl.py. Differences (reference line numbers):
- ``--device`` takes a torch device name (default ``cuda``; ``--device``
  alone is ``cuda``), where the reference's is a flag for its device
  route (:53-55, :110): the VarDCT stages of a lossy encode (and the
  decode of a JXL input) run there, and without a card they raise
  unless ``--device cpu`` is given. JPEG transcoding and the lossless
  and modular modes run on the host, as in the reference, and need no
  card;
- PIL is not imported (:60): input goes through ``load_image``, so PNM,
  PFM, PGX, EXR and JPEG input need no PIL; PNG, GIF and the other PIL
  formats still need it.
"""

from __future__ import annotations

import argparse
import sys
import time


def quality_to_distance(quality: float) -> float:
    """encode.h:1522 JxlEncoderDistanceFromQuality."""
    if quality >= 100:
        return 0.0
    if quality >= 30:
        return 0.1 + (100 - quality) * 0.09
    return 53.0 / 3000.0 * quality * quality - 23.0 / 20.0 * quality + 25.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cjxl", description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-d", "--distance", type=float, default=1.0,
                   help="butteraugli distance target (0 = lossless)")
    p.add_argument("-q", "--quality", type=float, default=None,
                   help="quality 0-100 (100 = lossless)")
    p.add_argument("-e", "--effort", type=int, default=7,
                   help="encoder effort 1-9 (<=3 fast-lossless; >=8 "
                        "butteraugli-guided quantization)")
    p.add_argument("--lossless", action="store_true")
    p.add_argument("-m", "--modular", action="store_true",
                   help="modular mode (lossless at -d 0; responsive "
                        "squeeze-quantized at -d > 0)")
    p.add_argument("-p", "--progressive", action="store_true",
                   help="progressive (multi-pass) encoding")
    p.add_argument("--resampling", type=int, default=1, choices=[1, 2, 4, 8],
                   help="encode at 1/N resolution with decoder upsampling")
    p.add_argument("--photon_noise", default=None,
                   help="'auto' or a LUT strength in [0,1] to synthesize "
                        "film grain")
    p.add_argument("--dots", action="store_true",
                   help="detect isolated dots and encode them as patches")
    p.add_argument("--container", action="store_true",
                   help="wrap the codestream in an ISOBMFF container")
    p.add_argument("-x", "--dec-hints", action="append", default=[],
                   metavar="key=value",
                   help="decoder hints, e.g. color_space="
                        "RGB_D65_SRG_Rel_SRG (lossless only)")
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   help="torch device of the VarDCT compute stage "
                        "(adaptive quant, ACS search, DCT, CfL, "
                        "quantization); default cuda")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from libjxl_tpu_torch.api import encode

    hints = dict(h.split("=", 1) for h in args.dec_hints if "=" in h)
    distance = args.distance
    if args.quality is not None:
        distance = quality_to_distance(args.quality)
    lossless = args.lossless or distance == 0

    if args.input.lower().endswith((".jpg", ".jpeg")) \
            and not args.lossless and args.distance == 1.0:
        # JPEG input: coefficient-preserving transcode (cjxl -j default)
        from libjxl_tpu_torch.extras.jpeg_transcode import (
            transcode_jpeg_container)
        from libjxl_tpu_torch.extras.jpeg_parser import JpegError
        try:
            with open(args.input, "rb") as f:
                jdata = f.read()
            t0 = time.time()
            out = transcode_jpeg_container(jdata)
            dt = time.time() - t0
            with open(args.output, "wb") as f:
                f.write(out)
            print(f"Transcoded {len(jdata)} byte JPEG to {len(out)} "
                  f"bytes ({len(out) / len(jdata):.2%}) in {dt:.2f}s",
                  file=sys.stderr)
            return 0
        except JpegError as e:
            print(f"coefficient transcode unavailable ({e}); "
                  f"re-encoding pixels", file=sys.stderr)

    # Codec registry: PNG/JPEG/GIF via PIL, PNM/PGX/EXR native
    # (extras/codecs.py; lib/extras/dec/decode.h facade).
    from libjxl_tpu_torch.extras.codecs import load_image
    loaded = load_image(args.input, device=args.device)
    arr = loaded.pixels
    if loaded.float_samples:
        arr = np.clip(arr, 0.0, 1.0)
    elif arr.ndim == 3 and arr.shape[2] == 4 and not args.lossless:
        arr = arr[:, :, :3]

    noise = args.photon_noise
    if noise not in (None, "auto"):
        noise = float(noise)
    # Lossless and modular encodes run on the host and use no device.
    device = "cpu" if lossless or args.modular else args.device
    t0 = time.time()
    data = encode(arr, distance=distance, lossless=lossless,
                  effort=args.effort, progressive=args.progressive,
                  resampling=args.resampling, noise=noise,
                  dots=args.dots, container=args.container,
                  modular=args.modular, device=device,
                  color_encoding=hints.get("color_space"))
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    mp = arr.shape[0] * arr.shape[1] / 1e6
    bpp = len(data) * 8 / (arr.shape[0] * arr.shape[1])
    print(f"Compressed {arr.shape[1]}x{arr.shape[0]} image to "
          f"{len(data)} bytes ({bpp:.3f} bpp) in {dt:.2f}s "
          f"({mp / dt:.3f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
