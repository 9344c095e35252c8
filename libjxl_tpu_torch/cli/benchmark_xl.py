"""benchmark_xl: multi-codec compression benchmark harness.

Reference: tools/benchmark/benchmark_xl.cc — runs a list of codec
configurations over an image corpus and reports BPP, encode/decode
speed, Max norm (butteraugli), pnorm, SSIMULACRA2 and PSNR per codec,
plus corpus aggregates (geometric means, like benchmark_xl's
aggregate row). Codec specs:

    jxl:d1.0        lossy VarDCT at distance 1.0
    jxl:d1.0:p      ... progressive
    jxl:lossless    lossless modular
    png / jpeg:q85 / webp:q80   via PIL (comparison codecs)

Usage:
    python -m libjxl_tpu_torch.cli.benchmark_xl --input 'dir/*.png' \
        --codec jxl:d1.0,jxl:d3.0,jpeg:q85 [--device cpu]

Copy of libjxl_tpu/cli/benchmark_xl.py. Differences (reference line
numbers):
- ``--device`` (new) takes a torch device name (default ``cuda``;
  ``--device`` alone is ``cuda``): ``_run_jxl`` passes it to the port's
  ``encode`` and ``decode`` (:45, :47), so the lossy codecs raise
  without a card unless ``--device cpu`` is given. ``jxl:lossless``
  runs on the host, as ``cjxl`` does for it, and needs no card.
  ``run_codec`` takes the device as a third argument. Both calls return
  host data, so the ``perf_counter`` window around each covers the
  card's work;
- PIL is imported only where a format needs it (:94): the inputs are
  read by ``extras/codecs.py:load_rgb8``, so PNM and PFM inputs need
  no PIL, and the comparison codecs (png, jpeg, webp) raise
  ``ImportError`` without it.
"""

from __future__ import annotations

import argparse
import glob
import io
import sys
import time

import numpy as np


def _run_jxl(img, spec, device):
    from libjxl_tpu_torch.api import decode, encode
    parts = spec.split(":")[1:]
    kwargs = {}
    for p in parts:
        if p.startswith("d"):
            kwargs["distance"] = float(p[1:])
        elif p == "lossless":
            kwargs["lossless"] = True
        elif p == "p":
            kwargs["progressive"] = True
        elif p.startswith("r"):
            kwargs["resampling"] = int(p[1:])
        elif p.startswith("e"):
            kwargs["effort"] = int(p[1:])
    if kwargs.get("lossless"):
        # The lossless encode runs on the host and uses no device.
        device = "cpu"
    t0 = time.perf_counter()
    data = encode(img, device=device, **kwargs)
    t1 = time.perf_counter()
    out = decode(data, device=device).pixels
    t2 = time.perf_counter()
    return data, out, t1 - t0, t2 - t1


def _run_pil(img, spec):
    from PIL import Image
    fmt, *opts = spec.split(":")
    quality = 85
    for o in opts:
        if o.startswith("q"):
            quality = int(o[1:])
    buf = io.BytesIO()
    pil = Image.fromarray(img)
    t0 = time.perf_counter()
    if fmt == "png":
        pil.save(buf, "PNG", optimize=True)
    elif fmt == "jpeg":
        pil.save(buf, "JPEG", quality=quality)
    elif fmt == "webp":
        pil.save(buf, "WEBP", quality=quality)
    else:
        raise ValueError(f"unknown codec {fmt}")
    t1 = time.perf_counter()
    buf.seek(0)
    out = np.asarray(Image.open(buf).convert("RGB"))
    t2 = time.perf_counter()
    return buf.getvalue(), out, t1 - t0, t2 - t1


def run_codec(img, spec, device="cuda"):
    if spec.startswith("jxl"):
        return _run_jxl(img, spec, device)
    return _run_pil(img, spec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark_xl", description=__doc__)
    p.add_argument("--input", required=True,
                   help="glob of input images (png/jpg/...)")
    p.add_argument("--codec", default="jxl:d1.0",
                   help="comma-separated codec specs")
    p.add_argument("--no_metrics", action="store_true",
                   help="skip butteraugli/ssimulacra2 (faster)")
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   help="torch device of the JPEG XL encode and decode; "
                        "default cuda")
    args = p.parse_args(argv)

    from libjxl_tpu_torch.extras.codecs import load_rgb8

    files = sorted(glob.glob(args.input))
    if not files:
        print(f"no inputs match {args.input}", file=sys.stderr)
        return 1
    specs = args.codec.split(",")

    header = (f"{'codec':16s} {'bpp':>7s} {'E MP/s':>8s} {'D MP/s':>8s} "
              f"{'MaxNorm':>8s} {'pnorm':>7s} {'ssim2':>7s} {'psnr':>7s}")
    print(header)
    print("-" * len(header))
    for spec in specs:
        bpps, encs, decs, maxns, pnorms, ssims, psnrs = \
            [], [], [], [], [], [], []
        for f in files:
            img = load_rgb8(f)
            npix = img.shape[0] * img.shape[1]
            data, out, enc_t, dec_t = run_codec(img, spec, args.device)
            bpps.append(len(data) * 8 / npix)
            encs.append(npix / enc_t / 1e6)
            decs.append(npix / dec_t / 1e6)
            if not args.no_metrics:
                from libjxl_tpu_torch.metrics.butteraugli import (
                    butteraugli_distance, butteraugli_pnorm)
                from libjxl_tpu_torch.metrics import psnr, ssimulacra2
                d, dmap = butteraugli_distance(img, out[:, :, :3],
                                               return_diffmap=True)
                maxns.append(d)
                pnorms.append(butteraugli_pnorm(dmap))
                ssims.append(ssimulacra2(img, out[:, :, :3]))
                psnrs.append(psnr(img, out[:, :, :3]))

        def gm(v):
            v = np.maximum(np.asarray(v, np.float64), 1e-9)
            return float(np.exp(np.mean(np.log(v))))

        row = (f"{spec:16s} {gm(bpps):7.3f} {gm(encs):8.3f} "
               f"{gm(decs):8.3f}")
        if not args.no_metrics:
            row += (f" {gm(maxns):8.3f} {gm(pnorms):7.3f} "
                    f"{np.mean(ssims):7.2f} {np.mean(psnrs):7.2f}")
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
