"""Encodes the BASELINE-config-5 bench corpus: three 3840x2160 16-bit
HDR images and a 1920x1080 crop of the first, at distance 1, effort 5,
PQ, progressive, EPF 3.

    python -m libjxl_tpu_torch.tools.gen_bench_corpus [0|1|2|1080p] \
        [--out DIR] [--device cpu]

The content is deterministic (fixed rng seeds), so the streams are
reproducible on one device.

Port of tools/gen_bench_corpus.py: ``make_image`` is the reference's,
bit for bit. Differences (reference line numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card): the port's ``encode`` runs its VarDCT stages there,
  where the reference encodes on the host (:59, :77);
- the streams are written to ``--out`` (a git-ignored directory by
  default), never to ``bench_corpus/`` (:21): the committed corpus is
  an earlier encoder's output and is not rewritten;
- with no image named, each image is encoded in a subprocess, as in the
  reference (:92-99), with the same ``--out`` and ``--device``.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

from libjxl_tpu_torch.tools import ROOT, default_out

N_IMAGES = 3
W4K, H4K = 3840, 2160
SETTINGS = dict(distance=1.0, effort=5, hdr="pq", progressive=True, epf=3)


def make_image(i):
    """Photographic-style 4K test content (smooth multi-frequency bands
    + sensor noise). All trig terms are separable, computed from 1-D
    axes and combined by outer product/broadcast — elementwise trig on
    full 4K float64 grids is slow on the host.
    """
    rng = np.random.default_rng(7 + i)
    xs = np.arange(W4K, dtype=np.float64)
    ys = np.arange(H4K, dtype=np.float64)
    chans = []
    for c in range(3):
        f1, f2 = 29 + 10 * i + 7 * c, 41 + 6 * i + 5 * c
        sx = np.sin(xs / f1 + c)
        cy = np.cos(ys / f2 + i)
        # sin((x+y)/s) = sin(x/s)cos(y/s) + cos(x/s)sin(y/s)
        s = float(f1 + f2)
        sxy = (np.outer(np.cos(ys / s), np.sin(xs / s))
               + np.outer(np.sin(ys / s), np.cos(xs / s)))
        base = (0.28 + 0.22 * cy[:, None] * sx[None, :] + 0.10 * sxy
                + rng.normal(0, 0.012, (H4K, W4K)))
        chans.append(base)
    img = np.clip(np.stack(chans, axis=-1), 0.0, 0.9)
    return np.round(img * 65535.0).astype(np.uint16)


def _encode(img, name, out, device):
    from libjxl_tpu_torch.api.simple import encode
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    stream = encode(img, device=device, **SETTINGS)
    path = os.path.join(out, name)
    with open(path, "wb") as f:
        f.write(stream)
    print(f"{path}: {len(stream)} bytes in {time.time()-t0:.1f}s",
          flush=True)
    return path


def encode_one(i, out, device=None):
    img16 = make_image(i)
    print(f"image {i} generated", flush=True)
    return _encode(img16, f"4k_hdr_pq_d1_e5_prog_epf3_{i}.jxl", out,
                   device)


def encode_1080p(out, device=None):
    """1080p stream with the same profile (a crop of image 0)."""
    img = np.ascontiguousarray(make_image(0)[:1080, :1920])
    return _encode(img, "1080p_hdr_pq_d1_e5_prog_epf3.jxl", out, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image", nargs="?", choices=("0", "1", "2", "1080p"))
    p.add_argument("--out", default=default_out("gen_bench_corpus"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the encoder's VarDCT stages "
                        "(default cuda)")
    args = p.parse_args(argv)
    if args.image == "1080p":
        encode_1080p(args.out, args.device)
    elif args.image is not None:
        encode_one(int(args.image), args.out, args.device)
    else:
        # One subprocess per image: a fresh process per encode avoids
        # allocator fragmentation at 4K sizes.
        for which in [str(i) for i in range(N_IMAGES)] + ["1080p"]:
            subprocess.run([sys.executable, "-m", __spec__.name, which,
                            "--out", os.path.abspath(args.out),
                            "--device", args.device], check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
