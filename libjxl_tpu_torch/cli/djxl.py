"""djxl: decode JPEG XL to PNG/PPM/NPY.

Reference: tools/djxl_main.cc. Usage:
    python -m libjxl_tpu_torch.cli.djxl input.jxl output.png [--device cpu]

Copy of libjxl_tpu/cli/djxl.py. Differences (reference line numbers):
- ``--device`` takes a torch device name (default ``cuda``; ``--device``
  alone is ``cuda``), where the reference's is a flag for its device
  route (:19-21, :72): ``decode`` and, for ``%d``/``{n}`` output,
  ``decode_all`` run there, and without a card they raise unless
  ``--device cpu`` is given (the reference's animation branch, :50,
  decodes on the host). ``--low-memory`` and JPEG reconstruction run
  on the host, as in the reference;
- PIL is imported only in the animation branch (:28), its one user, so
  ``.npy``, PNM, PFM, PGX, EXR and 16-bit RGB(A) PNG output need no PIL.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="djxl", description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   help="torch device of the decode pipeline (dequant + "
                        "IDCT + loop filters + color); default cuda")
    p.add_argument("--low-memory", action="store_true",
                   help="row-streamed decode bounded to O(group-row) "
                        "memory (low_memory_render_pipeline analogue)")
    args = p.parse_args(argv)

    import numpy as np

    from libjxl_tpu_torch.api import decode

    with open(args.input, "rb") as f:
        data = f.read()
    if args.output.lower().endswith((".jpg", ".jpeg")):
        # JPEG reconstruction from a transcoded JXL (djxl --jpeg).
        from libjxl_tpu_torch.container.boxes import is_container
        from libjxl_tpu_torch.extras.jpeg_transcode import (
            reconstruct_jpeg, transcode_jxl_to_jpeg)
        t0 = time.time()
        out = reconstruct_jpeg(data) if is_container(data) \
            else transcode_jxl_to_jpeg(data)
        with open(args.output, "wb") as f:
            f.write(out)
        print(f"Reconstructed {len(out)} byte JPEG in "
              f"{time.time() - t0:.2f}s", file=sys.stderr)
        return 0
    if "%d" in args.output or "{n}" in args.output:
        # Animation: write every frame (djxl out_%d.png).
        from PIL import Image

        from libjxl_tpu_torch.api import decode_all
        t0 = time.time()
        frames, meta = decode_all(data, device=args.device)
        for i, fr in enumerate(frames):
            path = args.output.replace("{n}", str(i))
            if "%d" in path:
                path = path % i
            arr = fr.pixels
            if arr.ndim == 3 and arr.shape[2] == 1:
                arr = arr[:, :, 0]
            Image.fromarray(arr).save(path)
        print(f"Decoded {len(frames)} frames in {time.time() - t0:.2f}s",
              file=sys.stderr)
        return 0
    t0 = time.time()
    if args.low_memory:
        from libjxl_tpu_torch.frame.low_memory import decode_low_memory
        chunks = {}
        h, w = decode_low_memory(
            data, lambda y0, rows: chunks.__setitem__(y0, rows))
        arr = np.concatenate([chunks[k] for k in sorted(chunks)], axis=0)
        dt = time.time() - t0
    else:
        res = decode(data, device=args.device)
        dt = time.time() - t0
        arr = res.pixels
    mp = arr.shape[0] * arr.shape[1] / 1e6
    print(f"Decoded {arr.shape[1]}x{arr.shape[0]} image in {dt:.2f}s "
          f"({mp / dt:.3f} MP/s)", file=sys.stderr)
    if args.output.endswith(".npy"):
        np.save(args.output, arr)
    else:
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        # Codec registry picks the writer from the extension: PNG keeps
        # 16-bit (incl. RGB48 via the in-tree PNG writer), PNM/PGX/EXR
        # are the native coders (extras/codecs.py).
        from libjxl_tpu_torch.extras.codecs import codec_from_path, save_image
        codec = codec_from_path(args.output)
        if codec == "exr" and arr.dtype != np.float32:
            arr = arr.astype(np.float32) / \
                (65535.0 if arr.dtype == np.uint16 else 255.0)
        save_image(arr, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
