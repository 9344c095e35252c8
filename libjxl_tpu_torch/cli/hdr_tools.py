"""HDR conversion tools: pq_to_hlg / tone_map / render_hlg.

Reference: tools/hdr/{pq_to_hlg,tone_map,render_hlg}.cc — PQ->HLG
conversion via Rec.2408 tone mapping + HLG inverse OOTF, PQ->SDR tone
mapping, and HLG rendering for a target display. I/O is 16-bit PNG
(PQ- or HLG-encoded) through PIL.

Usage:
    python -m libjxl_tpu_torch.cli.hdr_tools pq_to_hlg in.png out.png
    python -m libjxl_tpu_torch.cli.hdr_tools tone_map in.png out.png -t 100
    python -m libjxl_tpu_torch.cli.hdr_tools render_hlg in.png out.png -t 400

Copy of libjxl_tpu/cli/hdr_tools.py with imports rewritten to the port:
float64 numpy on the host, as in the reference. The ``.npy`` paths
(:23-28, :40-43) need no PIL; PNG input and output use PIL, as there.
"""

from __future__ import annotations

import argparse
import sys

# BT.2020 luminance weights (used by the reference's tone mappers).
_LUM = (0.2627, 0.6780, 0.0593)


def _load(path):
    import numpy as np
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype.kind == "f":
            return arr[:, :, :3].astype(np.float64)
        maxv = float(np.iinfo(arr.dtype).max)
        return arr[:, :, :3].astype(np.float64) / maxv
    from PIL import Image
    arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, 2)
    maxv = 65535.0 if arr.dtype.kind == "u" and arr.itemsize == 2 else 255.0
    return arr[:, :, :3].astype(np.float64) / maxv


def _save(path, enc, bits=16):
    import numpy as np
    if path.endswith(".npy"):
        # Full-precision path (PIL has no 3x16-bit PNG writer).
        np.save(path, np.clip(enc, 0.0, 1.0).astype(np.float32))
        return
    from PIL import Image
    maxv = 255
    Image.fromarray(
        np.clip(np.round(enc * maxv), 0, maxv).astype(np.uint8)).save(path)


def pq_to_hlg(args) -> int:
    """tools/hdr/pq_to_hlg.cc: PQ -> tone map to 1000 nits -> HLG."""
    import numpy as np

    from libjxl_tpu_torch.color.transfer_functions import (
        hlg_encoded_from_display, hlg_inverse_ootf, hlg_ootf_gamma,
        pq_display_from_encoded, rec2408_tone_map)
    enc = _load(args.input)
    nits = pq_display_from_encoded(enc, 10000.0) * 10000.0
    src_max = args.max_nits or float(
        (nits * np.asarray(_LUM)).sum(-1).max()) or 10000.0
    display = rec2408_tone_map(
        nits / src_max, source_range=(0.0, src_max),
        target_range=(0.0, 1000.0))
    scene = hlg_inverse_ootf(np.clip(display, 0, 1),
                             hlg_ootf_gamma(1000.0))
    _save(args.output, hlg_encoded_from_display(scene))
    return 0


def tone_map(args) -> int:
    """tools/hdr/tone_map.cc: PQ -> SDR sRGB at target_nits."""
    import numpy as np

    from libjxl_tpu_torch.color.transfer_functions import (
        pq_display_from_encoded, rec2408_tone_map)
    from libjxl_tpu_torch.color.xyb import linear_to_srgb
    enc = _load(args.input)
    nits = pq_display_from_encoded(enc, 10000.0) * 10000.0
    src_max = args.max_nits or float(
        (nits * np.asarray(_LUM)).sum(-1).max()) or 10000.0
    sdr = rec2408_tone_map(
        nits / src_max, source_range=(0.0, src_max),
        target_range=(0.0, args.target_nits))
    _save(args.output,
          linear_to_srgb(np.clip(sdr, 0, 1).transpose(2, 0, 1)
                         ).transpose(1, 2, 0), bits=8)
    return 0


def render_hlg(args) -> int:
    """tools/hdr/render_hlg.cc: HLG scene -> display at target_nits ->
    sRGB-encoded output."""
    import numpy as np

    from libjxl_tpu_torch.color.transfer_functions import (
        hlg_display_from_encoded, hlg_ootf, hlg_ootf_gamma)
    from libjxl_tpu_torch.color.xyb import linear_to_srgb
    enc = _load(args.input)
    scene = hlg_display_from_encoded(enc)
    display = hlg_ootf(scene, hlg_ootf_gamma(args.target_nits))
    _save(args.output,
          linear_to_srgb(np.clip(display, 0, 1).transpose(2, 0, 1)
                         ).transpose(1, 2, 0), bits=8)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hdr_tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("pq_to_hlg")
    p1.add_argument("input")
    p1.add_argument("output")
    p1.add_argument("-m", "--max_nits", type=float, default=0.0)
    p1.add_argument("-s", "--preserve_saturation", type=float, default=0.1)
    p1.set_defaults(fn=pq_to_hlg)

    p2 = sub.add_parser("tone_map")
    p2.add_argument("input")
    p2.add_argument("output")
    p2.add_argument("-t", "--target_nits", type=float, default=100.0)
    p2.add_argument("-m", "--max_nits", type=float, default=0.0)
    p2.add_argument("-s", "--preserve_saturation", type=float, default=0.1)
    p2.set_defaults(fn=tone_map)

    p3 = sub.add_parser("render_hlg")
    p3.add_argument("input")
    p3.add_argument("output")
    p3.add_argument("-t", "--target_nits", type=float, default=400.0)
    p3.set_defaults(fn=render_hlg)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
