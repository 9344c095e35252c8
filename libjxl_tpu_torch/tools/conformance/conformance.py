"""Conformance checker: decode .jxl files and compare against reference
.npy images (reference: tools/conformance/conformance.py CompareNPY —
per-frame max-channel RMSE and peak absolute error limits, ISO 18181-3
style).

Usage:
    python -m libjxl_tpu_torch.tools.conformance.conformance check \
        input.jxl ref.npy [--rmse 0.001] [--peak 0.005] [--device cpu]
    python -m libjxl_tpu_torch.tools.conformance.conformance decode \
        input.jxl out.npy [--device cpu]

Port of tools/conformance/conformance.py. Differences (reference line
numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card): the port's ``decode`` runs there (:22);
- ``check`` decodes in memory and writes no temporary file (:62);
- the reference image may be a ``.npy`` array or a ``.npz`` holding
  ``golden`` (the port's corpus), and an integer one is normalised by
  its dtype's maximum, as the decoded pixels are.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def normalised(arr: np.ndarray) -> np.ndarray:
    """Integer pixels as float32 in [0, 1] (by the dtype's maximum);
    float pixels unchanged."""
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) / np.iinfo(arr.dtype).max
    return arr


def load_reference(path: str) -> np.ndarray:
    """A reference image (``.npy``, or ``.npz`` holding ``golden``),
    normalised."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return normalised(z["golden"])
    return normalised(np.load(path))


def decode(data: bytes, device=None) -> np.ndarray:
    """The port's decode of ``data`` on ``device``, normalised."""
    from libjxl_tpu_torch.api import decode as decode_api
    return normalised(decode_api(data, device=device).pixels)


def decode_to_npy(jxl_path: str, npy_path: str, device=None) -> np.ndarray:
    with open(jxl_path, "rb") as f:
        arr = decode(f.read(), device)
    np.save(npy_path, arr)
    return arr


def compare(decoded: np.ndarray, reference: np.ndarray,
            rmse_limit: float, peak_limit: float) -> tuple[bool, str]:
    if decoded.shape != reference.shape:
        return False, (f"shape mismatch {decoded.shape} vs "
                       f"{reference.shape}")
    diff = decoded.astype(np.float64) - reference.astype(np.float64)
    # Per-channel RMSE, take the worst channel (CompareNPY semantics).
    rmse = np.sqrt(np.mean(diff ** 2, axis=(0, 1)))
    peak = np.abs(diff).max()
    ok = rmse.max() <= rmse_limit and peak <= peak_limit
    msg = (f"max-channel RMSE {rmse.max():.6f} (limit {rmse_limit}), "
           f"peak error {peak:.6f} (limit {peak_limit})")
    return ok, msg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pd = sub.add_parser("decode")
    pd.add_argument("input")
    pd.add_argument("output")
    pc = sub.add_parser("check")
    pc.add_argument("input")
    pc.add_argument("reference")
    pc.add_argument("--rmse", type=float, default=0.001)
    pc.add_argument("--peak", type=float, default=0.005)
    for sp in (pd, pc):
        sp.add_argument("--device", default="cuda",
                        help="torch device of the decode (default cuda)")
    args = p.parse_args(argv)

    if args.cmd == "decode":
        arr = decode_to_npy(args.input, args.output, args.device)
        print(f"decoded {arr.shape} -> {args.output}")
        return 0
    with open(args.input, "rb") as f:
        decoded = decode(f.read(), args.device)
    reference = load_reference(args.reference)
    ok, msg = compare(decoded, reference, args.rmse, args.peak)
    print(("PASS: " if ok else "FAIL: ") + msg)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
