"""Runs the conformance corpus: every .jxl must decode to its golden
.npy within the manifest's limits (reference: conformance.py).

    python -m libjxl_tpu_torch.tools.conformance.run_corpus [corpus_dir] \
        [--device cpu]

``corpus_dir`` defaults to ``generate_corpus``'s default ``--out``.

Port of tools/conformance/run_corpus.py. Differences (reference line
numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card): ``decode`` and ``decode_all`` run there (:26-28);
- a golden is ``<case>.npy`` in floats in [0, 1] (the reference
  generator's goldens) or ``<case>.npz`` holding ``golden`` in the
  decoded integer dtype, normalised by the dtype's maximum (the port's
  generator; :31);
- ``run`` returns each case's result for callers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from libjxl_tpu_torch.tools import default_out
from libjxl_tpu_torch.tools.conformance.conformance import load_reference


def load_golden(corpus: str, name: str) -> np.ndarray:
    """The golden of case ``name``, normalised to [0, 1]."""
    path = os.path.join(corpus, name + ".npz")
    if not os.path.exists(path):
        path = os.path.join(corpus, name + ".npy")
    return load_reference(path)


def decoded_pixels(data: bytes, animation: bool, device=None) -> np.ndarray:
    """The pixels a case is judged on: the last composed frame of an
    animation, else the decoded image."""
    from libjxl_tpu_torch.api import decode, decode_all
    if animation:
        return decode_all(data, device=device)[0][-1].pixels
    return decode(data, device=device).pixels


def run(corpus: str, device=None) -> list:
    """[(name, ok, rmse, peak)] for every case of the manifest, in name
    order."""
    with open(os.path.join(corpus, "manifest.json")) as f:
        manifest = json.load(f)
    results = []
    for name, limits in sorted(manifest.items()):
        with open(os.path.join(corpus, name + ".jxl"), "rb") as f:
            data = f.read()
        arr = decoded_pixels(data, bool(limits.get("animation")), device)
        maxval = 255 if arr.dtype == np.uint8 else 65535
        got = arr.astype(np.float64) / maxval
        ref = load_golden(corpus, name)
        diff = got - ref
        rmse = float(np.sqrt((diff ** 2).mean()))
        peak = float(np.abs(diff).max())
        # float32 golden storage leaves ~1e-7 quantization noise
        ok = rmse <= limits["rmse"] + 1e-6 and \
            peak <= limits["peak"] + 1e-6
        results.append((name, ok, rmse, peak))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("corpus", nargs="?",
                   default=default_out("conformance_corpus"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the decodes (default cuda)")
    args = p.parse_args(argv)
    failures = 0
    for name, ok, rmse, peak in run(args.corpus, args.device):
        print(f"{'PASS' if ok else 'FAIL'} {name}: rmse={rmse:.6f} "
              f"peak={peak:.6f}")
        failures += not ok
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
