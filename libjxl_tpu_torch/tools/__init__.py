"""The repository's tools over the port (reference: the root ``tools/``
directory, which drives ``libjxl_tpu``), each run as
``python -m libjxl_tpu_torch.tools.<name>``:

- ``conformance.conformance`` / ``run_corpus`` / ``generate_corpus``:
  the conformance checker and its corpus, with libjxl goldens where the
  system libjxl is installed;
- ``profile_device``: the per-stage device profile of
  ``decode_frame_device2``;
- ``microbench``: host benches and, with ``--device``, the device
  decode;
- ``rd_table``: the rate-distortion table against the system libjxl;
- ``interop_sweep``: the randomized differential sweep against it;
- ``fuzz_hunt`` over ``fuzz_targets`` (the decoder entry points under
  fuzz and the stream they mutate);
- ``gen_bench_corpus``: the 4K HDR bench corpus.

A tool that touches the device takes ``--device``, a torch device name
(``cuda`` by default; raises without a card, so pass ``--device cpu``
there). A tool writes only under its ``--out`` directory, which defaults
to ``torch_tools_out/<tool>`` at the repository's root (git-ignored).
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_out(tool: str) -> str:
    """The default ``--out`` directory of ``tool``."""
    return os.path.join(ROOT, "torch_tools_out", tool)
