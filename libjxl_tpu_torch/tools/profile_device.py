"""Per-stage device profile of the v2 decode pipeline.

Times each stage of ``decode_frame_device2`` on its own on a
bench-corpus feed, plus the transfer and dispatch costs, so kernel work
is attacked by measurement instead of guesswork.

    python -m libjxl_tpu_torch.tools.profile_device [--stream PATH] \
        [--reps N] [--device cpu]

Prints one JSON line per stage, ``{"stage": name, "ms": best time,
...}``, in the reference's order: ``parse_to_feed`` (host), the full
``decode_frame_device2(out="pq16")``, staging the frame's bytes and a
4-byte copy (the round-trip floor), the sparse scatter, ``decode_xyb2``
with all classes, with the 8x8 family only and the big classes by
difference, gaborish alone and EPF with 1, 2 and 3 iterations (the
loop-filter kernel through ``ops/epf_cuda.py`` on a card, its plain
version on the CPU), ``xyb_to_pq16`` and ``xyb_to_srgb8``, the
device-resident chain (coefficients -> PQ16 with no transfer) and the
full path's overhead over that chain.

Port of tools/profile_device.py. Differences (reference line numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card). A stage's time is the best of ``--reps`` runs after
  a warm-up, by CUDA events around the run on a card and by
  ``perf_counter`` on the CPU, where the reference takes the host clock
  around ``block_until_ready`` (:21-31);
- PyTorch runs eagerly, so each stage is the port's function called on
  tensors already on the device, not a jitted program (:91-182);
  gaborish and the EPF passes run through the kernel's wrapper, not
  ``filters_tpu`` (:151-160);
- the stream defaults to ``bench_corpus/``'s first 4K stream (:50-55),
  and each stage is a JSON line (``profile`` returns them).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from libjxl_tpu_torch.tools import ROOT

# The stages in the order they print (the reference's lines).
STAGES = ("parse_to_feed", "full_decode_frame_device2", "stage_bytes",
          "copy_4_bytes", "sparse_scatter", "decode_xyb2_all_classes",
          "decode_xyb2_8x8_family", "big_classes_by_difference",
          "gaborish", "epf_iters_1", "epf_iters_2", "epf_iters_3",
          "xyb_to_pq16", "xyb_to_srgb8", "device_resident_chain",
          "overhead_full_minus_chain")


def timeit(fn, reps: int, dev: torch.device) -> float:
    """Best time of ``reps`` runs of ``fn`` after one warm-up, seconds:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def default_stream() -> str:
    cands = sorted(glob.glob(os.path.join(ROOT, "bench_corpus",
                                          "4k_*.jxl")))
    if not cands:
        raise SystemExit("no bench_corpus stream; pass --stream")
    return cands[0]


def profile(data: bytes, device=None, reps: int = 5) -> list:
    """The stage lines of one stream: [{"stage": name, "ms": t, ...}],
    in ``STAGES`` order (``sparse_scatter`` only for a sparse feed)."""
    from libjxl_tpu_torch.device import _stage, feed_to_torch, resolve_device
    from libjxl_tpu_torch.ops import epf_cuda
    from libjxl_tpu_torch.ops.decode_torch import xyb_to_pq16, xyb_to_srgb8
    from libjxl_tpu_torch.tpu.batch_decode import parse_to_feed
    from libjxl_tpu_torch.tpu.pipeline import (
        decode_frame_device2, decode_xyb2, dense_coefficients,
        loop_filter_params,
    )

    dev = resolve_device(device)
    lines = []

    def stage(name, seconds, **extra):
        lines.append({"stage": name, "ms": seconds * 1e3, **extra})

    t0 = time.perf_counter()
    feed = parse_to_feed(data)
    t_parse = time.perf_counter() - t0
    H, W = feed["image_hw"]
    mpix = H * W / 1e6
    lf = feed["lf"]
    nz = feed.get("coeff_nz")
    stage("parse_to_feed", t_parse, clock="host", bytes=len(data),
          width=W, height=H, mpix_s=mpix / t_parse,
          coeff_shape=list(feed["coeff_img"].shape),
          classes=[list(k) for k in sorted(feed["classes"])],
          nnz=None if nz is None else int(nz[0].size),
          gab=bool(lf.gab), epf_iters=int(lf.epf_iters))

    # --- end-to-end reference point ---------------------------------
    def full():
        return decode_frame_device2(feed, H, W, out="pq16", device=dev)
    t_full = timeit(full, reps, dev)
    stage("full_decode_frame_device2", t_full, mpix_s=mpix / t_full)

    # --- transfer cost ----------------------------------------------
    total_b = (nz[0].nbytes + nz[1].nbytes if nz is not None
               else feed["coeff_img"].nbytes) \
        + feed["dc"].nbytes + 6 * feed["mat_ids"].size
    buf = np.zeros(max(total_b, 1 << 20), np.uint8)
    t_put = timeit(lambda: _stage(buf, dev), reps, dev)
    stage("stage_bytes", t_put, bytes=buf.nbytes,
          gb_s=buf.nbytes / t_put / 1e9)
    tiny = np.zeros(4, np.uint8)
    stage("copy_4_bytes", timeit(lambda: _stage(tiny, dev), reps, dev))

    # --- device-resident stage timings ------------------------------
    t = feed_to_torch(feed, dev)
    if nz is not None:
        stage("sparse_scatter", timeit(lambda: dense_coefficients(t),
                                       reps, dev), nnz=int(nz[0].size))
    coeff = dense_coefficients(t)

    def xyb_fn(big=True):
        return decode_xyb2(
            coeff, t["mat_ids"], t["raw_quant"], t["dc"], t["fx"], t["fb"],
            t["inv_gs"], t["qmul"], t["tables8"], t["mat_bank"],
            t["big_tables"] if big else {},
            t.get("classes") if big else None, t["biases"],
            t["BW_blocks"],
            class_masks=t.get("class_masks") if big else None,
            class_consts=t["class_consts"])
    t_xyb = timeit(xyb_fn, reps, dev)
    stage("decode_xyb2_all_classes", t_xyb)
    xyb = xyb_fn()[:, :H, :W].contiguous()
    t_xyb8 = timeit(lambda: xyb_fn(big=False), reps, dev)
    stage("decode_xyb2_8x8_family", t_xyb8)
    stage("big_classes_by_difference", t_xyb - t_xyb8)

    sig = t["inv_sigma"]
    stage("gaborish", timeit(lambda: epf_cuda.apply_loop_filters(
        xyb, sig, epf_iters=0, gab=True), reps, dev))
    for ei in (1, 2, 3):
        stage(f"epf_iters_{ei}", timeit(
            lambda ei=ei: epf_cuda.apply_loop_filters(
                xyb, sig, epf_iters=ei, gab=False), reps, dev))
    stage("xyb_to_pq16", timeit(lambda: xyb_to_pq16(xyb), reps, dev))
    stage("xyb_to_srgb8", timeit(lambda: xyb_to_srgb8(xyb), reps, dev))

    # Device-resident full chain (no transfer).
    lfp = loop_filter_params(lf)

    def chain():
        x = xyb_fn()[:, :H, :W].contiguous()
        if lfp["gab"] or lfp["epf_iters"] > 0:
            x = epf_cuda.apply_loop_filters(x, sig, **lfp)
        return xyb_to_pq16(x)
    t_chain = timeit(chain, reps, dev)
    stage("device_resident_chain", t_chain, mpix_s=mpix / t_chain)
    stage("overhead_full_minus_chain", t_full - t_chain)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stages (default cuda)")
    args = ap.parse_args(argv)
    path = args.stream or default_stream()
    with open(path, "rb") as f:
        data = f.read()
    print(json.dumps({"stream": path, "device": args.device}), flush=True)
    for line in profile(data, args.device, args.reps):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
