"""Microbenchmarks for the hot kernels (gbench analogue:
dct_gbench.cc, tf_gbench.cc, splines_gbench.cc,
dec_external_image_gbench.cc):

    python -m libjxl_tpu_torch.tools.microbench [--device [DEVICE]]

Prints one line per kernel: name, items/s, per-call latency. The host
benches run numpy and the native C++; ``--device`` adds the device
decode of a 1024x1024 stream through ``decode_frame_device2``.

Port of tools/microbench.py: the same benches and names. Differences
(reference line numbers):
- ``--device`` takes a torch device name (``cuda`` when given alone;
  raises without a card), where the reference's is a flag for JAX's
  default backend (:184-186). The device bench's name ends in the
  device type, ``device decode (cuda)`` (:139), and each timed run ends
  in ``torch.cuda.synchronize`` on a card (:136);
- the host decodes go through the port's host decoder, the
  event-driven ``Decoder`` run to ``FULL_IMAGE`` (the port's ``decode``
  runs VarDCT frames on a torch device; :62, :73, :90), and the host
  benches' inputs are encoded by the port's ``encode`` on the CPU, the
  device bench's on ``--device`` (:54, :66, :83, :98, :150);
- ``run`` returns each bench's (name, best seconds).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _bench(out: list, name: str, fn, items: float, unit: str, *,
           reps: int = 5, warmup: int = 1):
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    rate = items / best
    print(f"{name:<34} {rate / 1e6:10.2f} M{unit}/s   {best * 1e3:8.3f} ms")
    out.append((name, best))


def _encode(img, **kw):
    from libjxl_tpu_torch.api.simple import encode
    return encode(img, device="cpu", **kw)


def _host_decode(data: bytes):
    """One-shot host decode (the reference's ``decode(data)``)."""
    from libjxl_tpu_torch.api.decoder import Decoder, Event
    dec = Decoder(events={Event.FULL_IMAGE})
    dec.set_input(data)
    dec.close_input()
    ev = dec.process_input()
    if ev != Event.FULL_IMAGE:
        raise RuntimeError(f"host decode ended in {ev.name}")
    return dec.image


def bench_dct(out):
    from libjxl_tpu_torch.vardct.dct import dct_matrix
    rng = np.random.default_rng(0)
    n = 16384
    blocks = rng.normal(size=(n, 8, 8)).astype(np.float32)
    m8 = dct_matrix(8)

    def run():
        np.einsum("ui,nij,wj->nuw", m8, blocks, m8, optimize=True)
    _bench(out, "dct8x8 batched einsum", run, n * 64, "coeff")


def bench_ans_decode(out):
    rng = np.random.default_rng(1)
    img = np.clip(rng.normal(128, 30, (512, 512, 3)),
                  0, 255).astype(np.uint8)
    data = _encode(img, distance=1.0, effort=5)
    _bench(out, "vardct full host decode (512^2)",
           lambda: _host_decode(data), 512 * 512, "pix")


def bench_modular_decode(out):
    rng = np.random.default_rng(2)
    img = np.clip(rng.normal(128, 30, (512, 512, 3)),
                  0, 255).astype(np.uint8)
    data = _encode(img, lossless=True, effort=1)
    _bench(out, "modular lossless decode (512^2)",
           lambda: _host_decode(data), 512 * 512, "pix")


def bench_fast_lossless(out):
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:1024, 0:1024]
    img = np.clip((128 + 90 * np.sin(x / 31) * np.cos(y / 41))[..., None]
                  + rng.normal(0, 5, (1024, 1024, 3)), 0,
                  255).astype(np.uint8)
    data = _encode(img, lossless=True, effort=1)

    def enc():
        _encode(img, lossless=True, effort=1)
    _bench(out, "fast-lossless e1 encode (1 MPix)", enc, 1024 * 1024,
           "pix")
    _bench(out, "fast-lossless e1 decode (1 MPix)",
           lambda: _host_decode(data), 1024 * 1024, "pix")


def bench_low_memory(out):
    from libjxl_tpu_torch.frame.low_memory import decode_low_memory
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(128, 30, (768, 768, 3)),
                  0, 255).astype(np.uint8)
    data = _encode(img, distance=1.0, effort=5)

    def run():
        decode_low_memory(data, lambda y0, rows: None)
    _bench(out, "low-memory row-streamed decode (768^2)", run, 768 * 768,
           "pix")


def bench_transfer_functions(out):
    from libjxl_tpu_torch.color.transfer_functions import (
        pq_display_from_encoded, pq_encoded_from_display)
    from libjxl_tpu_torch.color.xyb import linear_to_srgb, srgb_to_linear
    x = np.random.default_rng(3).random((1024, 1024)).astype(np.float32)
    _bench(out, "srgb_to_linear", lambda: srgb_to_linear(x), x.size, "px")
    _bench(out, "linear_to_srgb", lambda: linear_to_srgb(x), x.size, "px")
    _bench(out, "pq eotf", lambda: pq_display_from_encoded(x), x.size,
           "px")
    _bench(out, "pq inv-eotf", lambda: pq_encoded_from_display(x),
           x.size, "px")


def bench_epf(out):
    from libjxl_tpu_torch.frame.frame_header import LoopFilter
    from libjxl_tpu_torch.pipeline.loop_filters import epf1
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 512, 512)).astype(np.float32)
    sig = np.full((64, 64), 2.0, np.float32)
    lf = LoopFilter()
    _bench(out, "epf1 (5x5, 512^2)", lambda: epf1(img, lf, sig),
           512 * 512, "px")


def bench_splines(out):
    from libjxl_tpu_torch.frame.splines import (
        Splines, quantize_spline, render_splines)
    from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
    sp = Splines()
    sp.quantization_adjustment = 0
    for i in range(8):
        color_dct = np.zeros((3, 32), np.float64)
        color_dct[1, 0] = 1.0
        sigma_dct = np.zeros(32, np.float64)
        sigma_dct[0] = 4.0
        cps = [(10.0 + 25.0 * j, 10.0 + 28.0 * i + 3.0 * j)
               for j in range(5)]
        sp.splines.append(quantize_spline(cps, color_dct, sigma_dct,
                                          0, 0.0, 1.0))
        sp.starting_points.append(cps[0])
    img = np.zeros((3, 256, 256), np.float32)

    def run():
        render_splines(sp, img.copy(), ColorCorrelation())
    _bench(out, "splines render (8 strokes)", run, 256 * 256, "px")


def bench_device(out, device):
    import torch

    from libjxl_tpu_torch.api.simple import encode
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.device import resolve_device
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    from libjxl_tpu_torch.tpu.pipeline import decode_frame_device2
    dev = resolve_device(device)
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(128, 30, (1024, 1024, 3)),
                  0, 255).astype(np.uint8)
    data = encode(img, distance=1.0, effort=5, device=dev)
    r = BitReader(data)
    meta = read_codestream_headers(r)
    feed = decode_frame(r, meta, device="feed").feed

    def run():
        decode_frame_device2(feed, 1024, 1024, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    _bench(out, f"device decode ({dev.type})", run, 1024 * 1024, "pix",
           warmup=2)


HOST_BENCHES = (bench_dct, bench_transfer_functions, bench_epf,
                bench_splines, bench_ans_decode, bench_modular_decode,
                bench_fast_lossless, bench_low_memory)


def run(device=None) -> list:
    """Runs the host benches and, when ``device`` is given, the device
    decode; returns [(name, best seconds)] in the order printed."""
    out: list = []
    for bench in HOST_BENCHES:
        bench(out)
    if device is not None:
        bench_device(out, device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="microbench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", nargs="?", const="cuda", default=None,
                   help="also run the device decode on this torch device "
                        "(cuda when given alone)")
    args = p.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
