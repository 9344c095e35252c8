#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libjxl_tpu_torch) on one NVIDIA
card: builds the native host library and the CUDA kernel from the
sources, holds the kernel against its plain PyTorch version (single
frames, batches, custom loop-filter weights), decodes the committed HDR
corpus (1080p and three 3840x2160 frames) bitstream -> PQ16 through
``decode_device``, checks the result against the plain CPU path, and
times the host parse, the device decode, sustained throughput and the
kernel. Then the post-stage path: the committed streams of
tests/torch_corpus (a 1080p frame upsampled 2x to 3840x2160 with photon
noise, and a 1080p frame with spline strokes) decoded on the card and
timed stage by stage; the batched path: ``DecodePipeline`` at
``batch=1`` and ``batch=3`` on the 1080p stream, as bench.py's 1080p
phases run it; and the public decode API (``decode``, ``decode_all``)
on the card against its CPU route: a 4K HDR stream to 16-bit PQ, 1080p
screen content with patches and a reference frame, a 720p RGBA
animation blended on the card and a lossless 1024x768 image with two
spot colours, each timed as host parse, device and host tail. Last, the
encoder (``encode``): bench.py's 1024x1024 test photo at d1 e5 and e7 on
the card against its CPU route, timed and split into host before the
stages, stage pre, stage B, the copy back and the host after; and the
HDR corpus image 0 at 1920x1080 and at 3840x2160 encoded on the card,
held against the committed streams and, stage by stage, against the
same stages run on the CPU. Last, the last device modules: the sharded
decode step (``parallel.make_sharded_decode2``) on a (1, 1) mesh of
NCCL ranks (one card: world size 1) over the three 4K corpus streams at
once, against ``decode_device``, with the kernel on the halo-extended
batch held against its plain version and timed; the v1 path
(``entry()``, ``decode_frame_device`` on the 1080p and a 4K stream's v1
feeds) and the v0 group decode, against the CPU and the v2 decode.
Last, the command line and the rest of the encode API (``cli_path``):
``cjxl`` of the 1024x1024 photo as a PPM on the card and on the CPU,
held to the encoder's gates; ``python -m libjxl_tpu_torch.cli.djxl`` of
a 4K corpus stream to a 16-bit PNG in a fresh process and ``djxl`` to
``.npy`` in this one, both identical to ``decode()`` on the card;
``djxl --low-memory`` (host) within 1 LSB of ``djxl`` on the card; the
committed JPEG transcoded by ``cjxl`` and reconstructed by ``djxl`` byte
for byte; ``encode_streaming`` (two chunks on the host, and one
single-group image on the card) and ``Encoder`` on the card, each byte
for byte its reference run. Last, the rest of the JAX package's tools
(``tools_path``) on bench.py's photo: ``benchmark_xl`` with its JPEG XL
encode and decode on the card (a warm-up, a timed run with the metrics,
then ``--device cpu``), held to the encoder's gates against the CPU;
the event-driven ``Decoder`` (host) over the card's progressive stream
in 64 KiB chunks, within 1 LSB of ``decode()`` on the card;
``jxlinfo`` of the 720p animation and the 1080p stream; ``jxltran
--pack`` and ``--strip`` back to the same codestream; the two metric
tools against the metric functions; ``hdr_tools tone_map`` of the 4K
PQ16 array ``djxl`` wrote; ``fast_lossless_encode`` decoded back
exactly; and the system libjxl's decode of the card's stream where it
is installed. These two phases run with PIL made unimportable, as on a
machine without it. Then the repository's tools
(``conformance_path``, ``libjxl_tpu_torch.tools``): ``run_corpus`` of the
committed conformance corpus (tests/torch_corpus/conformance/: 28
streams, with goldens from the system libjxl where it decoded them)
decoded on the card, every libjxl golden within the manifest's limits
(the one self golden, the port's own CPU decode of a PQ stream, is
reported, and where the card misses it the frame's XYB must be within
1e-4 of the CPU's); ``profile_device`` on 4K stream 0, one JSON line
per stage (the scatter, coefficients -> XYB
with all classes and with the 8x8 family alone, gaborish and EPF 1/2/3
through the kernel, the two tails, the device-resident chain and the
full path's overhead over it); ``microbench`` with its device decode on
the card; and, where the system libjxl is installed, ``rd_table`` and
``interop_sweep`` at one image and one distance (else ``"refjxl":
false``). Last, the decoder's error contract on the card
(``robustness_path``): the 40 files of tests/corpus/ and the seeded
byte-flip and truncation sweeps of ``fuzz_targets.valid_stream()``
through ``decode``, ``decode_all`` and ``decode_device``; each decodes
or raises ``JxlError`` (``decode_device`` may also refuse a frame its
feed route does not carry, with the documented NotImplementedError), no
feed is staged with an out-of-range index, and after it the CUDA
context still synchronises and the kernel still matches its plain
version within 2e-6. It runs last, so that a device-side assert there
poisons no later phase.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-only [--baseline SRC]

Prints one JSON line per phase, the card's name and power limit as
nvidia-smi gives them, a ``kernels`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA device, when any phase fails, or when the run exceeds
its time budget.

``--kernel-only`` builds only the kernel, runs the kernel-vs-plain phase
and times the kernel on synthetic frames (a 4K frame, a batch of three
1080p frames and the sharded step's halo-extended batch of three
2160x3856 frames) and each of its seven instances on the 4K frame, and
ends with a ``kernel_only_done`` line instead of the ``ok`` line. With
``--baseline SRC`` it also builds SRC, another version of csrc/epf.cu
(for example the parent commit's, from ``git show``, in the git-ignored
``libjxl_tpu_torch/_build/``), holds it bit for bit against the kernel
and times the two in turns in the same call:

    git show HEAD:libjxl_tpu_torch/csrc/epf.cu \
        > libjxl_tpu_torch/_build/epf_parent.cu
    python3 chip_smoke.py --kernel-only \
        --baseline libjxl_tpu_torch/_build/epf_parent.cu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "bench_corpus")
POST_CORPUS = os.path.join(ROOT, "tests", "torch_corpus")
FILE_1080P = "1080p_hdr_pq_d1_e5_prog_epf3.jxl"
FILES_4K = [f"4k_hdr_pq_d1_e5_prog_epf3_{i}.jxl" for i in range(3)]
FILE_UP2 = "4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl"
FILE_SPLINES = "1080p_splines_d1.jxl"
FILE_PATCHES = "1080p_screen_patches_d1_e7.jxl"
FILE_ANIM = "720p_anim4_rgba_blend_d1.jxl"
FILE_SPOT = "1024x768_spot2_lossless.jxl"
FILE_JPEG = "1024x768_photo_q85_420.jpg"
E2E_FRAMES, BATCH, BATCHED_FRAMES = 8, 3, 9   # as bench.py:317-349
BATCH_TOL = 1e-4        # a batched frame vs its single decode (XYB)
BUDGET_S = 900          # hard limit, builds included
KERNEL_TOL = 2e-6       # kernel vs plain version (reference's own bound)
XYB_TOL = 1e-4          # card vs CPU decode (port vs JAX tests' bound)
GROUP_TOL = 2e-4        # v0 group decode (tests/test_tpu_ops.py's bound)
SUSTAINED_DECODES = 12
ENC_SIZE, ENC_REPS = 1024, 3      # bench.py phase 4's image, timed encodes
ENC_LSB_TOL = 2                   # card vs CPU route, decoded by the port
QF_RTOL = 1e-5                    # quant field, card vs CPU stages
LSB8_TOL = 1                      # 8-bit output of two routes
STREAM_W, STREAM_H = 2500, 300    # encode_streaming: two DC-group chunks
# Share of the entries of each stage-B output that may differ between
# the card and the CPU on the same inputs. None differed on the 4K HDR
# frame. What can move one: the DCT products and the bit-cost and CfL
# sums are summed in another order by the card's BLAS and reductions
# than by the CPU's, so a value on a rounding, dead-zone or decision
# boundary may fall the other way.
ENC_STAGE_SHARE = {"strategies": 1e-4, "raw_quant": 1e-4, "qall": 1e-5,
                   "qdc": 1e-5, "ytox_map": 1e-4, "ytob_map": 1e-4,
                   "big_q": 1e-5}
# Shapes where the kernel's mirrored tables, sigma plane and field boxes
# meet the frame edge on both sides of one tile.
EDGE_SHAPES = ((1, 1), (5, 3), (7, 300), (300, 7), (33, 9))
STAGES = [(it, gab) for it in (0, 1, 2, 3) for gab in (True, False)
          if it or gab]

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

_phase = ["start"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _watchdog(t0: float) -> None:
    while True:
        time.sleep(1.0)
        if time.monotonic() - t0 > BUDGET_S:
            print(f"chip_smoke: time budget of {BUDGET_S} s exceeded in "
                  f"phase {_phase[0]!r}", file=sys.stderr, flush=True)
            os._exit(3)


def epf_operations_per_pixel(epf_iters: int, gab: bool) -> int:
    """FP32 operations per pixel of the loop-filter chain with each
    candidate's channel-scaled difference field shared by the plus taps
    (the least work; filters_tpu's formulation):
    gaborish 11 per channel; per candidate 3 x (sub, abs, mul) + 2 adds
    for the field, 4 adds for the plus sum (none single-pixel), then
    mul + add + max for the weight, 3 x (mul + add) to accumulate and
    1 add to the weight sum; per pass 1 mul for sigma and 3 divisions."""
    per_cand = 11 + 3 + 6 + 1
    ops = 33 if gab else 0
    if epf_iters >= 3:
        ops += 12 * (per_cand + 4) + 4
    if epf_iters >= 1:
        ops += 4 * (per_cand + 4) + 4
    if epf_iters >= 2:
        ops += 4 * per_cand + 4
    return ops


def bound_ms(h: int, w: int, bh: int, bw: int, epf_iters: int,
             gab: bool, n: int = 1):
    """Least time of the kernel on ``n`` frames of (3, h, w) with one
    (bh, bw) block map each."""
    nbytes = n * (2 * 3 * h * w * 4 + bh * bw * 4)
    ops = n * epf_operations_per_pixel(epf_iters, gab) * h * w
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def ptxas_summary(log: str) -> dict:
    """Registers, stack and spills per kernel instance from nvcc's
    ``-Xptxas -v`` messages, keyed ``gab<g>_iters<i>``."""
    out: dict = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"epf_kernelILi(\d)ELi(\d)E", ln)
        if m and ("entry function" in ln or "properties for" in ln):
            cur = out.setdefault(f"gab{m[1]}_iters{m[2]}", {})
        elif cur is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", ln)):
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        elif cur is not None and (m := re.search(r"Used (\d+) registers",
                                                 ln)):
            cur["registers"] = int(m[1])
    return out


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def read(name: str, corpus: str = CORPUS) -> bytes:
    with open(os.path.join(corpus, name), "rb") as f:
        return f.read()


def custom_loop_filter():
    """Custom gaborish weights, EPF channel scales and sigma parameters,
    written to a bitstream and read back as a decoder sees them."""
    from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
    from libjxl_tpu_torch.bitstream.fields import bundle_read, bundle_write
    from libjxl_tpu_torch.frame.frame_header import LoopFilter
    lf = LoopFilter(all_default=False, gab=True, gab_custom=True,
                    gab_x_weight1=0.09, gab_x_weight2=0.04,
                    gab_y_weight1=0.13, gab_y_weight2=0.07,
                    gab_b_weight1=0.1, gab_b_weight2=0.03,
                    epf_iters=3, epf_weight_custom=True,
                    epf_channel_scale=[32.0, 6.0, 2.5],
                    epf_sigma_custom=True, epf_quant_mul=0.55,
                    epf_pass0_sigma_scale=0.75, epf_pass2_sigma_scale=5.0,
                    epf_border_sad_mul=0.5)
    w = BitWriter()
    bundle_write(lf, w)
    w.align_to_byte()
    out = LoopFilter()
    bundle_read(BitReader(w.get_bytes()), out)
    return out


class ApiSplit:
    """Splits one ``decode``/``decode_all`` call of the port into host
    parse, device and host tail by wrapping the frame decode the API
    calls and the device decode the frame decode calls:
    - device: ``decode_frame_device2`` to its output complete on the card
      (host clock; staging, compute and post stages);
    - parse: the frame decodes less their device calls (entropy decode,
      the host stages of the frame, the XYB copy back to the host);
    - tail: the rest of the call (colour conversion, spot colours,
      blending, output pixels)."""

    def __init__(self, torch):
        from libjxl_tpu_torch.api import simple as api
        from libjxl_tpu_torch.tpu import pipeline
        self.torch, self.api, self.pipeline = torch, api, pipeline
        self.orig = api.decode_frame, pipeline.decode_frame_device2

    def run(self, fn, *args, **kw):
        torch = self.torch
        t = {"frames": 0.0, "device": 0.0}
        frame_fn, dev_fn = self.orig

        def frame(*a, **k):
            t0 = time.perf_counter()
            try:
                return frame_fn(*a, **k)
            finally:
                t["frames"] += time.perf_counter() - t0

        def device(*a, **k):
            t0 = time.perf_counter()
            out = dev_fn(*a, **k)
            if out.device.type == "cuda":
                torch.cuda.synchronize()
            t["device"] += time.perf_counter() - t0
            return out

        self.api.decode_frame = frame
        self.pipeline.decode_frame_device2 = device
        try:
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            self.api.decode_frame, self.pipeline.decode_frame_device2 = \
                self.orig
        return res, {"total_ms": total * 1e3,
                     "host_parse_ms": (t["frames"] - t["device"]) * 1e3,
                     "device_ms": t["device"] * 1e3,
                     "host_tail_ms": (total - t["frames"]) * 1e3}


def pq16_pixels(np, xyb):
    """The port API's output tail for a PQ stream, on the host: XYB ->
    linear (nits/255) -> PQ -> 16-bit codes, (H, W, 3)."""
    from libjxl_tpu_torch.color.transfer_functions import (
        pq_encoded_from_display,
    )
    from libjxl_tpu_torch.color.xyb import xyb_to_linear_rgb
    pq = pq_encoded_from_display(xyb_to_linear_rgb(xyb)
                                 * (255.0 / 10000.0)).astype(np.float32)
    return np.clip(np.round(pq * 65535), 0, 65535).astype(
        np.uint16).transpose(1, 2, 0)


def frame_xyb(data: bytes, device):
    """The XYB of the last frame of a single-frame stream from the port's
    frame decode on ``device``."""
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    r = BitReader(data)
    return decode_frame(r, read_codestream_headers(r), device=device).xyb


def api_path(torch, np, epf_cuda, smi):
    """The public decode API at full size, on the card and on its CPU
    route. Returns the EPF launches of the card runs (counted from 0
    just before them)."""
    import libjxl_tpu_torch
    split = ApiSplit(torch)

    def diff(a, b) -> int:
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    streams = [("hdr", FILES_4K[0], read(FILES_4K[0]), (2160, 3840, 3)),
               ("patches", FILE_PATCHES, read(FILE_PATCHES, POST_CORPUS),
                (1080, 1920, 3)),
               ("spot", FILE_SPOT, read(FILE_SPOT, POST_CORPUS),
                (768, 1024, 3)),
               ("animation", FILE_ANIM, read(FILE_ANIM, POST_CORPUS),
                (720, 1280, 4))]
    # Warm-up on the card (the constant banks, cuBLAS), not counted.
    libjxl_tpu_torch.decode(streams[1][2])
    epf_cuda.launches = 0
    card, launches, timing = {}, {}, {}
    for key, _, data, _ in streams:
        before = epf_cuda.launches
        if key == "animation":
            card[key], timing[key] = split.run(libjxl_tpu_torch.decode_all,
                                               data)
        else:
            card[key], timing[key] = split.run(libjxl_tpu_torch.decode,
                                               data)
        launches[key] = epf_cuda.launches - before
    total_launches = epf_cuda.launches
    if launches["hdr"] != 1 or launches["patches"] != 1:
        raise AssertionError(f"EPF launches per stream {launches}: the "
                             "VarDCT frames with loop filters take one")
    rows = []
    for key, name, data, shape in streams:
        row = {"stream": key, "file": name, "epf_launches": launches[key],
               "card_split_ms": timing[key]}
        if key == "animation":
            cpu, row["cpu_split_ms"] = split.run(
                libjxl_tpu_torch.decode_all, data, device="cpu")
            frames, _ = card[key]
            cpu_frames, _ = cpu
            if len(frames) != 4 or len(cpu_frames) != 4:
                raise AssertionError(f"{name}: {len(frames)} frames")
            row["frames"] = len(frames)
            row["max_lsb_diff"] = max(diff(f.pixels, c.pixels)
                                      for f, c in zip(frames, cpu_frames))
            row["shape"] = list(frames[0].pixels.shape)
            ok = row["max_lsb_diff"] <= 1 and all(
                f.pixels.shape == shape for f in frames)
        else:
            res = card[key]
            cpu, row["cpu_split_ms"] = split.run(libjxl_tpu_torch.decode,
                                                 data, device="cpu")
            px = res.pixels
            row["shape"] = list(px.shape)
            row["dtype"] = str(px.dtype)
            ok = px.shape == shape
            if key == "hdr":
                # XYB of the card's frame against the CPU route's; the
                # PQ16 codes on identical XYB; the raw code difference
                # of the two routes is reported, not gated (caveat 5).
                xyb_gpu = frame_xyb(data, "cuda")
                xyb_cpu = frame_xyb(data, "cpu")
                t0 = time.perf_counter()
                tail = pq16_pixels(np, xyb_gpu)
                row["pq16_tail_host_ms"] = (time.perf_counter() - t0) * 1e3
                row["finite"] = bool(np.isfinite(xyb_gpu).all())
                row["xyb_max_abs_diff"] = float(np.abs(
                    xyb_gpu - xyb_cpu).max())
                row["pq16_tail_max_code_diff"] = diff(px, tail)
                raw = np.abs(px.astype(np.int64)
                             - cpu.pixels.astype(np.int64))
                row["pq16_vs_cpu_max_code_diff"] = int(raw.max())
                row["pq16_vs_cpu_share_over_1_code"] = float(
                    (raw > 1).mean())
                ok = ok and px.dtype == np.uint16 and row["finite"] \
                    and row["xyb_max_abs_diff"] <= XYB_TOL \
                    and row["pq16_tail_max_code_diff"] <= 1
            else:
                row["max_lsb_diff"] = diff(px, cpu.pixels)
                ok = ok and px.dtype == np.uint8 \
                    and row["max_lsb_diff"] <= 1
        rows.append(row)
        if not ok:
            raise AssertionError(f"{name}: card vs CPU: {row}")
    emit({"phase": "api_path", "card": smi, "epf_launches": total_launches,
          "streams": rows})
    return total_launches


def test_photo(w: int, h: int, seed: int = 5):
    """bench.py's ``_test_photo`` (8-bit): smooth bands and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack(
        [0.5 + 0.3 * np.sin(x / 17 + c) * np.cos(y / 23)
         + 0.1 * np.sin((x + y) / 41)
         + rng.normal(0, 0.02, (h, w)) for c in range(3)],
        -1), 0, 1)
    return (img * 255).astype(np.uint8)


def make_image(i: int):
    """tools/gen_bench_corpus.py ``make_image``: the 3840x2160 16-bit
    image that ``bench_corpus/4k_hdr_pq_d1_e5_prog_epf3_<i>.jxl`` was
    encoded from."""
    import numpy as np
    w4k, h4k = 3840, 2160
    rng = np.random.default_rng(7 + i)
    xs = np.arange(w4k, dtype=np.float64)
    ys = np.arange(h4k, dtype=np.float64)
    chans = []
    for c in range(3):
        f1, f2 = 29 + 10 * i + 7 * c, 41 + 6 * i + 5 * c
        sx = np.sin(xs / f1 + c)
        cy = np.cos(ys / f2 + i)
        s = float(f1 + f2)
        sxy = (np.outer(np.cos(ys / s), np.sin(xs / s))
               + np.outer(np.sin(ys / s), np.cos(xs / s)))
        base = (0.28 + 0.22 * cy[:, None] * sx[None, :] + 0.10 * sxy
                + rng.normal(0, 0.012, (h4k, w4k)))
        chans.append(base)
    img = np.clip(np.stack(chans, axis=-1), 0.0, 0.9)
    return np.round(img * 65535.0).astype(np.uint16)


class EncodeSplit:
    """Splits one ``encode`` call of the port by wrapping the stages of
    ``ops/encode.py`` that ``frame/encode_frame.py`` calls:
    - ``stage_pre_ms``, ``quant_field_ms``, ``stage_b_ms``: device time of
      each stage (CUDA events around the call; a stage called by another
      counts in its caller);
    - ``copy_back_ms``: device time of the synchronising copies back
      (``to_host``: the quant field, then the outputs and planes);
    - ``host_before_ms``: host clock from the call to the first stage
      (colour conversion, padding, chromacity, patch search);
    - ``device_section_ms``: host clock from the first stage to the last
      copy back (the stages, the host's global scale between them);
    - ``host_after_ms``: host clock from the last copy back to the end
      (sub-8x8 pass, block lists, context clustering, entropy writing).
    With ``capture``, keeps each stage's inputs and the copied outputs of
    the last frame, to run the same stages on the CPU."""

    def __init__(self, torch):
        from libjxl_tpu_torch.ops import encode as ep
        self.torch, self.ep = torch, ep
        self.orig = (ep.encode_stage_pre, ep.initial_quant_field,
                     ep.stage_b, ep.to_host)

    def run(self, fn, *args, capture=None, **kw):
        torch, ep = self.torch, self.ep
        pre0, qf0, sb0, th0 = self.orig
        events, marks, depth = [], {}, [0]

        def timed(name, f, static=None):
            def wrapped(*a, **k):
                if depth[0]:
                    return f(*a, **k)
                marks.setdefault("first", time.perf_counter())
                if capture is not None:
                    capture[name] = (a, dict(k), static)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                depth[0] += 1
                try:
                    out = f(*a, **k)
                finally:
                    depth[0] -= 1
                end.record()
                events.append((name, start, end))
                if name == "copy_back":
                    marks["last"] = time.perf_counter()
                    if capture is not None:
                        capture.setdefault("copies", []).append(out)
                return out
            return wrapped

        def stage_b(*a, **k):
            return timed("stage_b", sb0(*a, **k), static=(a, k))

        ep.encode_stage_pre = timed("stage_pre", pre0)
        ep.initial_quant_field = timed("quant_field", qf0)
        ep.stage_b = stage_b
        ep.to_host = timed("copy_back", th0)
        try:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            (ep.encode_stage_pre, ep.initial_quant_field, ep.stage_b,
             ep.to_host) = self.orig
        split = {f"{n}_ms": 0.0 for n in ("stage_pre", "quant_field",
                                          "stage_b", "copy_back")}
        for name, start, end in events:
            split[f"{name}_ms"] += start.elapsed_time(end)
        split.update(total_ms=(t1 - t0) * 1e3,
                     host_before_ms=(marks["first"] - t0) * 1e3,
                     device_section_ms=(marks["last"] - marks["first"])
                     * 1e3,
                     host_after_ms=(t1 - marks["last"]) * 1e3)
        return out, split


def _share(np, a, b) -> dict:
    """Entries of two integer arrays that differ: share and largest gap."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    return {"share": float((d > 0).mean()) if d.size else 0.0,
            "max": int(d.max(initial=0))}


def encode_stages_vs_cpu(torch, np, cap) -> dict:
    """The stages of one card encode run again on the CPU from the card's
    inputs: stage pre from the same pre-gaborish planes, stage B from the
    card's stage-B inputs. Returns the differences of every output."""
    from libjxl_tpu_torch.ops import encode as ep
    cpu = torch.device("cpu")

    def to_cpu(v):
        if torch.is_tensor(v):
            return v.cpu()
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        return v
    out = {}
    (pre_in, dist, gab), pre_kw, _ = cap["stage_pre"]
    qf_cpu, planes_cpu = ep.encode_stage_pre(pre_in.cpu(), dist, gab,
                                             **pre_kw)
    b_args, b_kw, (sb_args, sb_kw) = cap["stage_b"]
    planes_card = b_args[0].cpu()
    qf_card = cap["copies"][0]["qf"]
    out["qf_max_rel_diff"] = float(np.max(np.abs(
        qf_card - qf_cpu.numpy()) / np.abs(qf_cpu.numpy())))
    out["planes_max_abs_diff"] = float((planes_card - planes_cpu).abs()
                                       .max())
    res = ep.stage_b(*sb_args, **sb_kw)(*[to_cpu(a) for a in b_args],
                                         **{k: to_cpu(v)
                                            for k, v in b_kw.items()})
    card = cap["copies"][-1]
    for k in ("strategies", "raw_quant", "qall", "qdc", "ytox_map",
              "ytob_map"):
        out[k] = _share(np, card[k], res[k].numpy())
    for k, v in card.get("big_q", {}).items():
        out[f"big_q_{k}"] = _share(np, v, res["big_q"][k].numpy())
    return out


def encode_path(torch, np, epf_cuda, smi):
    """The encoder at full size on the card: (a) bench.py phase 4's
    1024x1024 photo at d1 e5 and e7 against the CPU route, timed; (b)
    the HDR corpus image 0 (its 1080p crop and the 4K frame) against the
    committed streams and against the same stages on the CPU. Returns
    the EPF launches of the round-trip decodes on the card (counted from
    0 just before)."""
    import libjxl_tpu_torch
    from libjxl_tpu_torch.ops import encode as ep
    split = EncodeSplit(torch)

    def lsb(a, b) -> int:
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    img = test_photo(ENC_SIZE, ENC_SIZE, seed=5)
    mpix = ENC_SIZE * ENC_SIZE / 1e6
    rows, streams = [], []
    for effort in (5, 7):
        kw = dict(distance=1.0, effort=effort)
        libjxl_tpu_torch.encode(img, **kw)                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        ep.calls.clear()
        splits, card = [], None
        for _ in range(ENC_REPS):
            card, sp = split.run(libjxl_tpu_torch.encode, img, **kw)
            splits.append(sp)
        calls = dict(ep.calls)
        if calls.get(("encode_stage_b", "cuda")) != ENC_REPS or any(
                k[1] != "cuda" for k in calls):
            raise AssertionError(f"e{effort}: stage calls {calls}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        t = time.perf_counter()
        cpu = libjxl_tpu_torch.encode(img, device="cpu", **kw)
        cpu_ms = (time.perf_counter() - t) * 1e3
        mean_s = sum(sp["total_ms"] for sp in splits) / len(splits) / 1e3
        rows.append({"effort": effort, "distance": 1.0,
                     "shape": [ENC_SIZE, ENC_SIZE, 3],
                     "device_encode_mpix_s": mpix / mean_s,
                     "card_bytes": len(card), "cpu_bytes": len(cpu),
                     "byte_identical": card == cpu,
                     "card_split_ms": splits, "cpu_route_ms": cpu_ms,
                     "peak_mib": peak, "stage_calls": {
                         f"{k[0]}@{k[1]}": v for k, v in calls.items()}})
        streams.append((effort, card, cpu))
    # Round-trip decodes on the card (these launch the EPF kernel).
    epf_cuda.launches = 0
    for row, (effort, card, cpu) in zip(rows, streams):
        pc = libjxl_tpu_torch.decode(card).pixels
        pp = libjxl_tpu_torch.decode(cpu).pixels
        row["max_lsb_diff"] = lsb(pc, pp)
        row["mean_abs_err_vs_source"] = float(np.abs(
            pc.astype(np.float64) - img).mean())
    launches = epf_cuda.launches

    # (b) HDR at full width, with the settings of the committed corpus:
    # the 1920x1080 crop of image 0 against the committed 1080p stream,
    # which the encoder writes today byte for byte, and the 4K frame
    # against the committed 4K stream, which an earlier encoder wrote
    # (before the sub-8x8 selection, the learned MA tree and the precise
    # CfL fit): today's stream must be no larger and no worse than it.
    hdr_kw = dict(distance=1.0, effort=5, hdr="pq", progressive=True,
                  epf=3)
    src = make_image(0)
    hdr = {}
    for key, name, img in (("hdr_1080p", FILE_1080P,
                            np.ascontiguousarray(src[:1080, :1920])),
                           ("hdr_4k", FILES_4K[0], src)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cap: dict = {}
        ep.calls.clear()
        card_s, sp = split.run(libjxl_tpu_torch.encode, img, capture=cap,
                               **hdr_kw)
        calls = dict(ep.calls)
        if calls.get(("encode_stage_b", "cuda")) != 1 or any(
                k[1] != "cuda" for k in calls):
            raise AssertionError(f"{key}: stage calls {calls}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ref = read(name)
        t = time.perf_counter()
        stages = encode_stages_vs_cpu(torch, np, cap)
        stages_cpu_s = time.perf_counter() - t
        del cap
        torch.cuda.empty_cache()
        before = epf_cuda.launches
        dec_card = libjxl_tpu_torch.decode(card_s).pixels
        dec_ref = libjxl_tpu_torch.decode(ref).pixels
        launches += epf_cuda.launches - before
        mae_card = float(np.abs(dec_card.astype(np.float64) - img).mean())
        mae_ref = float(np.abs(dec_ref.astype(np.float64) - img).mean())
        h, w = img.shape[:2]
        hdr[key] = {"file": name, "card_bytes": len(card_s),
                    "committed_bytes": len(ref),
                    "byte_identical": card_s == ref,
                    "size_ratio": len(card_s) / len(ref),
                    "mae_card_pq16": mae_card, "mae_committed_pq16": mae_ref,
                    "mae_ratio": mae_card / mae_ref, "card_split_ms": sp,
                    "device_encode_mpix_s": h * w / 1e6
                    / (sp["total_ms"] / 1e3),
                    "peak_mib": peak, "stage_calls": {
                        f"{k[0]}@{k[1]}": v for k, v in calls.items()},
                    "stages_card_vs_cpu": stages,
                    "stages_cpu_s": stages_cpu_s}
        del dec_card, dec_ref
    emit({"phase": "encode_path", "card": smi, "epf_launches": launches,
          "photo_1024": rows, **hdr})
    for row in rows:
        if not (abs(row["card_bytes"] - row["cpu_bytes"])
                <= max(8, 0.01 * row["cpu_bytes"])
                and row["max_lsb_diff"] <= ENC_LSB_TOL):
            raise AssertionError(f"e{row['effort']}: card vs CPU route "
                                 f"{row['card_bytes']} vs "
                                 f"{row['cpu_bytes']} B, "
                                 f"{row['max_lsb_diff']} LSB")
    r1, r4 = hdr["hdr_1080p"], hdr["hdr_4k"]
    if not (abs(r1["size_ratio"] - 1) <= 0.01 and r1["mae_ratio"] <= 1.01
            and r4["size_ratio"] <= 1.01 and r4["mae_ratio"] <= 1.01):
        raise AssertionError(
            f"HDR encodes against the committed streams: 1080p size ratio "
            f"{r1['size_ratio']}, error ratio {r1['mae_ratio']}; 4K size "
            f"ratio {r4['size_ratio']}, error ratio {r4['mae_ratio']}")
    for key, row in hdr.items():
        st = row["stages_card_vs_cpu"]
        bad = {k: v for k, v in st.items() if isinstance(v, dict)
               and v["share"] > ENC_STAGE_SHARE[
                   "big_q" if k.startswith("big_q") else k]}
        if st["qf_max_rel_diff"] > QF_RTOL or bad:
            raise AssertionError(f"{key} stages, card vs CPU: {st}")
    return launches


def read_png16(np, data: bytes):
    """The samples of a 16-bit RGB(A) PNG as the port's in-tree writer
    writes it (one IDAT, filter 0 on every row); the phase runs without
    PIL, and PIL reads such a PNG only reduced to 8 bits."""
    import struct
    import zlib
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    if depth != 16 or ctype not in (2, 6):
        raise AssertionError(f"PNG depth {depth}, colour type {ctype}")
    ch = 3 if ctype == 2 else 4
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(h, 1 + w * ch * 2)
    if rows[:, 0].any():
        raise AssertionError("PNG rows with a filter other than 0")
    return rows[:, 1:].copy().view(">u2").reshape(h, w, ch).astype(
        np.uint16)


class NoPil:
    """While active, ``import PIL`` fails as it does where PIL is not
    installed; the modules of PIL already imported come back after."""

    def __enter__(self):
        self.saved = {k: sys.modules.pop(k) for k in list(sys.modules)
                      if k == "PIL" or k.startswith("PIL.")}
        sys.modules["PIL"] = None
        return self

    def __exit__(self, *exc):
        del sys.modules["PIL"]
        sys.modules.update(self.saved)


def cli_path(torch, np, epf_cuda, smi, tmp):
    """The port's command line and the rest of its encode API at full
    size, with the default device (the card) unless a step names the
    CPU. Writes its files into the directory ``tmp``, where
    ``tools_path`` reads the photo's PPM and the 4K ``.npy``. Returns the
    EPF launches of the in-process runs (counted from 0 just before
    them); the fresh process's launch is its own."""
    import contextlib
    import io

    import libjxl_tpu_torch
    from libjxl_tpu_torch.api import encode_streaming
    from libjxl_tpu_torch.api.encoder import Encoder, FrameSettings
    from libjxl_tpu_torch.cli import cjxl, djxl
    from libjxl_tpu_torch.extras import codecs

    def lsb(a, b) -> int:
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    def run(main, *argv) -> float:
        """One CLI run in process; its wall time in ms."""
        err = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = main([str(a) for a in argv])
        ms = (time.perf_counter() - t) * 1e3
        if rc != 0:
            raise AssertionError(f"{argv}: exit {rc}: {err.getvalue()}")
        return ms

    def slurp(path) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    photo = test_photo(ENC_SIZE, ENC_SIZE, seed=5)
    hdr_path = os.path.join(CORPUS, FILES_4K[0])
    jpeg_path = os.path.join(POST_CORPUS, FILE_JPEG)
    ms, checks = {}, {}
    epf_cuda.launches = 0

    def p(name):
        return os.path.join(tmp, name)

    with open(p("photo.ppm"), "wb") as f:
        f.write(codecs.encode_pnm(photo))

    # 1. cjxl on the card and on the CPU, held to the encoder gates.
    ms["cjxl_card"] = run(cjxl.main, p("photo.ppm"), p("card.jxl"),
                          "-d", "1", "-e", "5")
    ms["cjxl_cpu"] = run(cjxl.main, p("photo.ppm"), p("cpu.jxl"),
                         "-d", "1", "-e", "5", "--device", "cpu")
    card_s, cpu_s = slurp(p("card.jxl")), slurp(p("cpu.jxl"))
    dec_card = libjxl_tpu_torch.decode(card_s).pixels
    checks["cjxl"] = {
        "card_bytes": len(card_s), "cpu_bytes": len(cpu_s),
        "byte_identical": card_s == cpu_s,
        "max_lsb_diff": lsb(dec_card,
                            libjxl_tpu_torch.decode(cpu_s).pixels),
        "mean_abs_err_vs_source": float(np.abs(
            dec_card.astype(np.float64) - photo).mean())}
    c = checks["cjxl"]
    if not (abs(c["card_bytes"] - c["cpu_bytes"])
            <= max(8, 0.01 * c["cpu_bytes"])
            and c["max_lsb_diff"] <= ENC_LSB_TOL):
        raise AssertionError(f"cjxl card vs CPU: {c}")

    # 2. djxl: the module entry in a fresh process (builds or loads
    # the kernel on first use there), then in process.
    t = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "libjxl_tpu_torch.cli.djxl", hdr_path,
         p("hdr.png")], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    ms["djxl_4k_png_process"] = (time.perf_counter() - t) * 1e3
    if sub.returncode != 0:
        raise AssertionError(f"djxl process: exit {sub.returncode}: "
                             f"{sub.stderr[-3000:]}")
    hdr_px = libjxl_tpu_torch.decode(read(FILES_4K[0])).pixels
    png_px = read_png16(np, slurp(p("hdr.png")))
    before = epf_cuda.launches
    ms["djxl_4k_npy"] = run(djxl.main, hdr_path, p("hdr.npy"))
    npy_launches = epf_cuda.launches - before
    checks["djxl"] = {
        "dtype": str(hdr_px.dtype), "shape": list(hdr_px.shape),
        "png_max_code_diff": lsb(png_px, hdr_px),
        "npy_max_code_diff": lsb(np.load(p("hdr.npy")), hdr_px),
        "npy_epf_launches": npy_launches}
    c = checks["djxl"]
    if not (hdr_px.dtype == np.uint16 and hdr_px.shape == (2160, 3840, 3)
            and c["png_max_code_diff"] == 0
            and c["npy_max_code_diff"] == 0 and npy_launches == 1):
        raise AssertionError(f"djxl vs decode(): {c}")
    ms["djxl_low_memory_ppm"] = run(djxl.main, p("card.jxl"),
                                    p("lm.ppm"), "--low-memory")
    ms["djxl_ppm"] = run(djxl.main, p("card.jxl"), p("full.ppm"))
    lm = codecs.load_image(p("lm.ppm")).pixels
    full = codecs.load_image(p("full.ppm")).pixels
    checks["low_memory"] = {"max_lsb_diff": lsb(lm, full),
                            "dtype": str(lm.dtype)}
    if not (lm.dtype == np.uint8 and lsb(lm, full) <= LSB8_TOL
            and lsb(full, dec_card) == 0):
        raise AssertionError(f"low-memory vs djxl: {checks}")

    # 3. JPEG: coefficient transcode and reconstruction (host).
    jpeg = slurp(jpeg_path)
    ms["cjxl_jpeg"] = run(cjxl.main, jpeg_path, p("jpeg.jxl"))
    ms["djxl_jpeg"] = run(djxl.main, p("jpeg.jxl"), p("rec.jpg"))
    rec = slurp(p("rec.jpg"))
    checks["jpeg"] = {"jpeg_bytes": len(jpeg),
                      "jxl_bytes": os.path.getsize(p("jpeg.jxl")),
                      "byte_exact": rec == jpeg}
    if rec != jpeg:
        raise AssertionError(f"JPEG reconstruction: {checks['jpeg']}")

    # 4. The encode API: two chunks on the host, one single-group image
    # and the Encoder on the card.
    strip = test_photo(STREAM_W, STREAM_H, seed=5)
    calls = []

    def chunk(x0, y0, w, h):
        calls.append((x0, y0, w, h))
        return strip[y0:y0 + h, x0:x0 + w]

    t = time.perf_counter()
    s_card = encode_streaming(chunk, STREAM_W, STREAM_H, distance=1.0)
    ms["encode_streaming_2chunks"] = (time.perf_counter() - t) * 1e3
    s_cpu = encode_streaming(lambda x0, y0, w, h:
                             strip[y0:y0 + h, x0:x0 + w], STREAM_W,
                             STREAM_H, distance=1.0, device="cpu")
    s_px = libjxl_tpu_torch.decode(s_card).pixels
    err = np.abs(s_px.astype(np.float64) - strip)
    crop = np.ascontiguousarray(photo[:256, :256])
    t = time.perf_counter()
    single = encode_streaming(lambda x0, y0, w, h:
                              crop[y0:y0 + h, x0:x0 + w], 256, 256,
                              distance=1.0)
    ms["encode_streaming_single_group"] = (time.perf_counter() - t) * 1e3
    single_ref = libjxl_tpu_torch.encode(crop, distance=1.0)
    enc = Encoder(device="cuda")
    enc.add_image_frame(photo, FrameSettings(distance=1.0))
    t = time.perf_counter()
    jx = enc.process_output()
    ms["encoder_process_output"] = (time.perf_counter() - t) * 1e3
    jx_ref = libjxl_tpu_torch.encode(
        photo, distance=1.0, lossless=False, progressive=False, noise=None,
        resampling=1, effort=7, dots=False, patches=True, modular=False,
        photon_noise_iso=None, epf=-1)
    checks["encode_api"] = {
        "streaming_chunks": calls, "streaming_bytes": len(s_card),
        "streaming_card_eq_cpu": s_card == s_cpu,
        "streaming_max_err": float(err.max()),
        "streaming_rms_err": float(np.sqrt((err ** 2).mean())),
        "single_group_bytes": len(single),
        "single_group_eq_encode": single == single_ref,
        "encoder_bytes": len(jx), "encoder_eq_encode": jx == jx_ref}
    c = checks["encode_api"]
    if not (calls == [(0, 0, 2048, STREAM_H),
                      (2048, 0, STREAM_W - 2048, STREAM_H)]
            and c["streaming_card_eq_cpu"] and c["single_group_eq_encode"]
            and c["encoder_eq_encode"] and c["streaming_max_err"] < 64
            and c["streaming_rms_err"] < 12):
        raise AssertionError(f"encode API: {c}")
    # One launch per in-process decode of a stream with loop filters:
    # the two cjxl streams, the 4K stream, djxl to .npy and to PPM, and
    # the streamed stream.
    launches = epf_cuda.launches
    if launches != 6:
        raise AssertionError(f"cli_path: {launches} EPF launches, not 6")
    emit({"phase": "cli_path", "card": smi, "epf_launches": launches,
          "wall_ms": ms, "checks": checks})
    return launches


# benchmark_xl's columns after the codec, in its order.
BENCH_COLUMNS = ("bpp", "enc_mpix_s", "dec_mpix_s", "max_norm", "pnorm",
                 "ssim2", "psnr")
BENCH_SPECS = ("jxl:d1.0", "jxl:d1.0:p")
DECODER_CHUNK = 64 * 1024
# The event-driven decoder's events for one progressive frame, in the
# reference's order (tests/test_torch_decoder.py holds the port to it).
DECODER_EVENTS = re.compile(
    r"BASIC_INFO COLOR_ENCODING FRAME( FRAME_PROGRESSION)+ FULL_IMAGE "
    r"SUCCESS")
TOOLS_LAUNCHES = 7      # benchmark_xl 2 + 2 + run_codec 2 + decode() 1


def tools_path(torch, np, epf_cuda, smi, tmp):
    """The rest of the JAX package's tools at the encoder cell's size
    (bench.py's 1024x1024 photo), on the card unless a step names the
    CPU: ``benchmark_xl`` (its JPEG XL encode and decode; a warm-up, a
    timed run with the metrics, then ``--device cpu``), the event-driven
    ``Decoder`` (host) on the card's progressive stream in 64 KiB chunks,
    ``jxlinfo``, ``jxltran``, the two metric tools, ``hdr_tools
    tone_map`` of the 4K PQ16 ``.npy`` that ``cli_path``'s ``djxl``
    wrote into ``tmp``, ``fast_lossless_encode`` and the system libjxl
    where it is installed. Returns the EPF launches (counted from 0 just
    before the phase)."""
    import contextlib
    import io

    import libjxl_tpu_torch
    from libjxl_tpu_torch.api.decoder import Decoder, Event
    from libjxl_tpu_torch.cli import (benchmark_xl, butteraugli_main,
                                      hdr_tools, jxlinfo, jxltran,
                                      ssimulacra2_main)
    from libjxl_tpu_torch.extras import codecs, refjxl
    from libjxl_tpu_torch.extras.fast_lossless import fast_lossless_encode
    from libjxl_tpu_torch.metrics import ssimulacra2
    from libjxl_tpu_torch.metrics.butteraugli import (butteraugli_distance,
                                                      butteraugli_pnorm)

    def lsb(a, b) -> int:
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    def run(main, *argv):
        """One tool run in process: (its standard output, wall ms)."""
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main([str(a) for a in argv])
        ms = (time.perf_counter() - t) * 1e3
        if rc != 0:
            raise AssertionError(f"{argv}: exit {rc}: {err.getvalue()}")
        return out.getvalue(), ms

    def rows(text) -> dict:
        """benchmark_xl's rows: codec -> {column: value}."""
        got = {}
        for line in text.splitlines()[2:]:
            cells = line.split()
            got[cells[0]] = dict(zip(BENCH_COLUMNS, map(float, cells[1:])))
        if set(got) != set(BENCH_SPECS):
            raise AssertionError(f"benchmark_xl rows: {text}")
        return got

    def p(name):
        return os.path.join(tmp, name)

    photo = test_photo(ENC_SIZE, ENC_SIZE, seed=5)
    npix = ENC_SIZE * ENC_SIZE
    specs = ",".join(BENCH_SPECS)
    ms, checks = {}, {}
    epf_cuda.launches = 0

    # 1-2. benchmark_xl: a warm-up, the timed run with the metrics, then
    # the CPU; the card's streams and pixels against the CPU's, through
    # the tool's run_codec.
    run(benchmark_xl.main, "--input", p("photo.ppm"), "--codec", specs,
        "--no_metrics", "--device", "cuda")
    card_text, ms["benchmark_xl_card_metrics"] = run(
        benchmark_xl.main, "--input", p("photo.ppm"), "--codec", specs,
        "--device", "cuda")
    cpu_text, ms["benchmark_xl_cpu_no_metrics"] = run(
        benchmark_xl.main, "--input", p("photo.ppm"), "--codec", specs,
        "--no_metrics", "--device", "cpu")
    card_rows, cpu_rows = rows(card_text), rows(cpu_text)
    streams = {}
    for spec in BENCH_SPECS:
        data, out, _, _ = benchmark_xl.run_codec(photo, spec, "cuda")
        cpu_data, cpu_out, _, _ = benchmark_xl.run_codec(photo, spec, "cpu")
        streams[spec] = (data, out)
        row_bytes = card_rows[spec]["bpp"] * npix / 8
        cpu_row_bytes = cpu_rows[spec]["bpp"] * npix / 8
        checks[spec] = c = {
            "card_bytes": len(data), "cpu_bytes": len(cpu_data),
            "byte_identical": data == cpu_data,
            "row_bytes_diff": abs(row_bytes - cpu_row_bytes),
            "max_lsb_diff": lsb(out, cpu_out)}
        if not (abs(len(data) - len(cpu_data))
                <= max(8, 0.01 * len(cpu_data))
                and c["row_bytes_diff"] <= max(8, 0.01 * cpu_row_bytes)
                and c["max_lsb_diff"] <= ENC_LSB_TOL
                and out.shape == photo.shape):
            raise AssertionError(f"benchmark_xl {spec} card vs CPU: {c}")

    # 3. The event-driven decoder (host) on the progressive stream.
    pstream = streams["jxl:d1.0:p"][0]
    dec = Decoder(events={Event.BASIC_INFO, Event.COLOR_ENCODING,
                          Event.FRAME, Event.FRAME_PROGRESSION,
                          Event.FULL_IMAGE})
    seen, flushed = [], None
    t = time.perf_counter()
    for start in range(0, len(pstream), DECODER_CHUNK):
        dec.set_input(pstream[start:start + DECODER_CHUNK])
        if start + DECODER_CHUNK >= len(pstream):
            dec.close_input()
        for _ in range(1000):
            ev = dec.process_input()
            if ev == Event.NEED_MORE_INPUT:
                break
            seen.append(ev.name)
            if ev == Event.FRAME_PROGRESSION and flushed is None:
                flushed = dec.flush_image()
            if ev in (Event.SUCCESS, Event.ERROR):
                break
    ms["decoder_64k_chunks"] = (time.perf_counter() - t) * 1e3
    ref_px = libjxl_tpu_torch.decode(pstream, device="cuda").pixels
    checks["decoder"] = c = {
        "events": " ".join(seen), "chunks": -(-len(pstream)
                                               // DECODER_CHUNK),
        "flushed_shape": None if flushed is None else list(flushed.shape),
        "max_lsb_diff_vs_decode": lsb(dec.image, ref_px)}
    if not (DECODER_EVENTS.fullmatch(c["events"])
            and c["flushed_shape"] == [ENC_SIZE, ENC_SIZE, 3]
            and c["max_lsb_diff_vs_decode"] <= LSB8_TOL):
        raise AssertionError(f"Decoder: {c}")

    # 4. jxlinfo: the 720p animation and the 1080p corpus stream.
    anim_text, ms["jxlinfo_720p_anim"] = run(
        jxlinfo.main, os.path.join(POST_CORPUS, FILE_ANIM))
    hd_text, ms["jxlinfo_1080p"] = run(jxlinfo.main,
                                       os.path.join(CORPUS, FILE_1080P))
    checks["jxlinfo"] = c = {
        "anim_frames": anim_text.count("\nframe "),
        "anim_dimensions": "dimensions: 1280x720" in anim_text,
        "hd_dimensions": "dimensions: 1920x1080" in hd_text,
        "hd_frames": hd_text.count("\nframe "),
        "walk_stopped": "frame walk stopped" in anim_text + hd_text}
    if not (c["anim_frames"] == 4 and c["hd_frames"] == 1
            and c["anim_dimensions"] and c["hd_dimensions"]
            and not c["walk_stopped"]):
        raise AssertionError(f"jxlinfo: {c}\n{anim_text}\n{hd_text}")

    # 5. jxltran: pack the card's stream into a container, strip it back.
    with open(p("d1.jxl"), "wb") as f:
        f.write(streams["jxl:d1.0"][0])
    _, ms["jxltran_pack"] = run(jxltran.main, p("d1.jxl"), p("packed.jxl"),
                                "--pack")
    _, ms["jxltran_strip"] = run(jxltran.main, p("packed.jxl"),
                                 p("stripped.jxl"), "--strip")
    with open(p("stripped.jxl"), "rb") as f:
        stripped = f.read()
    checks["jxltran"] = {"container_bytes": os.path.getsize(p("packed.jxl")),
                         "round_trip_exact": stripped == streams[
                             "jxl:d1.0"][0]}
    if not checks["jxltran"]["round_trip_exact"]:
        raise AssertionError(f"jxltran: {checks['jxltran']}")

    # 6. The metric tools on the photo and its card decode print the
    # metric functions' values.
    card_out = streams["jxl:d1.0"][1]
    with open(p("d1.ppm"), "wb") as f:
        f.write(codecs.encode_pnm(card_out))
    s2_text, ms["ssimulacra2_main"] = run(ssimulacra2_main.main,
                                          p("photo.ppm"), p("d1.ppm"))
    ba_text, ms["butteraugli_main"] = run(
        butteraugli_main.main, p("photo.ppm"), p("d1.ppm"), "--pnorm", "3")
    s2 = ssimulacra2(photo, card_out)
    dist, dmap = butteraugli_distance(photo, card_out, intensity_target=80.0,
                                      return_diffmap=True)
    pn = butteraugli_pnorm(dmap, 3.0)
    checks["metric_tools"] = c = {
        "ssimulacra2": s2, "butteraugli": dist, "pnorm_3": pn,
        "ssimulacra2_printed": s2_text.strip(),
        "butteraugli_printed": ba_text.strip().splitlines()}
    if not (c["ssimulacra2_printed"] == f"{s2:.8f}"
            and c["butteraugli_printed"] == [f"{dist:.8f}",
                                             f"3.0-norm: {pn:.8f}"]):
        raise AssertionError(f"metric tools: {c}")

    # 7. hdr_tools tone_map of the 4K PQ16 array (host, float64).
    _, ms["hdr_tools_tone_map_4k"] = run(hdr_tools.main, "tone_map",
                                         p("hdr.npy"), p("sdr.npy"),
                                         "-t", "100")
    sdr = np.load(p("sdr.npy"))
    checks["hdr_tools"] = c = {
        "shape": list(sdr.shape), "dtype": str(sdr.dtype),
        "finite": bool(np.isfinite(sdr).all()),
        "min": float(sdr.min()), "max": float(sdr.max())}
    if not (c["shape"] == [2160, 3840, 3] and c["finite"]
            and 0.0 <= c["min"] <= c["max"] <= 1.0):
        raise AssertionError(f"hdr_tools tone_map: {c}")

    # 8. fast_lossless_encode (host), decoded back exactly.
    t = time.perf_counter()
    fl = fast_lossless_encode(photo)
    ms["fast_lossless_encode"] = (time.perf_counter() - t) * 1e3
    checks["fast_lossless"] = {
        "bytes": len(fl), "exact": bool(np.array_equal(
            libjxl_tpu_torch.decode(fl, device="cuda").pixels, photo))}
    if not checks["fast_lossless"]["exact"]:
        raise AssertionError(f"fast_lossless: {checks['fast_lossless']}")

    # 9. The system libjxl, where installed: its decode of the card's
    # stream within 1 LSB of the host's plus 1 of the card's.
    checks["refjxl"] = {"available": refjxl.available()}
    if refjxl.available():
        theirs = refjxl.decode(streams["jxl:d1.0"][0], dtype="uint8").pixels
        checks["refjxl"]["max_lsb_diff_vs_card"] = lsb(theirs, card_out)
        if checks["refjxl"]["max_lsb_diff_vs_card"] > 2:
            raise AssertionError(f"refjxl: {checks['refjxl']}")

    launches = epf_cuda.launches
    if launches != TOOLS_LAUNCHES:
        raise AssertionError(f"tools_path: {launches} EPF launches, not "
                             f"{TOOLS_LAUNCHES}")
    emit({"phase": "tools_path", "card": smi, "epf_launches": launches,
          "rows_card": card_rows, "rows_cpu": cpu_rows, "wall_ms": ms,
          "checks": checks})
    return launches


CONFORMANCE_CORPUS = os.path.join(POST_CORPUS, "conformance")
SWEEP_FLIP = 0xA5       # tests/test_fuzz.py's seeded byte flip
SWEEP_CUT_STEP = 3      # tests/test_fuzz.py's truncation sweep
# The feed route's documented refusal of a frame it does not carry
# (modular frames, chroma subsampling, extra channels, ...; raised by
# frame/decode_frame.py before any device work).
UNSUPPORTED = "is not supported by the device decode path"


def conformance_path(torch, np, epf_cuda, smi, tmp):
    """The repository's tools on the card (``libjxl_tpu_torch.tools``):
    ``run_corpus`` over the committed conformance corpus
    (tests/torch_corpus/conformance/, goldens from the system libjxl
    where it decoded the stream) within the manifest's limits (a missed
    self golden is held by its XYB, as below); ``profile_device`` on 4K
    stream 0, one JSON line per stage;
    ``microbench`` with the device decode; and, where the system libjxl
    is installed, ``rd_table`` and ``interop_sweep`` at one image and one
    distance. Returns the EPF launches (counted from 0 just before the
    phase)."""
    import contextlib
    import io

    from libjxl_tpu_torch.extras import refjxl
    from libjxl_tpu_torch.tools import (interop_sweep, microbench,
                                        profile_device, rd_table)
    from libjxl_tpu_torch.tools.conformance import run_corpus

    ms, checks = {}, {}
    epf_cuda.launches = 0

    # 1. The committed conformance corpus, decoded on the card.
    t = time.perf_counter()
    results = run_corpus.run(CONFORMANCE_CORPUS, "cuda")
    ms["run_corpus"] = (time.perf_counter() - t) * 1e3
    with open(os.path.join(CONFORMANCE_CORPUS, "manifest.json")) as f:
        manifest = json.load(f)
    checks["run_corpus"] = {
        name: {"ok": ok, "rmse": rmse, "peak": peak,
               "golden": manifest[name]["golden"],
               "limit_rmse": manifest[name]["rmse"],
               "limit_peak": manifest[name]["peak"]}
        for name, ok, rmse, peak in results}
    failed = [name for name, ok, _, _ in results if not ok]
    oracle_failed = [n for n in failed if manifest[n]["golden"] != "self"]
    if oracle_failed or len(results) != len(manifest):
        raise AssertionError(
            f"conformance on the card: {oracle_failed} fail "
            f"{[checks['run_corpus'][n] for n in oracle_failed]}")
    corpus_launches = epf_cuda.launches
    # A self golden is the port's own decode on the CPU, so a card decode
    # that misses it is held to the rule for two float32 decoders (its
    # PQ16 codes move by more than one in dark tones for XYB ~1e-7
    # apart; ROADMAP queue 3, caveat 5): the frame's XYB on the card
    # within XYB_TOL of the CPU's.
    checks["self_golden_missed_on_card"] = {}
    for name in failed:
        data = read(name + ".jxl", CONFORMANCE_CORPUS)
        err = float(np.abs(frame_xyb(data, "cuda")
                           - frame_xyb(data, "cpu")).max())
        checks["self_golden_missed_on_card"][name] = {
            **checks["run_corpus"][name], "xyb_max_abs_diff_vs_cpu": err}
        if not err <= XYB_TOL:
            raise AssertionError(f"conformance on the card: {name} "
                                 f"{checks['self_golden_missed_on_card']}")

    # 2. The per-stage profile of 4K stream 0.
    t = time.perf_counter()
    stages = profile_device.profile(read(FILES_4K[0]), "cuda", reps=5)
    ms["profile_device"] = (time.perf_counter() - t) * 1e3
    for line in stages:
        emit({"phase": "profile_device", "card": smi,
              "stream": FILES_4K[0], **line})
    if [s["stage"] for s in stages] != list(profile_device.STAGES):
        raise AssertionError("profile_device: stages "
                             f"{[s['stage'] for s in stages]}")

    # 3. microbench, with the device decode on the card.
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        benches = microbench.run("cuda")
    ms["microbench"] = (time.perf_counter() - t) * 1e3
    checks["microbench_ms"] = {name: s * 1e3 for name, s in benches}
    if benches[-1][0] != "device decode (cuda)" or len(benches) != 13:
        raise AssertionError(f"microbench: {out.getvalue()}")

    # 4. The system libjxl's tools, at one image and one distance.
    if refjxl.available():
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = rd_table.main(["--out", tmp, "--images", "1",
                                "--distances", "1.0", "--device", "cuda"])
        ms["rd_table"] = (time.perf_counter() - t) * 1e3
        row = [ln for ln in out.getvalue().splitlines()
               if ln.startswith("| 1.0 |")]
        if rc != 0 or len(row) != 1:
            raise AssertionError(f"rd_table: {out.getvalue()}")
        checks["rd_table_row"] = row[0]
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fails = interop_sweep.sweep(0, 1, device="cuda")
        ms["interop_sweep"] = (time.perf_counter() - t) * 1e3
        checks["interop_sweep_failures"] = [list(map(str, f))
                                            for f in fails]
        if fails:
            raise AssertionError(f"interop_sweep: {fails}")
    launches = epf_cuda.launches
    emit({"phase": "conformance_path", "card": smi,
          "refjxl": refjxl.available(), "epf_launches": launches,
          "epf_launches_run_corpus": corpus_launches,
          "cases": len(results), "wall_ms": ms, "checks": checks})
    return launches


def robustness_path(torch, np, epf_cuda, filters, smi):
    """The decoder's error contract on the card: the committed crash
    corpus (tests/corpus/) and the seeded byte-flip and truncation sweeps
    of ``fuzz_targets.valid_stream()`` through ``decode``, ``decode_all``
    and ``decode_device`` on ``cuda``. Each call decodes or raises
    ``JxlError`` (``decode_device`` may also refuse a frame its feed
    route does not carry, with its documented NotImplementedError);
    anything else fails the phase, and so does a feed staged with an
    out-of-range index. Then the CUDA context must still work: a
    synchronise and the EPF kernel against its plain version once more.
    Returns the EPF launches and the kernel's error in that check."""
    import glob

    import libjxl_tpu_torch
    from libjxl_tpu_torch.base.errors import JxlError
    from libjxl_tpu_torch.tools import fuzz_targets

    base = fuzz_targets.valid_stream("cuda")
    crash_corpus = os.path.join(ROOT, "tests", "corpus")
    inputs = [(os.path.basename(p), read(os.path.basename(p), crash_corpus))
              for p in sorted(glob.glob(os.path.join(crash_corpus,
                                                     "*.bin")))]
    n_corpus = len(inputs)
    for pos in range(len(base)):
        data = bytearray(base)
        data[pos] ^= SWEEP_FLIP
        inputs.append((f"flip{pos}", bytes(data)))
    inputs += [(f"cut{c}", base[:c])
               for c in range(0, len(base), SWEEP_CUT_STEP)]

    def decode_device(data):
        libjxl_tpu_torch.decode_device(data, out="pq16", device="cuda")
        torch.cuda.synchronize()

    calls = {"decode": lambda d: libjxl_tpu_torch.decode(d, device="cuda"),
             "decode_all": lambda d: libjxl_tpu_torch.decode_all(
                 d, device="cuda"),
             "decode_device": decode_device}
    counts = {name: {"decoded": 0, "JxlError": 0, "unsupported": 0}
              for name in calls}
    faults: list = []
    epf_cuda.launches = 0
    t = time.perf_counter()
    with fuzz_targets.checking_feeds(faults):
        for label, data in inputs:
            for name, fn in calls.items():
                try:
                    fn(data)
                    outcome = "decoded"
                except JxlError:
                    outcome = "JxlError"
                except NotImplementedError as e:
                    if name != "decode_device" or UNSUPPORTED not in str(e):
                        raise AssertionError(f"{name}({label}): {e!r}")
                    outcome = "unsupported"
                except Exception as e:
                    raise AssertionError(f"{name}({label}): {e!r}") from e
                counts[name][outcome] += 1
            if faults:
                raise AssertionError(f"{label}: out-of-range feed {faults}")
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = epf_cuda.launches

    # The context is alive: synchronise, then the kernel once more.
    torch.cuda.synchronize()
    rng = np.random.default_rng(20260417)
    dev = torch.device("cuda")
    img = torch.from_numpy(rng.normal(0, 0.3, (3, 257, 389))
                           .astype(np.float32)).to(dev)
    sig = torch.from_numpy(rng.uniform(-6.0, -0.05, (33, 49))
                           .astype(np.float32)).to(dev)
    err = (epf_cuda.apply_loop_filters(img, sig, epf_iters=3, gab=True)
           - filters.apply_loop_filters(img, sig, epf_iters=3, gab=True)) \
        .abs().max().item()
    torch.cuda.synchronize()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"after the robustness inputs the EPF kernel "
                             f"differs from its plain version by {err}")
    emit({"phase": "robustness_path", "card": smi,
          "inputs": len(inputs), "corpus_files": n_corpus,
          "flips": len(base), "cuts": len(inputs) - n_corpus - len(base),
          "valid_stream_bytes": len(base),
          "valid_stream_is_cpu_bytes": base == fuzz_targets.valid_stream(
              "cpu"),
          "outcomes": counts, "out_of_range_feeds": len(faults),
          "epf_launches": launches, "wall_ms": wall_ms,
          "kernel_after_max_abs_err": err})
    return launches, err


class KernelCapture:
    """Keeps the inputs of every ``epf_cuda.apply_loop_filters`` call made
    while it is active (the step calls the wrapper by attribute, so the
    wrapper seen there is this one); the launches go through as usual."""

    def __init__(self, epf_cuda):
        self.mod, self.orig, self.calls = epf_cuda, None, []

    def __enter__(self):
        self.orig = self.mod.apply_loop_filters

        def wrapped(img, sig, **kw):
            self.calls.append((img, sig, kw))
            return self.orig(img, sig, **kw)
        self.mod.apply_loop_filters = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.apply_loop_filters = self.orig


def sharded_path(torch, np, epf_cuda, filters, smi):
    """The last device modules on the card: (a) the slim-feed sharded
    step (``make_sharded_decode2``) at world size 1 on an NCCL (1, 1)
    mesh, one step on the three 4K corpus streams (B = 3), against
    ``decode_device(out="srgb8")``, with the EPF kernel on the
    halo-extended batch held against its plain version and timed;
    (b) the v1 path: ``entry()`` against its CPU run, ``decode_frame_device``
    on the 1080p stream's v1 feed against the CPU and the v2 decode, and
    stream 0 at 4K, timed; (c) the v0 group decode against the CPU.
    Returns (kernel row of the halo-extended batch, EPF launches of the
    card runs, each counted from 0 just before it)."""
    import libjxl_tpu_torch
    import torch.distributed as dist
    from libjxl_tpu_torch import entry
    from libjxl_tpu_torch.ops import decode_torch
    from libjxl_tpu_torch.parallel import ranks
    from libjxl_tpu_torch.parallel.sharded_decode import (
        HALO, batch_feeds2, gather, make_sharded_decode2,
    )
    from libjxl_tpu_torch.tpu import pipeline

    def lsb(a, b) -> int:
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int((a.to(torch.int32).cpu() - b.to(torch.int32).cpu())
                   .abs().max().item())

    # (a) the sharded step.
    streams = [read(n) for n in FILES_4K]
    t = time.perf_counter()
    feeds = [libjxl_tpu_torch.parse_to_feed(s) for s in streams]
    parse_ms = (time.perf_counter() - t) * 1e3
    h, w = feeds[0]["image_hw"]
    t = time.perf_counter()
    args, class_keys = batch_feeds2(feeds, 1)
    batch_ms = (time.perf_counter() - t) * 1e3
    lf = feeds[0]["lf"]
    epf_iters, gab = int(lf.epf_iters), bool(lf.gab)

    def step(mesh):
        fn, shard = make_sharded_decode2(mesh, h, w, epf_iters=epf_iters,
                                         gab=gab, class_keys=class_keys)
        local = shard(args)
        fn(*local)                                     # warm-up
        torch.cuda.synchronize()
        epf_cuda.launches = 0
        with KernelCapture(epf_cuda) as cap:
            out = fn(*local)
        torch.cuda.synchronize()
        launches = epf_cuda.launches
        full = gather(out, mesh)
        step_ms = cuda_ms(torch, lambda: fn(*local), 3)
        return {"out": full, "launches": launches, "calls": cap.calls,
                "step_ms": step_ms, "backend": dist.get_backend(),
                "world_size": dist.get_world_size()}

    res = ranks.run_ranks(step, 1, (1, 1), device_type="cuda",
                          timeout=600.0)[0]
    if res["launches"] != 1 or len(res["calls"]) != 1:
        raise AssertionError(f"sharded step: {res['launches']} EPF "
                             f"launches, {len(res['calls'])} calls")
    if res["backend"] != "nccl" or res["world_size"] != 1:
        raise AssertionError(f"sharded step ran on {res['backend']} at "
                             f"world size {res['world_size']}")
    out = res["out"]
    if tuple(out.shape) != (3, 3, h, w) or out.dtype != torch.uint8:
        raise AssertionError(f"sharded output {out.dtype} "
                             f"{tuple(out.shape)}")
    refs = [libjxl_tpu_torch.decode_device(s, out="srgb8")
            for s in streams]
    frame_lsb = [lsb(out[i], refs[i]) for i in range(3)]
    if max(frame_lsb) > 1:
        raise AssertionError(f"sharded step vs decode_device: "
                             f"{frame_lsb} LSB")
    # The batched v2 decode of the same frames, for comparison.
    pipeline.decode_frames_device_batched(feeds, h, w, out="srgb8")
    torch.cuda.synchronize()
    batched_ms = cuda_ms(torch, lambda: pipeline.decode_frames_device_batched(
        feeds, h, w, out="srgb8"), 3)
    # The kernel on the halo-extended batch the step gave it.
    img, sig, kw = res["calls"][0]
    step_ms = res["step_ms"]
    del res, out
    want_shape = (3, 3, h, w + 2 * HALO)
    if tuple(img.shape) != want_shape or tuple(sig.shape) != (
            3, -(-h // 8), w // 8 + 2):
        raise AssertionError(f"halo-extended shapes {tuple(img.shape)}, "
                             f"{tuple(sig.shape)}")
    got = epf_cuda.apply_loop_filters(img, sig, **kw)
    ref = filters.apply_loop_filters(img, sig, **kw)
    err = (got - ref).abs().max().item()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"EPF kernel on the halo-extended batch "
                             f"differs from its plain version by {err}")
    del got, ref
    k_ms = cuda_ms(torch, lambda: epf_cuda.apply_loop_filters(img, sig,
                                                              **kw), 20)
    p_ms = cuda_ms(torch, lambda: filters.apply_loop_filters(img, sig,
                                                             **kw), 3)
    b_ms, b_by, _, _ = bound_ms(img.shape[-2], img.shape[-1],
                                sig.shape[-2], sig.shape[-1],
                                kw["epf_iters"], kw["gab"], n=3)
    del img, sig
    torch.cuda.empty_cache()
    kernel_row = {"shape": list(want_shape), "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    sharded = {"frames": 3, "shape": [h, w], "mesh": [1, 1],
               "backend": "nccl", "world_size": 1,
               "host_parse_ms_3_frames": parse_ms,
               "batch_feeds2_ms": batch_ms, "step_device_ms": step_ms,
               "step_device_ms_per_frame": step_ms / 3,
               "batched_v2_device_ms": batched_ms,
               "batched_v2_device_ms_per_frame": batched_ms / 3,
               "epf_launches_per_step": 1,
               "max_lsb_vs_decode_device": frame_lsb,
               "epf_halo_batch": kernel_row}

    # (b) the v1 path (the v2 references first, outside the count).
    stream = libjxl_tpu_torch.encode(entry._test_images(1, 128)[0],
                                     distance=1.0, effort=5)
    d1080 = read(FILE_1080P)
    ref_1080 = libjxl_tpu_torch.decode_device(d1080, out="srgb8")
    f1 = entry.feed_v1(d1080)
    hw1 = f1["image_hw"]
    t = time.perf_counter()
    f4 = entry.feed_v1(streams[0])
    feed_v1_ms = (time.perf_counter() - t) * 1e3

    def v1_4k():
        return pipeline.decode_frame_device(
            f4, f4["lf"], None, None, None, h, w, inv_sigma=f4["inv_sigma"],
            as_numpy=False)
    epf_cuda.launches = 0
    fn, eargs = entry.entry(stream)
    card_entry = fn(*eargs)
    fn, eargs = entry.entry()                   # the default stream
    default_shape = tuple(fn(*eargs).shape)
    xyb_card = pipeline.decode_frame_device(
        f1, f1["lf"], None, None, None, *hw1, return_xyb=True,
        inv_sigma=f1["inv_sigma"])
    srgb_1080 = pipeline.decode_frame_device(
        f1, f1["lf"], None, None, None, *hw1, inv_sigma=f1["inv_sigma"],
        as_numpy=False)
    srgb_4k = v1_4k()
    torch.cuda.synchronize()
    v1_launches = epf_cuda.launches
    v1_ms = cuda_ms(torch, v1_4k, 3)
    fn, eargs = entry.entry(stream, device="cpu")
    entry_lsb = lsb(card_entry, fn(*eargs))
    xyb_cpu = pipeline.decode_frame_device(
        f1, f1["lf"], None, None, None, *hw1, return_xyb=True,
        inv_sigma=f1["inv_sigma"], device="cpu")
    v1_xyb_err = float(np.abs(xyb_card - xyb_cpu).max())
    v1_1080_lsb = lsb(srgb_1080, ref_1080)
    v1_4k_lsb = lsb(srgb_4k, refs[0])
    if not (default_shape == (3, 128, 128) and entry_lsb <= 1
            and v1_xyb_err <= XYB_TOL and v1_1080_lsb <= 1
            and v1_4k_lsb <= 1 and v1_launches == 5):
        raise AssertionError(
            f"v1 path: entry {entry_lsb} LSB ({default_shape}), 1080p XYB "
            f"{v1_xyb_err}, 1080p {v1_1080_lsb} LSB, 4K {v1_4k_lsb} LSB, "
            f"{v1_launches} EPF launches for 5 decodes")
    del f4, srgb_4k, refs
    torch.cuda.empty_cache()

    # (c) the v0 group decode.
    g_card = decode_torch.decode_groups_dct8(*decode_torch.example_inputs())
    g_cpu = decode_torch.decode_groups_dct8(
        *decode_torch.example_inputs(device="cpu"))
    v0_err = (g_card.cpu() - g_cpu).abs().max().item()
    if not (tuple(g_card.shape) == (4, 3, 256, 256)
            and v0_err <= GROUP_TOL):
        raise AssertionError(f"v0 group decode card vs CPU: {v0_err}")
    emit({"phase": "sharded_path", "card": smi, "sharded_v2": sharded,
          "v1": {"entry_max_lsb_card_vs_cpu": entry_lsb,
                 "v1_1080p_xyb_max_abs_card_vs_cpu": v1_xyb_err,
                 "v1_1080p_max_lsb_vs_v2": v1_1080_lsb,
                 "v1_4k_host_feed_v1_ms": feed_v1_ms,
                 "v1_4k_device_ms": v1_ms,
                 "v1_4k_max_lsb_vs_v2": v1_4k_lsb,
                 "epf_launches": v1_launches},
          "v0": {"shape": list(g_card.shape),
                 "max_abs_card_vs_cpu": v0_err}})
    return kernel_row, 1 + v1_launches


def bits_equal(torch, a, b) -> bool:
    """Whether two float32 tensors hold the same bits (-0 is not +0)."""
    torch.cuda.synchronize()
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def load_baseline(epf_cuda, src: str):
    """Build another version of csrc/epf.cu (same flags, same C
    interface) into _build/ and bind it; returns (library, nvcc's
    messages). A measurement aid for --baseline: the port never calls
    it."""
    import ctypes

    from libjxl_tpu_torch.native.build import BUILD_DIR, build_locked
    lib_path = os.path.join(BUILD_DIR, "libjxl_epf_baseline.so")
    log = build_locked(lib_path, src, [epf_cuda.nvcc()] +
                       epf_cuda.NVCC_FLAGS + [src], force=True)
    lib = ctypes.CDLL(lib_path)
    lib.jxl_epf_launch.restype = ctypes.c_int
    lib.jxl_epf_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p]
    return lib, log


def kernel_only_timing(torch, np, epf_cuda, filters, dev, rng, smi,
                       baseline=None):
    """The kernel (gaborish + three passes) on a synthetic 4K frame, a
    synthetic batch of three 1080p frames with one map each and the
    sharded step's halo-extended batch of three (2160, 3856) frames with
    one map each, against its bound; each of the seven instances on the
    4K frame. With ``baseline`` (a library from load_baseline), that
    kernel too, held bit for bit against this one and timed in turns
    with it (baseline, this, this, baseline) in this call."""
    import ctypes
    cases = {}
    for name, shape in (("4k", (3, 2160, 3840)),
                        ("batch_3x1080p", (3, 3, 1080, 1920)),
                        ("halo_batch_3x2160x3856", (3, 3, 2160, 3856))):
        h, w = shape[-2:]
        n = shape[0] if len(shape) == 4 else 1
        img = torch.from_numpy(rng.normal(0, 0.3, shape).astype(
            np.float32)).to(dev)
        maps = shape[:-3] + ((h + 7) // 8, (w + 7) // 8)
        sig = torch.from_numpy(rng.uniform(-6.0, -0.05, maps).astype(
            np.float32)).to(dev)
        cases[name] = (img, sig, bound_ms(h, w, *maps[-2:], 3, True, n))
    consts = epf_cuda.kernel_constants(
        filters.DEFAULT_GAB_WEIGHTS, 0.9, 6.5, 2.0 / 3,
        filters.DEFAULT_CHANNEL_SCALE)

    def run(name, it=3, gab=True):
        img, sig, _ = cases[name]
        return lambda: epf_cuda.apply_loop_filters(img, sig, epf_iters=it,
                                                   gab=gab)

    def run_baseline(name, img=None):
        img_, sig, _ = cases[name]
        img = img_ if img is None else img
        out = torch.empty_like(img)
        n = img.shape[0] if img.dim() == 4 else 1
        h, w = img.shape[-2:]

        def launch():
            rc = baseline.jxl_epf_launch(
                img.data_ptr(), sig.data_ptr(), out.data_ptr(), n, h, w,
                (w + 7) // 8, 0 if sig.dim() == 2 else sig[0].numel(), 1, 3,
                ctypes.addressof(consts),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"baseline kernel launch failed: {rc}")
            return out
        return launch

    row = {"phase": "kernel_timing", "card": smi, "synthetic": True}
    for name, (_, _, (b_ms, b_by, _, _)) in cases.items():
        got = run(name)()                              # warm-up
        torch.cuda.synchronize()
        row[name] = {"bound_ms": b_ms, "bound_by": b_by}
        if baseline is None:
            row[name]["ms"] = cuda_ms(torch, run(name), 20)
            continue
        same = bits_equal(torch, run_baseline(name)(), got)
        if not same:
            raise AssertionError(f"the kernel and the baseline differ on "
                                 f"{name}")
        times = {"baseline": [], "kernel": []}
        for who in ("baseline", "kernel", "kernel", "baseline"):
            times[who].append(cuda_ms(torch, run_baseline(name)
                                      if who == "baseline" else run(name),
                                      20))
        row[name].update(ms=times["kernel"], baseline_ms=times["baseline"],
                         identical_to_baseline=same)
        del got
    if baseline is not None:
        # Bit for bit also where quotients are tiny, subnormal or zero:
        # the 4K frame scaled down, and with a zero region and channel.
        img = cases["4k"][0]
        zeroed = img.clone()
        zeroed[:, 100:900, 200:1500] = 0.0
        zeroed[1] = -0.0
        for label, x in (("x1e-28", img * 1e-28), ("x1e-33", img * 1e-33),
                         ("x1e-38", img * 1e-38), ("zeros", zeroed)):
            sig = cases["4k"][1]
            if not bits_equal(torch, run_baseline("4k", x)(),
                              epf_cuda.apply_loop_filters(
                                  x, sig, epf_iters=3, gab=True)):
                raise AssertionError(f"the kernel and the baseline differ "
                                     f"on the 4K frame {label}")
        row["identical_to_baseline_scaled_4k"] = ["x1e-28", "x1e-33",
                                                  "x1e-38", "zeros"]
        del zeroed, x
    row["instances_4k_ms"] = {}
    for it, gab in STAGES:
        run("4k", it, gab)()
        torch.cuda.synchronize()
        row["instances_4k_ms"][f"gab{int(gab)}_iters{it}"] = cuda_ms(
            torch, run("4k", it, gab), 20)
    emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="build and check the kernel only, and time it")
    ap.add_argument("--baseline", metavar="SRC",
                    help="with --kernel-only: another version of "
                         "csrc/epf.cu to hold bit for bit against the "
                         "kernel and time beside it")
    args = ap.parse_args(argv)
    if args.baseline and not args.kernel_only:
        ap.error("--baseline needs --kernel-only")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA "
              "card", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    threading.Thread(target=_watchdog, args=(t0,), daemon=True).start()
    sys.path.insert(0, ROOT)
    import numpy as np

    from libjxl_tpu_torch.native import build as native_build
    from libjxl_tpu_torch.ops import epf_cuda, filters

    dev = torch.device("cuda")

    # ---- 0. card ----
    _phase[0] = "card"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 1. build (g++ host library and nvcc kernel, in parallel) ----
    _phase[0] = "build"
    results: dict = {}

    def timed(name, fn):
        t = time.monotonic()
        try:
            results[name] = (fn(), time.monotonic() - t)
        except BaseException as e:        # re-raised on the main thread
            results[name] = (e, time.monotonic() - t)

    builds = {"epf": lambda: epf_cuda.build(force=True)}
    if not args.kernel_only:
        builds["native"] = lambda: native_build.build(force=True)
    if args.baseline:
        builds["baseline"] = lambda: load_baseline(
            epf_cuda, os.path.abspath(args.baseline))
    jobs = [threading.Thread(target=timed, args=(name, fn))
            for name, fn in builds.items()]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    for name in builds:
        if isinstance(results[name][0], BaseException):
            raise results[name][0]
    if not args.kernel_only and results["native"][0] is None:
        raise RuntimeError("native host library did not build")
    occupancy = {f"gab{int(g)}_iters{i}": epf_cuda.occupancy(i, g)
                 for i, g in STAGES}
    emit({"phase": "build",
          "seconds": {k: round(v[1], 2) for k, v in results.items()},
          "ptxas": ptxas_summary(results["epf"][0]),
          "occupancy": occupancy})
    if args.baseline:
        emit({"phase": "build_baseline", "source": args.baseline,
              "ptxas": ptxas_summary(results["baseline"][0][1])})

    # ---- 2. kernel vs plain version on the card ----
    _phase[0] = "kernel_vs_plain"
    rng = np.random.default_rng(20260417)
    max_err = 0.0
    for h, w in ((96, 200), (61, 117), (2160, 3840)) + EDGE_SHAPES:
        img = torch.from_numpy(
            rng.normal(0, 0.3, (3, h, w)).astype(np.float32)).to(dev)
        sig = torch.from_numpy(rng.uniform(
            -6.0, -0.05, ((h + 7) // 8, (w + 7) // 8)).astype(
                np.float32)).to(dev)
        for it, gab in STAGES:
            got = epf_cuda.apply_loop_filters(img, sig, epf_iters=it,
                                              gab=gab)
            ref = filters.apply_loop_filters(img, sig, epf_iters=it,
                                             gab=gab)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            max_err = max(max_err, err)
            emit({"phase": "kernel_vs_plain", "shape": [3, h, w],
                  "epf_iters": it, "gab": gab, "max_abs_err": err})
            if not err <= KERNEL_TOL:
                raise AssertionError(
                    f"EPF kernel differs from its plain version by "
                    f"{err} > {KERNEL_TOL} at {(h, w, it, gab)}")
        del img, sig, got, ref
    # Batches: one launch for N frames, each frame held against the plain
    # version run alone, with one block map per frame and with one shared.
    # (2, 123, 528) and (3, 2160, 3856): the sharded step's
    # halo-extended tiles (W_local + 16 px, ragged heights).
    for n, (h, w) in ((3, (1080, 1920)), (2, (61, 117)), (2, (5, 3)),
                      (2, (123, 528)), (3, (2160, 3856))):
        img = torch.from_numpy(rng.normal(0, 0.3, (n, 3, h, w))
                               .astype(np.float32)).to(dev)
        sig = torch.from_numpy(rng.uniform(
            -6.0, -0.05, (n, (h + 7) // 8, (w + 7) // 8)).astype(
                np.float32)).to(dev)
        for shared in (False, True):
            maps = sig[0] if shared else sig
            before = epf_cuda.launches
            got = epf_cuda.apply_loop_filters(img, maps, epf_iters=3,
                                              gab=True)
            if epf_cuda.launches != before + 1:
                raise AssertionError("a batch took more than one launch")
            err = max((got[i] - filters.apply_loop_filters(
                img[i], sig[0] if shared else sig[i], epf_iters=3,
                gab=True)).abs().max().item() for i in range(n))
            torch.cuda.synchronize()
            max_err = max(max_err, err)
            emit({"phase": "kernel_vs_plain", "shape": [n, 3, h, w],
                  "shared_block_map": shared, "epf_iters": 3, "gab": True,
                  "max_abs_err": err})
            if not err <= KERNEL_TOL:
                raise AssertionError(
                    f"batched EPF kernel differs from its plain version "
                    f"by {err} > {KERNEL_TOL} at {(n, h, w, shared)}")
        del img, sig, got
    # Custom loop-filter weights from a frame header.
    from libjxl_tpu_torch.tpu import pipeline
    lf_custom = pipeline.loop_filter_params(custom_loop_filter())
    img = torch.from_numpy(rng.normal(0, 0.3, (3, 257, 389))
                           .astype(np.float32)).to(dev)
    sig = torch.from_numpy(rng.uniform(-6.0, -0.05, (33, 49))
                           .astype(np.float32)).to(dev)
    err = (epf_cuda.apply_loop_filters(img, sig, **lf_custom)
           - filters.apply_loop_filters(img, sig, **lf_custom)) \
        .abs().max().item()
    max_err = max(max_err, err)
    emit({"phase": "kernel_vs_plain", "shape": [3, 257, 389],
          "custom_loop_filter_weights": True, "max_abs_err": err})
    if not err <= KERNEL_TOL:
        raise AssertionError(f"EPF kernel with custom weights differs "
                             f"from its plain version by {err}")
    del img, sig
    torch.cuda.empty_cache()

    if args.kernel_only:
        kernel_only_timing(torch, np, epf_cuda, filters, dev, rng, smi,
                           results["baseline"][0][0] if args.baseline
                           else None)
        emit({"phase": "kernel_only_done", "card": smi,
              "max_abs_err": max_err, "wall_s": time.monotonic() - t0})
        return 0

    import libjxl_tpu_torch
    from libjxl_tpu_torch import device
    from libjxl_tpu_torch.device import feed_to_torch
    from libjxl_tpu_torch.ops import stages
    from libjxl_tpu_torch.ops.decode_torch import xyb_to_pq16

    # ---- 3. main path: bitstream -> PQ16 on the card ----
    _phase[0] = "main_path"
    names = [FILE_1080P] + FILES_4K
    data = {n: read(n) for n in names}
    torch.cuda.reset_peak_memory_stats()
    epf_cuda.launches = 0
    outs = {n: libjxl_tpu_torch.decode_device(data[n], out="pq16")
            for n in names}
    torch.cuda.synchronize()
    main_launches = epf_cuda.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if main_launches != len(names):
        raise AssertionError(f"EPF kernel launched {main_launches} times "
                             f"for {len(names)} frames")
    for n in names:
        o = outs[n]
        want = (3, 1080, 1920) if n == FILE_1080P else (3, 2160, 3840)
        if tuple(o.shape) != want or o.dtype != torch.uint16 \
                or o.device.type != "cuda":
            raise AssertionError(f"{n}: {o.dtype} {tuple(o.shape)} "
                                 f"on {o.device}")
    # Correctness against the plain path on the CPU. XYB is compared at
    # a float tolerance; PQ16 codes are compared on identical XYB input
    # (the card's), because PQ's slope is so steep in dark tones that
    # float32 rounding differences of ~1e-7 in XYB (another summation
    # order in the matmuls) move codes by more than one. The raw
    # card-vs-CPU code difference is reported beside.
    checks = []
    for n in (FILE_1080P, FILES_4K[0]):
        xyb_cpu = libjxl_tpu_torch.decode_device(data[n], out="xyb",
                                                 device="cpu")
        xyb_gpu = libjxl_tpu_torch.decode_device(data[n], out="xyb")
        pq_gpu = outs[n].to(torch.int32).cpu()
        finite = bool(torch.isfinite(xyb_gpu).all().item())
        xyb_err = (xyb_gpu.cpu() - xyb_cpu).abs().max().item()
        tail_err = (pq_gpu - xyb_to_pq16(xyb_gpu.cpu()).to(torch.int32)) \
            .abs().max().item()
        raw = (pq_gpu - xyb_to_pq16(xyb_cpu).to(torch.int32)).abs()
        checks.append({
            "file": n, "finite": finite, "xyb_max_abs_diff": xyb_err,
            "pq16_tail_max_code_diff": tail_err,
            "pq16_vs_cpu_max_code_diff": raw.max().item(),
            "pq16_vs_cpu_share_over_1_code": (raw > 1).double().mean()
            .item()})
        if not (finite and xyb_err <= XYB_TOL and tail_err <= 1):
            raise AssertionError(f"{n}: card vs CPU: {checks[-1]}")
    emit({"phase": "main_path", "frames": len(names),
          "epf_launches": main_launches, "peak_mib": round(peak_mib, 1),
          "checks": checks})
    del outs

    # ---- 4. timing (after a warm-up; card named above) ----
    _phase[0] = "timing"
    h, w = 2160, 3840
    streams = [data[n] for n in FILES_4K]
    parse_ms = []
    feeds = []
    for s in streams:
        t = time.perf_counter()
        feeds.append(libjxl_tpu_torch.parse_to_feed(s))
        parse_ms.append((time.perf_counter() - t) * 1e3)
    for f in feeds:                                     # warm-up
        pipeline.decode_frame_device2(f, h, w, out="pq16")
    torch.cuda.synchronize()
    device_ms = [cuda_ms(torch, lambda f=f: pipeline.decode_frame_device2(
        f, h, w, out="pq16"), 3) for f in feeds]
    # Stage split of one frame: staging, coefficients -> XYB, filters,
    # PQ16 tail.
    f0 = feeds[0]
    staged = feed_to_torch(f0, dev)
    lf = pipeline.loop_filter_params(f0["lf"])

    xyb = pipeline.staged_xyb(staged, h, w)
    filtered = epf_cuda.apply_loop_filters(xyb, staged["inv_sigma"], **lf)
    torch.cuda.synchronize()
    split = {
        "staging_ms": cuda_ms(torch, lambda: feed_to_torch(f0, dev), 3),
        "xyb_ms": cuda_ms(torch, lambda: pipeline.staged_xyb(staged, h, w),
                          3),
        "filters_ms": cuda_ms(torch, lambda: epf_cuda.apply_loop_filters(
            xyb, staged["inv_sigma"], **lf), 20),
        "pq16_ms": cuda_ms(torch, lambda: xyb_to_pq16(filtered), 10),
    }
    # The kernel against its plain version and its bound, on this frame.
    kernel_ms = split["filters_ms"]
    plain_ms = cuda_ms(torch, lambda: filters.apply_loop_filters(
        xyb, staged["inv_sigma"], **lf), 3)
    frame_err = (filters.apply_loop_filters(xyb, staged["inv_sigma"], **lf)
                 - filtered).abs().max().item()
    max_err = max(max_err, frame_err)
    if not frame_err <= KERNEL_TOL:
        raise AssertionError(f"EPF kernel differs from its plain version "
                             f"by {frame_err} on a decoded 4K frame")
    bh, bw = staged["inv_sigma"].shape
    b_ms, b_by, nbytes, ops = bound_ms(h, w, bh, bw, lf["epf_iters"],
                                       lf["gab"])
    del staged, xyb, filtered
    # Sustained: parse on this thread overlapped with device work.
    seq = [streams[i % 3] for i in range(SUSTAINED_DECODES)]
    t = time.perf_counter()
    res = libjxl_tpu_torch.decode_batch(seq, out="pq16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if len(res) != SUSTAINED_DECODES:
        raise AssertionError("sustained run lost frames")
    del res
    emit({"phase": "timing", "card": smi,
          "host_parse_ms_per_4k_frame": parse_ms,
          "device_ms_per_4k_frame": device_ms,
          "stage_split_ms_4k": split,
          "sustained_4k_mpix_per_s":
              SUSTAINED_DECODES * h * w / wall / 1e6,
          "sustained_decodes": SUSTAINED_DECODES, "sustained_wall_s": wall,
          "epf_kernel_ms_4k": kernel_ms, "epf_plain_ms_4k": plain_ms,
          "epf_max_abs_err_decoded_4k": frame_err,
          "epf_bound_ms_4k": b_ms, "epf_bound_by": b_by,
          "epf_bytes": nbytes, "epf_operations": ops})

    # ---- 5. post path: upsampling + noise, and splines, on the card ----
    _phase[0] = "post_path"
    up2, spl = read(FILE_UP2, POST_CORPUS), read(FILE_SPLINES, POST_CORPUS)
    post_feed = libjxl_tpu_torch.parse_to_feed(up2)
    post = post_feed["post"]
    gd, vfi = post["noise"][3], post["noise"][4]
    t = time.perf_counter()
    stages.noise_planes_for(*post["final_hw"], gd, vfi)    # host, cached
    noise_host_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    epf_cuda.launches = 0
    post_outs = {FILE_UP2: libjxl_tpu_torch.decode_device(up2, out="pq16"),
                 FILE_SPLINES: libjxl_tpu_torch.decode_device(spl,
                                                              out="pq16")}
    torch.cuda.synchronize()
    post_launches = epf_cuda.launches
    post_peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if post_launches != 2:
        raise AssertionError(f"EPF kernel launched {post_launches} times "
                             "for 2 post-path frames")
    post_checks = []
    for name, data_, want in ((FILE_UP2, up2, (3, 2160, 3840)),
                              (FILE_SPLINES, spl, (3, 1080, 1920))):
        o = post_outs[name]
        if tuple(o.shape) != want or o.dtype != torch.uint16 \
                or o.device.type != "cuda":
            raise AssertionError(f"{name}: {o.dtype} {tuple(o.shape)} "
                                 f"on {o.device}")
        xyb_cpu = libjxl_tpu_torch.decode_device(data_, out="xyb",
                                                 device="cpu")
        xyb_gpu = libjxl_tpu_torch.decode_device(data_, out="xyb")
        finite = bool(torch.isfinite(xyb_gpu).all().item())
        xyb_err = (xyb_gpu.cpu() - xyb_cpu).abs().max().item()
        # The tail on the card and on the CPU from this same XYB: the
        # spline scatter-adds land in another order in every card run,
        # so the PQ16 output above came from slightly different XYB.
        pq_gpu = xyb_to_pq16(xyb_gpu).to(torch.int32).cpu()
        tail_err = (pq_gpu - xyb_to_pq16(xyb_gpu.cpu()).to(torch.int32)) \
            .abs().max().item()
        run_diff = (o.to(torch.int32).cpu() - pq_gpu).abs().max().item()
        post_checks.append({"file": name, "shape": list(o.shape),
                            "finite": finite, "xyb_max_abs_diff": xyb_err,
                            "pq16_tail_max_code_diff": tail_err,
                            "pq16_two_card_runs_max_code_diff": run_diff})
        if not (finite and xyb_err <= XYB_TOL and tail_err <= 1):
            raise AssertionError(f"{name}: card vs CPU: {post_checks[-1]}")
        del xyb_cpu, xyb_gpu
    del post_outs

    def stage_split(feed):
        """Per-stage device ms of one frame (warm: the noise planes and
        the constant banks are cached on the card)."""
        fpost = feed["post"]
        h, w = feed["image_hw"]
        st = feed_to_torch(feed, dev)
        x0 = pipeline.staged_xyb(st, h, w)
        x1 = pipeline.loop_filters(x0, st)
        x2 = pipeline.upsample_stage(x1, fpost)
        x3 = pipeline.splines_stage(x2, fpost)
        x4 = pipeline.noise_stage(x3, fpost)
        torch.cuda.synchronize()
        split = {
            "staging_ms": cuda_ms(torch, lambda: feed_to_torch(feed, dev),
                                  3),
            "xyb_ms": cuda_ms(torch, lambda: pipeline.staged_xyb(st, h, w),
                              3),
            "filters_ms": cuda_ms(torch, lambda: pipeline.loop_filters(
                x0, st), 10)}
        if "upsample" in fpost:
            split["upsample_ms"] = cuda_ms(
                torch, lambda: pipeline.upsample_stage(x1, fpost), 5)
        if "splines" in fpost:
            split["splines_ms"] = cuda_ms(
                torch, lambda: pipeline.splines_stage(x2, fpost), 5)
        if "noise" in fpost:
            split["noise_ms"] = cuda_ms(
                torch, lambda: pipeline.noise_stage(x3, fpost), 5)
        split["pq16_ms"] = cuda_ms(torch, lambda: xyb_to_pq16(x4), 5)
        split["device_total_ms"] = cuda_ms(
            torch, lambda: pipeline.decode_frame_device2(
                feed, h, w, out="pq16", post=fpost), 3)
        return split

    t = time.perf_counter()
    spl_feed = libjxl_tpu_torch.parse_to_feed(spl)
    spl_parse_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    libjxl_tpu_torch.parse_to_feed(up2)
    up2_parse_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "post_path", "card": smi, "epf_launches": post_launches,
          "peak_mib": post_peak_mib, "checks": post_checks,
          "noise_planes_host_s_first_call": noise_host_s,
          "host_parse_ms": {FILE_UP2: up2_parse_ms,
                            FILE_SPLINES: spl_parse_ms},
          "stage_split_ms": {FILE_UP2: stage_split(post_feed),
                             FILE_SPLINES: stage_split(spl_feed)}})
    torch.cuda.empty_cache()

    # ---- 6. batched path: DecodePipeline(batch=3) at 1080p ----
    _phase[0] = "batched"
    s1080 = data[FILE_1080P]
    mp = 1920 * 1080 / 1e6

    def run(batch, frames, out="pq16"):
        pipe = libjxl_tpu_torch.DecodePipeline(out=out, max_inflight=4,
                                               batch=batch)
        t = time.perf_counter()
        futs = [pipe.submit(s1080) for _ in range(frames)]
        pipe.flush()
        res = [f.result() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        pipe.close()
        return res, wall

    run(1, 2)                                         # warm-up
    epf_cuda.launches = 0
    res, wall1 = run(1, E2E_FRAMES)
    e2e_launches = epf_cuda.launches
    run(BATCH, BATCH)                                 # warm-up
    epf_cuda.launches = 0
    res, wall3 = run(BATCH, BATCHED_FRAMES)
    batched_launches = epf_cuda.launches
    n_batches = -(-BATCHED_FRAMES // BATCH)
    if e2e_launches != E2E_FRAMES or batched_launches != n_batches:
        raise AssertionError(
            f"EPF launches {e2e_launches} for {E2E_FRAMES} single frames "
            f"and {batched_launches} for {n_batches} batches")
    if len(res) != BATCHED_FRAMES or any(
            tuple(o.shape) != (3, 1080, 1920) or o.dtype != torch.uint16
            for o in res):
        raise AssertionError("batched run lost or misshaped frames")
    del res
    # Each frame of a batch against its single decode, in XYB.
    single = libjxl_tpu_torch.decode_device(s1080, out="xyb")
    xres, _ = run(BATCH, BATCH, out="xyb")
    batch_err = max((o - single).abs().max().item() for o in xres)
    if not batch_err <= BATCH_TOL:
        raise AssertionError(f"batched frame differs from its single "
                             f"decode by {batch_err} (XYB)")
    # The kernel on the N x 1080p batch, against its plain version and
    # its bound.
    bfeed = libjxl_tpu_torch.parse_to_feed(s1080)
    bt = device.feeds_to_torch([bfeed] * BATCH, dev)
    bx = pipeline.staged_xyb(bt, 1080, 1920)
    blf = pipeline.loop_filter_params(bfeed["lf"])
    bk = epf_cuda.apply_loop_filters(bx, bt["inv_sigma"], **blf)
    bp = filters.apply_loop_filters(bx, bt["inv_sigma"], **blf)
    b_err = (bk - bp).abs().max().item()
    max_err = max(max_err, b_err)
    if not b_err <= KERNEL_TOL:
        raise AssertionError(f"batched EPF kernel differs from its plain "
                             f"version by {b_err} on decoded frames")
    bk_ms = cuda_ms(torch, lambda: epf_cuda.apply_loop_filters(
        bx, bt["inv_sigma"], **blf), 20)
    bp_ms = cuda_ms(torch, lambda: filters.apply_loop_filters(
        bx, bt["inv_sigma"], **blf), 3)
    bbh, bbw = bt["inv_sigma"].shape[-2:]
    bb_ms, bb_by, _, _ = bound_ms(1080, 1920, bbh, bbw, blf["epf_iters"],
                                  blf["gab"], n=BATCH)
    del bt, bx, bk, bp, xres, single
    emit({"phase": "batched", "card": smi,
          "e2e_1080p_mpix_s": E2E_FRAMES * mp / wall1,
          "e2e_1080p_batched_mpix_s": BATCHED_FRAMES * mp / wall3,
          "e2e_frames": E2E_FRAMES, "e2e_wall_s": wall1,
          "batched_frames": BATCHED_FRAMES, "batch": BATCH,
          "batched_wall_s": wall3, "epf_launches_batch1": e2e_launches,
          "epf_launches_batched": batched_launches,
          "batched_vs_single_xyb_max_abs_diff": batch_err,
          "epf_kernel_ms_batch": bk_ms, "epf_plain_ms_batch": bp_ms,
          "epf_bound_ms_batch": bb_ms, "epf_bound_by_batch": bb_by,
          "epf_max_abs_err_batch": b_err,
          "epf_batch_shape": [BATCH, 3, 1080, 1920]})

    # ---- 7. public decode API: decode / decode_all on the card ----
    _phase[0] = "api_path"
    torch.cuda.empty_cache()
    api_launches = api_path(torch, np, epf_cuda, smi)

    # ---- 8. encoder: encode() on the card ----
    _phase[0] = "encode_path"
    torch.cuda.empty_cache()
    enc_launches = encode_path(torch, np, epf_cuda, smi)

    # ---- 9. sharded step (NCCL, world size 1), v1 path, v0 groups ----
    _phase[0] = "sharded_path"
    torch.cuda.empty_cache()
    halo_row, sharded_launches = sharded_path(torch, np, epf_cuda, filters,
                                              smi)
    max_err = max(max_err, halo_row["max_abs_err"])

    # ---- 10-11. command line, the rest of the encode API, the tools ----
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp, \
            NoPil():              # nothing of the phases may need PIL
        _phase[0] = "cli_path"
        torch.cuda.empty_cache()
        cli_launches = cli_path(torch, np, epf_cuda, smi, tmp)
        _phase[0] = "tools_path"
        torch.cuda.empty_cache()
        tools_launches = tools_path(torch, np, epf_cuda, smi, tmp)

    # ---- 12-13. the repository's tools; the error contract (last, so
    # that a device-side assert poisons no later phase) ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        _phase[0] = "conformance_path"
        torch.cuda.empty_cache()
        conformance_launches = conformance_path(torch, np, epf_cuda, smi,
                                                tmp)
    _phase[0] = "robustness_path"
    torch.cuda.empty_cache()
    robustness_launches, after_err = robustness_path(torch, np, epf_cuda,
                                                     filters, smi)
    max_err = max(max_err, after_err)

    # ---- 14. kernels (the line before the last) ----
    _phase[0] = "kernels"
    emit({"phase": "done", "wall_s": time.monotonic() - t0})
    emit({"kernels": [{
        "name": "gaborish_epf",
        "route": "cuda",
        "source": "libjxl_tpu_torch/csrc/epf.cu",
        "replaces": "libjxl_tpu/ops/epf_pallas.py:233",
        "launches": (main_launches + post_launches + e2e_launches
                     + batched_launches + api_launches
                     + enc_launches + sharded_launches + cli_launches
                     + tools_launches + conformance_launches
                     + robustness_launches),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        # The sharded step's launch: three 4K frames widened by the
        # 8-px halo on both sides, one sigma map each.
        "halo_extended_batch": halo_row,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        print(f"chip_smoke: failed in phase {_phase[0]!r}",
              file=sys.stderr, flush=True)
        raise
    sys.exit(rc)
