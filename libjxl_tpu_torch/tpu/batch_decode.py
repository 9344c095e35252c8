"""Sustained decode: host parse on the caller's thread, overlapped with
staging and device work on one worker thread and its own CUDA stream.

Port of libjxl_tpu/tpu/batch_decode.py: ``DecodePipeline`` with
``batch`` (consecutive frames of one shape decoded together through
``decode_frames_device_batched``, one kernel launch per batch) and
``flush``, and ``decode_batch``.
"""

from __future__ import annotations

import concurrent.futures as _cf
import threading

import torch

from libjxl_tpu_torch.bitstream.bit_io import BitReader
from libjxl_tpu_torch.container.boxes import is_container, unpack_container
from libjxl_tpu_torch.device import resolve_device
from libjxl_tpu_torch.frame.decode_frame import decode_frame
from libjxl_tpu_torch.frame.headers import read_codestream_headers
from libjxl_tpu_torch.tpu.pipeline import (
    OUTPUTS, decode_frame_device2, decode_frames_device_batched,
)


def parse_to_feed(data: bytes) -> dict:
    """Host entropy decode of a (possibly containerized) codestream into
    the device feed of its first frame (a single VarDCT frame). A frame
    with upsampling, noise or splines carries them under ``"post"``."""
    if is_container(data):
        data = unpack_container(data).codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    return decode_frame(r, meta, device="feed").feed


def decode_device(data: bytes, out: str = "pq16",
                  device=None) -> torch.Tensor:
    """Decode one bitstream to a (3, H, W) tensor on ``device`` (default
    ``cuda``): uint16 PQ ("pq16"), uint8 sRGB ("srgb8") or float32 XYB
    ("xyb"). H and W are the image's size after the frame's upsampling."""
    dev = resolve_device(device)
    feed = parse_to_feed(data)
    h, w = feed["image_hw"]
    return decode_frame_device2(feed, h, w, out=out, device=dev,
                                post=feed.get("post"))


class DecodePipeline:
    """Streaming decoder: bitstreams in, device tensors out.

        pipe = DecodePipeline(out="pq16", batch=3)
        futures = [pipe.submit(s) for s in streams]
        pipe.flush()
        results = [f.result() for f in futures]
        pipe.close()

    ``submit`` parses on the calling thread, then hands the feed to one
    worker thread that stages it and runs the device decode on the
    pipeline's own CUDA stream. With ``batch`` > 1, consecutive frames
    wait until ``batch`` of them are pending (or ``flush``) and are then
    decoded together, with one kernel launch; a group that cannot be
    batched (mixed shapes, post stages; ValueError) is decoded frame by
    frame, and any other failure goes to every frame of the group. A
    future resolves when its output is complete on the card; the output
    (a view of the batch's (N, ...) tensor) is then safe to use from the
    stream that was current when it was submitted. ``max_inflight``
    bounds the frames between parse and completion (device memory
    pressure); a partial batch that holds all of them is flushed.
    """

    def __init__(self, out: str = "pq16", max_inflight: int = 4,
                 batch: int = 1, device=None):
        if out not in OUTPUTS:
            raise ValueError(f"out must be one of {OUTPUTS}, not {out!r}")
        self._out = out
        self._batch = max(1, int(batch))
        self._pending: list = []     # (feed, Future, consumer stream)
        self._dev = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._dev)
                        if self._dev.type == "cuda" else None)
        self._stage = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="jxl-stage")
        self._max_inflight = max_inflight
        self._slots = threading.Semaphore(max_inflight)

    def submit(self, data: bytes) -> "_cf.Future":
        """Parse on the calling thread, then stage + decode on the worker;
        returns a Future of the (3, H, W) output tensor."""
        feed = parse_to_feed(data)
        consumer = (torch.cuda.current_stream(self._dev)
                    if self._stream is not None else None)
        if len(self._pending) >= self._max_inflight:
            self.flush()             # else no slot could ever come free
        self._slots.acquire()
        if self._batch == 1:
            try:
                fut = self._stage.submit(self._render, feed, consumer)
            except BaseException:
                self._slots.release()
                raise
            fut.add_done_callback(lambda _: self._slots.release())
            return fut
        fut = _cf.Future()
        self._pending.append((feed, fut, consumer))
        if len(self._pending) >= self._batch:
            self.flush()
        return fut

    def flush(self) -> None:
        """Dispatch the pending partial batch, if any."""
        if not self._pending:
            return
        group, self._pending = self._pending, []
        self._stage.submit(self._render_batch, group)

    def _on_stream(self, fn, consumers):
        """Run ``fn`` on the pipeline's stream, make its output safe for
        the consumers' streams, and wait for it."""
        if self._stream is None:
            return fn()
        with torch.cuda.stream(self._stream):
            res = fn()
        # The caching allocator must not hand the output's memory back to
        # this stream while a consumer's stream may still read it; views
        # share their base's memory, so one record per stream covers them.
        for c in set(consumers):
            res.record_stream(c)
        self._stream.synchronize()
        return res

    def _render(self, feed: dict, consumer):
        h, w = feed["image_hw"]
        return self._on_stream(lambda: decode_frame_device2(
            feed, h, w, out=self._out, device=self._dev,
            post=feed.get("post")), [consumer])

    def _render_batch(self, group: list) -> None:
        feeds = [f for f, _, _ in group]
        h, w = feeds[0]["image_hw"]
        try:
            res = self._on_stream(lambda: decode_frames_device_batched(
                feeds, h, w, out=self._out, device=self._dev),
                [c for _, _, c in group])
            for i, (_, fut, _) in enumerate(group):
                fut.set_result(res[i])
        except ValueError:
            # Mixed shapes or frames that cannot be batched: per frame.
            for f, fut, c in group:
                try:
                    fut.set_result(self._render(f, c))
                except Exception as e:
                    fut.set_exception(e)
        except Exception as e:       # every waiter gets the failure
            for _, fut, _ in group:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            for _ in group:
                self._slots.release()

    def close(self) -> None:
        """Flush, then wait for every dispatched frame."""
        self.flush()
        self._stage.shutdown(wait=True)


def decode_batch(streams, out: str = "pq16", device=None,
                 max_inflight: int = 4, batch: int = 1) -> list:
    """Decode bitstreams through the pipeline; returns the (3, H, W)
    output tensors on ``device``, in order."""
    pipe = DecodePipeline(out=out, max_inflight=max_inflight, batch=batch,
                          device=device)
    try:
        futs = [pipe.submit(s) for s in streams]
        pipe.flush()
        return [f.result() for f in futs]
    finally:
        pipe.close()
