"""The decoder entry points under fuzz, the stream the mutation tests
start from, and the check that a host feed stages only in-range indices.

Port of the entry points of tests/test_fuzz.py (``ENTRY_POINTS``,
:35-114) and of its ``_valid_stream`` (:124-128). Every entry point
either returns or raises ``JxlError`` on any input; any other exception
is a fault. Differences from the reference:
- ``entry_points(device)`` builds the table: ``decode`` and
  ``decode_all`` run the port's device route on ``device`` (``cuda`` by
  default; raises without a card), where the reference's run on the
  host. The other eight are host parsers, as there;
- ``valid_stream(device)`` encodes on ``device``; on the CPU its bytes
  are the reference's;
- the module lives in the package, so ``tools/fuzz_hunt`` takes its
  targets from here and not from ``tests/`` (reference
  tools/fuzz_hunt.py:54).

``feed_index_faults`` lists what of a host feed (``parse_to_feed``'s
dict) would index out of range on the device: a sparse coefficient
index, a bank slot of ``mat_ids``, a big-block anchor or a map shape.
On a card such an index in ``index_add_`` or a gather is a device-side
assert that ends the process's CUDA context; ``checking_feeds`` records
the faults of every feed that the device route stages while it is
active.
"""

from __future__ import annotations

import contextlib

import numpy as np

from libjxl_tpu_torch.device import resolve_device


def entry_points(device=None) -> dict:
    """name -> fn(data) for the ten entry points of the reference's
    fuzz tests; ``decode`` and ``decode_all`` run on ``device``."""
    dev = resolve_device(device)

    def decode(data):
        from libjxl_tpu_torch.api.simple import decode
        decode(bytes(data), device=dev)

    def decode_all(data):
        from libjxl_tpu_torch.api.simple import decode_all
        decode_all(bytes(data), device=dev)

    return {
        "decode": decode,
        "decode_all": decode_all,
        "container": _container,
        "headers": _headers,
        "icc": _icc,
        "histograms": _histograms,
        "modular": _modular,
        "jbrd": _jbrd,
        "jpeg": _jpeg,
        "streaming": _streaming,
    }


def _container(data):
    from libjxl_tpu_torch.container.boxes import unpack_container
    unpack_container(bytes(data))


def _headers(data):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.frame.headers import read_codestream_headers
    read_codestream_headers(BitReader(bytes(data)))


def _icc(data):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.color.icc_codec import read_icc
    read_icc(BitReader(bytes(data)))


def _histograms(data):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.entropy.codes import decode_histograms
    decode_histograms(BitReader(bytes(data)), 16)


def _modular(data):
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.modular.codec import modular_decode
    from libjxl_tpu_torch.modular.image import ModularImage
    img = ModularImage(16, 16, 8, 3)
    modular_decode(BitReader(bytes(data)), img, 0, undo_transforms=True)


def _jbrd(data):
    from libjxl_tpu_torch.extras.jbrd import decode_jbrd
    decode_jbrd(bytes(data))


def _jpeg(data):
    from libjxl_tpu_torch.extras.jpeg_parser import parse_jpeg
    parse_jpeg(bytes(data))


def _streaming(data):
    from libjxl_tpu_torch.api.decoder import Decoder, Event
    dec = Decoder()
    data = bytes(data)
    for i in range(0, len(data), 37):
        dec.set_input(data[i:i + 37])
        for _ in range(4):
            ev = dec.process_input()
            if ev in (Event.SUCCESS, Event.ERROR):
                return
    dec.close_input()
    for _ in range(16):
        ev = dec.process_input()
        if ev in (Event.SUCCESS, Event.ERROR):
            return


def valid_stream(device=None) -> bytes:
    """The reference's mutation base: a 56x40 noisy image at distance 1,
    effort 3 (1676 bytes), encoded on ``device``."""
    from libjxl_tpu_torch.api.simple import encode
    rng = np.random.default_rng(11)
    img = np.clip(rng.normal(128, 40, (40, 56, 3)), 0, 255).astype(np.uint8)
    return encode(img, distance=1.0, effort=3, device=device)


def feed_index_faults(feed: dict) -> list:
    """What of ``feed`` would index out of range on the device: one
    string per fault, none for a feed that stages safely."""
    from libjxl_tpu_torch.tpu.feed import family8_matrices
    faults = []
    bh, bw = np.asarray(feed["mat_ids"]).shape
    want = {"coeff_img": (3, bh * 8, bw * 8), "raw_quant": (bh, bw),
            "dc": (3, bh, bw), "fx": (bh, bw), "fb": (bh, bw),
            "inv_sigma": (bh, bw), "biases": (4,), "qmul": (3,),
            "tables8": family8_matrices().shape[:1] + (3, 64)}
    for key, shape in want.items():
        if tuple(np.shape(feed[key])) != shape:
            faults.append(f"{key} shape {np.shape(feed[key])}, not {shape}")
    h, w = feed["image_hw"]
    if not (0 < h <= bh * 8 and 0 < w <= bw * 8):
        faults.append(f"image_hw {(h, w)} outside the {bh}x{bw} blocks")
    ids = np.asarray(feed["mat_ids"])
    if ids.size and (ids.max() >= want["tables8"][0] or ids.min() < -1):
        faults.append(f"mat_ids in [{ids.min()}, {ids.max()}]")
    nz = feed.get("coeff_nz")
    if nz is not None:
        idx = np.asarray(nz[0])
        numel = 3 * bh * 8 * bw * 8
        if idx.shape != np.shape(nz[1]):
            faults.append("coeff_nz index and value counts differ")
        if idx.size and (idx.min() < 0 or idx.max() >= numel):
            faults.append(f"coeff_nz index in [{idx.min()}, {idx.max()}] "
                          f"for {numel} coefficients")
    masks = feed.get("class_masks") or {}
    for (cy, cx), (anchors, mask) in feed["classes"].items():
        if tuple(np.shape(feed["big_tables"][(cy, cx)])) != (
                3, cy * cx * 64):
            faults.append(f"big_tables[{cy, cx}] shape "
                          f"{np.shape(feed['big_tables'][(cy, cx)])}")
        a = np.asarray(anchors)[np.asarray(mask) != 0]
        if a.size and (a.min() < 0 or (a // bw).max() + cy > bh
                       or (a % bw).max() + cx > bw):
            faults.append(f"class {(cy, cx)} anchor outside the blocks")
        if (cy, cx) in masks and tuple(np.shape(masks[(cy, cx)])) != (
                -(-bh // cy), -(-bw // cx)):
            faults.append(f"class_masks[{cy, cx}] shape "
                          f"{np.shape(masks[(cy, cx)])}")
    return faults


@contextlib.contextmanager
def checking_feeds(faults: list):
    """While active, every feed that ``decode_frame_device2`` stages is
    checked first, and its faults are appended to ``faults``."""
    from libjxl_tpu_torch.tpu import pipeline
    orig = pipeline.feed_to_torch

    def checked(feed, device):
        faults.extend(feed_index_faults(feed))
        return orig(feed, device)

    pipeline.feed_to_torch = checked
    try:
        yield faults
    finally:
        pipeline.feed_to_torch = orig
