"""The port's batched decode (``decode_frames_device_batched``,
``DecodePipeline(batch=)``, ``flush``, ``decode_batch(batch=)``) on the
CPU: against the JAX package's batched decode on the same feeds (XYB
within 1e-4: products summed in another order) and against the port's
own single-frame decode (each frame within 1e-5: the same arithmetic
with a batch axis, so only the matmuls' blocking may differ)."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libjxl_tpu.api import simple  # noqa: E402
from libjxl_tpu.tpu import pipeline as jax_pipeline  # noqa: E402
from libjxl_tpu.tpu.batch_decode import (  # noqa: E402
    parse_to_feed as jax_parse,
)
import libjxl_tpu_torch  # noqa: E402
from libjxl_tpu_torch.ops import filters  # noqa: E402
from libjxl_tpu_torch.tpu import batch_decode, pipeline  # noqa: E402
from libjxl_tpu_torch.tpu.batch_decode import parse_to_feed  # noqa: E402

XYB_TOL = 1e-4
SINGLE_TOL = 1e-5


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.clip(0.5 + 0.3 * np.sin(x / (11 + 2 * c) + c)
                            * np.cos(y / 17)
                            + rng.normal(0, 0.02, (h, w)), 0, 1)
                    for c in range(3)], axis=-1)
    return (img * 255).astype(np.uint8)


def _patterned(seed):
    """Noise, a ramp and a checkerboard: the encoder picks several
    8x8-family transforms and big blocks up to 64x64."""
    rng = np.random.default_rng(seed)
    img = np.full((200, 304, 3), 128, np.uint8)
    img[:100, :150] = rng.integers(0, 255, (100, 150, 3))
    img[100:, 150:] = (np.arange(154)[None, :, None] * 1.5).astype(np.uint8)
    y, x = np.mgrid[0:100, 0:150]
    img[100:, :150] = ((x // 4 + y // 4) % 2 * 200)[..., None]
    return img


_STREAMS: dict = {}


def _streams():
    """Three 200x304 frames of one shape with different class sets and
    8x8-family slots, a 96x96 frame (one group: the gather class path)
    and a 264x304 frame."""
    if not _STREAMS:
        _STREAMS["batch"] = [
            simple.encode(_smooth(200, 304, 3), distance=1.0, effort=5),
            simple.encode(_patterned(0), distance=1.0, effort=7),
            simple.encode(_patterned(1), distance=1.0, effort=5)]
        _STREAMS["small"] = simple.encode(_smooth(96, 96, 4),
                                          distance=1.0, effort=5)
        _STREAMS["taller"] = simple.encode(_smooth(264, 304, 5),
                                           distance=1.0, effort=5)
    return _STREAMS


def _single_xyb(data):
    return libjxl_tpu_torch.decode_device(data, out="xyb", device="cpu")


def test_batched_matches_jax_and_single_decodes():
    streams = _streams()["batch"]
    feeds = [parse_to_feed(s) for s in streams]
    pipeline.check_batchable(feeds)
    classes = [set(f["classes"]) for f in feeds]
    assert len({frozenset(c) for c in classes}) > 1   # zero-filled masks
    got = pipeline.decode_frames_device_batched(feeds, 200, 304,
                                                out="xyb", device="cpu")
    assert got.shape == (3, 3, 200, 304) and got.dtype == torch.float32
    ref = np.asarray(jax_pipeline.decode_frames_device_batched(
        [jax_parse(s) for s in streams], 200, 304, out="xyb"))
    assert np.abs(got.numpy() - ref).max() <= XYB_TOL
    for i, s in enumerate(streams):
        assert (got[i] - _single_xyb(s)).abs().max().item() <= SINGLE_TOL


@pytest.mark.parametrize("out,dtype", [("pq16", torch.uint16),
                                       ("srgb8", torch.uint8)])
def test_batched_output_tails(out, dtype):
    streams = _streams()["batch"][:2]
    feeds = [parse_to_feed(s) for s in streams]
    got = pipeline.decode_frames_device_batched(feeds, 200, 304, out=out,
                                                device="cpu")
    assert got.dtype == dtype and got.shape == (2, 3, 200, 304)
    xyb = pipeline.decode_frames_device_batched(feeds, 200, 304,
                                                out="xyb", device="cpu")
    assert torch.equal(got, pipeline.output_tail(xyb, out))


def _with(feed, **kw):
    f = dict(feed)
    f.update(kw)
    return f


def test_batch_preconditions_raise_value_error():
    a, b = (parse_to_feed(s) for s in _streams()["batch"][:2])
    taller = parse_to_feed(_streams()["taller"])
    lf = type(a["lf"])(**vars(a["lf"]))
    lf.gab_x_weight1 = 0.2
    gather = {k: v for k, v in b.items() if k != "class_masks"}
    dense = {k: v for k, v in b.items() if k != "coeff_nz"}
    bad = {
        "same-shape": [a, taller],
        "weights": [a, _with(b, lf=lf)],
        "post": [a, _with(b, post={"upsample": 2})],
        "dense-mask": [a, gather],
        "sparse": [a, dense],
    }
    for match, feeds in bad.items():
        with pytest.raises(ValueError, match=match):
            pipeline.decode_frames_device_batched(feeds, 200, 304,
                                                  device="cpu")


def test_pipeline_batch_with_partial_flush():
    """batch=3 over four frames: one full batch, then a partial one that
    flush() dispatches; each output within 1e-5 of its single decode."""
    streams = _streams()["batch"] + _streams()["batch"][:1]
    pipe = libjxl_tpu_torch.DecodePipeline(out="xyb", batch=3,
                                           device="cpu")
    try:
        futs = [pipe.submit(s) for s in streams]
        assert not futs[3].done()            # pending until flush()
        pipe.flush()
        outs = [f.result(timeout=300) for f in futs]
    finally:
        pipe.close()
    for s, o in zip(streams, outs):
        assert tuple(o.shape) == (3, 200, 304)
        assert (o - _single_xyb(s)).abs().max().item() <= SINGLE_TOL
    # The first three outputs are views of one (3, ...) batch tensor.
    assert outs[0].untyped_storage().data_ptr() == \
        outs[2].untyped_storage().data_ptr()


def test_pipeline_batch_falls_back_on_mixed_shapes():
    streams = [_streams()["small"], _streams()["batch"][0],
               _streams()["small"]]
    outs = libjxl_tpu_torch.decode_batch(streams, out="xyb", device="cpu",
                                         batch=3)
    for s, o in zip(streams, outs):
        assert torch.equal(o, _single_xyb(s))


def test_pipeline_batch_passes_other_errors_to_every_waiter(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device failure")
    monkeypatch.setattr(batch_decode, "decode_frames_device_batched", boom)
    pipe = libjxl_tpu_torch.DecodePipeline(out="xyb", batch=2,
                                           device="cpu")
    try:
        futs = [pipe.submit(s) for s in _streams()["batch"][:2]]
        for f in futs:
            with pytest.raises(RuntimeError, match="device failure"):
                f.result(timeout=300)
    finally:
        pipe.close()


def test_pipeline_batch_larger_than_max_inflight():
    """A batch that waits for more frames than may be in flight is
    flushed instead of blocking forever; close() flushes the rest."""
    streams = _streams()["batch"] * 2
    pipe = libjxl_tpu_torch.DecodePipeline(out="xyb", batch=4,
                                           max_inflight=2, device="cpu")
    futs = [pipe.submit(s) for s in streams]
    pipe.close()
    assert all(f.done() for f in futs)
    for s, f in zip(streams, futs):
        assert (f.result() - _single_xyb(s)).abs().max().item() \
            <= SINGLE_TOL


def test_decode_batch_with_post_stages_falls_back():
    """Frames with post stages are not batched; the pipeline decodes
    them one by one, to the upsampled size."""
    data = simple.encode(_smooth(64, 80, 5), distance=1.0, effort=5,
                         resampling=2)
    outs = libjxl_tpu_torch.decode_batch([data, data], out="xyb",
                                         device="cpu", batch=2)
    ref = _single_xyb(data)
    assert tuple(ref.shape) == (3, 64, 80)
    for o in outs:
        assert torch.equal(o, ref)


def test_plain_filters_take_a_batch():
    """The kernel's plain version on (N, 3, H, W) equals N single calls,
    with one shared block map and with one map per frame."""
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.normal(0, 0.3, (2, 3, 29, 43))
                           .astype(np.float32))
    sig = torch.from_numpy(rng.uniform(-6, -0.05, (2, 4, 6))
                           .astype(np.float32))
    for it, gab in ((3, True), (2, False), (0, True)):
        both = filters.apply_loop_filters(img, sig, epf_iters=it, gab=gab)
        shared = filters.apply_loop_filters(img, sig[0], epf_iters=it,
                                            gab=gab)
        for i in range(2):
            one = filters.apply_loop_filters(img[i], sig[i], epf_iters=it,
                                             gab=gab)
            assert torch.equal(both[i], one)
            assert torch.equal(
                shared[i], filters.apply_loop_filters(
                    img[i], sig[0], epf_iters=it, gab=gab))


def test_future_type():
    pipe = libjxl_tpu_torch.DecodePipeline(out="xyb", batch=2,
                                           device="cpu")
    try:
        fut = pipe.submit(_streams()["small"])
        assert isinstance(fut, cf.Future) and not fut.done()
    finally:
        pipe.close()
    assert fut.done()
