"""The port's post stages (libjxl_tpu_torch/ops/stages.py) and the
decode of frames that carry them, against the JAX package on the CPU.

Each stage function runs on the same numpy inputs (made from a seed) as
its counterpart in libjxl_tpu/ops/stages_tpu.py. Tolerances: upsampling,
Laplacian, noise and splines 1e-5 (float32 sums in another order; erf
of two libraries); the strength LUT 1e-6; the raw noise planes bit for
bit (the same host generator). Whole streams (2x and 4x resampling,
photon noise, noise with upsampling, splines): XYB within 1e-4 of the
JAX device path (``decode_frame(..., device=True).xyb``), and sRGB8
within 1 LSB of the JAX host decode, pinned to one worker because the
host's pixels depend on the worker count.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from libjxl_tpu.api import simple  # noqa: E402
from libjxl_tpu.bitstream.bit_io import BitReader  # noqa: E402
from libjxl_tpu.frame.decode_frame import (  # noqa: E402
    decode_frame as jax_decode_frame,
)
from libjxl_tpu.frame.headers import read_codestream_headers  # noqa: E402
from libjxl_tpu.ops import stages_tpu  # noqa: E402
from libjxl_tpu.parallel.runner import (  # noqa: E402
    ThreadRunner, get_runner, set_runner,
)
from libjxl_tpu.pipeline.upsample import _kernels as jax_kernels  # noqa: E402
import libjxl_tpu_torch  # noqa: E402
from libjxl_tpu_torch.ops import stages  # noqa: E402
from libjxl_tpu_torch.pipeline.upsample import _kernels  # noqa: E402
from libjxl_tpu_torch.tpu import pipeline  # noqa: E402
from libjxl_tpu_torch.tpu.batch_decode import parse_to_feed  # noqa: E402

XYB_TOL = 1e-4
STAGE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plane(seed, shape):
    return np.random.default_rng(seed).normal(0, 0.3, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_upsample_matches_jax(n):
    np.testing.assert_array_equal(_kernels(n), jax_kernels(n))
    k = _kernels(n).astype(np.float32)
    img = _plane(n, (3, 13, 22))
    ref = np.asarray(stages_tpu.upsample_image_tpu(jnp.asarray(img), n, k))
    got = stages.upsample_image(_t(img), n, _t(k)).numpy()
    assert got.shape == (3, 13 * n, 22 * n)
    assert np.abs(got - ref).max() <= STAGE_TOL


def test_laplacian_matches_jax():
    plane = _plane(1, (37, 29))
    ref = np.asarray(stages_tpu._laplacian5_tpu(jnp.asarray(plane)))
    got = stages.laplacian5(_t(plane)).numpy()
    assert np.abs(got - ref).max() <= STAGE_TOL


def test_strength_lut_matches_jax():
    rng = np.random.default_rng(2)
    lut = rng.uniform(0, 1.2, 8).astype(np.float32)
    x = rng.uniform(-0.5, 1.5, (41, 23)).astype(np.float32)
    ref = np.asarray(stages_tpu._strength_lut_tpu(jnp.asarray(lut),
                                                  jnp.asarray(x)))
    got = stages.strength_lut(_t(lut), _t(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6


def test_noise_planes_bit_exact():
    ref = stages_tpu.noise_planes_for(70, 90, 64, 1)
    got = stages.noise_planes_for(70, 90, 64, 1)
    assert got.dtype == np.float32 and got.shape == (3, 70, 90)
    np.testing.assert_array_equal(got, ref)


def test_add_noise_matches_jax():
    rng = np.random.default_rng(3)
    xyb = (rng.normal(0, 0.1, (3, 40, 56))
           + np.array([0, 0.5, 0.3])[:, None, None]).astype(np.float32)
    raw = stages.noise_planes_for(40, 56, 256, 1)
    lut = rng.uniform(0, 0.6, 8).astype(np.float32)
    ref = np.asarray(stages_tpu.add_noise_tpu(
        jnp.asarray(xyb), jnp.asarray(raw), jnp.asarray(lut), 0.1, 0.9))
    got = stages.add_noise(_t(xyb), _t(raw), _t(lut), 0.1, 0.9).numpy()
    assert np.abs(got - ref).max() <= STAGE_TOL


def test_render_splines_matches_jax():
    """Random splats, some across the frame edge, plus zero-intensity
    padding."""
    rng = np.random.default_rng(4)
    n = 64
    cy = rng.uniform(-10, 70, n).astype(np.float32)
    cx = rng.uniform(-10, 90, n).astype(np.float32)
    sig = rng.uniform(0.5, 4, n).astype(np.float32)
    inten = rng.uniform(0.2, 1.5, n).astype(np.float32)
    inten[50:] = 0
    col = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    xyb = _plane(5, (3, 60, 80))
    args = (cy, cx, sig, inten, col)
    ref = np.asarray(stages_tpu.render_splines_tpu(
        jnp.asarray(xyb), *map(jnp.asarray, args)))
    got = stages.render_splines(_t(xyb), *map(_t, args)).numpy()
    assert np.abs(got - ref).max() <= STAGE_TOL
    assert np.abs(got - xyb).max() > 0.1


def _image(h, w, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.clip(0.5 + 0.3 * np.sin(x / 13 + c) * np.cos(y / 19)
                     + rng.normal(0, 0.02, (h, w)), 0, 1)
             for c in range(3)]
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _splines_stream():
    """A frame with two strokes, as tests/test_device_stages.py builds
    it (the loop filters stay on)."""
    from libjxl_tpu.api.simple import CodecMetadata
    from libjxl_tpu.bitstream.bit_io import BitWriter
    from libjxl_tpu.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    from libjxl_tpu.frame.encode_frame import encode_vardct_frame
    from libjxl_tpu.frame.headers import BitDepth, write_codestream_headers
    from libjxl_tpu.frame.splines import Splines, quantize_spline

    qs, starts = [], []
    for cps, g, s0 in (([(10.0, 20.0), (60.0, 10.0), (100.0, 60.0),
                         (150.0, 120.0)], 0.4, 2.0),
                       ([(180.0, 10.0), (120.0, 80.0), (30.0, 140.0)],
                        -0.3, 1.2)):
        color_dct = np.zeros((3, 32))
        color_dct[1, 0] = g
        color_dct[0, 1] = 0.15
        sigma_dct = np.zeros(32)
        sigma_dct[0] = s0
        qs.append(quantize_spline(cps, color_dct, sigma_dct, 0, 0.0, 1.0))
        starts.append(cps[0])
    meta = CodecMetadata()
    meta.size.set(200, 160)
    meta.m.bit_depth = BitDepth.uint(8)
    meta.m.xyb_encoded = True
    w = BitWriter()
    write_codestream_headers(meta, w)
    srgb = _image(160, 200, seed=8).astype(np.float32) / 255.0
    xyb = linear_rgb_to_xyb(srgb_to_linear(srgb).transpose(2, 0, 1))
    encode_vardct_frame(xyb, meta, w, distance=1.0, effort=5,
                        splines=Splines(splines=qs, starting_points=starts))
    w.align_to_byte()
    return w.get_bytes()


STREAMS = {
    "up2": lambda: simple.encode(_image(96, 112), distance=1.0, effort=5,
                                 resampling=2),
    "up4": lambda: simple.encode(_image(96, 112), distance=1.0, effort=5,
                                 resampling=4),
    "photon_noise": lambda: simple.encode(_image(128, 128, seed=7),
                                          distance=1.0, effort=5,
                                          photon_noise_iso=3200),
    "noise_up2": lambda: simple.encode(_image(80, 80, seed=9),
                                       distance=1.5, effort=5,
                                       resampling=2, noise=1.5),
    "splines": _splines_stream,
}
STAGES = {"up2": {"upsample"}, "up4": {"upsample"},
          "photon_noise": {"noise"}, "noise_up2": {"upsample", "noise"},
          "splines": {"splines"}}
_DATA: dict = {}


def _data(name):
    if name not in _DATA:
        _DATA[name] = STREAMS[name]()
    return _DATA[name]


def _jax_device_xyb(data):
    r = BitReader(data)
    meta = read_codestream_headers(r)
    return np.asarray(jax_decode_frame(r, meta, device=True).xyb)


@pytest.mark.parametrize("name", list(STREAMS))
def test_post_stream_xyb_matches_jax_device(name):
    data = _data(name)
    post = parse_to_feed(data)["post"]
    assert set(post) - {"final_hw"} == STAGES[name]
    ref = _jax_device_xyb(data)
    got = libjxl_tpu_torch.decode_device(data, out="xyb", device="cpu")
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (3,) + post["final_hw"]
    assert np.abs(got.numpy() - ref).max() <= XYB_TOL


@pytest.mark.parametrize("name", list(STREAMS))
def test_post_stream_srgb8_matches_host(name):
    data = _data(name)
    prev = get_runner()
    set_runner(ThreadRunner(num_workers=1))
    try:
        host = simple.decode(data).pixels.astype(np.int64)
    finally:
        set_runner(prev)
    got = libjxl_tpu_torch.decode_device(data, out="srgb8", device="cpu")
    got = got.numpy().transpose(1, 2, 0).astype(np.int64)
    assert got.shape == host.shape
    assert np.abs(got - host).max() <= 1


def test_post_stages_follow_filters_in_reference_order():
    """decode_frame_device2 with a post dict equals the stages applied by
    hand in the reference's order (filters, upsampling and crop,
    splines, noise) on the same XYB."""
    feed = parse_to_feed(_data("noise_up2"))
    post = feed["post"]
    h, w = feed["image_hw"]
    got = pipeline.decode_frame_device2(feed, h, w, out="xyb",
                                        device="cpu", post=post)
    t = pipeline.feed_to_torch(feed, "cpu")
    xyb = pipeline.loop_filters(pipeline.staged_xyb(t, h, w), t)
    n = post["upsample"]
    xyb = stages.upsample_image(xyb, n, _t(_kernels(n).astype(np.float32)))
    xyb = xyb[:, :post["final_hw"][0], :post["final_hw"][1]]
    lut, ytox, ytob, gd, vfi = post["noise"]
    raw = _t(stages.noise_planes_for(*post["final_hw"], gd, vfi))
    ref = stages.add_noise(xyb, raw, _t(lut), float(ytox), float(ytob))
    assert torch.equal(got, ref)


def test_spline_stroke_params_match_jax():
    from libjxl_tpu.frame.splines import decode_splines as jax_splines
    from libjxl_tpu.vardct.cfl import ColorCorrelation
    from libjxl_tpu_torch.frame.splines import decode_splines
    from libjxl_tpu_torch.vardct.cfl import ColorCorrelation as Cmap
    from libjxl_tpu.frame.splines import encode_splines, Splines, \
        quantize_spline
    from libjxl_tpu.bitstream.bit_io import BitWriter
    from libjxl_tpu_torch.bitstream.bit_io import BitReader as PortReader

    cps = [(5.0, 8.0), (30.0, 40.0), (70.0, 20.0)]
    color_dct = np.zeros((3, 32))
    color_dct[1, 0] = 0.3
    color_dct[2, 3] = -0.1
    sigma_dct = np.zeros(32)
    sigma_dct[0] = 1.5
    w = BitWriter()
    encode_splines(Splines(splines=[quantize_spline(
        cps, color_dct, sigma_dct, 0, 0.0, 1.0)], starting_points=[cps[0]]),
        w)
    w.align_to_byte()
    data = w.get_bytes()
    ref = stages_tpu.spline_stroke_params(
        jax_splines(BitReader(data), 100 * 100), ColorCorrelation())
    got = stages.spline_stroke_params(
        decode_splines(PortReader(data), 100 * 100), Cmap())
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
