"""The port's public decode API (libjxl_tpu_torch.api: ``decode`` and
``decode_all``) against the JAX package on the CPU, and its new device
stages (spot colours, frame blending, the patch affine fold) against
their JAX counterparts on the same numpy inputs.

Every stream is made here by the JAX package's encoder from a numpy
seed, at most 200 x 160 pixels. ``decode(data, device="cpu")`` is held
against the JAX ``decode(data, device=True)`` and the JAX host
``decode(data)`` at 1 LSB, the reference's own device-vs-host tolerance
(tests/test_device_decode.py); float output at 1/maxval. Both hosts are
pinned to one worker: the host's pixels depend on the worker count.
Stages: spot and blend 1e-6, the patch fold 1e-4 in XYB (the pipeline
tolerance of tests/test_torch_pipeline.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libjxl_tpu.api import simple  # noqa: E402
from libjxl_tpu.bitstream.bit_io import BitReader  # noqa: E402
from libjxl_tpu.frame.decode_frame import (  # noqa: E402
    decode_frame as jax_decode_frame,
)
from libjxl_tpu.frame.headers import read_codestream_headers  # noqa: E402
from libjxl_tpu.ops import stages_tpu  # noqa: E402
from libjxl_tpu.parallel import runner as jax_runner  # noqa: E402
from libjxl_tpu.tpu import pipeline as jax_pipeline  # noqa: E402
from libjxl_tpu.tpu.batch_decode import parse_to_feed  # noqa: E402
import libjxl_tpu_torch  # noqa: E402
from libjxl_tpu_torch.api import simple as port_simple  # noqa: E402
from libjxl_tpu_torch.frame import decode_frame as port_frame  # noqa: E402
from libjxl_tpu_torch.ops import stages  # noqa: E402
from libjxl_tpu_torch.parallel import runner as port_runner  # noqa: E402
from libjxl_tpu_torch.tpu import pipeline  # noqa: E402

STAGE_TOL = 1e-6
XYB_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_worker():
    """Both packages' host decoders on one worker (caveat 1)."""
    prev = jax_runner.get_runner(), port_runner.get_runner()
    jax_runner.set_runner(jax_runner.ThreadRunner(num_workers=1))
    port_runner.set_runner(port_runner.ThreadRunner(num_workers=1))
    yield
    jax_runner.set_runner(prev[0])
    port_runner.set_runner(prev[1])


def _img(h=160, w=200, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.clip(0.5 + 0.3 * np.sin(x / (11 + 2 * c) + c)
                     * np.cos(y / 17) + rng.normal(0, 0.02, (h, w)), 0, 1)
             for c in range(3)]
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _rgba(h=96, w=112, seed=5):
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = _img(h, w, seed)
    a = np.zeros((h, w), np.uint8)
    a[10:70, 20:90] = 255
    a[40:50, :] = 100
    img[..., 3] = a
    return img


def _screenshot():
    """Repeated glyphs on a flat background: the encoder finds text-like
    patches and writes them into a reference frame
    (tests/test_device_stages.py test_device_patches_match_host)."""
    rng = np.random.default_rng(11)
    img = np.full((160, 200, 3), 240, np.uint8)
    glyph = (rng.random((12, 10, 3)) * 120).astype(np.uint8)
    for gy in range(4):
        for gx in range(8):
            img[10 + gy * 30:22 + gy * 30,
                8 + gx * 22:18 + gx * 22] = glyph
    return img


def _spot_stream():
    """Lossless modular with two spot-colour channels
    (tests/test_device_stages.py test_device_spot_color_matches_host)."""
    img = _img(72, 96, seed=11)
    h, w = img.shape[:2]
    spot = np.zeros((h, w), np.uint8)
    spot[20:40, 30:60] = 200
    spot2 = np.zeros((h, w), np.uint8)
    spot2[10:30, 5:25] = 120
    ecs = [{"type": "spot_color", "data": spot, "name": "ink",
            "spot_color": (1.0, 0.1, 0.2, 0.8)},
           {"type": "spot_color", "data": spot2, "name": "ink2",
            "spot_color": (0.0, 0.9, 0.4, 0.5)}]
    return simple.encode(img, lossless=True, extra_channels=ecs)


def _animation():
    """Three RGBA frames, frames 1-2 alpha-blended over the canvas
    (tests/test_device_stages.py test_device_animation_blend_matches_host)."""
    rng = np.random.default_rng(12)
    h, w = 64, 80
    frames = []
    for i in range(3):
        fr = np.zeros((h, w, 4), np.uint8)
        fr[:, :, :3] = np.clip(rng.normal(100 + 40 * i, 30, (h, w, 3)),
                               0, 255)
        a = np.zeros((h, w), np.uint8)
        a[8 * i:40 + 8 * i, 10:60] = 255
        a[20:30, :] = 128
        fr[:, :, 3] = a
        frames.append(fr)
    return simple.encode_animation(frames, distance=1.0, blend=True)


STREAMS = {
    "e1_d1": lambda: simple.encode(_img(), distance=1.0, effort=1),
    "e3_d1": lambda: simple.encode(_img(), distance=1.0, effort=3),
    "e5_d1": lambda: simple.encode(_img(), distance=1.0, effort=5),
    "e7_d1": lambda: simple.encode(_img(), distance=1.0, effort=7),
    "e5_d0.5": lambda: simple.encode(_img(), distance=0.5, effort=5),
    "e5_d2": lambda: simple.encode(_img(), distance=2.0, effort=5),
    "e5_d4": lambda: simple.encode(_img(), distance=4.0, effort=5),
    "odd_size": lambda: simple.encode(_img(131, 173, seed=4),
                                      distance=1.0, effort=5),
    "alpha": lambda: simple.encode(_rgba(), distance=1.0, effort=5),
    "lossless": lambda: simple.encode(_img(64, 80), lossless=True),
    "dc_frame": lambda: simple.encode(_img(), distance=1.0, effort=5,
                                      dc_frame=True),
    "preview": lambda: simple.encode(_img(), distance=1.0, effort=5,
                                     preview=True),
    "ycbcr420": lambda: simple.encode(_img(), distance=1.0,
                                      chroma_subsampling="420"),
    "patches": lambda: simple.encode(_screenshot(), distance=1.0,
                                     effort=7),
    "spot": _spot_stream,
}

_DATA: dict = {}


def _data(name):
    if name not in _DATA:
        _DATA[name] = STREAMS[name]()
    return _DATA[name]


def _diff(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jax(name):
    data = _data(name)
    got = libjxl_tpu_torch.decode(data, device="cpu")
    dev = simple.decode(data, device=True)
    host = simple.decode(data)
    assert got.pixels.dtype == dev.pixels.dtype
    assert _diff(got.pixels, dev.pixels) <= 1
    assert _diff(got.pixels, host.pixels) <= 1
    assert got.lossless == dev.lossless
    assert len(got.extra) == len(dev.extra)
    for (gi, ga), (_, da) in zip(got.extra, dev.extra):
        assert _diff(np.asarray(ga), np.asarray(da)) == 0, gi.name
    assert (got.preview is None) == (dev.preview is None)
    if dev.preview is not None:
        assert _diff(got.preview, dev.preview) <= 1
        assert _diff(got.preview, host.preview) <= 1


def test_stream_features():
    """The feature streams carry what their names say, so the cases
    above run the paths they are meant to."""
    from libjxl_tpu_torch.frame.frame_header import (
        FrameEncoding, FrameFlags, FrameType,
    )
    from libjxl_tpu_torch.frame.headers import (
        read_codestream_headers as port_headers,
    )
    from libjxl_tpu_torch.bitstream.bit_io import BitReader as PortReader

    def frames(name):
        r = PortReader(_data(name))
        meta = port_headers(r)
        refs, dcs, out = [None] * 4, [None] * 5, []
        if meta.m.have_preview:
            out.append(port_frame.decode_frame(r, meta, refs,
                                               is_preview=True).header)
        while True:
            f = port_frame.decode_frame(r, meta, refs, dc_frames=dcs)
            fh = f.header
            out.append(fh)
            if fh.frame_type == FrameType.DC_FRAME:
                dcs[fh.dc_level] = f.xyb
            elif fh.frame_type == FrameType.REFERENCE_ONLY:
                refs[fh.save_as_reference] = f.xyb
            if fh.is_last:
                return meta, out

    _, fhs = frames("patches")
    assert fhs[0].frame_type == FrameType.REFERENCE_ONLY
    assert fhs[-1].flags & FrameFlags.PATCHES
    _, fhs = frames("dc_frame")
    assert fhs[0].frame_type == FrameType.DC_FRAME
    assert fhs[-1].flags & FrameFlags.USE_DC_FRAME
    meta, fhs = frames("spot")
    assert fhs[-1].encoding == FrameEncoding.MODULAR
    assert [int(e.type) for e in meta.m.extra_channel_info] == [2, 2]
    meta, fhs = frames("preview")
    assert meta.m.have_preview and len(fhs) == 2
    meta, _ = frames("alpha")
    assert int(meta.m.extra_channel_info[0].type) == 0


def test_decode_frame_device_route_matches_jax(monkeypatch):
    """decode_frame on a torch device (the port's device route) returns
    the JAX device route's XYB within XYB_TOL, with the patches folded
    into the device post stage, not blitted on the host."""
    data = _data("patches")
    folds = []
    stage = pipeline.patch_stage
    monkeypatch.setattr(pipeline, "patch_stage", lambda x, ka: (
        folds.append(ka is not None), stage(x, ka))[1])

    def run(decode_frame_fn, reader, headers, device):
        r = reader(data)
        meta = headers(r)
        refs = [None] * 4
        while True:
            f = decode_frame_fn(r, meta, refs, device=device)
            if f.header.is_last:
                return f.xyb
            refs[f.header.save_as_reference] = f.xyb

    from libjxl_tpu_torch.bitstream.bit_io import BitReader as PortReader
    from libjxl_tpu_torch.frame.headers import (
        read_codestream_headers as port_headers,
    )
    ref = run(jax_decode_frame, BitReader, read_codestream_headers, True)
    got = run(port_frame.decode_frame, PortReader, port_headers, "cpu")
    assert folds == [False, True]      # the reference frame, then patches
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= XYB_TOL


def test_float_out_matches_jax():
    data = _data("e5_d1")
    got = libjxl_tpu_torch.decode(data, device="cpu", float_out=True)
    ref = simple.decode(data, device=True, float_out=True)
    assert got.pixels.dtype == np.float32 == ref.pixels.dtype
    assert np.abs(got.pixels - ref.pixels).max() <= 1 / 255


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float16,
                                   np.float32])
def test_dtype_matches_jax(dtype):
    data = _data("alpha")
    got = libjxl_tpu_torch.decode(data, device="cpu", dtype=dtype)
    ref = simple.decode(data, device=True, dtype=dtype)
    assert got.pixels.dtype == ref.pixels.dtype == np.dtype(dtype)
    if np.dtype(dtype).kind == "f":
        assert np.abs(got.pixels.astype(np.float64)
                      - ref.pixels.astype(np.float64)).max() <= 1 / 255
    else:
        # uint16 is the 8-bit decode scaled by 257: 1 LSB of it is 257.
        assert _diff(got.pixels, ref.pixels) <= (
            257 if dtype == np.uint16 else 1)


def test_hdr_pq_decode_matches_jax():
    """16-bit PQ output: the XYB of the device route within XYB_TOL of
    JAX's, and PQ16 within one code of JAX's on identical XYB (caveat 5:
    raw codes of two float32 backends may differ by more in dark
    tones)."""
    rng = np.random.default_rng(7)
    img = (np.clip(_img(64, 80).astype(np.float64) / 255
                   + rng.normal(0, 0.01, (64, 80, 3)), 0, 1)
           * 65535).astype(np.uint16)
    data = simple.encode(img, distance=1.0, effort=5, hdr="pq")
    got = libjxl_tpu_torch.decode(data, device="cpu")
    ref = simple.decode(data, device=True)
    assert got.pixels.dtype == np.uint16 == ref.pixels.dtype
    assert got.pixels.shape == ref.pixels.shape
    r = BitReader(data)
    ref_xyb = jax_decode_frame(r, read_codestream_headers(r),
                               device=True).xyb
    from libjxl_tpu_torch.bitstream.bit_io import BitReader as PortReader
    from libjxl_tpu_torch.frame.headers import (
        read_codestream_headers as port_headers,
    )
    r = PortReader(data)
    got_xyb = port_frame.decode_frame(r, port_headers(r),
                                      device="cpu").xyb
    assert np.abs(got_xyb - ref_xyb).max() <= XYB_TOL
    from libjxl_tpu.color.transfer_functions import (
        pq_encoded_from_display as jax_pq,
    )
    from libjxl_tpu.color.xyb import xyb_to_linear_rgb as jax_lin
    from libjxl_tpu_torch.color.transfer_functions import (
        pq_encoded_from_display,
    )
    from libjxl_tpu_torch.color.xyb import xyb_to_linear_rgb
    a = pq_encoded_from_display(xyb_to_linear_rgb(ref_xyb)
                                * (255.0 / 10000.0))
    b = jax_pq(jax_lin(ref_xyb) * (255.0 / 10000.0))
    assert np.abs(np.round(a * 65535) - np.round(b * 65535)).max() <= 1


def test_decode_all_blend_matches_jax():
    data = _animation()
    got, meta = libjxl_tpu_torch.decode_all(data, device="cpu")
    dev, _ = simple.decode_all(data, device=True)
    host, _ = simple.decode_all(data)
    assert len(got) == len(dev) == len(host) == 3
    assert meta.xsize == 80 and meta.ysize == 64
    for g, d, h in zip(got, dev, host):
        assert g.duration == d.duration
        assert g.pixels.shape == (64, 80, 4)
        assert _diff(g.pixels, d.pixels) <= 1
        assert _diff(g.pixels, h.pixels) <= 1


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _data("e5_d1")
    for fn in (libjxl_tpu_torch.decode, libjxl_tpu_torch.decode_all):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(data)


def test_package_exports_api():
    assert libjxl_tpu_torch.decode is port_simple.decode
    assert libjxl_tpu_torch.decode_all is port_simple.decode_all
    from libjxl_tpu_torch import api
    assert api.decode is port_simple.decode
    assert api.DecodeResult is port_simple.DecodeResult


# ---------------------------------------------------------------------------
# Stages against their JAX counterparts


def test_render_spot_matches_jax():
    rng = np.random.default_rng(31)
    color = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32)
    mixes = rng.uniform(0, 1, (2, 37, 53)).astype(np.float32)
    rgba = rng.uniform(0, 1, (2, 4)).astype(np.float32)
    ref = np.asarray(stages_tpu.render_spot_tpu(color, mixes, rgba))
    got = stages.render_spot(torch.from_numpy(color),
                             torch.from_numpy(mixes), torch.from_numpy(rgba))
    assert np.abs(got.numpy() - ref).max() <= STAGE_TOL


# Origins (x0, y0): inside, negative on both axes, past the right edge,
# and fully clipped (entirely outside the canvas).
ORIGINS = [(5, 7), (-9, -4), (30, -6), (60, 3), (-40, 0)]


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_blend_frame_matches_jax(mode):
    rng = np.random.default_rng(40 + mode)
    ch, cw, h, w = 29, 47, 21, 33
    canvas = rng.uniform(0, 1, (ch, cw, 3)).astype(np.float32)
    canvas_a = rng.uniform(0, 1, (ch, cw)).astype(np.float32)
    canvas_a[:3] = 0.0                 # new alpha 0 where source alpha is
    src = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    src_a = rng.uniform(0, 1, (h, w)).astype(np.float32)
    src_a[:, :4] = 0.0
    cases = 0
    for premul in (False, True):
        for sa in (src_a, None):
            for da in (canvas_a, None):
                for x0, y0 in ORIGINS:
                    rc, ra = stages_tpu.blend_frame_tpu(
                        canvas, da, src, sa, mode, x0, y0, premul)
                    tc = torch.from_numpy(canvas)
                    ta = None if da is None else torch.from_numpy(da)
                    gc, ga = stages.blend_frame(tc, ta, src, sa, mode, x0,
                                                y0, premul)
                    assert np.abs(gc.numpy() - np.asarray(rc)).max() \
                        <= STAGE_TOL, (premul, sa is None, da is None, x0)
                    assert (ga is None) == (ra is None)
                    if ga is not None:
                        assert np.abs(ga.numpy() - np.asarray(ra)).max() \
                            <= STAGE_TOL
                    # The inputs are left as they were.
                    assert np.array_equal(tc.numpy(), canvas)
                    cases += 1
    assert cases == 2 * 2 * 2 * len(ORIGINS)


def test_blend_frame_rejects_unknown_mode():
    c = torch.zeros(4, 4, 3)
    with pytest.raises(ValueError):
        stages.blend_frame(c, None, np.zeros((2, 2, 3), np.float32), None,
                           7, 0, 0)


def test_patch_affine_stage_matches_jax():
    """The port's decode_frame_device2 with a ``patch_affine`` post
    stage (random K and A) against the JAX one."""
    data = simple.encode(_img(96, 96), distance=1.0, effort=5)
    feed = parse_to_feed(data)
    rng = np.random.default_rng(8)
    k = rng.uniform(0, 1, (3, 96, 96)).astype(np.float32)
    a = rng.normal(0, 0.05, (3, 96, 96)).astype(np.float32)
    post = {"patch_affine": (k, a), "final_hw": (96, 96)}
    ref = np.asarray(jax_pipeline.decode_frame_device2(
        feed, 96, 96, out="xyb", post=post))
    got = pipeline.decode_frame_device2(feed, 96, 96, out="xyb",
                                        device="cpu", post=post)
    assert np.abs(got.numpy() - ref).max() <= XYB_TOL
