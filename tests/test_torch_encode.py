"""The port's device encoder (libjxl_tpu_torch.ops.encode and
``libjxl_tpu_torch.encode``) against the JAX package on the CPU: the
stage A functions and the whole encoder. The stage B functions are in
tests/test_torch_encode_stage_b.py.

Every input is made with numpy from a seed; both packages get the same
arrays and the same dequant tables (the JAX package's ``make_tables``
bundle, turned into tensors by ``tables_to_torch``). Tolerances:
- float planes (``srgb_to_xyb``, ``encode_stage_a``, the gaborish
  inverse): 1e-6 absolute; the quant field 1e-5 relative; stage B's
  ``dc_float`` 1e-5 absolute;
- integer outputs (strategy maps, raw quant, quantized DC, CfL maps):
  equal. The quantized AC coefficients are equal but for a share of at
  most 1e-4 of the entries, each at most 1 apart. The cause: the two
  packages sum the products of each DCT in another order (XLA's dot
  against torch's matmul; the contraction order is the same), so a
  coefficient moves by about 1e-7, and the few that sit on a rounding
  or dead-zone boundary round the other way. The one such entry in
  these cases lies in a DCT8X16 tile that the frame does not use.
- end to end, the gates of tests/test_device_encode.py: size within
  max(8 B, 1%) of the host encoder, decoded pixels within 2 LSB, and
  byte identity with the JAX host encoder at e5 and e7 on its test image.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from libjxl_tpu.api.simple import decode as jax_decode  # noqa: E402
from libjxl_tpu.api.simple import encode as jax_encode  # noqa: E402
from libjxl_tpu.color.xyb import (  # noqa: E402
    linear_rgb_to_xyb, srgb_to_linear,
)
from libjxl_tpu.ops import encode_pipeline as jep  # noqa: E402
from libjxl_tpu.parallel import runner as jax_runner  # noqa: E402
import libjxl_tpu_torch  # noqa: E402
from libjxl_tpu_torch.ops import encode as ep  # noqa: E402
from libjxl_tpu_torch.parallel import runner as port_runner  # noqa: E402

CPU = torch.device("cpu")
SHAPES = [(8, 8), (64, 64), (72, 136), (136, 72), (128, 144), (520, 16)]
FLOAT_TOL = 1e-6
QF_RTOL = 1e-5
LSB_TOL = 2


@pytest.fixture(autouse=True)
def one_worker():
    """Both packages' host decoders on one worker (ROADMAP caveat 1)."""
    prev = jax_runner.get_runner(), port_runner.get_runner()
    jax_runner.set_runner(jax_runner.ThreadRunner(num_workers=1))
    port_runner.set_runner(port_runner.ThreadRunner(num_workers=1))
    yield
    jax_runner.set_runner(prev[0])
    port_runner.set_runner(prev[1])


@functools.lru_cache(maxsize=None)
def _jit(fn, *args, **static):
    """The JAX function with its static arguments bound, jitted once."""
    return jax.jit(functools.partial(fn, *args, **static))


def _srgb(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([np.clip(0.45 + 0.3 * np.sin(x / (7 + 3 * c))
                             * np.cos(y / (11 - 2 * c))
                             + 0.1 * np.sin((x + 2 * y) / 23)
                             + rng.normal(0, 0.03, (h, w)), 0, 1)
                     for c in range(3)]).astype(np.float32)


def _xyb(h, w, seed=0):
    srgb = _srgb(h, w, seed)
    return linear_rgb_to_xyb(srgb_to_linear(srgb)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.numpy()


def _shape_id(s):
    return f"{s[0]}x{s[1]}"


# ---------------------------------------------------------------------------
# Stage A functions


def test_cbrt_matches_jnp():
    """The port's cube root against ``jnp.cbrt``: within 1 ulp on the
    values the opsin mix takes (the bias, about 0.0038, and above: the
    matrix is positive and linear light is not negative), and within one
    ulp of the correctly rounded root everywhere, near 0 included. There
    ``jnp.cbrt`` itself is off by up to 10 ulp (1e-30 -> 9.9999932e-11),
    so the port is held to the exact root, not to it."""
    rng = np.random.default_rng(1)
    bias = np.float32(0.0037930732552754493)
    mixed = np.concatenate([
        np.array([bias], np.float32),
        bias * (1 + rng.uniform(0, 1e-3, 500)).astype(np.float32),
        rng.uniform(bias, 1, 2000).astype(np.float32),
        rng.uniform(1, 60, 2000).astype(np.float32)]).astype(np.float32)
    got = _np(ep.cbrt(_t(mixed)))
    want = np.asarray(jnp.cbrt(mixed))
    assert np.all(np.abs(got - want) <= np.spacing(want))
    near0 = np.concatenate([
        np.array([0.0, 1e-30, 1e-12, 1e-7], np.float32),
        rng.uniform(0, 1e-4, 500).astype(np.float32)]).astype(np.float32)
    exact = np.cbrt(near0.astype(np.float64))
    got0 = _np(ep.cbrt(_t(near0))).astype(np.float64)
    assert np.all(np.abs(got0 - exact)
                  <= np.spacing(exact.astype(np.float32)))


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_srgb_to_xyb_matches_jax(shape):
    srgb = _srgb(*shape, seed=2)
    got = _np(ep.srgb_to_xyb(_t(srgb)))
    want = np.asarray(jep.srgb_to_xyb(srgb))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def test_srgb_to_xyb_matches_numpy():
    """As tests/test_tpu_ops.py test_xyb_roundtrip_device_vs_numpy: the
    device XYB against the host numpy transform."""
    rng = np.random.default_rng(5)
    srgb = rng.random((3, 16, 16), np.float32)
    got = _np(ep.srgb_to_xyb(_t(srgb)))
    np.testing.assert_allclose(got, linear_rgb_to_xyb(srgb_to_linear(srgb)),
                               atol=1e-5)


@pytest.mark.parametrize("gab,flat", [(True, False), (False, False),
                                      (True, True)])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_encode_stage_a_matches_jax(shape, gab, flat):
    linear = srgb_to_linear(_srgb(*shape, seed=3)).astype(np.float32)
    xyb, qf = ep.encode_stage_a(_t(linear), 1.0, gab, flat_qf=flat)
    jxyb, jqf = jep.encode_stage_a(linear, 1.0, gab, flat_qf=flat)
    np.testing.assert_allclose(_np(xyb), np.asarray(jxyb), rtol=0,
                               atol=FLOAT_TOL)
    np.testing.assert_allclose(_np(qf), np.asarray(jqf), rtol=QF_RTOL)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_gaborish_inverse_matches_jax(shape):
    xyb = _xyb(*shape, seed=4)
    got = _np(ep.gaborish_inverse(_t(xyb)))
    want = np.asarray(_jit(jep.gaborish_inverse_jnp)(xyb))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("distance", [0.5, 1.0, 1.9, 2.0, 5.0, 14.5])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_initial_quant_field_matches_jax(shape, distance):
    """Distances on both sides of the erosion weights' 2.0 break and of
    the 2.0-14.0 dampening ramp."""
    xyb = _xyb(*shape, seed=5)
    got = _np(ep.initial_quant_field(distance, _t(xyb)))
    want = np.asarray(_jit(jep.initial_quant_field_jnp, distance)(xyb))
    assert got.shape == (shape[0] // 8, shape[1] // 8)
    np.testing.assert_allclose(got, want, rtol=QF_RTOL)


@pytest.mark.parametrize("gab,flat", [(True, False), (False, False),
                                      (True, True), (False, True)])
def test_encode_stage_pre_matches_jax(gab, flat):
    xyb = _xyb(72, 136, seed=6)
    qf, planes = ep.encode_stage_pre(_t(xyb), 1.3, gab, flat_qf=flat)
    jqf, jplanes = jep.encode_stage_pre(jnp.asarray(xyb), 1.3, gab,
                                        flat_qf=flat)
    np.testing.assert_allclose(_np(qf), np.asarray(jqf), rtol=QF_RTOL)
    np.testing.assert_allclose(_np(planes), np.asarray(jplanes), rtol=0,
                               atol=FLOAT_TOL)


# ---------------------------------------------------------------------------
# End to end: libjxl_tpu_torch.encode(device="cpu")


def _test_image(h=128, w=144, seed=3):
    """tests/test_device_encode.py's test image."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = []
    for c in range(3):
        base = (0.45 + 0.3 * np.sin(x / (11 + 5 * c)) * np.cos(y / (17 - 3 * c))
                + 0.1 * np.sin((x + 2 * y) / 29)
                + rng.normal(0, 0.02, (h, w)))
        chans.append(np.clip(base, 0, 1))
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def _gates(port: bytes, ref: bytes):
    """Size within max(8 B, 1%) and decoded pixels within 2 LSB."""
    assert abs(len(port) - len(ref)) <= max(8, 0.01 * len(ref)), \
        (len(ref), len(port))
    pr = jax_decode(ref).pixels.astype(np.int32)
    pp = jax_decode(port).pixels.astype(np.int32)
    assert pp.shape == pr.shape
    assert np.abs(pr - pp).max() <= LSB_TOL


@pytest.mark.parametrize("effort,distance", [(3, 2.0), (5, 1.0), (7, 1.0)])
def test_port_encode_matches_host(effort, distance):
    img = _test_image()
    host = jax_encode(img, distance=distance, effort=effort)
    port = libjxl_tpu_torch.encode(img, distance=distance, effort=effort,
                                   device="cpu")
    _gates(port, host)


@pytest.mark.parametrize("effort", [5, 7])
def test_port_encode_byte_identical_e5_plus(effort):
    img = _test_image()
    host = jax_encode(img, distance=1.0, effort=effort)
    port = libjxl_tpu_torch.encode(img, distance=1.0, effort=effort,
                                   device="cpu")
    assert host == port, (len(host), len(port))


def test_port_encode_decodes_correctly():
    img = _test_image(96, 96, seed=9)
    data = libjxl_tpu_torch.encode(img, distance=1.0, effort=5,
                                   device="cpu")
    out = libjxl_tpu_torch.decode(data, device="cpu").pixels
    err = np.abs(out.astype(np.float64) - img.astype(np.float64)).mean()
    assert err < 5.0, err


def test_port_encode_odd_size():
    img = _test_image(101, 67, seed=11)
    host = jax_encode(img, distance=1.5, effort=5)
    port = libjxl_tpu_torch.encode(img, distance=1.5, effort=5,
                                   device="cpu")
    ph = jax_decode(host).pixels.astype(np.int32)
    pp = jax_decode(port).pixels.astype(np.int32)
    assert np.abs(ph - pp).max() <= LSB_TOL


def test_port_encode_low_effort():
    img = _test_image(80, 80, seed=13)
    data = libjxl_tpu_torch.encode(img, distance=2.0, effort=2,
                                   device="cpu")
    out = jax_decode(data).pixels.astype(np.float64)
    assert np.abs(out - img.astype(np.float64)).mean() < 6.0


def _hdr_crop():
    """A 256x256 crop of the 4K HDR corpus image 0
    (tools/gen_bench_corpus.py make_image)."""
    from tools.gen_bench_corpus import make_image
    return np.ascontiguousarray(make_image(0)[:256, :256])


def _screenshot():
    """Repeated glyphs on a flat background: the encoder finds text-like
    patches and writes them into a reference frame."""
    rng = np.random.default_rng(11)
    img = np.full((160, 200, 3), 240, np.uint8)
    glyph = (rng.random((12, 10, 3)) * 120).astype(np.uint8)
    for gy in range(4):
        for gx in range(8):
            img[10 + gy * 30:22 + gy * 30,
                8 + gx * 22:18 + gx * 22] = glyph
    return img


# (name, image, encode keywords, byte-identical to JAX device=True,
#  stage B calls on the port's device route).
FEATURES = {
    "hdr_pq_progressive_epf3": (
        _hdr_crop, dict(distance=1.0, effort=5, hdr="pq",
                        progressive=True, epf=3), True, 1),
    "patches": (_screenshot, dict(distance=1.0, effort=7, patches=True),
                True, 1),
    "dc_frame": (lambda: _test_image(96, 112, seed=4),
                 dict(distance=1.0, effort=5, dc_frame=True), True, 0),
    "photon_noise": (lambda: _test_image(96, 112, seed=5),
                     dict(distance=2.0, effort=5, photon_noise_iso=3200),
                     True, 1),
    "resampling2": (lambda: _test_image(96, 112, seed=6),
                    dict(distance=2.0, effort=5, resampling=2), True, 1),
    "effort8": (lambda: _test_image(48, 64, seed=7),
                dict(distance=1.0, effort=8), True, 4),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_port_encode_features_match_jax_device(name):
    """The port's encode against the JAX ``encode(device=True)`` on
    streams with features that change what runs where: the size and
    LSB gates always, byte identity where the two float32 routes agree,
    and the port's stage B calls (the main frame only: the patch sheet
    and the DC frame stay on the host; effort 8 encodes three trial
    frames before the final one)."""
    make, kw, identical, stage_b = FEATURES[name]
    img = make()
    ref = jax_encode(img, device=True, **kw)
    ep.calls.clear()
    port = libjxl_tpu_torch.encode(img, device="cpu", **kw)
    assert ep.calls[("encode_stage_b", "cpu")] == stage_b, dict(ep.calls)
    assert not [k for k in ep.calls if k[1] != "cpu"]
    _gates(port, ref)
    if identical:
        assert port == ref, (len(ref), len(port))


def test_stage_counters_show_the_route():
    """e5: the fused pre-stage and stage B on the device; e6 (the AR
    heuristic reads the host's gaborish planes): the quant field and
    stage B on the device, the pre-stage not at all."""
    img = _test_image(64, 64, seed=8)
    ep.calls.clear()
    libjxl_tpu_torch.encode(img, distance=1.0, effort=5, device="cpu")
    assert dict(ep.calls) == {("encode_stage_pre", "cpu"): 1,
                              ("initial_quant_field", "cpu"): 1,
                              ("encode_stage_b", "cpu"): 1}
    ep.calls.clear()
    libjxl_tpu_torch.encode(img, distance=1.0, effort=6, device="cpu")
    assert dict(ep.calls) == {("initial_quant_field", "cpu"): 1,
                              ("encode_stage_b", "cpu"): 1}


def test_encode_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ep.calls.clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        libjxl_tpu_torch.encode(_test_image(16, 16))
    assert not ep.calls
