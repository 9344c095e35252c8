"""Port loop filters (libjxl_tpu_torch/ops/filters.py, the plain PyTorch
version of the CUDA kernel) vs the JAX whole-frame filters and the
Pallas kernel in interpret mode.

Tolerance 2e-6, the reference's own for its kernel
(tests/test_epf_pallas.py): float rounding only, since backends order
and contract the float32 operations differently.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libjxl_tpu.ops.epf_pallas import apply_loop_filters_pallas  # noqa: E402
from libjxl_tpu.ops.filters_tpu import apply_loop_filters_tpu  # noqa: E402
from libjxl_tpu_torch.ops import epf_cuda, filters  # noqa: E402
from libjxl_tpu_torch.pipeline.loop_filters import MIN_SIGMA  # noqa: E402

TOL = 2e-6
_JAX_FILTERS = jax.jit(apply_loop_filters_tpu,
                       static_argnames=("epf_iters", "gab"))
_PALLAS = jax.jit(apply_loop_filters_pallas,
                  static_argnames=("epf_iters", "gab", "interpret"))
STAGES = [(it, gab) for it in (0, 1, 2, 3) for gab in (True, False)
          if it or gab]
SHAPES = [(96, 200), (61, 117)]
# Frames narrower or shorter than a 32-pixel tile or than the 7-pixel
# halo (mirroring wraps more than once), as the CUDA kernel meets them.
EDGE_SHAPES = [(1, 1), (5, 3), (7, 300), (300, 7), (33, 9)]


def _case(seed, h, w):
    """Image N(0, 0.3); a block map of realistic (negative) 1/sigma
    values of which about a third lie below MIN_SIGMA (EPF skip)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 0.3, (3, h, w)).astype(np.float32)
    sig = rng.uniform(-6.0, -0.05,
                      ((h + 7) // 8, (w + 7) // 8)).astype(np.float32)
    assert (sig < MIN_SIGMA).any() and (sig >= MIN_SIGMA).any()
    return img, sig


def _port(img, sig, **kw):
    return filters.apply_loop_filters(
        torch.from_numpy(img), torch.from_numpy(sig), **kw).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("epf_iters,gab", STAGES)
def test_matches_jnp_filters(epf_iters, gab, shape):
    img, sig = _case(3, *shape)
    ref = np.asarray(_JAX_FILTERS(
        jax.numpy.asarray(img), jax.numpy.asarray(sig),
        epf_iters=epf_iters, gab=gab))
    got = _port(img, sig, epf_iters=epf_iters, gab=gab)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("epf_iters,gab", STAGES)
def test_matches_pallas_interpret(epf_iters, gab, shape):
    img, sig = _case(4, *shape)
    ref = np.asarray(_PALLAS(
        jax.numpy.asarray(img), jax.numpy.asarray(sig),
        epf_iters=epf_iters, gab=gab, interpret=True))
    got = _port(img, sig, epf_iters=epf_iters, gab=gab)
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("epf_iters,gab", STAGES)
def test_edge_shapes_match_jnp_filters(epf_iters, gab, shape):
    rng = np.random.default_rng(21)
    h, w = shape
    img = rng.normal(0, 0.3, (3, h, w)).astype(np.float32)
    sig = rng.uniform(-6.0, -0.05,
                      ((h + 7) // 8, (w + 7) // 8)).astype(np.float32)
    ref = np.asarray(_JAX_FILTERS(
        jax.numpy.asarray(img), jax.numpy.asarray(sig),
        epf_iters=epf_iters, gab=gab))
    got = _port(img, sig, epf_iters=epf_iters, gab=gab)
    assert got.shape == ref.shape == (3, h, w)
    assert np.abs(got - ref).max() <= TOL


def test_skip_blocks_pass_through():
    """EPF-only: pixels of blocks under MIN_SIGMA keep their values."""
    img, sig = _case(7, 64, 128)
    sig[2:4, 3:6] = -10.0
    got = _port(img, sig, epf_iters=3, gab=False)
    np.testing.assert_array_equal(got[:, 16:32, 24:48],
                                  img[:, 16:32, 24:48])


@pytest.mark.parametrize("n,pad", [(5, 1), (5, 3), (3, 7), (117, 7)])
def test_symmetric_padding_repeats_edge(n, pad):
    x = np.arange(n, dtype=np.float32)[None, :] * np.ones((n, 1),
                                                           np.float32)
    got = filters.pad_symmetric(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, np.pad(x, pad, mode="symmetric"))


def test_wrapper_takes_plain_version_on_cpu():
    img, sig = _case(9, 61, 117)
    epf_cuda.launches = 0
    got = epf_cuda.apply_loop_filters(
        torch.from_numpy(img), torch.from_numpy(sig), epf_iters=3,
        gab=True).numpy()
    np.testing.assert_array_equal(
        got, _port(img, sig, epf_iters=3, gab=True))
    assert epf_cuda.launches == 0


def _custom_loop_filter(epf_iters):
    """A frame header's loop filter with custom gaborish weights, EPF
    channel scales and EPF sigma parameters, written to a bitstream and
    read back, as a decoder sees it."""
    from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
    from libjxl_tpu_torch.bitstream.fields import bundle_read, bundle_write
    from libjxl_tpu_torch.frame.frame_header import LoopFilter
    lf = LoopFilter(all_default=False, gab=True, gab_custom=True,
                    gab_x_weight1=0.09, gab_x_weight2=0.04,
                    gab_y_weight1=0.13, gab_y_weight2=0.07,
                    gab_b_weight1=0.1, gab_b_weight2=0.03,
                    epf_iters=epf_iters, epf_weight_custom=True,
                    epf_channel_scale=[32.0, 6.0, 2.5],
                    epf_sigma_custom=True, epf_quant_mul=0.55,
                    epf_pass0_sigma_scale=0.75, epf_pass2_sigma_scale=5.0,
                    epf_border_sad_mul=0.5)
    w = BitWriter()
    bundle_write(lf, w)
    w.align_to_byte()
    out = LoopFilter()
    bundle_read(BitReader(w.get_bytes()), out)
    assert out.gab_custom and out.epf_weight_custom and out.epf_sigma_custom
    return out


@pytest.mark.parametrize("epf_iters", [1, 2, 3])
def test_custom_loop_filter_weights_match_host(epf_iters):
    """The frame header's custom weights reach the plain version
    (through ``loop_filter_params``), which then matches the host chain
    (gaborish, EPF0-2 of pipeline/loop_filters.py) at the atol of
    tests/test_filters_tpu.py."""
    from libjxl_tpu_torch.pipeline import loop_filters as host
    from libjxl_tpu_torch.tpu.pipeline import loop_filter_params
    lf = _custom_loop_filter(epf_iters)
    rng = np.random.default_rng(epf_iters)
    img = rng.normal(0.5, 0.2, (3, 64, 80)).astype(np.float32)
    sig = host.compute_sigma_map(lf, rng.integers(100, 6000, (8, 10)),
                                 rng.integers(0, 8, (8, 10)),
                                 0.0002).astype(np.float32)
    ref = host.gaborish(img, lf)
    if epf_iters >= 3:
        ref = host.epf0(ref, lf, sig)
    ref = host.epf1(ref, lf, sig)
    if epf_iters >= 2:
        ref = host.epf2(ref, lf, sig)
    kw = loop_filter_params(lf)
    got = epf_cuda.apply_loop_filters(torch.from_numpy(img),
                                      torch.from_numpy(sig), **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    default = filters.apply_loop_filters(torch.from_numpy(img),
                                         torch.from_numpy(sig),
                                         epf_iters=epf_iters, gab=True)
    assert np.abs(default.numpy() - ref).max() > 1e-3
