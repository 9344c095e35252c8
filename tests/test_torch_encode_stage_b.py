"""The port's stage B functions (libjxl_tpu_torch.ops.encode:
``acs_select``, ``_adjust_quant_blocks``, ``_fit_cfl``,
``encode_stage_b``, ``stage_b``, ``make_tables``, ``tables_to_torch``)
against the JAX package's (ops/encode_pipeline.py) on the CPU, the
reference jitted as the JAX package's device route runs it.

Every input is made with numpy from a seed; both packages get the same
arrays and the same dequant tables (the JAX package's ``make_tables``
bundle, turned into tensors by ``tables_to_torch``). Tolerances: the
quant field 1e-5 relative; thresholds 1e-6 and ``dc_float`` 1e-5
absolute; strategy maps, raw quant, quantized DC and CfL maps equal. The
quantized AC coefficients are equal but for a share of at most 1e-4 of
the entries, each at most 1 apart. The cause: the two packages sum the
products of each DCT in another order (XLA's dot against torch's
matmul; the contraction order is the same), so a coefficient moves by
about 1e-7, and the few that sit on a rounding or dead-zone boundary
round the other way. The one such entry in these cases lies in a
DCT8X16 tile that the frame does not use.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from libjxl_tpu.color.xyb import (  # noqa: E402
    linear_rgb_to_xyb, srgb_to_linear,
)
from libjxl_tpu.frame.adaptive_quant import initial_quant_dc  # noqa: E402
from libjxl_tpu.ops import encode_pipeline as jep  # noqa: E402
from libjxl_tpu.vardct import ac_strategy as acs  # noqa: E402
from libjxl_tpu.vardct.cfl import ColorCorrelation  # noqa: E402
from libjxl_tpu.vardct.dct import dct_matrix  # noqa: E402
from libjxl_tpu.vardct.quant_weights import DequantMatrices  # noqa: E402
from libjxl_tpu.vardct.quantizer import QUANT_MAX, Quantizer  # noqa: E402
from libjxl_tpu.vardct.reconstruct import (  # noqa: E402
    b_qm_multiplier, x_qm_multiplier,
)
from libjxl_tpu_torch.ops import encode as ep  # noqa: E402
from libjxl_tpu_torch.vardct.quant_weights import (  # noqa: E402
    DequantMatrices as PortDequantMatrices,
)

CPU = torch.device("cpu")
SHAPES = [(8, 8), (64, 64), (72, 136), (136, 72), (128, 144), (520, 16)]
FLOAT_TOL = 1e-6
DC_TOL = 1e-5
QUANT_SHARE = 1e-4      # quantized AC entries allowed to differ, by 1
MERGE16, BIG = 0.92, 0.92


@functools.lru_cache(maxsize=None)
def _jit(fn, *args, **static):
    """The JAX function with its static arguments bound, jitted once."""
    return jax.jit(functools.partial(fn, *args, **static))


def _xyb(h, w, seed):
    """XYB of smooth bands plus noise, through the host numpy transform."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    srgb = np.stack([np.clip(0.45 + 0.3 * np.sin(x / (7 + 3 * c))
                             * np.cos(y / (11 - 2 * c))
                             + 0.1 * np.sin((x + 2 * y) / 23)
                             + rng.normal(0, 0.03, (h, w)), 0, 1)
                     for c in range(3)]).astype(np.float32)
    return linear_rgb_to_xyb(srgb_to_linear(srgb)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.numpy()


def _shape_id(s):
    return f"{s[0]}x{s[1]}"


def _stage_b_inputs(shape, seed, distance=1.0):
    """XYB (gaborish-inverted), the raw quant field and the scalars of
    one frame, as compute_vardct_encoding_device makes them."""
    xyb = _xyb(*shape, seed=seed)
    qf = np.asarray(_jit(jep.initial_quant_field_jnp, distance)(xyb))
    matrices = DequantMatrices()
    quantizer = Quantizer(matrices)
    raw_quant = quantizer.set_quant_field(initial_quant_dc(distance), qf)
    planes = np.asarray(_jit(jep.gaborish_inverse_jnp)(xyb))
    cmap = ColorCorrelation()
    return dict(
        xyb=planes, raw_quant=np.asarray(raw_quant, np.int32),
        inv_gs=np.float32(quantizer.inv_global_scale),
        x_mul=np.float32(x_qm_multiplier(3)),
        b_mul=np.float32(b_qm_multiplier(2)),
        mul_dc=np.asarray(quantizer.mul_dc(), np.float32),
        cfl_fac=np.asarray(cmap.dc_factors(), np.float32),
        tables=jep.make_tables(matrices), cmap=cmap)


def _scalar(v):
    return torch.tensor(v, dtype=torch.float32)


def test_make_tables_match_jax():
    """The port's numpy bundle equals the JAX package's bit for bit, and
    tables_to_torch carries it over unchanged."""
    ours = ep.make_tables(PortDequantMatrices())
    theirs = jep.make_tables(DequantMatrices())
    assert sorted(ours) == sorted(theirs)
    dev = ep.tables_to_torch(theirs, CPU)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype == np.float32, k
        assert np.array_equal(ours[k], theirs[k]), k
        assert np.array_equal(_np(dev[k]), theirs[k]), k


ACS_FLAGS = {4: dict(enable_16=True, enable_32=False, enable_rect=False,
                     enable_64=False),
             5: dict(enable_16=True, enable_32=True, enable_rect=False,
                     enable_64=False),
             6: dict(enable_16=True, enable_32=True, enable_rect=True,
                     enable_64=False),
             7: dict(enable_16=True, enable_32=True, enable_rect=True,
                     enable_64=True)}
ACS_TABLES = ("inv8y", "inv16y", "inv32y", "inv64y", "invwy", "invty")


@pytest.mark.parametrize("effort", [4, 5, 6, 7])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_acs_select_matches_jax(shape, effort):
    inp = _stage_b_inputs(shape, seed=7, distance=1.5)
    tb = inp["tables"]
    tt = ep.tables_to_torch(tb, CPU)
    got = ep.acs_select(_t(inp["xyb"][1]), _t(inp["raw_quant"]),
                        _scalar(inp["inv_gs"]), *[tt[k] for k in ACS_TABLES],
                        **ACS_FLAGS[effort], big_factor=BIG,
                        merge16=MERGE16)
    want = _jit(jep.acs_select_jnp, **ACS_FLAGS[effort], big_factor=BIG,
                merge16=MERGE16)(inp["xyb"][1], inp["raw_quant"],
                                 inp["inv_gs"], *[tb[k] for k in ACS_TABLES])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _coeffs8(xyb):
    """(3, BY, BX, 64) stored-layout 8x8 coefficients, from numpy."""
    _, h, w = xyb.shape
    m = dct_matrix(8)
    blocks = xyb.astype(np.float64).reshape(3, h // 8, 8, w // 8, 8) \
        .transpose(0, 1, 3, 2, 4)
    coef = np.einsum("ui,cabij,wj->cabwu", m, blocks, m)
    return coef.reshape(3, h // 8, w // 8, 64).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_adjust_quant_blocks_matches_jax(shape):
    inp = _stage_b_inputs(shape, seed=8)
    coeffs = _coeffs8(inp["xyb"])
    rng = np.random.default_rng(8)
    mask = rng.random(inp["raw_quant"].shape) < 0.8
    flat_inv = inp["tables"]["i8"]
    rq, thr = ep._adjust_quant_blocks(
        _t(coeffs), _t(flat_inv), _t(inp["raw_quant"]),
        _scalar(inp["inv_gs"]), _scalar(inp["x_mul"]),
        _scalar(inp["b_mul"]), _t(mask), QUANT_MAX)
    jrq, jthr = _jit(jep._adjust_quant_blocks_jnp, quant_max=QUANT_MAX)(
        coeffs, flat_inv, inp["raw_quant"], inp["inv_gs"], inp["x_mul"],
        inp["b_mul"], mask)
    np.testing.assert_array_equal(_np(rq), np.asarray(jrq))
    np.testing.assert_allclose(_np(thr), np.asarray(jthr), rtol=0,
                               atol=FLOAT_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_fit_cfl_matches_jax(shape):
    """Edge tiles (block counts not multiples of 8) included."""
    inp = _stage_b_inputs(shape, seed=9)
    coeffs = _coeffs8(inp["xyb"])
    flat_inv = inp["tables"]["i8"]
    got = ep._fit_cfl(_t(coeffs), _t(flat_inv), _t(inp["raw_quant"]),
                      1.0 / _scalar(inp["inv_gs"]))
    want = _jit(jep._fit_cfl_jnp)(coeffs, flat_inv, inp["raw_quant"],
                                  np.float32(1.0) / inp["inv_gs"])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _run_stage_b(inp, effort, fixed=None):
    """The port's stage B and the reference's jitted one on one input."""
    cm = inp["cmap"]
    kw = dict(effort=effort, quant_max=QUANT_MAX,
              base_cx=cm.base_correlation_x, base_cb=cm.base_correlation_b,
              color_scale=cm.color_scale, big_factor=BIG, merge16=MERGE16)
    got = ep.encode_stage_b(
        _t(inp["xyb"]), _t(inp["raw_quant"]), _scalar(inp["inv_gs"]),
        _scalar(inp["x_mul"]), _scalar(inp["b_mul"]), _t(inp["mul_dc"]),
        _t(inp["cfl_fac"]), ep.tables_to_torch(inp["tables"], CPU),
        fixed_strategies=None if fixed is None else _t(fixed), **kw)
    args = [inp["xyb"], inp["raw_quant"], inp["inv_gs"], inp["x_mul"],
            inp["b_mul"], inp["mul_dc"], inp["cfl_fac"], inp["tables"]]
    if fixed is not None:
        args.append(fixed)
    want = jep.stage_b_jitted(
        effort, QUANT_MAX, cm.base_correlation_x, cm.base_correlation_b,
        cm.color_scale, with_fixed=fixed is not None, big_factor=BIG,
        merge16=MERGE16)(*args)
    return got, jax.tree_util.tree_map(np.asarray, want)


def _check_quant(got, want, name):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= QUANT_SHARE, \
        (name, int(diff.max(initial=0)), float((diff > 0).mean()))


def _check_stage_b(got, want):
    for k in ("strategies", "raw_quant", "qdc", "ytox_map", "ytob_map"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    assert got["qall"].dtype == torch.int32
    _check_quant(_np(got["qall"]), want["qall"], "qall")
    assert sorted(got["big_q"]) == sorted(want["big_q"])
    for k in got["big_q"]:
        _check_quant(_np(got["big_q"][k]), want["big_q"][k], k)
    np.testing.assert_allclose(_np(got["dc_float"]), want["dc_float"],
                               rtol=0, atol=DC_TOL)


@pytest.mark.parametrize("effort", [2, 3, 4, 5, 6])
def test_encode_stage_b_matches_jax(effort):
    inp = _stage_b_inputs((128, 144), seed=10 + effort)
    _check_stage_b(*_run_stage_b(inp, effort))


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_encode_stage_b_e7_matches_jax(shape):
    """Effort 7 (every class) at every shape: classes that do not fit
    (``BY // cy == 0``), rectangular pairs and 64x64 transforms at the
    frame edge, edge CfL tiles."""
    inp = _stage_b_inputs(shape, seed=20)
    _check_stage_b(*_run_stage_b(inp, 7))


def test_encode_stage_b_fixed_strategies_match_jax():
    """A given strategy map, every big class placed by hand, in place of
    the search (the reference's ``with_fixed``); the port's ``stage_b``
    dispatch binds the same static arguments."""
    inp = _stage_b_inputs((128, 144), seed=21)
    st = np.zeros((16, 18), np.int32)
    st[0:8, 0:8] = -1
    st[0, 0] = acs.DCT64X64
    st[8:12, 0:4] = -1
    st[8, 0] = acs.DCT32X32
    st[8:10, 4:6] = -1
    st[8, 4] = acs.DCT16X16
    st[12, 4:6] = [acs.DCT8X16, -1]
    st[14:16, 8] = [acs.DCT16X8, -1]
    got, want = _run_stage_b(inp, 5, fixed=st)
    _check_stage_b(got, want)
    np.testing.assert_array_equal(_np(got["strategies"]), st)
    cm = inp["cmap"]
    fn = ep.stage_b(5, QUANT_MAX, cm.base_correlation_x,
                    cm.base_correlation_b, cm.color_scale, with_fixed=True,
                    big_factor=BIG, merge16=MERGE16)
    again = fn(_t(inp["xyb"]), _t(inp["raw_quant"]), _scalar(inp["inv_gs"]),
               _scalar(inp["x_mul"]), _scalar(inp["b_mul"]),
               _t(inp["mul_dc"]), _t(inp["cfl_fac"]),
               ep.tables_to_torch(inp["tables"], CPU), _t(st))
    for k in ("strategies", "raw_quant", "qall", "qdc"):
        assert torch.equal(again[k], got[k]), k
