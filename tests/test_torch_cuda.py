"""Tests that need an NVIDIA card: the hand-written EPF kernel against
its plain PyTorch version (single frames, batches, custom loop-filter
weights, the sharded step's halo-extended tiles), the decode on the
card (single, batched, with post stages, the public
``decode``/``decode_all``, the sharded step on an NCCL rank, the v1 path
and the v0 group decode), the encoder (``encode`` and its stages), the
command line (``cjxl``/``djxl``, ``benchmark_xl``), the rest of the
encode API (``encode_streaming``, ``Encoder``) and the event-driven
``Decoder`` over a stream the card encoded, against the plain CPU path.
They
import neither jax nor the JAX package, so they run on a machine that
has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip (the kernel has no CPU mode).
"""

import os

import numpy as np
import pytest
import torch

import libjxl_tpu_torch
from libjxl_tpu_torch.ops import epf_cuda, filters
from libjxl_tpu_torch.ops.decode_torch import xyb_to_pq16

TOL = 2e-6          # kernel vs plain: float rounding only
XYB_TOL = 1e-4      # card vs CPU decode: products summed in other orders
STAGES = [(it, gab) for it in (0, 1, 2, 3) for gab in (True, False)
          if it or gab]
# Frames narrower or shorter than one tile, or than the halo: the
# kernel's mirrored tables, sigma plane and field boxes meet both edges.
EDGE_SHAPES = [(1, 1), (5, 3), (7, 300), (300, 7), (33, 9)]
# Ragged for the kernel's strips of 8 rows (heights one below and one
# above a multiple of 8) and for its 32 x 32 tile (heights and widths one
# below and one above a multiple of 32).
RAGGED_SHAPES = [(39, 70), (41, 70), (63, 95), (65, 97)]
CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_corpus")
POST_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_corpus")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _case(seed, h, w, device):
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 0.3, (3, h, w)).astype(np.float32)
    sig = rng.uniform(-6.0, -0.05,
                      ((h + 7) // 8, (w + 7) // 8)).astype(np.float32)
    return torch.from_numpy(img).to(device), torch.from_numpy(sig).to(device)


@pytest.mark.parametrize("shape", [(96, 200), (61, 117), (2160, 3840)]
                         + EDGE_SHAPES + RAGGED_SHAPES)
@pytest.mark.parametrize("epf_iters,gab", STAGES)
def test_kernel_matches_plain(epf_iters, gab, shape, cuda_device):
    x, s = _case(11, *shape, cuda_device)
    before = epf_cuda.launches
    got = epf_cuda.apply_loop_filters(x, s, epf_iters=epf_iters, gab=gab)
    assert epf_cuda.launches == before + 1
    ref = filters.apply_loop_filters(x, s, epf_iters=epf_iters, gab=gab)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.device == x.device
    assert (got - ref).abs().max().item() <= TOL


def test_kernel_occupancy(cuda_device):
    """Each of the seven instances launches with its shared memory; the
    main path's (gaborish + three passes: two image buffers, six fields
    of 42 rows and the sigma plane, all at a row stride of 49 words) keeps
    two blocks of 256 threads on an SM. No stage, no kernel."""
    for it, gab in STAGES:
        occ = epf_cuda.occupancy(it, gab)
        assert occ["blocks_per_sm"] >= 1
        assert occ["shared_bytes"] <= 227 * 1024
    occ = epf_cuda.occupancy(3, True)
    assert occ["shared_bytes"] == 112888 and occ["blocks_per_sm"] == 2
    with pytest.raises(RuntimeError):
        epf_cuda.occupancy(0, False)


def test_kernel_rejects_bad_input(cuda_device):
    x, s = _case(12, 64, 64, cuda_device)
    with pytest.raises(TypeError):
        epf_cuda.apply_loop_filters(x.double(), s)
    with pytest.raises(ValueError):
        epf_cuda.apply_loop_filters(x.transpose(1, 2), s)
    with pytest.raises(ValueError):
        epf_cuda.apply_loop_filters(x, s[:4])
    with pytest.raises(ValueError):
        epf_cuda.apply_loop_filters(x, s.cpu())


def test_corpus_decode_on_card_matches_cpu(cuda_device):
    """XYB within XYB_TOL of the CPU path; PQ16 within one code of the
    CPU tail on the same XYB (PQ's dark-tone slope turns float32
    reordering in XYB into several codes, so raw codes are not
    compared)."""
    with open(os.path.join(CORPUS, "1080p_hdr_pq_d1_e5_prog_epf3.jxl"),
              "rb") as f:
        data = f.read()
    before = epf_cuda.launches
    pq = libjxl_tpu_torch.decode_device(data, out="pq16")
    xyb = libjxl_tpu_torch.decode_device(data, out="xyb")
    torch.cuda.synchronize()
    assert epf_cuda.launches == before + 2
    assert pq.device.type == "cuda" and pq.dtype == torch.uint16
    assert tuple(pq.shape) == (3, 1080, 1920)
    ref = libjxl_tpu_torch.decode_device(data, out="xyb", device="cpu")
    assert (xyb.cpu() - ref).abs().max().item() <= XYB_TOL
    tail = xyb_to_pq16(xyb.cpu()).to(torch.int32)
    assert (pq.cpu().to(torch.int32) - tail).abs().max().item() <= 1


def test_pipeline_on_card_matches_single_decodes(cuda_device):
    with open(os.path.join(CORPUS, "1080p_hdr_pq_d1_e5_prog_epf3.jxl"),
              "rb") as f:
        data = f.read()
    outs = libjxl_tpu_torch.decode_batch([data] * 3, out="pq16")
    ref = libjxl_tpu_torch.decode_device(data, out="pq16")
    for o in outs:
        assert o.device.type == "cuda"
        assert torch.equal(o, ref)


@pytest.mark.parametrize("n,shape,per_frame_map", [
    (3, (96, 200), True), (2, (61, 117), True), (3, (61, 117), False),
    (2, (5, 3), True), (2, (39, 97), True), (2, (41, 63), False),
    (3, (65, 95), True)])
@pytest.mark.parametrize("epf_iters,gab", [(3, True), (2, False),
                                           (1, True)])
def test_batched_kernel_matches_plain(n, shape, per_frame_map, epf_iters,
                                      gab, cuda_device):
    """One launch filters the whole batch, each frame as the plain
    version filters it alone."""
    rng = np.random.default_rng(13)
    h, w = shape
    x = torch.from_numpy(rng.normal(0, 0.3, (n, 3, h, w))
                         .astype(np.float32)).to(cuda_device)
    bmap = ((n,) if per_frame_map else ()) + ((h + 7) // 8, (w + 7) // 8)
    s = torch.from_numpy(rng.uniform(-6.0, -0.05, bmap)
                         .astype(np.float32)).to(cuda_device)
    before = epf_cuda.launches
    got = epf_cuda.apply_loop_filters(x, s, epf_iters=epf_iters, gab=gab)
    assert epf_cuda.launches == before + 1
    torch.cuda.synchronize()
    for i in range(n):
        ref = filters.apply_loop_filters(
            x[i], s[i] if per_frame_map else s, epf_iters=epf_iters,
            gab=gab)
        assert (got[i] - ref).abs().max().item() <= TOL


def _custom_loop_filter(epf_iters):
    """Custom gaborish weights, EPF channel scales and sigma parameters,
    written to a bitstream and read back."""
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
    return out


@pytest.mark.parametrize("epf_iters", [1, 2, 3])
def test_kernel_custom_loop_filter_weights(epf_iters, cuda_device):
    """Custom header weights: the kernel within 2e-6 of the plain version
    and within 5e-5 of the host chain (tests/test_filters_tpu.py's atol)."""
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
    x = torch.from_numpy(img).to(cuda_device)
    s = torch.from_numpy(sig).to(cuda_device)
    got = epf_cuda.apply_loop_filters(x, s, **kw)
    plain = filters.apply_loop_filters(x, s, **kw)
    torch.cuda.synchronize()
    assert (got - plain).abs().max().item() <= TOL
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("name,hw", [
    ("4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl", (2160, 3840)),
    ("1080p_splines_d1.jxl", (1080, 1920))])
def test_post_path_on_card_matches_cpu(name, hw, cuda_device):
    """Upsampling + noise, and splines, on the card: XYB within XYB_TOL of
    the CPU path (splines scatter-add in no fixed order on the card)."""
    with open(os.path.join(POST_CORPUS, name), "rb") as f:
        data = f.read()
    before = epf_cuda.launches
    pq = libjxl_tpu_torch.decode_device(data, out="pq16")
    xyb = libjxl_tpu_torch.decode_device(data, out="xyb")
    torch.cuda.synchronize()
    assert epf_cuda.launches == before + 2
    assert pq.dtype == torch.uint16 and tuple(pq.shape) == (3,) + hw
    assert pq.device.type == "cuda"
    ref = libjxl_tpu_torch.decode_device(data, out="xyb", device="cpu")
    assert (xyb.cpu() - ref).abs().max().item() <= XYB_TOL


def test_batched_pipeline_on_card(cuda_device):
    """batch=3 over four 1080p frames: two launches (a full batch and the
    flushed rest); each frame within 1e-5 XYB of its single decode; the
    outputs stay valid after close()."""
    with open(os.path.join(CORPUS, "1080p_hdr_pq_d1_e5_prog_epf3.jxl"),
              "rb") as f:
        data = f.read()
    ref = libjxl_tpu_torch.decode_device(data, out="xyb")
    before = epf_cuda.launches
    pipe = libjxl_tpu_torch.DecodePipeline(out="xyb", batch=3)
    futs = [pipe.submit(data) for _ in range(4)]
    pipe.close()
    outs = [f.result() for f in futs]
    assert epf_cuda.launches == before + 2
    del futs
    scratch = torch.full((64, 2 ** 20), 7.0, device=cuda_device)
    torch.cuda.synchronize()
    for o in outs:
        assert o.device.type == "cuda" and tuple(o.shape) == (3, 1080, 1920)
        assert (o - ref).abs().max().item() <= 1e-5
    del scratch


def _api_stream(name):
    corpus = CORPUS if name.startswith("4k_hdr_pq_d1") else POST_CORPUS
    with open(os.path.join(corpus, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,shape,launches", [
    ("1080p_screen_patches_d1_e7.jxl", (1080, 1920, 3), 1),
    ("1024x768_spot2_lossless.jxl", (768, 1024, 3), 0)])
def test_api_decode_on_card_matches_cpu(name, shape, launches,
                                        cuda_device):
    """``decode`` on the card (patches with a reference frame, EPF on the
    kernel; spot colours mixed on the card) within 1 LSB of its CPU
    route."""
    data = _api_stream(name)
    before = epf_cuda.launches
    got = libjxl_tpu_torch.decode(data)
    assert epf_cuda.launches == before + launches
    ref = libjxl_tpu_torch.decode(data, device="cpu")
    assert got.pixels.shape == ref.pixels.shape == shape
    assert got.pixels.dtype == np.uint8
    assert np.abs(got.pixels.astype(np.int64)
                  - ref.pixels.astype(np.int64)).max() <= 1


def test_api_decode_hdr_on_card_matches_cpu(cuda_device):
    """The 4K HDR stream through ``decode``: 16-bit PQ; the card frame's
    XYB within XYB_TOL of the CPU route's, and the output equals the
    host tail on that XYB within one code (caveat 5: raw codes of the
    two routes may differ by more in dark tones)."""
    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.color.transfer_functions import (
        pq_encoded_from_display,
    )
    from libjxl_tpu_torch.color.xyb import xyb_to_linear_rgb
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    from libjxl_tpu_torch.frame.headers import read_codestream_headers

    data = _api_stream("4k_hdr_pq_d1_e5_prog_epf3_0.jxl")

    def xyb(device):
        r = BitReader(data)
        return decode_frame(r, read_codestream_headers(r),
                            device=device).xyb

    got = libjxl_tpu_torch.decode(data)
    assert got.pixels.dtype == np.uint16
    assert got.pixels.shape == (2160, 3840, 3)
    card = xyb("cuda")
    assert np.abs(card - xyb("cpu")).max() <= XYB_TOL
    pq = pq_encoded_from_display(xyb_to_linear_rgb(card)
                                 * (255.0 / 10000.0)).astype(np.float32)
    tail = np.clip(np.round(pq * 65535), 0, 65535).transpose(1, 2, 0)
    assert np.abs(got.pixels.astype(np.int64) - tail).max() <= 1


def test_api_decode_all_on_card_matches_cpu(cuda_device):
    """The 720p RGBA animation: four frames blended on the card, each
    within 1 LSB of the CPU route."""
    data = _api_stream("720p_anim4_rgba_blend_d1.jxl")
    got, meta = libjxl_tpu_torch.decode_all(data)
    ref, _ = libjxl_tpu_torch.decode_all(data, device="cpu")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.pixels.shape == (720, 1280, 4)
        assert g.duration == r.duration
        assert np.abs(g.pixels.astype(np.int64)
                      - r.pixels.astype(np.int64)).max() <= 1


def test_blend_and_spot_stages_on_card(cuda_device):
    """The blend and spot stages on card tensors equal their CPU runs
    within 1e-6, and the blended canvas stays on the card."""
    from libjxl_tpu_torch.ops import stages
    rng = np.random.default_rng(3)
    canvas = torch.from_numpy(rng.uniform(0, 1, (40, 50, 3))
                              .astype(np.float32))
    ca = torch.from_numpy(rng.uniform(0, 1, (40, 50)).astype(np.float32))
    src = rng.uniform(0, 1, (30, 20, 3)).astype(np.float32)
    sa = rng.uniform(0, 1, (30, 20)).astype(np.float32)
    for mode in range(5):
        gc, ga = stages.blend_frame(canvas.to(cuda_device),
                                    ca.to(cuda_device), src, sa, mode,
                                    -3, 15)
        rc, ra = stages.blend_frame(canvas, ca, src, sa, mode, -3, 15)
        assert gc.device.type == "cuda"
        assert (gc.cpu() - rc).abs().max().item() <= 1e-6
        assert (ga.cpu() - ra).abs().max().item() <= 1e-6
    color = torch.from_numpy(rng.uniform(0, 1, (3, 40, 50))
                             .astype(np.float32))
    mixes = torch.from_numpy(rng.uniform(0, 1, (2, 40, 50))
                             .astype(np.float32))
    rgba = torch.from_numpy(rng.uniform(0, 1, (2, 4)).astype(np.float32))
    got = stages.render_spot(color.to(cuda_device), mixes.to(cuda_device),
                             rgba.to(cuda_device))
    ref = stages.render_spot(color, mixes, rgba)
    assert (got.cpu() - ref).abs().max().item() <= 1e-6


def _photo(size, seed=5):
    """bench.py's ``_test_photo``: smooth bands and noise, 8-bit."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size]
    img = np.clip(np.stack(
        [0.5 + 0.3 * np.sin(x / 17 + c) * np.cos(y / 23)
         + 0.1 * np.sin((x + y) / 41)
         + rng.normal(0, 0.02, (size, size)) for c in range(3)], -1), 0, 1)
    return (img * 255).astype(np.uint8)


@pytest.mark.parametrize("effort", [5, 7])
@pytest.mark.parametrize("size", [256, 1024])
def test_encode_on_card_matches_cpu(size, effort, cuda_device):
    """The VarDCT stages on the card (counted) against the CPU route: the
    size within max(8 B, 1%), the decodes within 2 LSB."""
    from libjxl_tpu_torch.ops import encode as ep
    img = _photo(size)
    ep.calls.clear()
    card = libjxl_tpu_torch.encode(img, distance=1.0, effort=effort)
    assert ep.calls[("encode_stage_b", "cuda")] == 1
    assert all(k[1] == "cuda" for k in ep.calls), dict(ep.calls)
    cpu = libjxl_tpu_torch.encode(img, distance=1.0, effort=effort,
                                  device="cpu")
    assert abs(len(card) - len(cpu)) <= max(8, 0.01 * len(cpu))
    pc = libjxl_tpu_torch.decode(card).pixels.astype(np.int64)
    pp = libjxl_tpu_torch.decode(cpu).pixels.astype(np.int64)
    assert pc.shape == (size, size, 3)
    assert np.abs(pc - pp).max() <= 2


def test_encode_stages_on_card_match_cpu(cuda_device):
    """Stage pre and stage B (effort 7: every class) on the card and on
    the CPU from the same inputs: the quant field within 1e-5 relative,
    the planes within 1e-5, the integer outputs equal up to the shares
    that chip_smoke.py gates the 4K frame with."""
    import chip_smoke
    from libjxl_tpu_torch.frame.adaptive_quant import initial_quant_dc
    from libjxl_tpu_torch.ops import encode as ep
    from libjxl_tpu_torch.vardct.cfl import ColorCorrelation
    from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices
    from libjxl_tpu_torch.vardct.quantizer import QUANT_MAX, Quantizer
    from libjxl_tpu_torch.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    srgb = _photo(256).astype(np.float32) / 255
    pre = linear_rgb_to_xyb(srgb_to_linear(srgb).transpose(2, 0, 1))
    pre = torch.from_numpy(np.ascontiguousarray(pre, np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        qf, planes = ep.encode_stage_pre(pre.to(dev), 1.0, True)
        out[dev] = [qf.cpu().numpy(), planes.cpu()]
    qf, planes = out["cuda"]
    assert np.max(np.abs(qf - out["cpu"][0]) / out["cpu"][0]) <= 1e-5
    assert (planes - out["cpu"][1]).abs().max().item() <= 1e-5
    matrices = DequantMatrices()
    quantizer = Quantizer(matrices)
    raw_quant = quantizer.set_quant_field(initial_quant_dc(1.0), qf)
    cm = ColorCorrelation()
    fn = ep.stage_b(7, QUANT_MAX, cm.base_correlation_x,
                    cm.base_correlation_b, cm.color_scale)
    res = {}
    for dev in ("cuda", "cpu"):
        d = torch.device(dev)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=d)
        r = fn(planes.to(d), torch.from_numpy(raw_quant).to(d),
               f32(quantizer.inv_global_scale), f32(1.0), f32(1.0),
               f32(quantizer.mul_dc()), f32(cm.dc_factors()),
               ep.tables_to_torch(ep.make_tables(matrices), d))
        res[dev] = ep.to_host(r)
    for k, limit in chip_smoke.ENC_STAGE_SHARE.items():
        pairs = ([(res["cuda"]["big_q"][c], res["cpu"]["big_q"][c])
                  for c in res["cpu"]["big_q"]] if k == "big_q"
                 else [(res["cuda"][k], res["cpu"][k])])
        for a, b in pairs:
            assert (a != b).mean() <= limit, (k, float((a != b).mean()))


# ---- the last device modules: sharded step, v1 path, v0 groups ----------

def _corpus_1080p():
    with open(os.path.join(CORPUS, "1080p_hdr_pq_d1_e5_prog_epf3.jxl"),
              "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,h,w", [(2, 123, 528), (3, 2160, 3856)])
def test_kernel_on_halo_extended_shards(n, h, w, cuda_device):
    """The sharded step's launch: tiles W_local + 16 px wide (not a
    multiple of the kernel's 32-px tile), ragged heights, one map per
    frame one block wider on each side; each frame as the plain version
    filters it alone."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(0, 0.3, (n, 3, h, w))
                         .astype(np.float32)).to(cuda_device)
    s = torch.from_numpy(rng.uniform(
        -6.0, -0.05, (n, (h + 7) // 8, w // 8)).astype(np.float32)).to(
            cuda_device)
    before = epf_cuda.launches
    got = epf_cuda.apply_loop_filters(x, s, epf_iters=3, gab=True)
    assert epf_cuda.launches == before + 1
    for i in range(n):
        ref = filters.apply_loop_filters(x[i], s[i], epf_iters=3, gab=True)
        assert (got[i] - ref).abs().max().item() <= TOL


def test_sharded_step_on_nccl_rank_matches_decode_device(cuda_device):
    """The slim-feed sharded step at world size 1 through NCCL (one
    card), two frames in one step: one EPF launch, each frame within 1
    LSB of ``decode_device``."""
    import torch.distributed as dist

    from libjxl_tpu_torch.parallel import ranks
    from libjxl_tpu_torch.parallel.sharded_decode import (
        batch_feeds2, gather, make_sharded_decode2,
    )
    data = _corpus_1080p()
    feed = libjxl_tpu_torch.parse_to_feed(data)
    h, w = feed["image_hw"]
    args, class_keys = batch_feeds2([feed, feed], 1)
    lf = feed["lf"]

    def step(mesh):
        fn, shard = make_sharded_decode2(
            mesh, h, w, epf_iters=int(lf.epf_iters), gab=bool(lf.gab),
            class_keys=class_keys)
        local = shard(args)
        before = epf_cuda.launches
        out = gather(fn(*local), mesh)
        return out, epf_cuda.launches - before, dist.get_backend()

    out, launches, backend = ranks.run_ranks(step, 1, device_type="cuda",
                                             timeout=600.0)[0]
    assert backend == "nccl" and launches == 1
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 3, h, w)
    ref = libjxl_tpu_torch.decode_device(data, out="srgb8")
    for i in range(2):
        assert (out[i].int() - ref.int()).abs().max().item() <= 1


def test_cuda_tensor_in_gloo_group_raises(cuda_device):
    from libjxl_tpu_torch.parallel import ranks
    from libjxl_tpu_torch.parallel.sharded_decode import (
        _halo_exchange_w, gather,
    )

    def check(mesh):
        x = torch.zeros((1, 3, 8, 16), device="cuda")
        with pytest.raises(ValueError, match="cannot travel"):
            gather(x, mesh)
        with pytest.raises(ValueError, match="cannot travel"):
            _halo_exchange_w(x, 8, mesh.get_group("space"), 2)
        return True
    assert ranks.run_ranks(check, 1, device_type="cpu") == [True]


def test_entry_on_card_matches_cpu(cuda_device):
    from libjxl_tpu_torch import entry
    stream = libjxl_tpu_torch.encode(entry._test_images(1, 128)[0],
                                     distance=1.0, effort=5)
    fn, args = entry.entry(stream)
    before = epf_cuda.launches
    got = fn(*args)
    assert epf_cuda.launches == before + 1
    assert got.device.type == "cuda" and tuple(got.shape) == (3, 128, 128)
    fn, args = entry.entry(stream, device="cpu")
    assert (got.cpu().int() - fn(*args).int()).abs().max().item() <= 1


def test_v1_decode_on_card_matches_cpu_and_v2(cuda_device):
    from libjxl_tpu_torch import entry
    from libjxl_tpu_torch.tpu import pipeline
    data = _corpus_1080p()
    feed = entry.feed_v1(data)
    kw = dict(inv_sigma=feed["inv_sigma"])
    xyb = pipeline.decode_frame_device(feed, feed["lf"], None, None, None,
                                       1080, 1920, return_xyb=True, **kw)
    ref = pipeline.decode_frame_device(feed, feed["lf"], None, None, None,
                                       1080, 1920, return_xyb=True,
                                       device="cpu", **kw)
    assert np.abs(xyb - ref).max() <= XYB_TOL
    srgb = pipeline.decode_frame_device(feed, feed["lf"], None, None, None,
                                        1080, 1920, as_numpy=False, **kw)
    v2 = libjxl_tpu_torch.decode_device(data, out="srgb8")
    assert (srgb.int() - v2.int()).abs().max().item() <= 1


def test_v0_group_decode_on_card_matches_cpu(cuda_device):
    from libjxl_tpu_torch.ops import decode_torch
    got = decode_torch.decode_groups_dct8(*decode_torch.example_inputs())
    ref = decode_torch.decode_groups_dct8(
        *decode_torch.example_inputs(device="cpu"))
    assert got.device.type == "cuda"
    assert (got.cpu() - ref).abs().max().item() <= 2e-4


def _cli(main, *argv):
    import contextlib
    import io
    with contextlib.redirect_stderr(io.StringIO()):
        assert main([str(a) for a in argv]) == 0


def test_cli_on_card(tmp_path, cuda_device):
    """``cjxl`` on the card (the default device) against ``--device
    cpu`` within the encoder's gates; ``djxl`` to ``.npy`` identical to
    ``decode()`` on the card, through one EPF launch; ``--low-memory``
    (host) within 1 LSB of it."""
    from libjxl_tpu_torch.cli import cjxl, djxl
    from libjxl_tpu_torch.extras import codecs
    img = _photo(256)
    (tmp_path / "in.ppm").write_bytes(codecs.encode_pnm(img))
    _cli(cjxl.main, tmp_path / "in.ppm", tmp_path / "card.jxl", "-e", "5")
    _cli(cjxl.main, tmp_path / "in.ppm", tmp_path / "cpu.jxl", "-e", "5",
         "--device", "cpu")
    card = (tmp_path / "card.jxl").read_bytes()
    cpu = (tmp_path / "cpu.jxl").read_bytes()
    assert abs(len(card) - len(cpu)) <= max(8, 0.01 * len(cpu))
    px = libjxl_tpu_torch.decode(card).pixels
    pp = libjxl_tpu_torch.decode(cpu).pixels
    assert np.abs(px.astype(np.int64) - pp).max() <= 2
    before = epf_cuda.launches
    _cli(djxl.main, tmp_path / "card.jxl", tmp_path / "card.npy")
    assert epf_cuda.launches - before == 1
    np.testing.assert_array_equal(np.load(tmp_path / "card.npy"), px)
    _cli(djxl.main, tmp_path / "card.jxl", tmp_path / "lm.ppm",
         "--low-memory")
    lm = codecs.load_image(str(tmp_path / "lm.ppm")).pixels
    assert np.abs(lm.astype(np.int64) - px).max() <= 1


def test_encode_api_on_card(cuda_device):
    """A single-group ``encode_streaming`` and ``Encoder`` on the card:
    byte for byte ``encode`` on the card with the same settings; a
    two-chunk stream (host) equal to its CPU run."""
    from libjxl_tpu_torch.api import encode_streaming
    from libjxl_tpu_torch.api.encoder import Encoder, FrameSettings
    img = _photo(256)
    one = encode_streaming(lambda x0, y0, w, h: img[y0:y0 + h, x0:x0 + w],
                           256, 256, distance=1.0)
    assert one == libjxl_tpu_torch.encode(img, distance=1.0)
    enc = Encoder(device="cuda")
    enc.add_image_frame(img, FrameSettings(distance=2.0, effort=5))
    assert enc.process_output() == libjxl_tpu_torch.encode(
        img, distance=2.0, effort=5)
    strip = np.ascontiguousarray(np.tile(img, (1, 10, 1))[:, :2300])
    get = lambda x0, y0, w, h: strip[y0:y0 + h, x0:x0 + w]  # noqa: E731
    assert encode_streaming(get, 2300, 256) == \
        encode_streaming(get, 2300, 256, device="cpu")


def test_benchmark_xl_on_card(tmp_path, cuda_device):
    """``benchmark_xl``'s JPEG XL codecs on the card against ``--device
    cpu`` through its ``run_codec``: bytes within max(8 B, 1%), pixels
    within 2 LSB (the encoder's gates); the tool itself runs on the card
    by default."""
    import contextlib
    import io

    from libjxl_tpu_torch.cli import benchmark_xl
    from libjxl_tpu_torch.extras import codecs
    img = _photo(256)
    for spec in ("jxl:d1.0", "jxl:d1.0:p"):
        before = epf_cuda.launches
        card, pc, _, _ = benchmark_xl.run_codec(img, spec)
        assert epf_cuda.launches - before == 1
        cpu, pp, _, _ = benchmark_xl.run_codec(img, spec, "cpu")
        assert abs(len(card) - len(cpu)) <= max(8, 0.01 * len(cpu))
        assert pc.shape == img.shape
        assert np.abs(pc.astype(np.int64) - pp).max() <= 2
    (tmp_path / "in.ppm").write_bytes(codecs.encode_pnm(img))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert benchmark_xl.main(["--input", str(tmp_path / "in.ppm"),
                                  "--codec", "jxl:d1.0",
                                  "--no_metrics"]) == 0
    assert out.getvalue().splitlines()[-1].startswith("jxl:d1.0 ")


def test_decoder_over_card_stream(cuda_device):
    """The event-driven ``Decoder`` (host) over a progressive stream the
    card encoded, in 4 KiB chunks: the image within 1 LSB of ``decode``
    on the card, and a partial image before the end."""
    from libjxl_tpu_torch.api.decoder import Decoder, Event
    img = _photo(256)
    data = libjxl_tpu_torch.encode(img, distance=1.0, progressive=True)
    dec = Decoder(events={Event.FULL_IMAGE, Event.FRAME_PROGRESSION})
    flushed, ev = None, None
    for start in range(0, len(data), 4096):
        dec.set_input(data[start:start + 4096])
        if start + 4096 >= len(data):
            dec.close_input()
        while True:
            ev = dec.process_input()
            if ev == Event.FRAME_PROGRESSION and flushed is None:
                flushed = dec.flush_image()
            if ev in (Event.NEED_MORE_INPUT, Event.SUCCESS, Event.ERROR):
                break
    assert ev == Event.SUCCESS
    assert flushed is not None and flushed.shape == img.shape
    px = libjxl_tpu_torch.decode(data).pixels
    assert np.abs(dec.image.astype(np.int64) - px).max() <= 1
