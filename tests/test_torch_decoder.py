"""The port's event-driven ``Decoder`` (``libjxl_tpu_torch.api.decoder``)
against the JAX package's on the same bytes, fed in the same chunks.

Each case drives both decoders through the same loop and holds the port
to the reference's sequence of events, to every image and ``frames``
entry byte for byte, and to each ``flush_image()`` result. Both are host
code (the port's ``Decoder`` takes no device, as the reference's runs on
the host). The one-shot route's pixels depend on the worker count
(ROADMAP queue 3, caveat 1), so both packages' runners are pinned to one
worker while a case runs.

The cases are the counterparts of ``tests/test_streaming_api.py``'s
decoder tests (whole, chunked and container input, garbage, sections
decoded once, the progressive flush, rewind and skip, boxes, JPEG
reconstruction, the modular incremental path, an animation fed byte by
byte, the preferred profile and the row callback) and of the streaming
entry point of ``tests/test_fuzz.py`` on mutated streams."""

import io

import numpy as np
import pytest

import libjxl_tpu.frame.incremental as ref_inc_mod
import libjxl_tpu_torch.frame.incremental as inc_mod
from libjxl_tpu.api import decoder as ref_decoder
from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.api.encoder import Encoder, FrameSettings
from libjxl_tpu.parallel import runner as ref_runner
from libjxl_tpu_torch.api import decoder
from libjxl_tpu_torch.parallel import runner

MAX_STEPS = 4096


@pytest.fixture(autouse=True)
def one_worker():
    prev = (ref_runner.get_runner(), runner.get_runner())
    ref_runner.set_runner(ref_runner.ThreadRunner(num_workers=1))
    runner.set_runner(runner.ThreadRunner(num_workers=1))
    yield
    ref_runner.set_runner(prev[0])
    runner.set_runner(prev[1])


def _img(h=40, w=50):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x % 256, y % 256, (x + y) % 256], -1).astype(np.uint8)


def _noisy(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = np.outer(np.sin(np.linspace(0, 9, h)),
                    np.cos(np.linspace(0, 7, w)))[..., None] * 100 + 128
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _drive(mod, data, step=None, events=None, flush=False, setup=None,
           after=None):
    """Feed ``data`` in chunks of ``step`` bytes (all at once if None;
    a tuple gives the offsets where chunks end), calling
    ``process_input`` until it asks for more; then close the input and
    run to SUCCESS or ERROR. Returns the log: each event's
    name, with the image (and the frame count) at FULL_IMAGE, the box at
    BOX, the JPEG at JPEG_RECONSTRUCTION, and each ``flush_image()``
    result when ``flush``; ``after(dec, log)`` runs at the end."""
    ev_t = mod.Event
    dec = mod.Decoder(events={ev_t[e] for e in events} if events else None)
    if setup:
        setup(dec)
    log = []

    def pump():
        for _ in range(MAX_STEPS):
            ev = dec.process_input()
            entry = [ev.name]
            if ev == ev_t.FULL_IMAGE:
                entry += [dec.image.copy(), len(dec.frames)]
            elif ev == ev_t.BOX:
                entry += [dec.box_type, dec.box_contents]
            elif ev == ev_t.JPEG_RECONSTRUCTION:
                entry.append(dec.jpeg_bytes)
            elif ev == ev_t.BASIC_INFO:
                entry.append(dec.basic_info.__dict__.copy())
            log.append(entry)
            if ev in (ev_t.NEED_MORE_INPUT, ev_t.SUCCESS, ev_t.ERROR):
                return ev
        raise AssertionError("decoder did not settle")

    if isinstance(step, tuple):
        ends = [*step, len(data)]
    else:
        step = step or len(data) or 1
        ends = [min(i + step, len(data))
                for i in range(0, len(data), step)] or [0]
    ev = None
    for start, end in zip([0] + ends[:-1], ends):
        dec.set_input(data[start:end])
        ev = pump()
        if flush:
            part = dec.flush_image()
            log.append(["flush", None if part is None else part.copy()])
        if ev in (ev_t.SUCCESS, ev_t.ERROR):
            break
    dec.close_input()
    if ev not in (ev_t.SUCCESS, ev_t.ERROR):
        pump()
    if after:
        after(dec, log)
    return log


def _same(got, ref):
    assert len(got) == len(ref), ([e[0] for e in got], [e[0] for e in ref])
    for g, r in zip(got, ref):
        assert len(g) == len(r) and g[0] == r[0], (g[0], r[0])
        for a, b in zip(g[1:], r[1:]):
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                assert isinstance(a, np.ndarray) and \
                    isinstance(b, np.ndarray), g[0]
                assert a.dtype == b.dtype and a.shape == b.shape, g[0]
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (g[0], a, b)


def _both(data, **kw):
    ref = _drive(ref_decoder, data, **kw)
    got = _drive(decoder, data, **kw)
    _same(got, ref)
    return got


def test_whole_input():
    img = _img()
    log = _both(ref_api.encode(img, lossless=True))
    assert [e[0] for e in log] == ["BASIC_INFO", "COLOR_ENCODING", "FRAME",
                                   "FULL_IMAGE", "SUCCESS"]
    np.testing.assert_array_equal(log[3][1], img)


@pytest.mark.parametrize("step,end", [((10, 40), "ERROR"), (10, "ERROR"),
                                      (97, "SUCCESS"), (1000, "SUCCESS")],
                         ids=["10_30_rest", "10", "97", "1000"])
def test_chunked_input(step, end):
    """The reference test's chunks (10 bytes, 30, the rest) and even
    steps. Where the first chunk is 10 bytes, both decoders end in ERROR:
    run on until they ask for more input, the reference's incremental
    decoder accepts the frame's TOC read from a prefix that ends inside
    it (10 of its 12 bytes; the one section's range comes out empty) and
    then decodes the section from bytes that have not arrived (``invalid
    dc_quant``). Its own test calls ``process_input`` once per chunk and
    so stops before the frame. The port copies it (ROADMAP queue 3)."""
    data = ref_api.encode(_img(), distance=1.0)
    log = _both(data, step=step, events=["BASIC_INFO", "FULL_IMAGE"])
    assert log[-1][0] == end
    assert end == "ERROR" or any(e[0] == "FULL_IMAGE" for e in log)


def test_container_input():
    img = _img()
    log = _both(ref_api.encode(img, lossless=True, container=True),
                events=["FULL_IMAGE"])
    np.testing.assert_array_equal(log[0][1], img)


@pytest.mark.parametrize("data", [b"\x00" * 64, b"\xff\x0a" + b"\x00" * 40,
                                  b"", b"\x00\x00\x00\x0cJXL \r\n\x87\n"],
                         ids=["zeros", "bad_header", "empty", "box_only"])
def test_garbage_input(data):
    log = _both(data)
    assert log[-1][0] in ("ERROR", "NEED_MORE_INPUT")


def _count_sections(mod, names):
    """Wraps the incremental decoder's section methods of ``mod`` with
    counters; returns (counts, restore)."""
    cls = mod.IncrementalFrameDecoder
    calls = {n: 0 for n in names}
    orig = {n: getattr(cls, f"_decode_{n}") for n in names}

    def wrap(name, fn):
        def inner(self, *a, **k):
            calls[name] += 1
            return fn(self, *a, **k)
        return inner

    for n in names:
        setattr(cls, f"_decode_{n}", wrap(n, orig[n]))

    def restore():
        for n in names:
            setattr(cls, f"_decode_{n}", orig[n])
    return calls, restore


@pytest.mark.parametrize("kind", ["vardct", "modular"])
def test_sections_decoded_once(kind):
    """Prime-sized chunks: every section of the port's incremental
    decoder (the port's module, patched here) decodes exactly once, as
    the reference's does, and the image is the reference's."""
    if kind == "vardct":
        img = _img(128, 128)
        data = ref_api.encode(img, distance=1.0, effort=3)
        names, step = ["lf_global", "dc_group", "ac_global",
                       "ac_group"], 97
        want = {"lf_global": 1, "dc_group": 1, "ac_global": 1,
                "ac_group": 1}
    else:
        img = _img(300, 300)
        data = ref_api.encode(img, lossless=True, effort=3)
        names, step = ["lf_global", "dc_group", "ac_group"], 211
        want = {"lf_global": 1, "dc_group": 1, "ac_group": 4}
    counts = []
    logs = []
    for mod, dmod in ((ref_inc_mod, ref_decoder), (inc_mod, decoder)):
        calls, restore = _count_sections(mod, names)
        try:
            logs.append(_drive(dmod, data, step=step,
                               events=["FULL_IMAGE"]))
        finally:
            restore()
        counts.append(calls)
    _same(logs[1], logs[0])
    assert counts[1] == counts[0] == want
    if kind == "modular":
        np.testing.assert_array_equal(logs[1][-2][1], img)


def test_progressive_flush_image():
    """A progressive stream fed in 50 steps: every ``flush_image()`` (None
    until DC and AC-global have arrived) equals the reference's, and the
    first image comes before the whole stream."""
    data = ref_api.encode(_noisy(256, 256), distance=1.0, effort=3,
                          progressive=True)
    step = max(1, len(data) // 50)
    log = _both(data, step=step, events=["FULL_IMAGE", "FRAME_PROGRESSION"],
                flush=True)
    flushes = [e[1] for e in log if e[0] == "flush"]
    first = next(i for i, f in enumerate(flushes) if f is not None)
    assert first < len(flushes) - 1
    assert flushes[first].shape == (256, 256, 3)
    assert "FRAME_PROGRESSION" in [e[0] for e in log]


def test_rewind_and_skip_frames():
    frames = [np.full((32, 32, 3), v, np.uint8) for v in (40, 120, 220)]
    data = ref_api.encode_animation(frames, lossless=True)

    def after(dec, log):
        dec.rewind()
        ev = dec.process_input()
        log.append(["rewind", ev.name, dec.image.copy()])
        dec.skip_frames(1)
        ev = dec.process_input()
        log.append(["skip", ev.name, dec.image.copy(), len(dec.frames)])

    log = _both(data, events=["FULL_IMAGE"], after=after)
    images = [e[1] for e in log if e[0] == "FULL_IMAGE"]
    assert len(images) == 3
    assert log[-2][1] == log[-1][1] == "FULL_IMAGE"
    np.testing.assert_array_equal(log[-2][2], images[0])
    np.testing.assert_array_equal(log[-1][2], images[2])


def test_skip_frames_of_lossy_animation():
    """Skipping a VarDCT frame jumps over its sections via the TOC."""
    rng = np.random.default_rng(4)
    frames = [np.clip(_img(64, 64).astype(int)
                      + rng.integers(-20, 20, (64, 64, 3)), 0,
                      255).astype(np.uint8) for _ in range(3)]
    data = ref_api.encode_animation(frames, durations=[1, 1, 1],
                                    distance=1.0)
    _both(data, events=["FULL_IMAGE"], setup=lambda d: d.skip_frames(1))


def test_animation_byte_by_byte():
    rng = np.random.default_rng(4)
    frames = [np.clip(_img(96, 96).astype(int)
                      + rng.integers(-20, 20, (96, 96, 3)), 0,
                      255).astype(np.uint8) for _ in range(3)]
    data = ref_api.encode_animation(frames, durations=[1, 1, 1],
                                    distance=1.0)
    log = _both(data, step=499, events=["FULL_IMAGE"])
    assert [e[0] for e in log].count("FULL_IMAGE") == 3


def test_box_and_jpeg_reconstruction_events():
    from PIL import Image

    from libjxl_tpu.extras.jpeg_transcode import transcode_jpeg_container
    enc = Encoder()
    enc.add_image_frame(_img(), FrameSettings(lossless=True))
    enc.add_box(b"Exif", b"\x00\x00\x00\x00MM\x00\x2aXX")
    log = _both(enc.process_output(), events=["BOX", "FULL_IMAGE"])
    assert ["BOX", b"Exif", b"\x00\x00\x00\x00MM\x00\x2aXX"] in log
    buf = io.BytesIO()
    Image.fromarray(_img(48, 64)).save(buf, format="JPEG", quality=90)
    jxl = transcode_jpeg_container(buf.getvalue())
    log = _both(jxl, events=["JPEG_RECONSTRUCTION", "FULL_IMAGE"])
    assert ["JPEG_RECONSTRUCTION", buf.getvalue()] in log


@pytest.mark.parametrize("profile", ["srgb", "linear", "icc"])
def test_preferred_profile_and_row_callback(profile):
    from libjxl_tpu.color import cms
    data = ref_api.encode(_img(32, 48), distance=1.0)
    pref = cms.srgb_icc() if profile == "icc" else profile

    def setup_rows(rows):
        def setup(dec):
            dec.set_preferred_color_profile(pref)
            dec.set_image_out_callback(
                lambda x, y, n, row: rows.append((x, y, n, row.copy())))
        return setup

    rows_ref, rows = [], []
    ref = _drive(ref_decoder, data, events=["FULL_IMAGE"],
                 setup=setup_rows(rows_ref))
    got = _drive(decoder, data, events=["FULL_IMAGE"],
                 setup=setup_rows(rows))
    _same(got, ref)
    assert len(rows) == len(rows_ref) == 32
    for (x, y, n, r), (xr, yr, nr, rr) in zip(rows, rows_ref):
        assert (x, y, n) == (xr, yr, nr)
        np.testing.assert_array_equal(r, rr)


def _fuzz_base():
    rng = np.random.default_rng(11)
    img = np.clip(rng.normal(128, 40, (40, 56, 3)), 0, 255).astype(
        np.uint8)
    return ref_api.encode(img, distance=1.0, effort=3)


@pytest.mark.parametrize("seed", range(12))
def test_mutated_stream_matches_reference(seed):
    """``tests/test_fuzz.py``'s streaming entry point: a byte of a valid
    stream replaced and the stream cut, fed in 37-byte chunks. The port
    ends where the reference ends (SUCCESS or ERROR), with its events
    and images."""
    base = _fuzz_base()
    rng = np.random.default_rng(seed)
    data = bytearray(base)
    data[int(rng.integers(len(data)))] = int(rng.integers(256))
    data = bytes(data[:1 + int(rng.integers(len(data)))])
    _both(data, step=37)
