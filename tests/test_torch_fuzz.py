"""The JAX package's robustness contract held by the port on the CPU:
every decoder entry point either returns or raises ``JxlError`` on any
input. Counterparts of tests/test_fuzz.py (Hypothesis random bytes and
mutated streams, the seeded byte-flip and truncation sweeps),
tests/test_corpus_replay.py (the committed crash corpus under
tests/corpus/) and tests/test_robustness.py, over
``libjxl_tpu_torch.tools.fuzz_targets`` with ``device="cpu"``.

On the crash corpus and the seeded sweep the port's ``decode`` and
``decode_all`` are also held to the JAX package's: the same outcome
(pixels or ``JxlError``) and, where both decode, pixels within 1 LSB
(the host pixels of the reference depend on its worker count, ROADMAP
queue 3 caveat 1). Every feed that the port's device route stages on
these inputs must index in range (``fuzz_targets.feed_index_faults``):
on a card an index out of range is a device-side assert.

The Hypothesis tests keep the reference's settings and add
``derandomize=True``, so that every run draws the same inputs and this
file's time is known. A random ``icc`` input can declare an encoded size
of up to 2^28 bytes: the reference's ICC reader then decodes zero bits
past the end of the input symbol by symbol, for minutes, before it
fails. The port's checks for the end of the input every 512 symbols, as
libjxl's ICCReader::Process does (``test_icc_size_past_input``).
"""

import glob
import io
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from libjxl_tpu.api import simple as ref_api
from libjxl_tpu.base.errors import JxlError as RefJxlError
from libjxl_tpu_torch.api import simple as port_api
from libjxl_tpu_torch.base.errors import JxlError
from libjxl_tpu_torch.tools.fuzz_targets import (
    checking_feeds, entry_points, valid_stream,
)

EPS = entry_points("cpu")
CORPUS = os.path.join(os.path.dirname(__file__), "corpus")
FILES = sorted(glob.glob(os.path.join(CORPUS, "*.bin")))
_SETTINGS = dict(max_examples=120, deadline=None, derandomize=True,
                 suppress_health_check=[HealthCheck.too_slow])


def _check(fn, data):
    try:
        fn(data)
    except JxlError:
        pass
    # Any other exception propagates and fails the test.


@pytest.fixture(scope="module")
def base():
    return valid_stream("cpu")


def test_valid_stream_is_the_references(base):
    """The mutation base is the reference's 1676-byte stream."""
    rng = np.random.default_rng(11)
    img = np.clip(rng.normal(128, 40, (40, 56, 3)), 0, 255).astype(np.uint8)
    assert base == ref_api.encode(img, distance=1.0, effort=3)
    assert len(base) == 1676


@pytest.mark.parametrize("name", sorted(EPS))
@settings(**_SETTINGS)
@given(data=st.binary(min_size=0, max_size=256))
def test_random_bytes(name, data):
    _check(EPS[name], data)


@pytest.mark.parametrize("name", ["decode", "streaming", "container"])
@settings(max_examples=80, deadline=None, derandomize=True)
@given(pos=st.integers(0, 10_000), val=st.integers(0, 255),
       cut=st.integers(0, 10_000))
def test_mutated_valid_stream(base, name, pos, val, cut):
    """Bit flips + truncations of a real stream (djxl_fuzzer corpus
    style)."""
    data = bytearray(base)
    data[pos % len(data)] = val
    data = bytes(data[:1 + cut % len(data)])
    _check(EPS[name], data)


def _port(fn, data, faults):
    """The port's result on ``data``, None for JxlError; the feeds the
    device route stages are checked into ``faults``."""
    try:
        with checking_feeds(faults):
            return fn(data, device="cpu")
    except JxlError:
        return None


def _ref(fn, data):
    try:
        return fn(data)
    except RefJxlError:
        return None


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _decode_parity(data, faults, where):
    got = _port(port_api.decode, data, faults)
    want = _ref(ref_api.decode, data)
    assert (got is None) == (want is None), where
    if got is not None:
        assert _lsb(got.pixels, want.pixels) <= 1, where
    return got is not None


def test_seeded_mutation_sweep(base):
    """Every byte position flipped once: the port decodes exactly where
    the reference does, within 1 LSB, and stages every feed in range."""
    faults, decoded = [], 0
    for pos in range(len(base)):
        data = bytearray(base)
        data[pos] ^= 0xA5
        decoded += _decode_parity(bytes(data), faults, pos)
    assert faults == []
    assert 0 < decoded < len(base)


def test_truncation_sweep(base):
    faults = []
    for cut in range(0, len(base), 3):
        _port(port_api.decode, base[:cut], faults)
    assert faults == []


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.basename(f) for f in FILES])
def test_replay(path):
    """Every entry point decodes or raises JxlError on a committed
    crasher; ``decode`` and ``decode_all`` match the reference's
    outcome and pixels, and stage their feeds in range."""
    with open(path, "rb") as f:
        data = f.read()
    for name, fn in sorted(EPS.items()):
        if name not in ("decode", "decode_all"):
            _check(fn, data)
    faults = []
    _decode_parity(data, faults, path)
    got = _port(port_api.decode_all, data, faults)
    want = _ref(ref_api.decode_all, data)
    assert (got is None) == (want is None)
    if got is not None:
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            assert _lsb(a.pixels, b.pixels) <= 1
    assert faults == []


def test_icc_size_past_input():
    """A valid ICC stream whose declared encoded size (2^24) runs past
    the input fails with NotEnoughBytesError within 512 symbols of the
    end, not after decoding 2^24 symbols of zero bits; a whole profile
    still reads back."""
    from libjxl_tpu_torch.base.errors import NotEnoughBytesError
    from libjxl_tpu_torch.bitstream.bit_io import BitReader, BitWriter
    from libjxl_tpu_torch.bitstream.fields import write_u64
    from libjxl_tpu_torch.color import cms, icc_codec
    from libjxl_tpu_torch.entropy.codes import (
        build_and_encode_histograms, write_tokens,
    )
    icc = cms.srgb_icc()
    w = BitWriter()
    icc_codec.write_icc(icc, w)
    w.align_to_byte()
    assert icc_codec.read_icc(BitReader(w.get_bytes())) == icc
    enc = icc_codec.predict_icc(icc)
    ctx = np.zeros(len(enc), np.int32)
    val = np.asarray(bytearray(enc), np.int64)
    b1 = b2 = 0
    for i, byte in enumerate(enc):
        ctx[i] = icc_codec._ans_context(i, b1, b2)
        b2, b1 = b1, byte
    w = BitWriter()
    write_u64(1 << 24, w)
    codes = build_and_encode_histograms(icc_codec.NUM_ICC_CONTEXTS,
                                        [(ctx, val)], w)
    write_tokens((ctx, val), codes, w)
    w.align_to_byte()
    with pytest.raises(NotEnoughBytesError):
        icc_codec.read_icc(BitReader(w.get_bytes()))


def test_corpus_exists():
    """The corpus must stay populated — an empty glob silently skips
    every replay above."""
    assert len(FILES) >= 8, f"crash corpus unexpectedly small: {FILES}"


# ---------------------------------------------------------------------------
# tests/test_robustness.py

def _img():
    y, x = np.mgrid[0:48, 0:64]
    return np.stack([x % 256, y % 256, (x + y) % 256], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def streams():
    img = _img()
    enc = port_api.encode
    return [enc(img, lossless=True, device="cpu"),
            enc(img, distance=1.0, device="cpu"),
            enc(img, distance=1.0, progressive=True, device="cpu")]


def test_truncation_ladder(streams):
    for data in streams:
        for frac in (0.1, 0.3, 0.5, 0.7, 0.9, 0.98):
            cut = data[:int(len(data) * frac)]
            try:
                port_api.decode(cut, device="cpu")
            except Exception as e:
                assert isinstance(e, JxlError), (frac, type(e))


def test_bit_flips(streams):
    rng = np.random.default_rng(42)
    for data in streams:
        arr = np.frombuffer(data, np.uint8).copy()
        for _ in range(40):
            corrupted = arr.copy()
            pos = rng.integers(0, len(arr))
            corrupted[pos] ^= 1 << rng.integers(0, 8)
            try:
                res = port_api.decode(corrupted.tobytes(), device="cpu")
                # Decoding may "succeed" with different pixels; that's
                # fine as long as shapes stay sane.
                assert res.pixels.shape[0] <= 1 << 20
            except Exception as e:
                assert isinstance(e, JxlError), type(e)


def test_random_garbage():
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 10, 100, 1000):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        with pytest.raises(JxlError):
            port_api.decode(b"\xff\x0a" + blob, device="cpu")


def test_empty_and_tiny():
    for blob in (b"", b"\xff", b"\x00", b"\xff\x0a"):
        with pytest.raises(JxlError):
            port_api.decode(blob, device="cpu")


def test_jpeg_parser_fuzz():
    from PIL import Image

    from libjxl_tpu_torch.extras.jpeg_parser import JpegError, parse_jpeg

    rng = np.random.default_rng(13)
    buf = io.BytesIO()
    Image.fromarray(_img()).save(buf, "JPEG", quality=80)
    data = bytearray(buf.getvalue())
    for _ in range(60):
        corrupted = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            corrupted[rng.integers(0, len(data))] = rng.integers(0, 256)
        try:
            parse_jpeg(bytes(corrupted))
        except Exception as e:
            assert isinstance(e, JpegError), type(e)
    for n in (0, 2, 10, 50):
        with pytest.raises(Exception):
            parse_jpeg(bytes(rng.integers(0, 256, n, dtype=np.uint8)))


def test_jxl_to_jpeg_rejects_non_transcode():
    from libjxl_tpu_torch.extras.jpeg_parser import JpegError
    from libjxl_tpu_torch.extras.jpeg_transcode import transcode_jxl_to_jpeg
    data = port_api.encode(_img(), distance=1.0, device="cpu")
    with pytest.raises(JpegError):
        transcode_jxl_to_jpeg(data)
