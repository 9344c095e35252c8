"""Build the committed streams of the port's post-stage path and of its
public decode API with the JAX package's host encoder. A data tool, not
part of the port (it imports ``libjxl_tpu``); pytest does not collect
it.

    python tests/torch_corpus/generate.py [up2|splines|patches|anim|spot|jpeg]
    python tests/torch_corpus/generate.py corpus-sizes
    python tests/torch_corpus/generate.py conformance

- ``4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl``: the content of
  ``tools/gen_bench_corpus.py:make_image(0)`` (3840x2160, 16-bit),
  encoded at distance 2, effort 5, PQ, progressive, EPF 3, 2x
  resampling and photon noise at ISO 3200: a 1920x1080 coded frame whose
  decode upsamples to 3840x2160 and adds noise.
- ``1080p_splines_d1.jxl``: a 1920x1080 8-bit frame with eight spline
  strokes, distance 1, loop filters on (the encoder's defaults), built
  with ``encode_vardct_frame`` as ``tests/test_device_stages.py`` does.
- ``1080p_screen_patches_d1_e7.jxl``: 1920x1080 8-bit screen content
  (lines of repeated glyphs on a flat light background, a gradient
  panel and a photo-like panel) at distance 1, effort 7,
  ``patches=True``: a
  reference frame holding the glyph sheet, then the frame that places
  the patches, with gaborish and EPF on.
- ``720p_anim4_rgba_blend_d1.jxl``: 1280x720, four RGBA frames through
  ``encode_animation(..., distance=1.0, blend=True)``: frames 1-3 blend
  over the canvas with alpha.
- ``1024x768_spot2_lossless.jxl``: a lossless 1024x768 8-bit image with
  two spot-colour extra channels, as ``tests/test_device_stages.py``
  builds its spot stream, at this size.
- ``1024x768_photo_q85_420.jpg``: ``photo_image()`` (smooth bands and
  light noise, 8-bit RGB) written by PIL as a baseline JPEG at quality
  85 with 4:2:0 chroma subsampling: the input of the JPEG transcode
  and reconstruction checks (``python tests/torch_corpus/generate.py
  jpeg``; PIL only, no encoder of the repo).

- ``conformance/``: the port's conformance corpus, written by
  ``libjxl_tpu_torch.tools.conformance.generate_corpus`` on the CPU
  (``python tests/torch_corpus/generate.py conformance``): 28 cases, one
  stream, one golden (``.npz``, the decoded integer dtype) and one
  manifest entry each, with goldens from the system libjxl
  (``refjxl``) where it decodes the stream. It uses the port only.

The generation is deterministic (fixed seeds and encoder settings).

``corpus-sizes`` writes nothing: it encodes ``make_image(0)`` at 3840x2160
and its 1920x1080 crop with the settings of ``bench_corpus/`` (distance
1, effort 5, PQ, progressive, EPF 3) through the JAX package's host
encoder as it stands, and prints each stream's size beside the
committed one's (``bench_corpus/4k_hdr_pq_d1_e5_prog_epf3_0.jxl`` and
``bench_corpus/1080p_hdr_pq_d1_e5_prog_epf3.jxl``) and whether the bytes
are the same. The host encoder needs no ``jax``.
"""

import importlib.util
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

UP2 = "4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl"
SPLINES = "1080p_splines_d1.jxl"
PATCHES = "1080p_screen_patches_d1_e7.jxl"
ANIM = "720p_anim4_rgba_blend_d1.jxl"
SPOT = "1024x768_spot2_lossless.jxl"
JPEG = "1024x768_photo_q85_420.jpg"


def _bench_image(i: int) -> np.ndarray:
    """make_image(i) of tools/gen_bench_corpus.py, loaded by path."""
    path = os.path.join(ROOT, "tools", "gen_bench_corpus.py")
    spec = importlib.util.spec_from_file_location("gen_bench_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_image(i)


def _write(name: str, data: bytes, t0: float) -> None:
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(data)
    print(f"{name}: {len(data)} bytes in {time.time() - t0:.1f} s",
          flush=True)


def encode_up2() -> None:
    from libjxl_tpu.api.simple import encode
    img16 = _bench_image(0)
    t0 = time.time()
    _write(UP2, encode(img16, distance=2.0, effort=5, hdr="pq",
                       progressive=True, epf=3, resampling=2,
                       photon_noise_iso=3200), t0)


def _splines(h: int, w: int, n: int, seed: int):
    """``n`` random four-point strokes inside the frame, of moderate
    width (sigma 1.5-3.5) and colour, so every splat fits the device
    window."""
    from libjxl_tpu.frame.splines import Splines, quantize_spline
    rng = np.random.default_rng(seed)
    qs, starts = [], []
    for _ in range(n):
        x0, y0 = rng.uniform(100, w - 400), rng.uniform(100, h - 300)
        cps = [(float(round(x0 + 90 * k + rng.uniform(-30, 30))),
                float(round(y0 + 60 * k * rng.choice([-1, 1])
                            + rng.uniform(-20, 20)))) for k in range(4)]
        color_dct = np.zeros((3, 32))
        color_dct[1, 0] = rng.uniform(0.2, 0.5)
        color_dct[0, 1] = rng.uniform(-0.1, 0.1)
        color_dct[2, 0] = rng.uniform(-0.2, 0.2)
        sigma_dct = np.zeros(32)
        sigma_dct[0] = rng.uniform(1.5, 3.5)
        sigma_dct[1] = rng.uniform(-0.5, 0.5)
        qs.append(quantize_spline(cps, color_dct, sigma_dct, 0, 0.0, 1.0))
        starts.append(cps[0])
    return Splines(splines=qs, starting_points=starts)


def encode_splines() -> None:
    from libjxl_tpu.api.simple import CodecMetadata
    from libjxl_tpu.bitstream.bit_io import BitWriter
    from libjxl_tpu.color.xyb import linear_rgb_to_xyb, srgb_to_linear
    from libjxl_tpu.frame.encode_frame import encode_vardct_frame
    from libjxl_tpu.frame.headers import BitDepth, write_codestream_headers

    h, w = 1080, 1920
    img = _bench_image(1)[:h, :w].astype(np.float32) / 65535.0
    t0 = time.time()
    meta = CodecMetadata()
    meta.size.set(w, h)
    meta.m.bit_depth = BitDepth.uint(8)
    meta.m.xyb_encoded = True
    wtr = BitWriter()
    write_codestream_headers(meta, wtr)
    xyb = linear_rgb_to_xyb(srgb_to_linear(img).transpose(2, 0, 1))
    encode_vardct_frame(xyb, meta, wtr, distance=1.0, effort=5,
                        splines=_splines(h, w, 8, seed=5))
    wtr.align_to_byte()
    _write(SPLINES, wtr.get_bytes(), t0)


def screen_image(h: int = 1080, w: int = 1920, seed: int = 21
                 ) -> np.ndarray:
    """Screen content: lines of text made of 40 random dark 12x10 glyphs
    on a flat light background (glyph pitch 22 x 30 pixels, as
    ``tests/test_device_stages.py`` lays out its glyphs), above a
    gradient panel and a smooth photo-like panel 200 pixels tall, 8-bit
    RGB. The background stays more than half the frame, as the encoder's
    text-patch detector requires."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 240, np.uint8)
    glyphs = [(rng.random((12, 10, 3)) * 120).astype(np.uint8)
              for _ in range(40)]
    for y in range(10, h - 240, 30):
        for x in range(8, w - 10, 22):
            if rng.random() < 0.15:
                continue                        # a space between words
            img[y:y + 12, x:x + 10] = glyphs[int(rng.integers(0, 40))]
    ph, pw = 200, 900
    y0 = h - ph - 20
    yy, xx = np.mgrid[0:ph, 0:pw]
    img[y0:y0 + ph, 40:40 + pw] = np.stack(
        [40 + 180 * xx / pw, 60 + 120 * yy / ph, 200 - 150 * xx / pw],
        axis=-1).astype(np.uint8)
    photo = [0.5 + 0.3 * np.sin(xx / (23 + 5 * c) + c) * np.cos(yy / 31)
             for c in range(3)]
    img[y0:y0 + ph, w - 40 - pw:w - 40] = (
        np.stack(photo, axis=-1) * 255).astype(np.uint8)
    return img


def encode_patches() -> None:
    from libjxl_tpu.api.simple import encode
    img = screen_image()
    t0 = time.time()
    _write(PATCHES, encode(img, distance=1.0, effort=7, patches=True), t0)


def animation_frames(h: int = 720, w: int = 1280, n: int = 4) -> list:
    """``n`` RGBA frames: smooth colour fields with a moving opaque
    rectangle, a half-transparent band and a transparent rest."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        fr = np.zeros((h, w, 4), np.uint8)
        for c in range(3):
            fr[:, :, c] = np.clip(
                110 + 35 * i + 60 * np.sin(xx / (41 + 7 * c) + i)
                * np.cos(yy / (37 + 3 * c)), 0, 255)
        a = np.zeros((h, w), np.uint8)
        y0, x0 = h // 8 + 60 * i, w // 8 + 120 * i
        a[y0:y0 + h // 2, x0:x0 + w // 2] = 255
        a[h // 3:h // 3 + h // 10, :] = 128
        fr[:, :, 3] = a
        frames.append(fr)
    return frames


def encode_anim() -> None:
    from libjxl_tpu.api.simple import encode_animation
    frames = animation_frames()
    t0 = time.time()
    _write(ANIM, encode_animation(frames, distance=1.0, blend=True), t0)


def spot_image(h: int = 768, w: int = 1024):
    """A smooth 8-bit RGB image and two spot-colour channels (an ink
    rectangle and a soft disc), as the extra_channels list of
    ``encode``."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.3 * np.sin(xx / (97 + 13 * c) + c)
                    * np.cos(yy / 89) for c in range(3)], axis=-1)
    img = (img * 255).astype(np.uint8)
    spot = np.zeros((h, w), np.uint8)
    spot[h // 4:h // 2, w // 3:2 * w // 3] = 200
    r2 = (yy - 2 * h // 3) ** 2 + (xx - w // 4) ** 2
    spot2 = np.clip(150 - r2 / 60.0, 0, 150).astype(np.uint8)
    ecs = [{"type": "spot_color", "data": spot, "name": "ink",
            "spot_color": (1.0, 0.1, 0.2, 0.8)},
           {"type": "spot_color", "data": spot2, "name": "ink2",
            "spot_color": (0.0, 0.9, 0.4, 0.5)}]
    return img, ecs


def encode_spot() -> None:
    from libjxl_tpu.api.simple import encode
    img, ecs = spot_image()
    t0 = time.time()
    _write(SPOT, encode(img, lossless=True, extra_channels=ecs), t0)


def photo_image(h: int = 768, w: int = 1024, seed: int = 5) -> np.ndarray:
    """Smooth colour bands with light noise, 8-bit RGB (the content of
    bench.py's test photo)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack(
        [0.5 + 0.3 * np.sin(x / 17 + c) * np.cos(y / 23)
         + 0.1 * np.sin((x + y) / 41)
         + rng.normal(0, 0.02, (h, w)) for c in range(3)], -1), 0, 1)
    return (img * 255).astype(np.uint8)


def write_jpeg() -> None:
    import io

    from PIL import Image
    t0 = time.time()
    buf = io.BytesIO()
    Image.fromarray(photo_image()).save(buf, "JPEG", quality=85,
                                        subsampling=2)
    _write(JPEG, buf.getvalue(), t0)


def corpus_sizes() -> None:
    from libjxl_tpu.api.simple import encode
    img16 = _bench_image(0)
    for name, img in (("4k_hdr_pq_d1_e5_prog_epf3_0.jxl", img16),
                      ("1080p_hdr_pq_d1_e5_prog_epf3.jxl",
                       np.ascontiguousarray(img16[:1080, :1920]))):
        t0 = time.time()
        data = encode(img, distance=1.0, effort=5, hdr="pq",
                      progressive=True, epf=3)
        with open(os.path.join(ROOT, "bench_corpus", name), "rb") as f:
            ref = f.read()
        print(f"{name}: host encoder {len(data)} bytes in "
              f"{time.time() - t0:.1f} s, committed {len(ref)} bytes, "
              f"identical {data == ref}", flush=True)


def write_conformance() -> None:
    import shutil

    from libjxl_tpu_torch.tools.conformance.generate_corpus import generate
    out = os.path.join(HERE, "conformance")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    cases = generate(out, device="cpu")
    print(f"conformance/: {len(cases)} cases in {time.time() - t0:.1f} s",
          flush=True)


def main() -> None:
    which = sys.argv[1:] or ["up2", "splines", "patches", "anim", "spot"]
    for name in which:
        {"up2": encode_up2, "splines": encode_splines,
         "patches": encode_patches, "anim": encode_anim,
         "spot": encode_spot, "jpeg": write_jpeg,
         "corpus-sizes": corpus_sizes,
         "conformance": write_conformance}[name]()


if __name__ == "__main__":
    main()
