"""Build the committed streams of the port's post-stage path with the JAX
package's host encoder. A data tool, not part of the port (it imports
``libjxl_tpu``); pytest does not collect it.

    python tests/torch_corpus/generate.py [up2|splines]

- ``4k_hdr_pq_d2_e5_up2_iso3200_epf3.jxl``: the content of
  ``tools/gen_bench_corpus.py:make_image(0)`` (3840x2160, 16-bit),
  encoded at distance 2, effort 5, PQ, progressive, EPF 3, 2x
  resampling and photon noise at ISO 3200: a 1920x1080 coded frame whose
  decode upsamples to 3840x2160 and adds noise.
- ``1080p_splines_d1.jxl``: a 1920x1080 8-bit frame with eight spline
  strokes, distance 1, loop filters on (the encoder's defaults), built
  with ``encode_vardct_frame`` as ``tests/test_device_stages.py`` does.

The generation is deterministic (fixed seeds and encoder settings).
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


def main() -> None:
    which = sys.argv[1:] or ["up2", "splines"]
    for name in which:
        {"up2": encode_up2, "splines": encode_splines}[name]()


if __name__ == "__main__":
    main()
