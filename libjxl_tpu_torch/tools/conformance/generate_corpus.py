"""Generates a conformance corpus: one .jxl + golden .npz per feature
(reference: tools/conformance/generator.py):

    python -m libjxl_tpu_torch.tools.conformance.generate_corpus \
        [--out DIR] [--device cpu]
    python -m libjxl_tpu_torch.tools.conformance.run_corpus DIR \
        [--device cpu]

Port of tools/conformance/generate_corpus.py: the same cases, encoders
and limits. Differences (reference line numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card): the port's ``encode`` and the self-golden
  ``decode``/``decode_all`` run there (:31, :53-61);
- ``--out`` defaults to a git-ignored directory, not to
  ``conformance_corpus`` in the working directory (:194);
- goldens are stored in the decoded integer dtype (uint8/uint16), not
  as float32 divided by the maximum, and compressed: ``<case>.npz``
  holds the array ``golden`` (:80, :129); ``run_corpus`` reads both
  forms;
- each case with a golden from the system libjxl records its version,
  ``refjxl.version()``, under ``"libjxl"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from libjxl_tpu_torch.tools import default_out


def _gradient(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(128 + 100 * np.sin(x / 23) * np.cos(y / 17)),
                    (128 + 90 * np.cos(x / 19)),
                    (120 + 80 * np.sin((x + y) / 29))], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255) \
        .astype(np.uint8)


def generate(out_dir: str, device=None) -> dict:
    """Writes the corpus into ``out_dir``; returns its manifest."""
    from libjxl_tpu_torch.api import decode, decode_all, encode_animation
    from libjxl_tpu_torch.api import encode as encode_api
    from libjxl_tpu_torch.extras import refjxl

    def encode(img, **kw):
        return encode_api(img, device=device, **kw)

    os.makedirs(out_dir, exist_ok=True)
    cases = {}
    have_ref = refjxl.available()
    version = ".".join(map(str, refjxl.version())) if have_ref else None

    def save(name, data, golden):
        with open(os.path.join(out_dir, name + ".jxl"), "wb") as f:
            f.write(data)
        np.savez_compressed(os.path.join(out_dir, name + ".npz"),
                            golden=golden)

    def emit(name, data, tolerance=0.0, force_self=False,
             animation=False):
        """Write a stream + golden. The golden comes from the SYSTEM
        libjxl decoder whenever it can decode the stream (a self-golden
        conformance case cannot catch a shared enc/dec bug); our own
        decode is the fallback, recorded in the manifest. Lossless
        oracle goldens keep tolerance 0 (bit-exact); lossy ones allow
        decoder-side float rounding."""
        if animation:
            # Conformance surface = the LAST composed frame (what the
            # oracle's decoder returns after running to SUCCESS).
            arr = decode_all(data, device=device)[0][-1].pixels
            lossless = False
        else:
            res = decode(data, device=device)
            arr = res.pixels
            lossless = res.lossless
        maxval = 255 if arr.dtype == np.uint8 else 65535
        golden = None
        source = "self"
        if have_ref and not force_self:
            try:
                nchan = 1 if arr.ndim == 2 else arr.shape[2]
                g = refjxl.decode(
                    data, dtype="uint8" if maxval == 255 else "uint16",
                    num_channels=nchan).pixels
                if g.ndim == 3 and g.shape[2] == 1 and arr.ndim == 2:
                    g = g[:, :, 0]
                if g.shape == arr.shape:
                    golden = g.astype(arr.dtype)
                    source = "oracle"
                    if tolerance == 0.0 and not lossless:
                        tolerance = 0.004   # decoder float rounding
            except refjxl.RefJxlError:
                pass
        if golden is None:
            golden = arr
        save(name, data, golden)
        cases[name] = {"rmse": tolerance, "peak": tolerance * 4 + 1e-6,
                       "golden": source, "animation": animation}
        if source == "oracle":
            cases[name]["libjxl"] = version

    img = _gradient(128, 160)
    emit("lossless_rgb", encode(img, lossless=True))
    emit("lossless_16bit", encode(
        (img.astype(np.uint16) * 257), lossless=True))
    emit("lossless_gray", encode(img[:, :, 0], lossless=True))
    rgba = np.dstack([img, np.full(img.shape[:2], 200, np.uint8)])
    emit("lossless_rgba", encode(rgba, lossless=True))
    emit("vardct_d1", encode(img, distance=1.0))
    emit("vardct_d4", encode(img, distance=4.0))
    emit("progressive", encode(img, distance=1.0, progressive=True))
    emit("resampling2", encode(img, distance=1.0, resampling=2))
    emit("noise", encode(img, distance=1.0, noise=0.05))
    emit("container", encode(img, lossless=True, container=True))
    emit("preview", encode(_gradient(200, 260, 1), distance=1.0,
                           preview=True))
    emit("effort8", encode(img, distance=1.0, effort=8))
    # Prefix-coded fast-lossless, subsampled YCbCr VarDCT with
    # filters/progressive.
    emit("fast_lossless_e1", encode(img, lossless=True, effort=1))
    # Text-patch (screenshot) frame: repeated glyphs -> patches + a
    # reference frame.
    shot = np.full((128, 176, 3), 235, np.uint8)
    g_rng = np.random.default_rng(3)
    glyph = (g_rng.random((12, 10, 3)) * 110).astype(np.uint8)
    for gy in range(3):
        for gx in range(7):
            shot[8 + gy * 36:20 + gy * 36,
                 6 + gx * 24:16 + gx * 24] = glyph
    emit("text_patches", encode(shot, distance=1.0, effort=7))
    emit("ycbcr420_epf", encode(img, distance=1.0,
                                chroma_subsampling="420", epf=2))
    emit("ycbcr422_progressive", encode(img, distance=1.0,
                                        chroma_subsampling="422",
                                        progressive=True))
    # Spot color, alpha-BLEND animation (the last composed frame is the
    # conformance surface), HDR PQ.
    spot = np.zeros(img.shape[:2], np.uint8)
    spot[30:70, 40:100] = 180
    emit("spot_color", encode(
        img, lossless=True,
        extra_channels=[{"type": "spot_color", "data": spot,
                         "name": "ink",
                         "spot_color": (1.0, 0.1, 0.2, 0.8)}]))
    af = []
    arng = np.random.default_rng(5)
    for i in range(2):
        fr = np.zeros((96, 112, 4), np.uint8)
        fr[:, :, :3] = np.clip(arng.normal(110 + 30 * i, 30,
                                           (96, 112, 3)), 0, 255)
        a = np.zeros((96, 112), np.uint8)
        a[10 + 20 * i:70, 15:90] = 255
        fr[:, :, 3] = a
        af.append(fr)
    emit("animation_blend",
         encode_animation(af, distance=1.0, blend=True), animation=True)
    # PQ stays self-golden: the 0.7 oracle converts HDR output through
    # its CMS to a different target space than our PQ-passthrough.
    emit("hdr_pq_16bit", encode(
        (img.astype(np.uint16) * 257), distance=1.0, hdr="pq"),
        force_self=True)

    # Differential cases (the corpus must not be fully self-golden):
    # streams produced by the INDEPENDENT system libjxl encoder with
    # goldens from its own decoder — our decoder must match them; plus
    # our streams with system-libjxl-decoded goldens.
    if have_ref:
        def emit_ref_encoded(name, data, tolerance):
            golden = refjxl.decode(data, dtype="uint8").pixels
            save(name, data, golden.astype(np.uint8))
            cases[name] = {"rmse": tolerance,
                           "peak": tolerance * 4 + 1e-6,
                           "golden": "oracle", "libjxl": version}

        for e in (1, 3, 7):
            emit_ref_encoded(f"ref_encoded_d1_e{e}",
                             refjxl.encode(img, distance=1.0, effort=e),
                             tolerance=0.004)
        emit_ref_encoded("ref_encoded_lossless",
                         refjxl.encode(img, lossless=True, effort=3),
                         tolerance=0.0)
        emit_ref_encoded("ref_golden_our_stream",
                         encode(img, distance=1.0), tolerance=0.004)
        # System-libjxl goldens for the new stream classes.
        emit_ref_encoded("ref_golden_patches",
                         encode(shot, distance=1.0, effort=7),
                         tolerance=0.004)
        emit_ref_encoded("ref_golden_420",
                         encode(img, distance=1.0,
                                chroma_subsampling="420", epf=2),
                         tolerance=0.004)
        emit_ref_encoded("ref_encoded_fjxl",
                         refjxl.encode(img, lossless=True, effort=1),
                         tolerance=0.0)
        emit_ref_encoded("ref_encoded_e7_multigroup",
                         refjxl.encode(_gradient(384, 300, 2),
                                       lossless=True, effort=7),
                         tolerance=0.0)
    else:
        print("warning: system libjxl unavailable; corpus is "
              "self-golden only", file=sys.stderr)

    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(cases, f, indent=1)
    return cases


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=default_out("conformance_corpus"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the encodes and self-golden "
                        "decodes (default cuda)")
    args = p.parse_args(argv)
    cases = generate(args.out, args.device)
    print(f"wrote {len(cases)} cases to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
