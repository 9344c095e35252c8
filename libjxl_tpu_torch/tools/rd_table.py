"""Rate-distortion parity table: this encoder vs system libjxl cjxl.

BASELINE.md config 2 analogue: 768x512 photographic-style corpus,
lossy encodes at several distances, measuring BPP + butteraugli
(system-libjxl comparator = independent oracle) + SSIMULACRA2 (ours)
for both encoders. The corpus is procedurally generated
photographic-like content (multi-octave value noise + edges + color
gradients + texture), not the actual Kodak set; the comparison is
still encoder-vs-encoder on identical inputs with an independent
decoder and metric.

    python -m libjxl_tpu_torch.tools.rd_table [--out DIR] [--images N] \
        [--distances 0.5,1.0] [--device cpu]

Port of tools/rd_table.py: the same corpora, columns and matched-quality
interpolation. Differences (reference line numbers):
- ``--device`` is a torch device name (``cuda`` by default; raises
  without a card), where the reference's is a flag for the jitted
  device stages (:125-126); the port's ``encode`` runs its VarDCT
  stages there (:145, :188);
- ``--out`` is a directory (a git-ignored one by default), and the
  table is written to ``RD_TABLE.md`` in it, not to ``docs/`` (:120);
- it raises ``SystemExit`` when the system libjxl is not installed, and
  ``table`` returns the rows for callers.
"""

import argparse
import os
import sys
import time

import numpy as np

from libjxl_tpu_torch.tools import default_out


def _octave_noise(rng, h, w, octaves=5, persistence=0.55):
    """Multi-octave value noise (photographic spatial spectrum)."""
    out = np.zeros((h, w))
    amp, total = 1.0, 0.0
    for o in range(octaves):
        step = max(2, 1 << (octaves - o + 2))
        gh, gw = h // step + 2, w // step + 2
        grid = rng.normal(0, 1, (gh, gw))
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        # smoothstep bilinear
        fy = fy * fy * (3 - 2 * fy); fx = fx * fx * (3 - 2 * fx)
        v = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
             + grid[y0][:, x0 + 1] * (1 - fy) * fx
             + grid[y0 + 1][:, x0] * fy * (1 - fx)
             + grid[y0 + 1][:, x0 + 1] * fy * fx)
        out += amp * v
        total += amp
        amp *= persistence
    return out / total


def make_corpus(n, h=512, w=768, seed=42):
    """Photographic-like RGB uint8 images: smooth luminance structure,
    chromatic gradients, hard edges and fine texture + sensor noise."""
    rng = np.random.default_rng(seed)
    images = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        luma = _octave_noise(rng, h, w) * 0.9
        # hard geometric edges (architecture-ish)
        for _ in range(6):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            ang = rng.uniform(0, np.pi)
            d = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
            luma += rng.uniform(-0.25, 0.25) * np.tanh(d / rng.uniform(1, 6))
        # chroma: smooth independent fields
        ca = _octave_noise(rng, h, w, octaves=3) * 0.5
        cb = _octave_noise(rng, h, w, octaves=3) * 0.5
        # fine texture + photon-ish noise
        tex = rng.normal(0, 0.015, (h, w))
        base = 0.45 + 0.35 * luma + tex
        r = base + 0.25 * ca
        g = base - 0.10 * ca + 0.12 * cb
        b = base - 0.28 * cb
        img = np.clip(np.stack([r, g, b], axis=-1), 0, 1)
        images.append((img * 255).astype(np.uint8))
    return images


def make_hard_corpus(h=512, w=768, seed=7):
    """Adversarial profiles the photographic corpus misses:
    anti-aliased text/screenshot, ordered dither, near-black HDR-ish
    gradients — heuristics tuned only on sin*cos texture
    over-merge/over-quantize these."""
    rng = np.random.default_rng(seed)
    out = []
    # 1) screenshot: flat panels, 1px rules, repeated glyph clusters
    img = np.full((h, w, 3), 242, np.uint8)
    for _ in range(8):
        y0, x0 = rng.integers(0, h - 60), rng.integers(0, w - 120)
        hh, ww = rng.integers(40, 160), rng.integers(80, 300)
        img[y0:y0 + hh, x0:x0 + ww] = rng.integers(200, 255, 3)
        img[y0, x0:x0 + ww] = 120
        img[y0:y0 + hh, x0] = 120
    glyph = (rng.random((11, 7)) < 0.45)
    for gy in range(12, h - 16, 18):
        for gx in range(10, w - 12, 9):
            if rng.random() < 0.8:
                img[gy:gy + 11, gx:gx + 7][glyph] = 40
    out.append(img.copy())
    # 2) ordered dither over a gradient (worst case for smoothing)
    bayer = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                      [1, 9, 3, 11], [15, 7, 13, 5]]) / 16.0
    gy, gx = np.mgrid[0:h, 0:w]
    g = (gx / w * 0.85 + gy / h * 0.1)
    tile = np.tile(bayer, (h // 4 + 1, w // 4 + 1))[:h, :w]
    d = ((g > tile).astype(np.uint8) * 255)
    out.append(np.stack([d, d, d], -1))
    # 3) near-black gradient + dim highlights (HDR shadow handling)
    base = (g * 14.0) ** 1.2
    img3 = np.stack([base, base * 0.96, base * 1.05], -1)
    for _ in range(24):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        rr = rng.integers(2, 9)
        img3[max(0, cy - rr):cy + rr, max(0, cx - rr):cx + rr] += \
            rng.uniform(20, 90)
    out.append(np.clip(img3, 0, 255).astype(np.uint8))
    return out


def table(corpus, distances, effort, device=None):
    """Encodes ``corpus`` with the port (on ``device``) and the system
    libjxl at each distance; returns [(d, bpp ours, bpp ref, butteraugli
    ours, butteraugli ref, ssimulacra2 ours, ssimulacra2 ref, enc MP/s
    ours, enc MP/s ref, bpp ratio at matched butteraugli)]."""
    from libjxl_tpu_torch.api.simple import encode
    from libjxl_tpu_torch.extras import refjxl
    from libjxl_tpu_torch.metrics.ssimulacra2 import ssimulacra2

    def enc_ours(img, d):
        return encode(img, distance=d, effort=effort, device=device)

    px_per_img = corpus[0].shape[0] * corpus[0].shape[1]
    rows = []
    for d in distances:
        acc = {k: 0.0 for k in ("bpp_o", "bpp_r", "ba_o", "ba_r",
                                "s2_o", "s2_r", "enc_o", "enc_r")}
        for img in corpus:
            t0 = time.time()
            so = enc_ours(img, d)
            acc["enc_o"] += time.time() - t0
            t0 = time.time()
            sr = refjxl.encode(img, distance=d, effort=effort)
            acc["enc_r"] += time.time() - t0
            acc["bpp_o"] += len(so) * 8 / px_per_img
            acc["bpp_r"] += len(sr) * 8 / px_per_img
            # Decode both with the INDEPENDENT reference decoder.
            do = np.asarray(refjxl.decode(so, dtype="uint8").pixels)
            do = do.reshape(img.shape[0], img.shape[1], -1)[..., :3]
            dr = np.asarray(refjxl.decode(sr, dtype="uint8").pixels)
            dr = dr.reshape(img.shape[0], img.shape[1], -1)[..., :3]
            acc["ba_o"] += refjxl.butteraugli_distance(img, do)
            acc["ba_r"] += refjxl.butteraugli_distance(img, dr)
            acc["s2_o"] += float(ssimulacra2(img, do))
            acc["s2_r"] += float(ssimulacra2(img, dr))
        n = len(corpus)
        rows.append((d, acc["bpp_o"] / n, acc["bpp_r"] / n,
                     acc["ba_o"] / n, acc["ba_r"] / n,
                     acc["s2_o"] / n, acc["s2_r"] / n,
                     n * px_per_img / 1e6 / acc["enc_o"],
                     n * px_per_img / 1e6 / acc["enc_r"]))

    # Matched-quality comparison: interpolate OUR (butteraugli, log bpp)
    # curve at the reference's achieved butteraugli per row (BD-rate
    # style) — the encoders land at different quality for the same
    # nominal distance, so matched-distance bpp ratios alone mislead.
    ba_o = np.array([r[3] for r in rows])
    bpp_o = np.array([r[1] for r in rows])
    # The two encoders land at different achieved quality for the same
    # nominal distance (this encoder sits finer at high distances), so
    # OUR curve also gets sampled at coarser settings — the matched-
    # quality interpolation must bracket every reference point instead
    # of extrapolating past our last measurement.
    max_ref_ba = max(r[4] for r in rows)
    extra_d = [d for d in (6.0, 8.0, 12.0)
               if max(ba_o) < max_ref_ba and d > max(distances)]
    for d in extra_d:
        if max(ba_o) >= max_ref_ba:
            break
        bpp_e = ba_e = 0.0
        for img in corpus:
            so = enc_ours(img, d)
            do = np.asarray(refjxl.decode(so, dtype="uint8").pixels)
            do = do.reshape(img.shape[0], img.shape[1], -1)[..., :3]
            bpp_e += len(so) * 8 / px_per_img
            ba_e += refjxl.butteraugli_distance(img, do)
        ba_o = np.append(ba_o, ba_e / len(corpus))
        bpp_o = np.append(bpp_o, bpp_e / len(corpus))
    order = np.argsort(ba_o)
    out = []
    for row in rows:
        lb = np.interp(row[4], ba_o[order], np.log(bpp_o[order]))
        out.append(row + (float(np.exp(lb)) / row[2],))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=default_out("rd_table"))
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--effort", type=int, default=7)
    ap.add_argument("--distances", default="0.5,1.0,2.0,4.0")
    ap.add_argument("--corpus", choices=("photo", "hard"),
                    default="photo")
    ap.add_argument("--device", default="cuda",
                    help="torch device of this encoder's VarDCT stages "
                         "(default cuda)")
    args = ap.parse_args(argv)

    from libjxl_tpu_torch.extras import refjxl
    if not refjxl.available():
        raise SystemExit("rd_table needs the system libjxl (refjxl)")
    distances = [float(d) for d in args.distances.split(",")]
    corpus = make_corpus(args.images) if args.corpus == "photo" \
        else make_hard_corpus()
    rows = table(corpus, distances, args.effort, args.device)

    lines = [
        "# Rate-distortion parity: libjxl_tpu_torch vs system libjxl cjxl",
        "",
        f"Corpus ({args.corpus}): {len(corpus)} procedurally generated "
        f"photographic-style 768x512 RGB images "
        f"(libjxl_tpu_torch/tools/rd_table.py make_corpus). Effort "
        f"{args.effort}; this encoder's VarDCT stages on "
        f"{args.device}; both bitstreams decoded by the system libjxl "
        f"decoder; butteraugli = system libjxl comparator; "
        f"SSIMULACRA2 = in-tree implementation.",
        "",
        "| distance | bpp ours | bpp ref | butteraugli ours | "
        "butteraugli ref | ssimulacra2 ours | ssimulacra2 ref | "
        "enc MP/s ours | enc MP/s ref | bpp ratio @matched ba |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (d, bo, br, bao, bar, so, sr, eo, er, m) in rows:
        lines.append(
            f"| {d} | {bo:.3f} | {br:.3f} | {bao:.3f} | {bar:.3f} | "
            f"{so:.2f} | {sr:.2f} | {eo:.2f} | {er:.2f} | {m:.3f} |")
    lines.append("")
    lines.append(f"Generated {time.strftime('%Y-%m-%d')} by "
                 f"`python -m libjxl_tpu_torch.tools.rd_table`.")
    text = "\n".join(lines) + "\n"
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "RD_TABLE.md"), "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
