"""Randomized differential interop sweep vs system libjxl.

    python -m libjxl_tpu_torch.tools.interop_sweep [seed] [iterations] \
        [--device cpu]

Random sizes/content/settings, both directions (their streams -> our
decoder vs their decoder; our streams -> their decoder). Past runs of
this sweep found multigroup local-transform lossless streams decoding
wrong, odd-dimension squeezed channels losing their last column
(clipped group rects), and AFV/DCT4X4 square sub-blocks using
untransposed coefficients.

Port of tools/interop_sweep.py: the same draws from the seed, in the
same order, and the same limits. Differences (reference line numbers):
- ``--device`` (new), a torch device name (``cuda`` by default; raises
  without a card): the port's ``encode``, ``decode`` and ``decode_all``
  run there, where the reference pins JAX to the CPU (:16-17);
- the sweep is a function, ``sweep``, run under ``main`` (the
  reference runs at import, :20-121), and ``main`` exits 1 when any
  case failed (:119-121).
"""

import argparse
import sys
import traceback

import numpy as np


def sweep(seed: int = 0, n: int = 40, device=None) -> list:
    """Runs ``n`` random cases; returns the failures as (case, direction,
    max error or the exception's last line)."""
    from libjxl_tpu_torch.api.simple import decode, decode_all
    from libjxl_tpu_torch.api.simple import encode as encode_api
    from libjxl_tpu_torch.api.simple import encode_animation
    from libjxl_tpu_torch.extras import refjxl

    def encode(img, **kw):
        return encode_api(img, device=device, **kw)

    rng = np.random.default_rng(seed)
    fails = []

    def rand_img():
        h = int(rng.integers(8, 520))
        w = int(rng.integers(8, 520))
        kind = rng.integers(0, 4)
        if kind == 0:      # photo-ish
            y, x = np.mgrid[0:h, 0:w]
            img = np.stack([np.clip(
                0.5 + 0.4 * np.sin(x / (5 + rng.integers(30)) + c)
                * np.cos(y / (5 + rng.integers(30)))
                + rng.normal(0, 0.03, (h, w)), 0, 1) for c in range(3)], -1)
            return (img * 255).astype(np.uint8)
        if kind == 1:      # flat + blocks
            img = np.full((h, w, 3), rng.integers(0, 255), np.uint8)
            for _ in range(rng.integers(1, 8)):
                y0, x0 = rng.integers(0, h), rng.integers(0, w)
                img[y0:y0 + rng.integers(1, h), x0:x0 + rng.integers(1, w)] \
                    = rng.integers(0, 255, 3)
            return img
        if kind == 2:      # noise
            return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        # gradient palette-ish (few colors)
        pal = rng.integers(0, 256, (rng.integers(2, 17), 3))
        return pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)

    for it in range(n):
        img = rand_img()
        h, w = img.shape[:2]
        lossless = bool(rng.integers(0, 2))
        eff = int(rng.integers(1, 10))
        d = float(rng.choice([0.5, 1.0, 2.0, 4.0, 8.0]))
        # FORMAT features the 0.7 oracle still decodes (the frozen
        # spec): progressive passes, resampling, noise, EPF overrides,
        # container boxes, spot color, alpha-BLEND animation frames.
        extra_kw = {}
        profile = int(rng.integers(0, 7))
        if profile == 1 and not lossless:
            extra_kw["progressive"] = True
        elif profile == 2 and not lossless and h >= 16 and w >= 16:
            extra_kw["resampling"] = int(rng.choice([2, 4]))
        elif profile == 3 and not lossless:
            extra_kw["noise"] = float(rng.uniform(800, 6400))
        elif profile == 4 and not lossless:
            extra_kw["epf"] = int(rng.integers(0, 4))
        elif profile == 5:
            extra_kw["container"] = True
        elif profile == 6:
            spot = (rng.random((h, w)) < 0.1).astype(np.uint8) * 200
            extra_kw["extra_channels"] = [
                {"type": "spot_color", "data": spot, "name": "ink",
                 "spot_color": (1.0, 0.2, 0.1, 0.7)}]
        desc = f"it{it} {h}x{w} lossless={lossless} e{eff} d={d} " \
               f"profile={profile}"
        try:
            # ref -> ours
            rs = refjxl.encode(img, lossless=lossless,
                               distance=0.0 if lossless else d, effort=eff)
            ours = decode(rs, device=device).pixels
            refd = np.asarray(refjxl.decode(rs, dtype="uint8").pixels)
            refd = refd.reshape(h, w, -1)[..., :3]
            err = np.abs(ours.astype(int) - refd.astype(int)).max()
            lim = 0 if lossless else 2
            if err > lim:
                fails.append((desc, "ref->ours", err))
            # ours -> ref (with the profile's feature settings)
            os_ = encode(img, lossless=lossless,
                         distance=0.0 if lossless else d,
                         effort=min(eff, 9), **extra_kw)
            ours2 = decode(os_, device=device).pixels[..., :3]
            refd2 = np.asarray(refjxl.decode(os_, dtype="uint8").pixels)
            refd2 = refd2.reshape(ours2.shape[0], ours2.shape[1],
                                  -1)[..., :3]
            err2 = np.abs(ours2.astype(int) - refd2.astype(int)).max()
            if err2 > (0 if lossless else 2):
                fails.append((desc, "ours->refdec", err2))
            # Animation profile: all composed frames vs the oracle.
            if profile == 0 and not lossless and bool(rng.integers(0, 2)) \
                    and h >= 16 and w >= 16:
                fr2 = np.dstack([np.roll(img, 5, axis=1),
                                 np.full((h, w), 180, np.uint8)])
                fr1 = np.dstack([img, np.full((h, w), 255, np.uint8)])
                anim = encode_animation([fr1, fr2], distance=d, blend=True)
                ofr = refjxl.decode_frames(anim, dtype="uint8",
                                           num_channels=4)
                ufr, _ = decode_all(anim, device=device)
                for i, (o, u) in enumerate(zip(ofr, ufr)):
                    e3 = np.abs(o.astype(int)
                                - u.pixels.astype(int)).max()
                    if e3 > 1:
                        fails.append((desc, f"anim-frame{i}", e3))
        except Exception:  # noqa: BLE001 — every case is reported
            fails.append((desc, "EXC",
                          traceback.format_exc().splitlines()[-1]))
        if (it + 1) % 10 == 0:
            print(f"{it+1}/{n} done, {len(fails)} failures", flush=True)
    return fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("iterations", nargs="?", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="torch device of this codec (default cuda)")
    args = p.parse_args(argv)
    from libjxl_tpu_torch.extras import refjxl
    if not refjxl.available():
        raise SystemExit("interop_sweep needs the system libjxl (refjxl)")
    fails = sweep(args.seed, args.iterations, args.device)
    print("FAILURES:", len(fails))
    for f in fails[:20]:
        print(" ", f)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
