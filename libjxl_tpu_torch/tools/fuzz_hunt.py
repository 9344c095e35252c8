"""Offline fuzz hunt: randomized + structured mutations over diverse
valid streams, saving any input whose decode escapes JxlError, or that
stages an out-of-range index on the device, into ``--out``.

Reference analogue: tools/djxl_fuzzer.cc + djxl_fuzzer_test.cc (crash
corpus replayed as a gtest).

    python -m libjxl_tpu_torch.tools.fuzz_hunt [--seconds 300] \
        [--seed 0] [--out DIR] [--device cpu]
    python -m libjxl_tpu_torch.tools.fuzz_hunt --write-seeds [--out DIR]

Port of tools/fuzz_hunt.py: the same seed streams, mutations and seed
corpus. Differences (reference line numbers):
- the entry points come from ``fuzz_targets`` in this package, not
  from ``tests/test_fuzz.py`` (:53-55); ``decode`` and ``decode_all``
  run on ``--device`` (a torch device name, ``cuda`` by default; raises
  without a card), and the seed streams are encoded there (:29-49);
- crashers and seeds are written to ``--out`` (a git-ignored directory
  by default), never to ``tests/corpus/`` (:25);
- a decode that stages a feed with an out-of-range index
  (``fuzz_targets.feed_index_faults``) is saved as a crasher too: on a
  card it would be a device-side assert;
- ``hunt`` returns the counts for callers.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
import traceback

import numpy as np

from libjxl_tpu_torch.base.errors import JxlError
from libjxl_tpu_torch.tools import default_out
from libjxl_tpu_torch.tools.fuzz_targets import checking_feeds, entry_points


def seed_streams(device=None) -> list:
    """Diverse valid streams covering the major codestream shapes."""
    from libjxl_tpu_torch.api.simple import encode as encode_api
    from libjxl_tpu_torch.api.simple import encode_animation

    def encode(img, **kw):
        return encode_api(img, device=device, **kw)

    rng = np.random.default_rng(7)
    img = np.clip(rng.normal(128, 48, (64, 72, 3)), 0, 255).astype(np.uint8)
    gray16 = rng.integers(0, 65536, (48, 40), dtype=np.uint16)
    small = img[:24, :24]
    streams = [
        ("vardct_e3", encode(img, distance=1.0, effort=3)),
        ("vardct_prog", encode(img, distance=2.0, progressive=True)),
        ("modular_lossless", encode(small, lossless=True)),
        ("modular_gray16", encode(gray16, lossless=True)),
        ("container", encode(small, distance=1.0, container=True)),
        ("noise", encode(img, distance=1.0, noise=3200.0)),
        ("anim", encode_animation([small, small[::-1]], distance=1.5)),
        ("e1_fast", encode(small, lossless=True, effort=1)),
        ("upsample2", encode(img, distance=1.0, resampling=2)),
        ("ycbcr420", encode(img, distance=1.0,
                            chroma_subsampling="420")),
    ]
    return streams


def save_crash(out: str, data: bytes, name: str, report: str) -> str:
    os.makedirs(out, exist_ok=True)
    h = hashlib.sha1(data).hexdigest()[:12]
    path = os.path.join(out, f"crash-{name}-{h}.bin")
    with open(path, "wb") as f:
        f.write(data)
    with open(path + ".txt", "w") as f:
        f.write(report)
    return path


def write_seeds(out: str, device=None) -> int:
    """Deterministic seed corpus: every stream shape truncated at
    structural fractions and header-flipped — the regression baseline
    a replay runs even before any hunted crash lands."""
    os.makedirs(out, exist_ok=True)
    n = 0
    for name, data in seed_streams(device):
        cases = {
            f"seed-{name}": data,
            f"seed-{name}-t25": data[:len(data) // 4],
            f"seed-{name}-t75": data[:3 * len(data) // 4],
        }
        flip = bytearray(data)
        flip[min(18, len(flip) - 1)] ^= 0x40   # inside size header
        cases[f"seed-{name}-hdrflip"] = bytes(flip)
        for cname, cdata in cases.items():
            with open(os.path.join(out, cname + ".bin"), "wb") as f:
                f.write(cdata)
            n += 1
    print(f"wrote {n} seed corpus files")
    return n


def hunt(seconds: float, seed: int, out: str, device=None) -> tuple:
    """Mutates the seed streams for ``seconds``; returns (inputs,
    crashes). Every crasher is saved under ``out``."""
    eps = entry_points(device)
    seeds = seed_streams(device)
    rng = np.random.default_rng(seed)
    found = 0
    iters = 0
    t_end = time.time() + seconds
    while time.time() < t_end:
        iters += 1
        mode = rng.integers(0, 10)
        if mode == 0:
            data = rng.integers(0, 256, rng.integers(1, 512),
                                dtype=np.uint8).tobytes()
            sname = "rand"
        else:
            sname, base = seeds[int(rng.integers(0, len(seeds)))]
            buf = bytearray(base)
            for _ in range(int(rng.integers(1, 6))):
                op = rng.integers(0, 4)
                if op == 0 and len(buf) > 1:          # flip
                    buf[int(rng.integers(0, len(buf)))] ^= \
                        int(rng.integers(1, 256))
                elif op == 1 and len(buf) > 4:        # truncate
                    buf = buf[:int(rng.integers(1, len(buf)))]
                elif op == 2:                         # insert
                    i = int(rng.integers(0, len(buf) + 1))
                    buf[i:i] = bytes([int(rng.integers(0, 256))])
                elif op == 3 and len(buf) > 8:        # splice chunk
                    i = int(rng.integers(0, len(buf) - 4))
                    j = int(rng.integers(0, len(buf) - 4))
                    buf[i:i + 4] = buf[j:j + 4]
            data = bytes(buf)
        name, fn = list(eps.items())[int(rng.integers(0, len(eps)))]
        faults: list = []
        report = None
        try:
            with checking_feeds(faults):
                fn(data)
        except JxlError:
            pass
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — crash found
            report = "".join(traceback.format_exception(e))
        if faults:
            report = (report or "") + "out-of-range feed:\n" + \
                "\n".join(faults) + "\n"
        if report is not None:
            found += 1
            path = save_crash(out, data, f"{name}-{sname}", report)
            print(f"CRASH {name} on {sname}: {path}")
    print(f"{iters} inputs, {found} crashes")
    return iters, found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write-seeds", action="store_true")
    p.add_argument("--out", default=default_out("fuzz_hunt"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the decode entry points and the "
                        "seed encodes (default cuda)")
    args = p.parse_args(argv)
    if args.write_seeds:
        write_seeds(args.out, args.device)
        return 0
    _, found = hunt(args.seconds, args.seed, args.out, args.device)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
