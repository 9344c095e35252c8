"""Text-like patch detection for screenshot/UI content.

Reference: lib/jxl/enc_patch_dictionary.cc:231 FindTextLikePatches and
:620 FindBestPatchDictionary — flat 4x4 "screenshot" seed squares grow
into a background mask; small connected components outside it with a
uniform border become dictionary patches, deduplicated and bin-packed
into a reference frame that is encoded once and stamped (kAdd) at every
occurrence. The detection here follows the same staged heuristic with
the flood fill vectorized as iterative masked dilation instead of a
serial BFS.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu_torch.frame.patches import (
    PatchBlendMode, PatchBlending, PatchDictionary, PatchPosition,
    PatchRefPosition,
)

# XYB channel quantization/steps and similarity weights
# (enc_patch_dictionary.cc:185 PatchColorspaceInfo, is_xyb branch).
_DEQUANT = np.array([0.01615, 0.08875, 0.1922], np.float32)
_WEIGHTS = np.array([30.0, 3.0, 1.0], np.float32)
_PATCH_SIDE = 4
_MAX_PATCH_SIZE = 32
_SIM_BG = 0.8            # kSimilarThreshold
_SIM_BORDER = 0.03       # kVerySimilarThreshold / kHasSimilarThreshold
_DIST_LIMIT = 50         # kDistanceLimit
_MIN_PEAK = 2
_MIN_OCCURRENCES = 2
_MIN_MAX_PATCH_PIXELS = 20


def _wdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Weighted L1 color distance over leading channel axis."""
    return np.tensordot(_WEIGHTS, np.abs(a - b), axes=(0, 0))


def _find_seeds(img: np.ndarray) -> np.ndarray:
    """(H, W) bool: pixels inside flat, screenshot-like 4x4 squares."""
    _, h, w = img.shape
    ph, pw = h // _PATCH_SIDE, w // _PATCH_SIDE
    if ph < 3 or pw < 3:
        return np.zeros((h, w), bool)
    s = _PATCH_SIDE
    blocks = img[:, :ph * s, :pw * s].reshape(3, ph, s, pw, s)
    corners = blocks[:, :, 0, :, 0]                       # (3, ph, pw)
    flat = (np.abs(blocks - corners[:, :, None, :, None])
            <= 1e-4).all(axis=(0, 2, 4))                  # (ph, pw)
    # >= 8 of the 9 naturally-aligned neighbor corners share the color.
    num_same = np.zeros((ph, pw), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = np.roll(corners, (-dy, -dx), axis=(1, 2))
            num_same += (np.abs(nb - corners) <= 1e-4).all(axis=0)
    seeds_blk = flat & (num_same >= 8)
    seeds_blk[0, :] = seeds_blk[-1, :] = False
    seeds_blk[:, 0] = seeds_blk[:, -1] = False
    seeds = np.zeros((h, w), bool)
    seeds[:ph * s, :pw * s] = np.repeat(
        np.repeat(seeds_blk, s, axis=0), s, axis=1)
    return seeds


def _grow_background(img: np.ndarray, seeds: np.ndarray,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Flood-fills "similar enough" pixels outward from the seed areas
    (the BFS at enc_patch_dictionary.cc:385, run as parallel dilation).

    Returns (is_background (H,W) bool, background (3,H,W) colors: each
    background pixel carries its flood source's color)."""
    _, h, w = img.shape
    bg = seeds.copy()
    src_col = np.where(bg[None], img, 0.0).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int32)
    src_y = np.where(bg, yy, 0).astype(np.int32)
    src_x = np.where(bg, xx, 0).astype(np.int32)
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
              if (dy, dx) != (0, 0)]

    def shifted(a, dy, dx, fill=0):
        out = np.full_like(a, fill)
        ys0, ys1 = max(dy, 0), h + min(dy, 0)
        xs0, xs1 = max(dx, 0), w + min(dx, 0)
        out[ys0:ys1, xs0:xs1] = a[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
        return out

    for _ in range(2 * _DIST_LIMIT + 8):
        changed = False
        for dy, dx in shifts:
            nb_bg = shifted(bg, dy, dx, False)
            cand = nb_bg & ~bg
            if not cand.any():
                continue
            nsy = shifted(src_y, dy, dx)
            nsx = shifted(src_x, dy, dx)
            ncol = np.stack([shifted(src_col[c], dy, dx)
                             for c in range(3)])
            dist = np.abs(yy - nsy) + np.abs(xx - nsx)
            ok = cand & (dist <= _DIST_LIMIT) & \
                (_wdist(img, ncol) <= _SIM_BG)
            if ok.any():
                bg |= ok
                for c in range(3):
                    src_col[c] = np.where(ok, ncol[c], src_col[c])
                src_y = np.where(ok, nsy, src_y)
                src_x = np.where(ok, nsx, src_x)
                changed = True
        if not changed:
            break
    return bg, src_col


def _connected_components(fg: np.ndarray):
    """8-connected components of the (sparse) foreground mask:
    yields (ys, xs) index arrays."""
    h, w = fg.shape
    labels = np.full((h, w), -1, np.int32)
    coords = np.argwhere(fg)
    next_label = 0
    for y0, x0 in coords:
        if labels[y0, x0] >= 0:
            continue
        stack = [(int(y0), int(x0))]
        labels[y0, x0] = next_label
        comp = []
        while stack:
            y, x = stack.pop()
            comp.append((y, x))
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < h and 0 <= nx < w and fg[ny, nx] \
                            and labels[ny, nx] < 0:
                        labels[ny, nx] = next_label
                        stack.append((ny, nx))
        next_label += 1
        ys = np.array([p[0] for p in comp])
        xs = np.array([p[1] for p in comp])
        yield ys, xs


def find_text_like_patches(img: np.ndarray):
    """Detects repeated text-like glyphs in (3, H, W) XYB.

    Returns a list of dicts {"fpixels": (3, ph, pw) residual,
    "qpixels": int8 key, "positions": [(x, y), ...]} or [] when the
    image is not screenshot-like."""
    img = np.ascontiguousarray(img, np.float32)
    _, h, w = img.shape
    seeds = _find_seeds(img)
    if not seeds.any():
        return []
    bg, bg_col = _grow_background(img, seeds)
    fg = ~bg
    if not fg.any() or fg.sum() > bg.sum():
        return []  # not screenshot-like after all

    candidates = []
    for ys, xs in _connected_components(fg):
        min_y, max_y = ys.min(), ys.max()
        min_x, max_x = xs.min(), xs.max()
        if max_x - min_x >= _MAX_PATCH_SIZE or \
                max_y - min_y >= _MAX_PATCH_SIZE:
            continue
        # All background pixels bordering the CC must share a color.
        border = set()
        for y, x in zip(ys, xs):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < h and 0 <= nx < w and bg[ny, nx]:
                        border.add((ny, nx))
        if not border:
            continue
        bys = np.array([p[0] for p in border])
        bxs = np.array([p[1] for p in border])
        bcols = bg_col[:, bys, bxs]
        ref = bcols[:, 0]
        if (_wdist(bcols, ref[:, None]) > _SIM_BORDER).any():
            continue
        # The patch must sit on similar background somewhere nearby.
        y0, y1 = max(min_y - 2, 0), min(max_y + 3, h)
        x0, x1 = max(min_x - 2, 0), min(max_x + 3, w)
        if not (_wdist(img[:, y0:y1, x0:x1],
                       ref[:, None, None]) <= _SIM_BORDER).any():
            continue
        fpix = img[:, min_y:max_y + 1, min_x:max_x + 1] \
            - ref[:, None, None]
        q = np.trunc(fpix / _DEQUANT[:, None, None])
        if (q < -128).any() or (q > 127).any():
            continue  # too_big
        if (np.abs(q) < _MIN_PEAK).all():
            continue  # too_small
        candidates.append({"fpixels": fpix,
                           "qpixels": q.astype(np.int8),
                           "positions": [(int(min_x), int(min_y))]})

    # Deduplicate identical quantized patches; keep recurring ones.
    by_key: dict[bytes, dict] = {}
    for cand in candidates:
        key = cand["qpixels"].shape[1:] + (cand["qpixels"].tobytes(),)
        key = repr(key).encode()
        if key in by_key:
            by_key[key]["positions"].extend(cand["positions"])
        else:
            by_key[key] = cand
    patches = [p for p in by_key.values()
               if len(p["positions"]) >= _MIN_OCCURRENCES]
    if not patches:
        return []
    if max(p["fpixels"][0].size for p in patches) < _MIN_MAX_PATCH_PIXELS:
        return []
    return patches


def _bin_pack(patches):
    """First-fit packing into a growing canvas
    (enc_patch_dictionary.cc:666)."""
    patches = sorted(patches, key=lambda p: -p["fpixels"][0].size)
    total = sum(p["fpixels"][0].size for p in patches)
    max_w = max(p["fpixels"].shape[2] for p in patches)
    max_h = max(p["fpixels"].shape[1] for p in patches)
    ref_w = max(max_w, int(np.sqrt(total)))
    ref_h = max(max_h, int(np.sqrt(total)))
    while True:
        ref_w = int(ref_w * 1.05) + 1
        ref_h = int(ref_h * 1.05) + 1
        occupied = np.zeros((ref_h, ref_w), bool)
        placed = []
        ok = True
        for p in patches:
            _, psh, psw = p["fpixels"].shape
            found = False
            for y0 in range(ref_h - psh + 1):
                for x0 in range(ref_w - psw + 1):
                    if not occupied[y0:y0 + psh, x0:x0 + psw].any():
                        occupied[y0:y0 + psh, x0:x0 + psw] = True
                        placed.append((x0, y0))
                        found = True
                        break
                if found:
                    break
            if not found:
                ok = False
                break
        if ok:
            max_y = max(y0 + p["fpixels"].shape[1]
                        for (x0, y0), p in zip(placed, patches))
            return patches, placed, ref_w, max_y


def build_text_patch_sheet(img: np.ndarray, patches: list,
                           ) -> tuple[np.ndarray, PatchDictionary,
                                      np.ndarray]:
    """Packs detected glyph residuals into a reference-frame sheet and
    subtracts every occurrence from the image (kAdd blending restores
    them at decode). Returns (sheet, dictionary, cleaned_img)."""
    patches, placed, ref_w, ref_h = _bin_pack(patches)
    sheet = np.zeros((3, ref_h, ref_w), np.float32)
    cleaned = img.astype(np.float32).copy()
    d = PatchDictionary()
    for i, ((x0, y0), p) in enumerate(zip(placed, patches)):
        _, psh, psw = p["fpixels"].shape
        sheet[:, y0:y0 + psh, x0:x0 + psw] = p["fpixels"]
        d.ref_positions.append(PatchRefPosition(
            ref=1, x0=x0, y0=y0, xsize=psw, ysize=psh))
        for (px, py) in p["positions"]:
            d.positions.append(PatchPosition(px, py, i))
            d.blendings.append([PatchBlending(PatchBlendMode.ADD)])
            cleaned[:, py:py + psh, px:px + psw] -= p["fpixels"]
    order = sorted(range(len(d.positions)),
                   key=lambda i: (d.positions[i].y, d.positions[i].x))
    d.positions = [d.positions[i] for i in order]
    d.blendings = [d.blendings[i] for i in order]
    return sheet, d, cleaned
