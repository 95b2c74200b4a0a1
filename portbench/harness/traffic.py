"""The benchmark's traffic: seeded frame sequences and training batches.

Frozen copies, kept here so that the yardstick does not move with the
program: :func:`make_cell_sequence` is the drifting-cell generator of
``lstm_unet_tpu_torch/io/synthetic.py`` (same arrays for the same arguments),
:func:`instance_to_three_class` and :func:`percentile_normalize` the
three-class target and the whole-frame normalisation of
``lstm_unet_tpu_torch/io/preprocess.py``. A workload's ``traffic`` block
(``portbench/workloads/<name>.json``) holds every parameter; the seed of a
run picks the cells' places, sizes, speeds and the noise, never the sizes of
the work (frames, frame size, cell count, batch and crop shapes).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def make_cell_sequence(num_frames: int, height: int, width: int, num_cells: int,
                       seed: int, noise: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """(images ``[T, H, W]`` uint16, instance labels ``[T, H, W]`` uint16) of
    ``num_cells`` elliptical cells drifting at up to a pixel a frame."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(0.2 * height, 0.8 * height, num_cells)
    cx = rng.uniform(0.2 * width, 0.8 * width, num_cells)
    vy = rng.uniform(-1.0, 1.0, num_cells)
    vx = rng.uniform(-1.0, 1.0, num_cells)
    ry = rng.uniform(height * 0.06, height * 0.12, num_cells)
    rx = rng.uniform(width * 0.06, width * 0.12, num_cells)
    inten = rng.uniform(0.5, 1.0, num_cells)
    yy, xx = np.mgrid[0:height, 0:width]
    imgs = np.zeros((num_frames, height, width), np.float32)
    labs = np.zeros((num_frames, height, width), np.uint16)
    for t in range(num_frames):
        for c in range(num_cells):
            y, x = cy[c] + vy[c] * t, cx[c] + vx[c] * t
            y0, y1 = max(int(y - ry[c]) - 1, 0), min(int(y + ry[c]) + 2, height)
            x0, x1 = max(int(x - rx[c]) - 1, 0), min(int(x + rx[c]) + 2, width)
            if y0 >= y1 or x0 >= x1:
                continue
            d = (((yy[y0:y1, x0:x1] - y) / ry[c]) ** 2
                 + ((xx[y0:y1, x0:x1] - x) / rx[c]) ** 2)
            inside = d <= 1.0
            labs[t, y0:y1, x0:x1][inside] = c + 1
            imgs[t, y0:y1, x0:x1][inside] = inten[c] * np.exp(-d[inside])
        imgs[t] += rng.normal(0, noise, (height, width)).astype(np.float32)
    imgs = np.clip(imgs, 0, None)
    imgs_u16 = (imgs / max(imgs.max(), 1e-6) * 60000).astype(np.uint16)
    return imgs_u16, labs


def instance_to_three_class(labels: np.ndarray) -> np.ndarray:
    """Instance mask -> {0: background, 1: interior, 2: boundary} (uint8): a
    labelled pixel is boundary when a pixel of its 3x3 neighbourhood
    (edge-replicated) carries another label, background included."""
    lab = labels.astype(np.int32)
    fg = lab > 0
    boundary = np.zeros_like(fg)
    h, w = lab.shape
    padded = np.pad(lab, 1, mode="edge")
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                boundary |= fg & (padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] != lab)
    out = np.zeros(lab.shape, dtype=np.uint8)
    out[fg] = 1
    out[boundary] = 2
    return out


def percentile_normalize(img: np.ndarray) -> np.ndarray:
    """``(x - p1) / max(p99 - p1, 1e-6)`` of a whole frame, in f32."""
    x = img.astype(np.float32)
    lo, hi = np.percentile(x, 1.0), np.percentile(x, 99.0)
    return (x - lo) / max(hi - lo, 1e-6)


def sequence(traffic: Dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The cell's sequence: (raw uint16 frames, instance labels)."""
    return make_cell_sequence(traffic["frames"], traffic["height"], traffic["width"],
                              traffic["cells"], seed)


def train_batches(traffic: Dict, seed: int) -> Iterator[Tuple[np.ndarray, ...]]:
    """Endless truncated-BPTT batches of the reader's layout, ``(image
    [B,T,h,w,1] f32, seg [B,T,h,w] int32, valid [B,T] f32, full_seg [B,T] f32,
    is_last [B] f32)``: lane b reads its own crop of the sequence (a corner
    or the middle, by lane) window after window, whole frames normalised
    before they are cropped, and its state ends (``is_last``) with the
    sequence's last window; then it starts again from the first. The first
    batch is window ``first_window`` (0 unless the traffic says), so that
    the first steps can cross a sequence's end. Batches come from one host
    array made here, so every step's rows differ until the sequence
    wraps."""
    imgs, labs = sequence(traffic, seed)
    norm = np.stack([percentile_normalize(f) for f in imgs])
    seg = np.stack([instance_to_three_class(f) for f in labs]).astype(np.int32)
    b, t = traffic["batch"], traffic["unroll"]
    ch, cw = traffic["crop"]
    n_frames, h, w = imgs.shape
    corners = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
               ((h - ch) // 2, (w - cw) // 2)]
    windows = n_frames // t
    ones = np.ones((b, t), np.float32)
    step = traffic.get("first_window", 0)
    while True:
        win = step % windows
        sl = slice(win * t, (win + 1) * t)
        crops = [corners[lane % len(corners)] for lane in range(b)]
        img = np.stack([norm[sl, y:y + ch, x:x + cw] for y, x in crops])[..., None]
        lab = np.stack([seg[sl, y:y + ch, x:x + cw] for y, x in crops])
        last = np.full((b,), float(win == windows - 1), np.float32)
        yield (np.ascontiguousarray(img), np.ascontiguousarray(lab), ones, ones, last)
        step += 1
