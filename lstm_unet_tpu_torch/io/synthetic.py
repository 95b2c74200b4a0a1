"""Synthetic sequences in the Cell Tracking Challenge layout.

Counterpart of ``lstm_unet_tpu/io/synthetic.py``: the same arrays for the same
arguments and seed (``tests/test_torch_infer.py``), so the golden sequence
and flagship-size smoke data can be made where only PyTorch is installed.
Moving elliptical "cells" with instance labels, written as
``<root>/<dataset>/<seq>/t###.tif`` and ``<seq>_GT/SEG/man_seg###.tif``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .tiff import write_tiff


def make_cell_sequence(
    num_frames: int = 12,
    height: int = 64,
    width: int = 64,
    num_cells: int = 4,
    seed: int = 0,
    noise: float = 0.05,
    radius_scale: float = 1.0,
    velocity_scale: float = 1.0,
    overlap_frac: float = 0.0,
    overlap_gap: Tuple[float, float] = (0.55, 1.05),
    overlap_match_intensity: bool = False,
    overlap_rel_velocity: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (images [T,H,W] uint16, labels [T,H,W] uint16) of drifting
    cells; the knobs are the reference's (see its docstring). Every extra
    random draw sits behind its knob, so defaults reproduce old sequences."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(0.2 * height, 0.8 * height, num_cells)
    cx = rng.uniform(0.2 * width, 0.8 * width, num_cells)
    vy = rng.uniform(-1.0, 1.0, num_cells) * velocity_scale
    vx = rng.uniform(-1.0, 1.0, num_cells) * velocity_scale
    ry = rng.uniform(height * 0.06, height * 0.12, num_cells) * radius_scale
    rx = rng.uniform(width * 0.06, width * 0.12, num_cells) * radius_scale
    inten = rng.uniform(0.5, 1.0, num_cells)
    if overlap_frac > 0:
        # the last n_ov cells are re-placed touching an earlier anchor and
        # drift with it
        n_ov = min(int(round(num_cells * overlap_frac)), num_cells - 1)
        for c in range(num_cells - n_ov, num_cells):
            j = int(rng.integers(0, c))
            ang = rng.uniform(0.0, 2.0 * np.pi)
            gap = rng.uniform(*overlap_gap)
            cy[c] = np.clip(cy[j] + np.sin(ang) * gap * (ry[j] + ry[c]),
                            0.1 * height, 0.9 * height)
            cx[c] = np.clip(cx[j] + np.cos(ang) * gap * (rx[j] + rx[c]),
                            0.1 * width, 0.9 * width)
            vy[c], vx[c] = vy[j], vx[j]
            if overlap_match_intensity:
                inten[c] = inten[j]
            if overlap_rel_velocity > 0:
                vy[c] += rng.normal(0, overlap_rel_velocity)
                vx[c] += rng.normal(0, overlap_rel_velocity)

    yy, xx = np.mgrid[0:height, 0:width]
    imgs = np.zeros((num_frames, height, width), np.float32)
    labs = np.zeros((num_frames, height, width), np.uint16)
    for t in range(num_frames):
        for c in range(num_cells):
            y, x = cy[c] + vy[c] * t, cx[c] + vx[c] * t
            d = ((yy - y) / ry[c]) ** 2 + ((xx - x) / rx[c]) ** 2
            inside = d <= 1.0
            labs[t][inside] = c + 1  # later cells overwrite earlier ones
            imgs[t][inside] = inten[c] * np.exp(-d[inside])
        imgs[t] += rng.normal(0, noise, (height, width)).astype(np.float32)
    imgs = np.clip(imgs, 0, None)
    imgs_u16 = (imgs / max(imgs.max(), 1e-6) * 60000).astype(np.uint16)
    return imgs_u16, labs


def spiral_mask(n: int) -> np.ndarray:
    """One connected 1-px spiral in an n x n frame: a single component whose
    geodesic diameter is ~n^2/2, the worst case of sweep-based CCL (the
    reference's ``tests/test_ops.py::_spiral_mask``)."""
    mask = np.zeros((n, n), bool)
    y = x = 0
    dy, dx = 0, 1
    top, bottom, left, right = 0, n - 1, 0, n - 1
    mask[y, x] = True
    while True:
        ny, nx = y + dy, x + dx
        if dy == 0 and dx == 1 and nx > right:
            dy, dx = 1, 0
            top += 2
        elif dy == 1 and dx == 0 and ny > bottom:
            dy, dx = 0, -1
            right -= 2
        elif dy == 0 and dx == -1 and nx < left:
            dy, dx = -1, 0
            bottom -= 2
        elif dy == -1 and dx == 0 and ny < top:
            dy, dx = 0, 1
            left += 2
        ny, nx = y + dy, x + dx
        if not (top - 2 <= ny <= bottom + 2 and left - 2 <= nx <= right + 2):
            break
        if top > bottom or left > right:
            break
        y, x = ny, nx
        mask[y, x] = True
    return mask


def dense_components_mask(height: int, width: int, seed: int = 0) -> np.ndarray:
    """Thousands of small components: random blobs of 1-4 px a side on a
    4-px grid, so neighbouring blobs sometimes merge."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((height, width), bool)
    for y0 in range(0, height - 3, 4):
        for x0 in range(0, width - 3, 4):
            if rng.random() < 0.8:
                hh, ww = rng.integers(1, 5, 2)
                mask[y0:y0 + hh, x0:x0 + ww] = True
    return mask


def write_ctc_dataset(root: str, dataset: str = "Synth-N2DH-SIM", seq: str = "01",
                      annotate_every: int = 1, **kwargs) -> Tuple[str, str]:
    """Write a synthetic sequence in CTC layout; returns (seq_dir, seg_dir).
    ("SIM" in the dataset name marks the GT as fully annotated.)"""
    imgs, labs = make_cell_sequence(**kwargs)
    seq_dir = os.path.join(root, dataset, seq)
    seg_dir = os.path.join(root, dataset, seq + "_GT", "SEG")
    os.makedirs(seq_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    for t in range(imgs.shape[0]):
        write_tiff(os.path.join(seq_dir, f"t{t:03d}.tif"), imgs[t])
        if t % annotate_every == 0:
            write_tiff(os.path.join(seg_dir, f"man_seg{t:03d}.tif"), labs[t])
    return seq_dir, seg_dir
