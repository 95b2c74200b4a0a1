"""CTC SEG measure, in numpy (counterpart of ``lstm_unet_tpu/metrics/seg.py``).

For every ground-truth object R, the segmented object S with
|R ∩ S| > 0.5·|R| (at most one exists) scores |R ∩ S| / |R ∪ S|; no such S
scores 0. The dataset score is the mean over all GT objects.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def dense_ranks(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(ids, ranks)``: the sorted label ids with 0 first (prepended when no
    pixel is background) and each pixel's index into them. Indexing by rank
    keeps the joint histogram small whatever the (sparse, large) CTC ids."""
    ids, ranks = np.unique(labels, return_inverse=True)
    if ids[0] != 0:
        ids = np.concatenate([[0], ids])
        ranks = ranks + 1
    return ids, ranks


def joint_histogram(gt_ranks: np.ndarray, n_gt: int, pred_ranks: np.ndarray,
                    n_pred: int) -> np.ndarray:
    flat = gt_ranks.ravel().astype(np.int64) * n_pred + pred_ranks.ravel()
    return np.bincount(flat, minlength=n_gt * n_pred).reshape(n_gt, n_pred)


def seg_measure(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, int]:
    """SEG over one frame: (sum of per-object Jaccards, number of GT objects)."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if gt.shape != pred.shape:
        raise ValueError(f"shape mismatch {gt.shape} vs {pred.shape}")
    gt_ids, gt_d = dense_ranks(gt)
    if gt_ids.size <= 1:
        return 0.0, 0
    pred_ids, pred_d = dense_ranks(pred)
    joint = joint_histogram(gt_d, gt_ids.size, pred_d, pred_ids.size)
    gt_sizes = joint.sum(axis=1)
    pred_sizes = joint.sum(axis=0)
    total = 0.0
    for g in range(1, gt_ids.size):
        inter = joint[g, 1:]  # overlaps with every non-background prediction
        if inter.size == 0:
            continue
        best = int(np.argmax(inter)) + 1
        ovl = int(inter[best - 1])
        if ovl * 2 > gt_sizes[g]:  # strict majority
            total += ovl / (gt_sizes[g] + pred_sizes[best] - ovl)
    return float(total), int(gt_ids.size - 1)


def seg_measure_sequence(gt_frames: Iterable[np.ndarray],
                         pred_frames: Iterable[np.ndarray]) -> float:
    """Mean SEG over all GT objects of a sequence."""
    total, count = 0.0, 0
    for gt, pred in zip(gt_frames, pred_frames):
        t, c = seg_measure(gt, pred)
        total += t
        count += c
    return total / count if count else 0.0
