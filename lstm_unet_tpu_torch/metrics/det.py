"""CTC DET measure, in numpy (counterpart of ``lstm_unet_tpu/metrics/det.py``).

The cost of editing the computed markers into the reference markers (Matula
et al. 2015, AOGM-D restricted to node operations): a computed marker matched
by k > 1 reference markers needs k - 1 splits (weight 5), an unmatched
reference marker is a false negative (10), a computed marker matched by none
a false positive (1). R matches S iff |R ∩ S| > 0.5·|R|, as in SEG.
DET = 1 - min(AOGM-D, 10·N_ref) / (10·N_ref).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from .seg import dense_ranks, joint_histogram

W_NS = 5.0
W_FN = 10.0
W_FP = 1.0


def det_counts(gt: np.ndarray, pred: np.ndarray) -> Tuple[int, int, int, int]:
    """``(ns, fn, fp, n_gt)`` over one frame."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if gt.shape != pred.shape:
        raise ValueError(f"shape mismatch {gt.shape} vs {pred.shape}")
    gt_ids, gt_d = dense_ranks(gt)
    pred_ids, pred_d = dense_ranks(pred)
    n_gt = int(gt_ids.size - 1)
    n_pred = int(pred_ids.size - 1)
    if n_gt == 0:
        return 0, 0, n_pred, 0
    if n_pred == 0:
        return 0, n_gt, 0, n_gt
    joint = joint_histogram(gt_d, gt_ids.size, pred_d, pred_ids.size)
    gt_sizes = joint.sum(axis=1)
    matches_per_pred = np.zeros(pred_ids.size, np.int64)
    fn = 0
    for g in range(1, gt_ids.size):
        inter = joint[g, 1:]
        best = int(np.argmax(inter)) + 1
        if int(inter[best - 1]) * 2 > gt_sizes[g]:
            matches_per_pred[best] += 1
        else:
            fn += 1
    matched = matches_per_pred[1:]
    fp = int(np.count_nonzero(matched == 0))
    ns = int(np.maximum(matched - 1, 0).sum())
    return ns, fn, fp, n_gt


def det_score(ns: int, fn: int, fp: int, n_ref: int) -> float:
    """DET from summed edit counts; 0 when there is no reference marker."""
    if n_ref == 0:
        return 0.0
    d0 = W_FN * n_ref
    return 1.0 - min(W_NS * ns + W_FN * fn + W_FP * fp, d0) / d0


def det_measure_sequence(gt_frames: Iterable[np.ndarray],
                         pred_frames: Iterable[np.ndarray]) -> float:
    """DET over a sequence."""
    ns = fn = fp = n_ref = 0
    for gt, pred in zip(gt_frames, pred_frames):
        s, n, p, g = det_counts(gt, pred)
        ns += s
        fn += n
        fp += p
        n_ref += g
    return det_score(ns, fn, fp, n_ref)
