"""Decompose per-object SEG loss into failure modes.

Counterpart of the reference's ``scripts/seg_error_decomposition.py``: the
same categories, losses and printed lines, on the host (numpy). It
attributes the SEG loss per GT object, so the next lever is chosen from
data. Categories, per GT object R (SEG rules: the matched pred S must cover
>50% of R; the score is IoU, else 0):

- ``shape``    — matched 1:1, loss = 1-IoU is boundary/footprint error only.
- ``merged``   — matched, but S also majority-covers ≥1 other GT object:
                 the model fused touching cells (instance-split territory).
- ``absorbed`` — unmatched: R's plurality-pred majority-covers a DIFFERENT
                 GT object (R was swallowed whole by a neighbor's component).
- ``dropped``  — unmatched: R's pixels are mostly background in the pred
                 (occlusion crescents, min_cell_size deletions).
- ``oversplit``— unmatched: R is covered by foreground but no single pred
                 reaches 50% (fragmented into several components).

Usage:
    python -m lstm_unet_tpu_torch.scripts.seg_error_decomposition \
        --gt_root HELDOUT/eval --pred_root RESULTS \
        [--dataset Synth-N2DH-SIM] [--top 8]

Prints one table per sequence plus a dataset aggregate; ``--top`` lists the
worst individual objects (sequence/frame/gt-id) for eyeballing.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np

from ..io.tiff import read_tiff

CATS = ("shape", "merged", "absorbed", "dropped", "oversplit")


def decompose_frame(gt: np.ndarray, pred: np.ndarray):
    """Yield (gt_id, category, seg_score, loss, detail) per GT object."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    gt_ids = np.unique(gt)
    gt_ids = gt_ids[gt_ids > 0]
    if gt_ids.size == 0:
        return []
    n_g = int(gt.max()) + 1
    n_p = int(pred.max()) + 1
    joint = np.zeros((n_g, n_p), np.int64)
    np.add.at(joint, (gt.ravel(), pred.ravel()), 1)
    gt_sizes = joint.sum(axis=1)
    pred_sizes = joint.sum(axis=0)
    # for merge detection: which GT object (if any) does each pred label
    # majority-cover?  pred p covers g when joint[g,p]*2 > gt_sizes[g]
    covers = defaultdict(list)  # pred label -> [gt ids it majority-covers]
    for g in gt_ids:
        row = joint[g, 1:]
        if row.size and row.max() * 2 > gt_sizes[g]:
            covers[int(np.argmax(row)) + 1].append(int(g))

    out = []
    for g in gt_ids:
        row = joint[g, 1:]
        best = int(np.argmax(row)) + 1 if row.size else 0
        ovl = int(row[best - 1]) if row.size else 0
        if ovl * 2 > gt_sizes[g]:
            union = gt_sizes[g] + pred_sizes[best] - ovl
            score = ovl / union
            others = [x for x in covers[best] if x != g]
            cat = "merged" if others else "shape"
            detail = f"pred {best} also covers gt {others}" if others else ""
            out.append((int(g), cat, float(score), 1.0 - float(score), detail))
            continue
        # unmatched: attribute the zero
        bg = int(joint[g, 0])
        fg = int(gt_sizes[g] - bg)
        if bg * 2 >= gt_sizes[g]:
            cat, detail = "dropped", f"{bg}/{int(gt_sizes[g])} px background"
        elif best and covers.get(best) and g not in covers[best]:
            cat = "absorbed"
            detail = f"plurality pred {best} belongs to gt {covers[best]}"
        else:
            nz = np.count_nonzero(row)
            cat, detail = "oversplit", f"{fg} fg px across {nz} pred labels"
        out.append((int(g), cat, 0.0, 1.0, detail))
    return out


def load_labeled(path: str) -> np.ndarray:
    return np.asarray(read_tiff(path))


def frames_of(d: str, pat: str):
    for p in sorted(glob.glob(os.path.join(d, pat))):
        m = re.search(r"(\d+)\.tif$", p)
        if m:
            yield int(m.group(1)), p


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--dataset", default="Synth-N2DH-SIM")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    ds_gt = os.path.join(args.gt_root, args.dataset)
    seqs = sorted(d[:-3] for d in os.listdir(ds_gt) if d.endswith("_GT"))
    grand = defaultdict(lambda: [0, 0.0])  # cat -> [count, loss sum]
    worst = []
    n_total, seg_total = 0, 0.0
    for seq in seqs:
        gt_dir = os.path.join(ds_gt, f"{seq}_GT", "SEG")
        pred_dir = os.path.join(args.pred_root, args.dataset, f"{seq}_RES")
        gt_frames = dict(frames_of(gt_dir, "man_seg*.tif"))
        stats = defaultdict(lambda: [0, 0.0])
        n_seq, seg_seq = 0, 0.0
        for t, gp in sorted(gt_frames.items()):
            pp = os.path.join(pred_dir, f"mask{t:03d}.tif")
            if not os.path.exists(pp):
                continue
            for g, cat, score, loss, detail in decompose_frame(
                    load_labeled(gp), load_labeled(pp)):
                stats[cat][0] += 1
                stats[cat][1] += loss
                grand[cat][0] += 1
                grand[cat][1] += loss
                n_seq += 1
                seg_seq += score
                if loss > 0.02:
                    worst.append((loss, seq, t, g, cat, detail))
        n_total += n_seq
        seg_total += seg_seq
        print(f"\n== seq {seq}: SEG {seg_seq / max(n_seq, 1):.4f} "
              f"({n_seq} objects) ==")
        for cat in CATS:
            c, l = stats[cat]
            if c:
                print(f"  {cat:9s} n={c:4d}  loss_sum={l:8.3f}  "
                      f"(costs {l / n_seq:.4f} SEG)")
    print(f"\n== dataset: SEG {seg_total / max(n_total, 1):.4f} "
          f"({n_total} objects) ==")
    for cat in CATS:
        c, l = grand[cat]
        if c:
            print(f"  {cat:9s} n={c:4d}  loss_sum={l:8.3f}  "
                  f"(costs {l / n_total:.4f} SEG)")
    worst.sort(reverse=True)
    print(f"\nworst {args.top} objects:")
    for loss, seq, t, g, cat, detail in worst[:args.top]:
        print(f"  loss={loss:.3f} seq={seq} frame={t} gt={g} "
              f"[{cat}] {detail}")


if __name__ == "__main__":
    main()
