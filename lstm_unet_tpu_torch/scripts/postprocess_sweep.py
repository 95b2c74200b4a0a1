"""Offline postprocess-parameter calibration on saved probability dumps.

Counterpart of the reference's ``scripts/postprocess_sweep.py``, with its
flags, printed table and ``--json_out`` keys, plus ``--device`` (default
``cuda``: the postprocess runs on the card, K3 and all; ``cpu`` runs the
plain PyTorch path). The full instance postprocess (threshold -> CCL ->
size filter -> marker growth -> FOV) is a deterministic integer-domain
function of the softmax probabilities (``ops/postprocess.py::
postprocess_frame``), and ``ctc_sweep --save_intermediate`` saves exactly
the tensor that function consumed (original-size, post-TTA-average probs).
So the postprocess knobs (cell_thresh / edge_thresh / grow_iters /
min_cell_size, and the optional prob-split stage) can be swept offline
against those dumps with no model run. Each dump is moved to the device
once and every config runs on it there; the labels are scored on the host
(``metrics.seg_measure``).

Protocol: calibrate on the VAL sequence's dumps, then confirm the single
chosen config on the held-out eval dumps (``calibrate_recipe`` does both);
sweeping on held-out and reporting its max is selection on the test set.

Self-check: with ``--baseline_check`` the production config's labels are
compared bit for bit with the saved mask TIFFs (the first frames, one per
sequence swept): a dump made with other postprocess flags than the ones
claimed prints ``BASELINE MISMATCH``, and the sweep exits 1 once its table
(and JSON) is written.

Usage:
    python -m lstm_unet_tpu_torch.scripts.postprocess_sweep \
        --gt_root HELDOUT/train --pred_root VAL_DUMPS --seqs 03 --min_cell_size 50
    # then re-run the single winner on the eval dumps:
    python -m lstm_unet_tpu_torch.scripts.postprocess_sweep \
        --gt_root HELDOUT/eval --pred_root EVAL_DUMPS --min_cell_size 50 \
        --cell_grid 0.55 --edge_grid 0.3
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import re
from collections import defaultdict

import numpy as np
import torch

from ..io.tiff import read_tiff
from ..metrics import seg_measure
from ..ops.postprocess import postprocess_frame
from ..utils import resolve_device


def parse_floats(s: str):
    return tuple(float(x) for x in s.split(",") if x.strip())


def parse_ints(s: str):
    return tuple(int(x) for x in s.split(",") if x.strip())


def run_config(probs: torch.Tensor, cfg: dict) -> np.ndarray:
    """One offline postprocess pass: the production op on ``probs`` where
    they lie (the card, or the CPU's plain versions), labels to the host."""
    return postprocess_frame(probs, **cfg).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True,
                    help="ctc_sweep output root with <seq>_RES/intermediate/"
                         "probs*.npy dumps (--save_intermediate)")
    ap.add_argument("--dataset", default="Synth-N2DH-SIM")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the hand kernels) or 'cpu' (plain PyTorch); "
                         "'cuda' without a GPU raises")
    ap.add_argument("--seqs", default="",
                    help="comma-separated sequence names (default: all with "
                         "dumps)")
    # the config the dumps' masks were produced with (baseline + self-check)
    ap.add_argument("--min_cell_size", type=int, default=50)
    ap.add_argument("--fov", type=int, default=0)
    ap.add_argument("--grow_iters", type=int, default=0)
    ap.add_argument("--baseline_check", action="store_true",
                    help="assert the production config reproduces the saved "
                         "masks bit-identically (first frame per sequence)")
    # sweep grids (cartesian product)
    ap.add_argument("--cell_grid", default="0.4,0.45,0.5,0.55,0.6,0.7")
    ap.add_argument("--edge_grid", default="0.2,0.3,0.4")
    ap.add_argument("--min_size_grid", default="",
                    help="optional min_cell_size grid (default: fixed "
                         "--min_cell_size)")
    ap.add_argument("--grow_grid", default="",
                    help="optional grow_iters grid (0 = to exhaustion)")
    ap.add_argument("--size_filter_grid", default="pre",
                    help="size_filter values to sweep ('pre','post' or "
                         "'pre,post')")
    # optional prob-split stage swept jointly (split_sweep.py calibrates the
    # split alone on components of SAVED masks; here it runs in-pipeline)
    ap.add_argument("--split_hi_grid", default="",
                    help="enable instance_split(prob) with these hi_thresh "
                         "values (e.g. '0.7,0.8,0.9'); empty = split off")
    ap.add_argument("--split_erode_grid", default="1")
    ap.add_argument("--split_min_size_grid", default="0")
    ap.add_argument("--limit_frames", type=int, default=0,
                    help="cap annotated frames per sequence (0 = all) — "
                         "quick smoke runs")
    ap.add_argument("--json_out", default="",
                    help="also write the ranked results as JSON (baseline, "
                         "per-seq means, every config) — machine-readable "
                         "for scripts/calibrate_recipe.py")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cell_g = parse_floats(args.cell_grid)
    edge_g = parse_floats(args.edge_grid)
    min_g = parse_ints(args.min_size_grid) or (args.min_cell_size,)
    grow_g = parse_ints(args.grow_grid) or (args.grow_iters,)
    if args.split_hi_grid:
        split_g = [dict(instance_split=True, split_method="prob",
                        split_hi_thresh=hi, split_erode=er,
                        split_min_size=ms)
                   for hi in parse_floats(args.split_hi_grid)
                   for er in parse_ints(args.split_erode_grid)
                   for ms in parse_ints(args.split_min_size_grid)]
    else:
        split_g = [dict()]

    sf_g = tuple(s.strip() for s in args.size_filter_grid.split(",")
                 if s.strip()) or ("pre",)
    configs = []
    for ct, et, ms, gi, sf, sp in itertools.product(cell_g, edge_g, min_g,
                                                    grow_g, sf_g, split_g):
        cfg = dict(cell_thresh=ct, edge_thresh=et, min_cell_size=ms,
                   grow_iters=gi, size_filter=sf, fov=args.fov, **sp)
        configs.append(cfg)
    base_cfg = dict(cell_thresh=0.5, edge_thresh=0.3,
                    min_cell_size=args.min_cell_size,
                    grow_iters=args.grow_iters, fov=args.fov)

    ds_gt = os.path.join(args.gt_root, args.dataset)
    seqs = sorted(d[:-3] for d in os.listdir(ds_gt) if d.endswith("_GT"))
    if args.seqs:
        keep = set(s.strip() for s in args.seqs.split(","))
        seqs = [s for s in seqs if s in keep]

    base = defaultdict(lambda: [0.0, 0])     # saved-mask baseline
    totals = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    checked = 0
    mismatched = 0
    n_frames = 0
    for seq in seqs:
        gt_dir = os.path.join(ds_gt, f"{seq}_GT", "SEG")
        pred_dir = os.path.join(args.pred_root, args.dataset, f"{seq}_RES")
        inter = os.path.join(pred_dir, "intermediate")
        if not os.path.isdir(inter):
            print(f"seq {seq}: no dumps at {inter} — skipped", flush=True)
            continue
        frames_done = 0
        for gp in sorted(glob.glob(os.path.join(gt_dir, "man_seg*.tif"))):
            t = int(re.search(r"(\d+)\.tif$", gp).group(1))
            probp = os.path.join(inter, f"probs{t:03d}.npy")
            if not os.path.exists(probp):
                continue
            if args.limit_frames and frames_done >= args.limit_frames:
                break
            frames_done += 1
            gt = np.asarray(read_tiff(gp))
            probs = torch.from_numpy(np.load(probp)).to(device)
            # saved-mask baseline (what the producing run shipped)
            saved = None
            for fmt in ("mask%03d.tif", "mask%04d.tif"):
                mp = os.path.join(pred_dir, fmt % t)
                if os.path.exists(mp):
                    saved = np.asarray(read_tiff(mp))
                    break
            if saved is not None:
                s, n = seg_measure(gt, saved)
                base[seq][0] += s
                base[seq][1] += n
                if args.baseline_check and checked < len(seqs):
                    off = run_config(probs, base_cfg)
                    if not np.array_equal(off.astype(np.uint16), saved):
                        d = int((off.astype(np.uint16) != saved).sum())
                        print(f"BASELINE MISMATCH seq {seq} t={t}: {d} px "
                              f"differ — the dump run used OTHER postprocess "
                              f"flags than {base_cfg}", flush=True)
                        mismatched += 1
                    checked += 1
            for cfg in configs:
                lbl = run_config(probs, cfg)
                s2, n2 = seg_measure(gt, lbl)
                key = tuple(sorted(cfg.items()))
                totals[key][seq][0] += s2
                totals[key][seq][1] += n2
            n_frames += 1
        b = base[seq]
        if b[1]:
            print(f"saved-mask baseline seq {seq}: "
                  f"SEG {b[0] / b[1]:.4f}", flush=True)

    if not n_frames:
        print("no (GT, dump) frame pairs found — nothing swept")
        return 0

    def seq_mean(per_seq):
        vals = [v[0] / max(v[1], 1) for v in per_seq.values()]
        return sum(vals) / len(vals)

    base_mean = seq_mean(base) if base else float("nan")
    print(f"\nsaved-mask baseline mean (seq-avg): {base_mean:.4f} "
          f"over {n_frames} frames\n")
    rows = sorted(((seq_mean(per_seq), dict(key))
                   for key, per_seq in totals.items()), key=lambda r: -r[0])
    print(f"{'mean':>7} {'delta':>8}  config")
    for m, cfg in rows:
        extra = ""
        if cfg.get("instance_split"):
            extra = (f" split(hi={cfg['split_hi_thresh']} "
                     f"er={cfg['split_erode']} ms={cfg['split_min_size']})")
        if cfg.get("size_filter", "pre") != "pre":
            extra += f" sf={cfg['size_filter']}"
        print(f"{m:7.4f} {m - base_mean:+8.4f}  cell={cfg['cell_thresh']:.2f} "
              f"edge={cfg['edge_thresh']:.2f} min={cfg['min_cell_size']} "
              f"grow={cfg['grow_iters']}{extra}", flush=True)

    if args.json_out:
        payload = {
            "baseline_mean": base_mean,
            "baseline_per_seq": {s: v[0] / max(v[1], 1)
                                 for s, v in base.items()},
            "n_frames": n_frames,
            "rows": [{"mean": m, "config": cfg,
                      "per_seq": {s: v[0] / max(v[1], 1) for s, v in
                                  totals[tuple(sorted(cfg.items()))].items()}}
                     for m, cfg in rows],
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"json written: {args.json_out}")
    return 1 if mismatched else 0


if __name__ == "__main__":
    raise SystemExit(main())
