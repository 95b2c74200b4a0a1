"""Two-invocation postprocess calibration: sweep on VAL, confirm on eval.

Counterpart of the reference's ``scripts/calibrate_recipe.py``, with its
flags, grids and result JSON, plus ``--device`` (default ``cuda``), passed to
each ``postprocess_sweep`` child. It recalibrates the joint postprocess
recipe for each retrained model:

1. sweep the joint grid (threshold x size_filter x optional prob-split) on
   the VAL sequence's probability dumps (the sequence train2d validated on
   — never part of eval), with ``--baseline_check``;
2. take the single best-on-VAL config, pre-registered by construction;
3. re-run exactly that config once on the held-out eval dumps and report
   its mean next to the eval saved-mask baseline.

Sweeping directly on eval and reporting its max would be selection on the
test set; this tool never ranks on eval (the eval invocation has singleton
grids).

Usage (after ctc_sweep --save_intermediate produced both dump trees):
    python -m lstm_unet_tpu_torch.scripts.calibrate_recipe \
        --gt_root_val HELDOUT/train --pred_root_val VAL_DUMPS --val_seqs 03 \
        --gt_root_eval HELDOUT/eval --pred_root_eval EVAL_DUMPS \
        --out recipe_calibration.json
Prints one final JSON line: {"val_best": ..., "winner": {...}, "eval_mean":
..., "eval_baseline": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from ..utils import resolve_device

# the dir that holds the package: the children import it from there
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP = "lstm_unet_tpu_torch.scripts.postprocess_sweep"

# the reference's joint grid: a flat plateau around its winner, so a coarse
# grid suffices; the no-split configs get a pass of their own
CELL_GRID = "0.5,0.55,0.6"
EDGE_GRID = "0.25,0.3,0.35"
SF_GRID = "pre,post"
SPLIT_HI_GRID = "0.75,0.8,0.85"
SPLIT_MS_GRID = "2500,3500,4500"


def child_env() -> dict:
    """The environment of a child process: this one's, with the package's
    dir first on ``PYTHONPATH``."""
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def run_sweep(gt_root: str, pred_root: str, seqs: str, json_out: str,
              grids: dict, min_cell: int, grow: int,
              baseline_check: bool = False, device: str = "cuda") -> dict:
    cmd = [sys.executable, "-m", SWEEP, "--gt_root", gt_root,
           "--pred_root", pred_root, "--min_cell_size", str(min_cell),
           "--grow_iters", str(grow), "--json_out", json_out,
           "--device", device]
    if seqs:
        cmd += ["--seqs", seqs]
    if baseline_check:
        cmd += ["--baseline_check"]
    for k, v in grids.items():
        cmd += [f"--{k}", str(v)]
    r = subprocess.run(cmd, text=True, capture_output=True, env=child_env())
    sys.stderr.write(r.stdout[-3000:] + r.stderr[-2000:])
    if r.returncode != 0:
        raise RuntimeError(f"sweep failed rc={r.returncode}")
    with open(json_out) as f:
        return json.load(f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gt_root_val", required=True)
    ap.add_argument("--pred_root_val", required=True)
    ap.add_argument("--val_seqs", default="03")
    ap.add_argument("--gt_root_eval", required=True)
    ap.add_argument("--pred_root_eval", required=True)
    ap.add_argument("--eval_seqs", default="")
    ap.add_argument("--min_cell_size", type=int, default=50)
    ap.add_argument("--grow_iters", type=int, default=0)
    ap.add_argument("--cell_grid", default=CELL_GRID)
    ap.add_argument("--edge_grid", default=EDGE_GRID)
    ap.add_argument("--size_filter_grid", default=SF_GRID)
    ap.add_argument("--split_hi_grid", default=SPLIT_HI_GRID)
    ap.add_argument("--split_min_size_grid", default=SPLIT_MS_GRID)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run: 'cuda' (the hand kernels) or "
                         "'cpu' (plain PyTorch); 'cuda' without a GPU raises")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU for 'cuda': raise here, not in a child

    tmp = tempfile.mkdtemp(prefix="calib_")

    # VAL: joint grid WITH the prob-split stage, and WITHOUT it (split_hi
    # nonempty forces instance_split on, so no-split needs its own pass)
    common = dict(cell_grid=args.cell_grid, edge_grid=args.edge_grid,
                  size_filter_grid=args.size_filter_grid)
    val_split = run_sweep(args.gt_root_val, args.pred_root_val, args.val_seqs,
                          os.path.join(tmp, "val_split.json"),
                          dict(common, split_hi_grid=args.split_hi_grid,
                               split_erode_grid="1",
                               split_min_size_grid=args.split_min_size_grid),
                          args.min_cell_size, args.grow_iters,
                          baseline_check=True, device=args.device)
    val_plain = run_sweep(args.gt_root_val, args.pred_root_val, args.val_seqs,
                          os.path.join(tmp, "val_plain.json"), common,
                          args.min_cell_size, args.grow_iters,
                          device=args.device)
    rows = val_split["rows"] + val_plain["rows"]
    rows.sort(key=lambda r: -r["mean"])
    winner = rows[0]
    cfg = winner["config"]

    # eval: the single pre-registered winner (singleton grids — no ranking)
    eval_grids = dict(cell_grid=str(cfg["cell_thresh"]),
                      edge_grid=str(cfg["edge_thresh"]),
                      size_filter_grid=cfg.get("size_filter", "pre"))
    if cfg.get("instance_split"):
        eval_grids.update(split_hi_grid=str(cfg["split_hi_thresh"]),
                          split_erode_grid=str(cfg["split_erode"]),
                          split_min_size_grid=str(cfg["split_min_size"]))
    ev = run_sweep(args.gt_root_eval, args.pred_root_eval, args.eval_seqs,
                   os.path.join(tmp, "eval_confirm.json"), eval_grids,
                   cfg["min_cell_size"], cfg["grow_iters"], device=args.device)
    ev_row = ev["rows"][0]

    result = {
        "val_best": winner["mean"],
        "val_baseline": val_split["baseline_mean"],
        "winner": cfg,
        "eval_mean": ev_row["mean"],
        "eval_per_seq": ev_row["per_seq"],
        "eval_baseline": ev["baseline_mean"],
        "eval_baseline_per_seq": ev["baseline_per_seq"],
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
