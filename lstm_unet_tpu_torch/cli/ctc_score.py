"""Score existing CTC result masks (SEG and/or DET); no model, no device.

Same flags and JSON as ``python -m lstm_unet_tpu.cli.ctc_score``, over the
CTC layout::

    <pred_root>/<dataset>/<seq>_RES/mask*.tif        uint16 instance labels
    <gt_root>/<dataset>/<seq>_GT/SEG/man_seg*.tif    SEG ground truth
    <gt_root>/<dataset>/<seq>_GT/TRA/man_track*.tif  DET markers (optional)

GT frames are paired with masks by frame index (the GT may be sparse), as
``ctc_sweep --score_seg`` does. DET scores against the TRA markers, else
against the SEG GT, and records which (``det_gt``: ``TRA`` or
``SEG-fallback``; a partially annotated SEG GT counts the unannotated cells
a model finds as false positives).

Usage:
    python -m lstm_unet_tpu_torch.cli.ctc_score --gt_root data/CTC \
        --pred_root results [--seg] [--det] [--json scores.json]
"""

from __future__ import annotations

import argparse
import json
import os

from ..metrics import det_measure_sequence, seg_measure_sequence
from ..utils import log_print
from .ctc_sweep import _aligned_gt_pred


def find_result_dirs(pred_root: str):
    """Yield (dataset, seq, res_dir) for every ``*_RES`` dir under pred_root."""
    for ds in sorted(os.listdir(pred_root)):
        ds_dir = os.path.join(pred_root, ds)
        if not os.path.isdir(ds_dir):
            continue
        for name in sorted(os.listdir(ds_dir)):
            if name.endswith("_RES") and os.path.isdir(os.path.join(ds_dir, name)):
                yield ds, name[:-4], os.path.join(ds_dir, name)


def score_sequence(gt_base: str, res_dir: str, seg: bool, det: bool) -> dict:
    """The scores of one ``_RES`` dir against its ``_GT`` dir ``gt_base``."""
    entry = {}
    if seg:
        gts, preds = _aligned_gt_pred(os.path.join(gt_base, "SEG"), "man_seg*.tif", res_dir)
        if gts:
            entry.update(seg=seg_measure_sequence(gts, preds), seg_frames=len(gts))
    if det:
        gts, preds = _aligned_gt_pred(os.path.join(gt_base, "TRA"), "man_track*.tif", res_dir)
        det_gt = "TRA"
        if not gts:
            gts, preds = _aligned_gt_pred(os.path.join(gt_base, "SEG"), "man_seg*.tif",
                                          res_dir)
            det_gt = "SEG-fallback"
        if gts:
            entry.update(det=det_measure_sequence(gts, preds), det_frames=len(gts),
                         det_gt=det_gt)
    return entry


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="score CTC masks (SEG/DET) against ground truth")
    ap.add_argument("--pred_root", required=True,
                    help="root holding <dataset>/<seq>_RES mask dirs")
    ap.add_argument("--gt_root", required=True,
                    help="root holding <dataset>/<seq>_GT ground truth")
    ap.add_argument("--seg", action="store_true", help="score SEG")
    ap.add_argument("--det", action="store_true",
                    help="score DET (TRA markers when present, else SEG GT)")
    ap.add_argument("--json", default="", help="also write the scores to this JSON file")
    args = ap.parse_args(argv)
    if not (args.seg or args.det):
        args.seg = args.det = True

    results = {}
    for ds, seq, res_dir in find_result_dirs(args.pred_root):
        gt_base = os.path.join(args.gt_root, ds, seq + "_GT")
        entry = score_sequence(gt_base, res_dir, args.seg, args.det)
        if not entry:
            log_print(f"skip {ds}/{seq}: no ground truth under {gt_base}")
            continue
        results[f"{ds}/{seq}"] = entry
        for key in ("seg", "det"):
            if key in entry:
                log_print(f"{key.upper()} {ds}/{seq}: {entry[key]:.4f} "
                          f"({entry[key + '_frames']} annotated frames)")
        if entry.get("det_gt") == "SEG-fallback":
            log_print(f"DET {ds}/{seq}: no TRA markers, scored against the SEG GT "
                      "(det_gt='SEG-fallback')")
    if not results:
        raise SystemExit(f"nothing scored: no GT-matched *_RES dirs under {args.pred_root}")
    per_seq = list(results.values())
    for key in ("seg", "det"):
        vals = [e[key] for e in per_seq if key in e]
        if vals:
            results[f"mean_{key}"] = sum(vals) / len(vals)
            log_print(f"{key.upper()} mean over {len(vals)} sequence(s): "
                      f"{results[f'mean_{key}']:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        log_print(f"wrote {args.json}")
    return results


if __name__ == "__main__":
    main()
