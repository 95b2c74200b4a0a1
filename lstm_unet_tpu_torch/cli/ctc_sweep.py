"""Sweep every CTC sequence under a root through the port, batched.

Same flags as ``python -m lstm_unet_tpu.cli.ctc_sweep``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Each sequence gets
a ``<output_root>/<dataset>/<seq>_RES`` dir of masks. Sequences are grouped
by frame shape, sorted by length within a group and streamed in chunks of
``--max_batch`` lanes (``engine/infer.py::run_inference_batched``), so a
short lane idles behind a long one as little as possible. ``--score_seg`` /
``--score_det`` then score each sequence against its ``_GT`` (DET against
``TRA`` markers where present, else ``SEG``).

``--recipe`` overlays a knob recipe; a flag given on the command line wins
over its key. A token names an option when it is the option string, or a
strict prefix of exactly one option string (argparse's abbreviation), so
``--tta`` does not also claim ``--tta_mode``. ``--conv_method`` and
``--entry_layouts`` are TPU lowering knobs: accepted at their defaults,
anything else raises ``NotImplementedError``.

Usage:
    python -m lstm_unet_tpu_torch.cli.ctc_sweep --model_path MODEL_DIR \
        --root_data_dir ./data/CTC --output_root ./results
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from collections import defaultdict

from ..checkpoint.convert import load_model
from ..config import InferenceParams, load_recipe
from ..engine.infer import calibrate_model_dir, run_inference_batched
from ..io.dataset import _frame_index
from ..io.tiff import read_tiff
from ..metrics import det_measure_sequence, seg_measure_sequence
from ..utils import log_print, resolve_device
from .inference2d import _TPU_ONLY


def find_sequences(root: str):
    """Yield (dataset, seq, seq_dir) for every CTC sequence under root."""
    for ds in sorted(os.listdir(root)):
        ds_dir = os.path.join(root, ds)
        if not os.path.isdir(ds_dir):
            continue
        for seq in sorted(os.listdir(ds_dir)):
            seq_dir = os.path.join(ds_dir, seq)
            if (os.path.isdir(seq_dir) and not seq.endswith(("_GT", "_ST", "_RES"))
                    and glob.glob(os.path.join(seq_dir, "t*.tif"))):
                yield ds, seq, seq_dir


def _aligned_gt_pred(gt_dir: str, pattern: str, out_dir: str):
    """The GT frames of ``gt_dir`` matching ``pattern`` (which may be sparse)
    paired with the masks of ``out_dir`` of the same frame index."""
    idx_re = re.compile(re.escape(pattern).replace(r"\*", r"(\d+)") + "$")
    gts, preds = [], []
    for g in sorted(glob.glob(os.path.join(gt_dir, pattern))):
        idx = _frame_index(g, idx_re)
        if idx is None:
            continue
        for fmt in ("mask%03d.tif", "mask%04d.tif"):
            mp = os.path.join(out_dir, fmt % idx)
            if os.path.exists(mp):
                gts.append(read_tiff(g))
                preds.append(read_tiff(mp))
                break
    return gts, preds


# paths and stage control: never taken from a recipe
_RECIPE_INFRA = {"model_path", "root_data_dir", "output_root", "seqs", "ckpt_step",
                 "calibrate", "watchdog_secs", "recipe", "save_intermediate", "score_seg",
                 "score_det", "device", "help"}


def explicit_dests(ap: argparse.ArgumentParser, argv) -> set:
    """The dests of the options named on the command line ``argv``: a token
    names an option when it equals one of its strings, or else is a strict
    prefix of exactly one option string of the parser."""
    options = {o: a.dest for a in ap._actions for o in a.option_strings}
    out = set()
    for tok in argv:
        if not tok.startswith("--") or len(tok) <= 2:
            continue
        tok = tok.split("=", 1)[0]
        if tok in options:
            out.add(options[tok])
            continue
        hits = [o for o in options if o.startswith(tok)]
        if len(hits) == 1:
            out.add(options[hits[0]])
    return out


def apply_recipe(ap: argparse.ArgumentParser, args: argparse.Namespace, argv=None) -> dict:
    """Overlay ``args.recipe``'s knobs onto ``args`` in place, except those
    given on the command line; returns what was applied."""
    if not args.recipe:
        return {}
    knob_dests = {a.dest for a in ap._actions} - _RECIPE_INFRA
    recipe = load_recipe(args.recipe, known=knob_dests)
    explicit = explicit_dests(ap, sys.argv[1:] if argv is None else argv)
    applied = {k: v for k, v in recipe.items() if k not in explicit}
    for k, v in applied.items():
        setattr(args, k, v)
    skipped = {k: v for k, v in recipe.items() if k in explicit}
    log_print(f"recipe {args.recipe}: {applied}"
              + (f" (explicit flags win over {skipped})" if skipped else ""))
    return applied


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--root_data_dir", type=str, required=True)
    ap.add_argument("--output_root", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (hand-written kernels) or 'cpu' (plain PyTorch); "
                         "'cuda' without a GPU raises")
    ap.add_argument("--min_cell_size", type=int, default=10)
    ap.add_argument("--FOV", type=int, default=0)
    ap.add_argument("--cell_thresh", type=float, default=0.5)
    ap.add_argument("--edge_thresh", type=float, default=0.3)
    ap.add_argument("--boundary_growth", type=str, default="marker",
                    choices=["marker", "dilate", "none"])
    ap.add_argument("--grow_iters", type=int, default=0)
    ap.add_argument("--conv_method", type=str, default="conv", choices=["conv", "dots", "auto"],
                    help="a TPU lowering knob: only its default is accepted")
    ap.add_argument("--entry_layouts", action="store_true",
                    help="a TPU layout knob: rejected")
    ap.add_argument("--tta", action="store_true",
                    help="average the probabilities of the 4 flip variants")
    ap.add_argument("--tta_mode", type=str, default="flip", choices=("flip", "d4"),
                    help="'d4' adds the 4 transposed variants (frames pad square)")
    ap.add_argument("--instance_split", action="store_true",
                    help="split merged components of touching cells")
    ap.add_argument("--size_filter", type=str, default="pre", choices=("pre", "post"))
    ap.add_argument("--split_method", type=str, default="dist", choices=("dist", "prob"))
    ap.add_argument("--split_window", type=int, default=16)
    ap.add_argument("--split_min_dist", type=int, default=4)
    ap.add_argument("--split_slack", type=int, default=1)
    ap.add_argument("--split_rel", type=float, default=0.65)
    ap.add_argument("--split_rel_window", type=int, default=48)
    ap.add_argument("--split_min_size", type=int, default=0)
    ap.add_argument("--split_hi_thresh", type=float, default=0.8)
    ap.add_argument("--split_erode", type=int, default=1)
    ap.add_argument("--pre_sequence_frames", type=int, default=4)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--int8_keep_float", type=str, default="",
                    help="comma-separated site prefixes kept float in an int8 run")
    ap.add_argument("--state_dtype", type=str, default="auto",
                    choices=["auto", "float32", "bfloat16"])
    ap.add_argument("--fused_cell", action="store_true",
                    help="fused ConvLSTM kernel at the levels it supports")
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--reset_on_jump", type=float, default=0.0,
                    help="zero the LSTM state at a scene cut (mean abs frame delta "
                         "threshold; 0 = off)")
    ap.add_argument("--save_intermediate", action="store_true",
                    help="also save per-frame probabilities in <seq>_RES/intermediate/")
    ap.add_argument("--score_seg", action="store_true",
                    help="score SEG against <seq>_GT/SEG where present")
    ap.add_argument("--score_det", action="store_true",
                    help="score DET against <seq>_GT/TRA markers, else <seq>_GT/SEG")
    ap.add_argument("--seqs", type=str, default="",
                    help="comma-separated sequence names to sweep; default: all")
    ap.add_argument("--ckpt_step", type=int, default=0,
                    help="saved step of a training run's dir (0 = latest)")
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="int8: first calibrate the activation scales on the first N "
                         "frames of the first sequence (writes act_scales.json into "
                         "--model_path)")
    ap.add_argument("--watchdog_secs", type=float, default=0.0,
                    help="exit 17 when no frame completes for this many seconds; "
                         "0 disables")
    ap.add_argument("--recipe", type=str, default="",
                    help="knob recipe JSON; explicit flags win over its keys")
    return ap


def score(pairs, seg: bool, det: bool) -> None:
    """Log SEG and DET of each (seq_dir, out_dir) against its ``_GT``."""
    for seq_dir, out_dir in pairs:
        if seg:
            gts, preds = _aligned_gt_pred(seq_dir + "_GT/SEG", "man_seg*.tif", out_dir)
            if gts:
                log_print(f"SEG {seq_dir}: {seg_measure_sequence(gts, preds):.4f} "
                          f"({len(gts)} annotated frames)")
        if det:
            gts, preds = _aligned_gt_pred(seq_dir + "_GT/TRA", "man_track*.tif", out_dir)
            if not gts:
                gts, preds = _aligned_gt_pred(seq_dir + "_GT/SEG", "man_seg*.tif", out_dir)
            if gts:
                log_print(f"DET {seq_dir}: {det_measure_sequence(gts, preds):.4f} "
                          f"({len(gts)} annotated frames)")


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    apply_recipe(ap, args, argv)
    if args.conv_method != "conv" or args.entry_layouts:
        raise NotImplementedError(
            f"--conv_method {args.conv_method} / --entry_layouts {args.entry_layouts} "
            f"are not ported: {_TPU_ONLY}")
    device = resolve_device(args.device)

    if args.calibrate and args.dtype != "int8":
        # only an int8 run reads the scales: leave the model dir as it is
        log_print(f"--calibrate ignored: dtype={args.dtype} (int8 only)")
        args.calibrate = 0
    if args.calibrate:
        first = next(iter(find_sequences(args.root_data_dir)), None)
        if first is None:
            raise FileNotFoundError(f"no CTC sequences under {args.root_data_dir}")
        calibrate_model_dir(args.model_path, first[2], n_frames=args.calibrate,
                            step=args.ckpt_step or None, device=device)

    names = ("min_cell_size", "FOV", "cell_thresh", "edge_thresh", "boundary_growth",
             "grow_iters", "instance_split", "size_filter", "tta", "tta_mode",
             "split_method", "split_window", "split_min_dist", "split_slack", "split_rel",
             "split_rel_window", "split_min_size", "split_hi_thresh", "split_erode",
             "pre_sequence_frames", "watchdog_secs", "save_intermediate", "dtype",
             "state_dtype", "fused_cell", "reset_on_jump", "int8_keep_float", "ckpt_step")
    ip = InferenceParams(model_path=args.model_path, **{k: getattr(args, k) for k in names})
    model = load_model(args.model_path, device, dtype=args.dtype,
                       state_dtype=args.state_dtype, fused_cell=args.fused_cell,
                       step=args.ckpt_step or None)

    keep = {s.strip() for s in args.seqs.split(",") if s.strip()}
    groups = defaultdict(list)  # frame shape -> [(n_frames, seq_dir, out_dir)]
    for ds, seq, seq_dir in find_sequences(args.root_data_dir):
        if keep and seq not in keep:
            continue
        frames = sorted(glob.glob(os.path.join(seq_dir, "t*.tif")))
        out_dir = os.path.join(args.output_root, ds, f"{seq}_RES")
        groups[read_tiff(frames[0]).shape].append((len(frames), seq_dir, out_dir))

    total, pairs = 0, []
    for shape, items in groups.items():
        items = [(s, o) for _, s, o in sorted(items, key=lambda x: x[0])]
        log_print(f"sweep: {len(items)} sequence(s) at {shape}")
        for i in range(0, len(items), args.max_batch):
            chunk = items[i:i + args.max_batch]
            total += run_inference_batched(ip, [s for s, _ in chunk], [o for _, o in chunk],
                                           device=device, model=model)
            pairs.extend(chunk)
    log_print(f"sweep complete: {total} masks")
    if args.score_seg or args.score_det:
        score(pairs, args.score_seg, args.score_det)
    return total


if __name__ == "__main__":
    main()
