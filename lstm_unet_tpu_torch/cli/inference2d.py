"""Inference CLI of the PyTorch port.

Same flags as ``python -m lstm_unet_tpu.cli.inference2d``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Flags of features
not ported yet are accepted by the parser and raise ``NotImplementedError``
naming where ``ROADMAP.md`` tracks them.

Usage:
    python -m lstm_unet_tpu_torch.cli.inference2d --model_path MODEL_DIR \
        --sequence_path data/Fluo-N2DH-SIM+/01 --output_path out/01_RES
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import InferenceParams, load_recipe
from ..engine.infer import run_inference

_INT8 = "ROADMAP.md queue 1 item 9 (int8 inference)"
_SPLIT = "ROADMAP.md queue 1 item 10 (instance splitting)"
_SURFACE = "ROADMAP.md queue 1 item 11 (TTA, reset_on_jump)"
_MESH = "ROADMAP.md queue 1 item 12 (parallelism)"
_TPU_ONLY = "ROADMAP.md 'Do not port' (a TPU lowering or layout knob)"

# flag -> where the roadmap tracks it; given on the command line, each raises
_UNPORTED_FLAGS = {
    "calibrate": _INT8, "int8_keep_float": _INT8,
    "tta": _SURFACE, "tta_mode": _SURFACE, "reset_on_jump": _SURFACE,
    "instance_split": _SPLIT, "split_method": _SPLIT, "split_hi_thresh": _SPLIT,
    "split_erode": _SPLIT, "split_window": _SPLIT, "split_min_dist": _SPLIT,
    "split_slack": _SPLIT, "split_rel": _SPLIT, "split_rel_window": _SPLIT,
    "split_min_size": _SPLIT,
    "conv_method": _TPU_ONLY, "entry_layouts": _TPU_ONLY,
}
# recipe key -> (value that leaves the feature off, roadmap item)
_UNPORTED_RECIPE = {
    "instance_split": (False, _SPLIT), "tta": (False, _SURFACE),
    "reset_on_jump": (0.0, _SURFACE), "int8_keep_float": ("", _INT8),
    "conv_method": ("conv", _TPU_ONLY), "entry_layouts": (False, _TPU_ONLY),
    "mesh_shape": ({}, _MESH),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True,
                    help="dir with model_params.json + params.npz")
    ap.add_argument("--sequence_path", type=str, required=True)
    ap.add_argument("--output_path", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (hand-written kernels) or 'cpu' (plain "
                         "PyTorch); 'cuda' without a GPU raises")
    ap.add_argument("--filename_format", type=str)
    ap.add_argument("--FOV", type=int)
    ap.add_argument("--min_cell_size", type=int)
    ap.add_argument("--max_cell_size", type=int)
    ap.add_argument("--cell_thresh", type=float)
    ap.add_argument("--edge_thresh", type=float)
    ap.add_argument("--boundary_growth", type=str,
                    choices=["marker", "dilate", "none"])
    ap.add_argument("--grow_iters", type=int)
    ap.add_argument("--size_filter", type=str, choices=("pre", "post"))
    ap.add_argument("--pre_sequence_frames", type=int)
    ap.add_argument("--save_intermediate", action="store_true", default=None)
    ap.add_argument("--save_intermediate_path", type=str)
    ap.add_argument("--dtype", type=str, choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--state_dtype", type=str,
                    choices=["auto", "float32", "bfloat16"])
    ap.add_argument("--fused_cell", action="store_true", default=None,
                    help="fused ConvLSTM kernel at the levels it supports")
    ap.add_argument("--digit_4", action="store_true", default=None)
    ap.add_argument("--watchdog_secs", type=float,
                    help="exit 17 when no frame completes for this many "
                         "seconds; 0 disables")
    ap.add_argument("--recipe", type=str,
                    help="knob recipe JSON; explicit flags win over its keys")
    ap.add_argument("--ckpt_step", type=int, help="only 0 (the exported step)")
    # not ported yet: accepted, then rejected by name in main()
    ap.add_argument("--conv_method", type=str, choices=["conv", "dots", "auto"])
    ap.add_argument("--entry_layouts", action="store_true", default=None)
    ap.add_argument("--tta", action="store_true", default=None)
    ap.add_argument("--tta_mode", type=str, choices=("flip", "d4"))
    ap.add_argument("--instance_split", action="store_true", default=None)
    ap.add_argument("--split_method", type=str, choices=("dist", "prob"))
    for name, typ in (("split_hi_thresh", float), ("split_erode", int),
                      ("split_window", int), ("split_min_dist", int),
                      ("split_slack", int), ("split_rel", float),
                      ("split_rel_window", int), ("split_min_size", int)):
        ap.add_argument(f"--{name}", type=typ)
    ap.add_argument("--int8_keep_float", type=str)
    ap.add_argument("--reset_on_jump", type=float)
    ap.add_argument("--calibrate", type=int, metavar="N")
    return ap


def main(argv=None) -> int:
    args = vars(build_parser().parse_args(argv))
    device = args.pop("device")
    recipe = args.pop("recipe")
    for flag, where in _UNPORTED_FLAGS.items():
        if args.pop(flag) is not None:
            raise NotImplementedError(f"--{flag} is not ported yet: {where}")
    if args["dtype"] == "int8":
        raise NotImplementedError(f"--dtype int8 is not ported yet: {_INT8}")
    params = InferenceParams()
    if recipe:
        rec = load_recipe(recipe)
        for key, (off, where) in _UNPORTED_RECIPE.items():
            if rec.get(key, off) != off:
                raise NotImplementedError(
                    f"recipe key {key}={rec[key]!r} is not ported yet: {where}")
        if rec.get("dtype") == "int8":
            raise NotImplementedError(f"recipe dtype int8 is not ported yet: {_INT8}")
        known = {f.name for f in dataclasses.fields(params)}
        params.override(**{k: v for k, v in rec.items() if k in known})
    params.override(**args)
    return run_inference(params, device=device)


if __name__ == "__main__":
    main()
