"""Inference CLI of the PyTorch port.

Same flags as ``python -m lstm_unet_tpu.cli.inference2d``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). ``--dtype int8``
runs the convs as int8 (dynamic scales, or the calibrated ones of
``act_scales.json`` in the model dir); ``--calibrate N`` first calibrates
them on the sequence's first N frames, on the same device;
``--int8_keep_float`` keeps sites float. ``--tta`` averages the flip
(``--tta_mode d4``: the dihedral) variants of each frame; ``--reset_on_jump X``
zeroes the LSTM state at a scene cut. A recipe's ``mesh_shape`` (``{"data":
N}``, ``{"data": N, "spatial": M}``) splits the stream over the ranks of a
multi-process run, as the reference reads it from the recipe; ``--device
cuda`` is then each rank's own card (``cuda:LOCAL_RANK``, over nccl), a
named card (``cuda:0``) one that the ranks share (over gloo). Flags of
features not ported are accepted by the parser and raise
``NotImplementedError`` naming where ``ROADMAP.md`` tracks them.

Usage:
    python -m lstm_unet_tpu_torch.cli.inference2d --model_path MODEL_DIR \
        --sequence_path data/Fluo-N2DH-SIM+/01 --output_path out/01_RES
    torchrun --nproc_per_node 2 -m lstm_unet_tpu_torch.cli.inference2d ... \
        --recipe mesh.json      # {"mesh_shape": {"spatial": 2}}
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import InferenceParams, load_recipe
from ..engine.infer import calibrate_model_dir, run_inference
from ..parallel.distributed import barrier, initialize, is_writer, world_size
from ..parallel.mesh import mesh_layout

_TPU_ONLY = "ROADMAP.md 'Do not port' (a TPU lowering or layout knob)"

# flag -> where the roadmap tracks it; given on the command line, each raises
_UNPORTED_FLAGS = {"conv_method": _TPU_ONLY, "entry_layouts": _TPU_ONLY}
# recipe key -> (value that leaves the feature off, roadmap item)
_UNPORTED_RECIPE = {"conv_method": ("conv", _TPU_ONLY), "entry_layouts": (False, _TPU_ONLY)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True,
                    help="dir with model_params.json + params.npz, or a port "
                         "training run's dir (its latest saved step)")
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
    ap.add_argument("--ckpt_step", type=int,
                    help="saved step of a training run's dir (0 = latest)")
    ap.add_argument("--instance_split", action="store_true", default=None,
                    help="split merged components of touching cells")
    ap.add_argument("--split_method", type=str, choices=("dist", "prob"),
                    help="'dist': distance-ridge markers; 'prob': markers from "
                         "the model's own p(cell) dips")
    for name, typ in (("split_hi_thresh", float), ("split_erode", int),
                      ("split_window", int), ("split_min_dist", int),
                      ("split_slack", int), ("split_rel", float),
                      ("split_rel_window", int), ("split_min_size", int)):
        ap.add_argument(f"--{name}", type=typ)
    ap.add_argument("--tta", action="store_true", default=None,
                    help="test-time augmentation: average the probabilities of "
                         "the frame's variants, streamed as extra lanes")
    ap.add_argument("--tta_mode", type=str, choices=("flip", "d4"),
                    help="'flip': 4 axis flips; 'd4': and their transposes (8, "
                         "frames pad square); needs --tta")
    ap.add_argument("--reset_on_jump", type=float,
                    help="zero the LSTM state when a frame's clipped mean "
                         "|delta| from the last exceeds this; 0 disables")
    # not ported: accepted, then rejected by name in main()
    ap.add_argument("--conv_method", type=str, choices=["conv", "dots", "auto"])
    ap.add_argument("--entry_layouts", action="store_true", default=None)
    ap.add_argument("--int8_keep_float", type=str,
                    help="comma-separated site prefixes kept float in an int8 "
                         "run (e.g. 'encoder/0,head')")
    ap.add_argument("--calibrate", type=int, metavar="N",
                    help="first calibrate the int8 activation scales on the "
                         "sequence's first N frames (writes act_scales.json into "
                         "--model_path; later int8 runs reuse it)")
    return ap


def main(argv=None) -> int:
    args = vars(build_parser().parse_args(argv))
    device = args.pop("device")
    recipe = args.pop("recipe")
    calibrate = args.pop("calibrate")
    for flag, where in _UNPORTED_FLAGS.items():
        if args.pop(flag) is not None:
            raise NotImplementedError(f"--{flag} is not ported yet: {where}")
    params = InferenceParams()
    if recipe:
        rec = load_recipe(recipe)
        for key, (off, where) in _UNPORTED_RECIPE.items():
            if rec.get(key, off) != off:
                raise NotImplementedError(
                    f"recipe key {key}={rec[key]!r} is not ported yet: {where}")
        known = {f.name for f in dataclasses.fields(params)}
        params.override(**{k: v for k, v in rec.items() if k in known})
    params.override(**args)
    device = initialize(device)
    if params.mesh_shape:  # refuse a mesh the run cannot hold before loading anything
        mesh_layout(params.mesh_shape, world_size())
    if calibrate:  # rank 0 writes act_scales.json; every rank then reads it
        if is_writer():
            calibrate_model_dir(params.model_path, params.sequence_path, n_frames=calibrate,
                                filename_format=params.filename_format,
                                step=params.ckpt_step or None, device=device)
        barrier()
    return run_inference(params, device=device)


if __name__ == "__main__":
    main()
