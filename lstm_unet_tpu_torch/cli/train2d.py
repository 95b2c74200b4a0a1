"""Training CLI of the PyTorch port.

Same flags as ``python -m lstm_unet_tpu.cli.train2d``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path; ``cuda`` without a
GPU raises). Every flag maps onto the :class:`CTCParams` knob of its name;
knobs without a flag (``elastic_augmentation``, ``spike_warmup``, ...) come
from ``--recipe``, as in the reference. ``--mesh_shape`` (``'{"data": N}'``,
``'{"data": N, "spatial": M}'``) trains over the ranks of a multi-process
run; ``--device cuda`` is then each rank's own card (``cuda:LOCAL_RANK``,
over nccl), a named card (``cuda:0``) one that the ranks share (over
gloo), and rank 0 alone writes the run's files. The flags of the
reference's TPU workarounds are accepted by the parser and raise
``NotImplementedError`` naming where ``ROADMAP.md`` tracks them.

Usage:
    python -m lstm_unet_tpu_torch.cli.train2d --root_data_dir ./data \\
        --train_sequence_list Fluo-N2DH-SIM+:01 --num_iterations 10000
    torchrun --nproc_per_node 2 -m lstm_unet_tpu_torch.cli.train2d --device cpu \\
        --mesh_shape '{"data": 2}' ...
"""

from __future__ import annotations

import argparse
import json

from ..config import CTCParams, NetKernelParams, load_recipe
from ..engine.train import Trainer
from ..parallel.distributed import initialize
from ..utils import log_print

_TPU_ONLY = "ROADMAP.md 'Do not port' (a workaround of the TPU or its client)"

# flag -> where the roadmap tracks it; given on the command line, each raises
_UNPORTED_FLAGS = {
    "conv_method": _TPU_ONLY, "entry_layouts": _TPU_ONLY,
    "compact_upload": _TPU_ONLY, "rss_relaunch_gb": _TPU_ONLY,
}


def _parse_seq_list(s: str):
    """'Fluo-N2DH-SIM+:01,Fluo-N2DH-SIM+:02' -> [(dataset, seq), ...]."""
    return [tuple(item.rsplit(":", 1)) for item in s.split(",")]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (hand-written kernels) or 'cpu' (plain "
                         "PyTorch); 'cuda' without a GPU raises")
    ap.add_argument("--experiment_name", type=str)
    ap.add_argument("--root_save_dir", type=str)
    ap.add_argument("--root_data_dir", type=str)
    ap.add_argument("--train_sequence_list", type=_parse_seq_list,
                    help="e.g. 'Fluo-N2DH-SIM+:01,Fluo-N2DH-SIM+:02'")
    ap.add_argument("--val_sequence_list", type=_parse_seq_list)
    ap.add_argument("--crop_size", type=int, nargs=2)
    ap.add_argument("--batch_size", type=int)
    ap.add_argument("--unroll_len", type=int)
    ap.add_argument("--learning_rate", type=float)
    ap.add_argument("--grad_clip_norm", type=float)
    ap.add_argument("--num_iterations", type=int)
    ap.add_argument("--class_weights", type=float, nargs=3)
    ap.add_argument("--net_kernel_params", type=str,
                    help="JSON file or inline JSON with the architecture")
    ap.add_argument("--validation_interval", type=int)
    ap.add_argument("--print_to_console_interval", type=int)
    ap.add_argument("--save_checkpoint_iteration", type=int)
    ap.add_argument("--write_to_tb_interval", type=int)
    ap.add_argument("--dry_run", action="store_true", default=None)
    ap.add_argument("--watchdog_secs", type=float,
                    help="exit 17 if no train step completes for this many "
                         "seconds; 0 disables")
    ap.add_argument("--dtype", type=str, choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true", default=None)
    ap.add_argument("--remat_policy", type=str, choices=["full", "save_outputs"])
    ap.add_argument("--gt_is_full_seg", type=lambda s: s.lower() == "true",
                    default=None, help="override the full-annotation heuristic")
    ap.add_argument("--recipe", type=str, default=None,
                    help="knob recipe JSON; the training keys it carries apply "
                         "before explicit flags")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load_checkpoint", action="store_true", default=None,
                    help="start from a checkpoint: --load_checkpoint_path (a seeded "
                         "fine-tune), else the run's own")
    ap.add_argument("--load_checkpoint_path", type=str,
                    help="the seed's save dir or run dir (with --load_checkpoint)")
    ap.add_argument("--continue_run", action="store_true", default=None,
                    help="resume the latest run of --experiment_name to its total-step "
                         "target (target_step.json)")
    ap.add_argument("--profile", action="store_true", default=None,
                    help="trace the 11th-16th steps into the run's logs dir")
    ap.add_argument("--spike_factor", type=float,
                    help="roll back to the last checkpoint when the train loss exceeds "
                         "this factor x its EMA; 0 disables")
    ap.add_argument("--spike_cooldown", type=int)
    ap.add_argument("--spike_max_rollbacks", type=int)
    ap.add_argument("--adam_mu_dtype", type=str, choices=["float32", "bfloat16"],
                    help="Adam first-moment storage dtype (nu stays f32)")
    ap.add_argument("--data_provider_class", type=str,
                    choices=["CTCRAMReaderSequence2D", "GrainCTCReaderSequence2D"],
                    help="the threaded reader, or the deterministic one whose batch is "
                         "a function of (seed, step), so a resumed run replays the stream")
    ap.add_argument("--mesh_shape", type=json.loads,
                    help="JSON, e.g. '{\"data\": 2, \"spatial\": 2}': train over the "
                         "ranks of a multi-process run")
    # not ported: accepted, then rejected by name in main()
    ap.add_argument("--rss_relaunch_gb", type=float)
    ap.add_argument("--compact_upload", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--conv_method", type=str, choices=["conv", "dots", "auto"])
    ap.add_argument("--entry_layouts", action="store_true", default=None)
    return ap


def main(argv=None) -> Trainer:
    """Train as the flags say; returns the trainer (its ``history`` and
    ``last_val_metrics`` hold what was printed)."""
    args = vars(build_parser().parse_args(argv))
    device = args.pop("device")
    seed = args.pop("seed")
    recipe = args.pop("recipe")
    nkp = args.pop("net_kernel_params")
    for flag, where in _UNPORTED_FLAGS.items():
        if args.pop(flag) is not None:
            raise NotImplementedError(f"--{flag} is not ported yet: {where}")
    params = CTCParams()
    if recipe:
        params.override(**load_recipe(recipe, known=set(vars(params))))
    if nkp:
        try:
            d = json.loads(nkp)
        except json.JSONDecodeError:
            with open(nkp) as f:
                d = json.load(f)
        params.net_kernel_params = NetKernelParams.from_dict(d)
    for k in ("crop_size", "class_weights"):
        if args.get(k):
            args[k] = tuple(args[k])
    params.override(**args)
    trainer = Trainer(params, seed=seed, device=initialize(device))
    log_print(f"training: save_dir={params.experiment_save_dir}")
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
