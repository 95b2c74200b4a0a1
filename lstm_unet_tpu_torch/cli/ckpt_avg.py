"""Average saved checkpoint steps into a new model dir ("model soup").

Same flags as ``python -m lstm_unet_tpu.cli.ckpt_avg``, on the port's
checkpoint format (``checkpoint/ckpt.py::average_checkpoints``). The output
dir holds ``model_params.json`` and one params-only step, and is a model dir
that ``inference2d`` and ``ctc_sweep`` ``--model_path`` read. An int8 run of
it needs its own calibration (``--calibrate``): ``act_scales.json`` is not
copied.

Usage:
    python -m lstm_unet_tpu_torch.cli.ckpt_avg --model_path runs/MyRun_X \
        --output_dir runs/MyRun_X/soup --steps 4000,5000,6000
"""

from __future__ import annotations

import argparse

from ..checkpoint.ckpt import average_checkpoints
from ..utils import log_print


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True,
                    help="a training run's save dir (step dirs + model_params.json) "
                         "or the run dir above it")
    ap.add_argument("--output_dir", type=str, required=True,
                    help="the new model dir for the averaged checkpoint")
    ap.add_argument("--steps", type=str, default="",
                    help="comma-separated steps to average (default: all saved)")
    ap.add_argument("--out_step", type=int, default=None,
                    help="step number of the average (default: the newest averaged)")
    args = ap.parse_args(argv)
    steps = [int(s) for s in args.steps.split(",") if s.strip()] or None
    out_step = average_checkpoints(args.model_path, args.output_dir, steps=steps,
                                   out_step=args.out_step)
    log_print(f"averaged {steps or 'all saved steps'} from {args.model_path} -> "
              f"{args.output_dir} (step {out_step})")
    return out_step


if __name__ == "__main__":
    main()
