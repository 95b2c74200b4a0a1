"""The output check's control and planted faults, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --variants int4,frozen

Puts the plain reference in the program's place, computed one precision
below what the configuration states (``int4`` for an int8 configuration,
``fp8`` for a bf16 one), or with a fault planted (``frozen``: a step that
returns its state unchanged; ``altered``: the labels altered where they are
produced, one pixel made an instance of its own; ``halfbatch``: half of the batch
left out, the mean taken over the rest, which is half of the TTA variants
in a stream, half of the lanes in training), and prints, a line per seed
and variant, the numbers the check compares, read as a run reads them: a
streaming control streams the cell's ``check_frames`` frames from the zero
state. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _nhwc(state: List) -> List:
    return [[tuple(t.permute(0, 2, 3, 1) for t in pair) for pair in lvl] for lvl in state]


def stream_numbers(cell, seed: int, variant: str, device) -> Dict[str, float]:
    import numpy as np

    from portbench.harness import stream, traffic
    from portbench.reference import postprocess as ref_post

    frames = traffic.sequence(cell.traffic, seed)[0]
    judge = stream.ReferenceStream(cell, seed, frames, device)
    quant = cell.config["quant"] if cell.config["quant"] != "none" else "float"
    prec = variant if variant in ("int4", "fp8") else quant
    ctl = stream.ReferenceStream(cell, seed, frames, device, precision=prec, head=judge.head)
    if variant == "halfbatch" and not ctl.tta:
        raise ValueError("halfbatch needs a batch: a TTA stream")

    raws, outputs, state = [], [], None
    for t in range(cell.traffic["check_frames"]):
        raw = frames[t:t + 1]
        new, logits = ctl.step(state, raw)
        probs = (_half_mean(logits) if variant == "halfbatch"
                 else stream.reference_probs(ctl.cell, logits))
        labels = np.stack([ref_post.postprocess(p, ctl.params) for p in probs.cpu().numpy()])
        if variant == "altered":
            labels = _one_pixel_instance(labels)
        if variant != "frozen":  # frozen: every step reads the zero state
            state = new
        raws.append(raw)
        outputs.append((labels, probs.cpu()))
    return stream.compare(judge, raws, outputs)


def _half_mean(logits):
    import torch

    p = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    v = p.reshape((4, -1) + p.shape[1:])
    return torch.stack([v[0], v[1].flip(1)]).mean(dim=0)


def _one_pixel_instance(labels):
    out = labels.copy()
    for lane in out:
        lane[0, 0] = lane.max() + 1
    return out


def train_numbers(cell, seed: int, variant: str, device) -> Dict[str, float]:
    from portbench.harness import train

    n = cell.traffic["check_steps"]
    judge = train.reference_readings(train.ReferenceTraining(cell, seed, device), n)
    ctl = train.ReferenceTraining(cell, seed, device,
                                  precision="fp8" if variant == "fp8" else "float",
                                  half_batch=variant == "halfbatch")
    readings = train.reference_readings(ctl, n)
    readings["states"] = {k: _nhwc(v) for k, v in readings["states"].items()}
    if variant == "frozen":
        readings["change"] = {k: 0.0 for k in readings["change"]}
    return train.compare(readings, judge)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench.harness.cell import load

    cell = load(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            if cell.mode == "stream":
                numbers = stream_numbers(cell, seed, variant, device)
            else:
                numbers = train_numbers(cell, seed, variant, device)
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": variant,
                              "numbers": numbers}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
