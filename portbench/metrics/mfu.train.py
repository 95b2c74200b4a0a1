"""The training step's share of the card's bf16 peak: the frozen model-flop
count of a step (``harness/arith.py::train_flops``, no remat recompute)
times steps/s of the unprofiled stretch, over the dtype's dense peak, in %."""

from portbench.harness import arith


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    h, w = tr["crop"]
    flops = arith.train_flops(cfg, h, w, tr["batch"], tr["unroll"]) * run.rate
    return 100.0 * flops / arith.PEAK_FLOPS[cfg["dtype"]]
