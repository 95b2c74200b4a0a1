"""The streaming step's share of the card's peak: the frozen model-flop
count of a frame (``harness/arith.py::conv_flops``) times the model lanes a
frame (TTA variants count) times frames/s of the unprofiled stretch, over
the dense peak of the dtype the convs run in (int8 or bf16), in %."""

from portbench.harness import arith


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    dtype = "int8" if cfg["quant"] == "int8" else cfg["dtype"]
    flops = arith.conv_flops(cfg, tr["height"], tr["width"]) * run.lanes * run.rate
    return 100.0 * flops / arith.PEAK_FLOPS[dtype]
