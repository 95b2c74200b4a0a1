"""K4's share of its roofline (``csrc/convlstm_wgmma.cu``, the fused
ConvLSTM level): the summed bound of a frame's K4 launches
(``harness/arith.py::convlstm_bound_s``, at the model's lanes) times the
frames profiled, over K4's device time in the trace, in %. Nothing to read
where K4 did not run."""

from portbench.harness import arith


def read(run):
    t = run.kernel_s("convlstm_wgmma")
    cfg, tr = run.cell.config, run.cell.traffic
    if t <= 0 or cfg["quant"] == "int8":
        return None
    bound = arith.convlstm_bound_s(cfg, tr["height"], tr["width"], run.lanes, cfg["dtype"])
    return 100.0 * bound * run.units / t
