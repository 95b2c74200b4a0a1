"""The int8 convs' share of their roofline (``csrc/conv_int8_wgmma.cu``,
``csrc/conv_int8_smallk.cu``, ``csrc/conv_int8.cu``): the summed bound of a
frame's int8 conv sites (``harness/arith.py::int8_conv_bound_s``) times the
frames profiled, over the device time of the int8 conv kernels in the
trace, in %. Nothing to read where no int8 conv ran."""

from portbench.harness import arith


def read(run):
    t = run.kernel_s("conv_int8")
    if t <= 0:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    bound = arith.int8_conv_bound_s(cfg, tr["height"], tr["width"], run.lanes,
                                    cfg["fused_cell"])
    return 100.0 * bound * run.units / t
