"""K1's and K2's share of their bytes bound (``csrc/lstm_gates.cu``, the
ConvLSTM gate update and its backward) in training: the summed bound of a
step's launches (``harness/arith.py::lstm_gates_bound_s``; two forward
passes under full remat) times the steps profiled, over the two kernels'
device time in the trace, in %."""

from portbench.harness import arith


def read(run):
    t = run.kernel_s("gate_update_kernel", "gate_update_bwd_kernel")
    if t <= 0:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    h, w = tr["crop"]
    passes = 2 if tr["remat"] else 1
    bound = arith.lstm_gates_bound_s(cfg, h, w, tr["batch"], tr["unroll"], cfg["dtype"],
                                     passes)
    return 100.0 * bound * run.units / t
