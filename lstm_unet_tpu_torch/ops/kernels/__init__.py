"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``lstm_unet_tpu/ops/pallas``. Each wrapper takes its plain
version for CPU tensors and launches its CUDA kernel for CUDA tensors, and
counts both in its :class:`_build.LaunchCount` (see :func:`counts`).

A CUDA graph (``engine/graph.py``) runs no wrapper when it is replayed, so
its launches are counted apart: :func:`record_capture` takes the launches
the wrappers counted while a graph was captured (which ran nothing) back
off the counts and returns them, :func:`record_replay` adds them once a
replay, and :func:`restore` takes back what a capture that failed counted.
:data:`GRAPHS` counts the captures and the replays (a traced twin's capture
apart, ``engine/graph.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import ccl, conv_int8, convlstm_cell, lstm_gates, postprocess_loops

# kernel name -> its launch count (the K numbering of the TPU kernel table)
KERNELS = {
    "lstm_gate_update": lstm_gates.COUNT,           # K1
    "lstm_gate_update_bwd": lstm_gates.BWD_COUNT,   # K2
    "ccl": ccl.COUNT,                               # K3, cluster route
    "ccl_grid": ccl.GRID_COUNT,                     # K3, grid route
    "fused_convlstm_level_wgmma": convlstm_cell.WGMMA_COUNT,  # K4, bf16 tensor cores
    "fused_convlstm_level_tf32x3": convlstm_cell.TF32X3_COUNT,  # K4, f32 as 3xTF32
    "fused_convlstm_level_narrow": convlstm_cell.NARROW_COUNT,  # K4, narrow levels
    "conv2d_int8": conv_int8.COUNT,                 # the int8 conv (no TPU kernel), mma_sync
    "conv2d_int8_wgmma": conv_int8.WGMMA_COUNT,     # the int8 conv, wgmma, quantize folded in
    "conv2d_int8_wgmma_narrow": conv_int8.WGMMA_NARROW_COUNT,  # of those, 32 or 64 columns
    "conv2d_int8_wgmma_gates": conv_int8.GATES_COUNT,  # of those, with the gate epilogue
    "conv2d_int8_smallk": conv_int8.SMALLK_COUNT,   # the int8 conv, small K, quantize folded in
    "grow_into_band": postprocess_loops.GROW_COUNT,   # the growth loop (no TPU kernel)
    "erosion_distance": postprocess_loops.ERODE_COUNT,  # the erosion loop (no TPU kernel)
    "split_markers": postprocess_loops.SPLIT_COUNT,   # the 'dist' split's markers (no TPU kernel)
}


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"kernel": launches, "plain": plain calls}}``."""
    return {name: {"kernel": n.kernel, "plain": n.plain}
            for name, n in KERNELS.items()}


class GraphCount:
    """How often a streaming step was captured as CUDA graphs (``twins``:
    the traced twins' captures), and replayed (a twin's replays too)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.twins = 0
        self.replays = 0


GRAPHS = GraphCount()

Launches = Dict[str, Tuple[int, int]]  # kernel -> (launches, plain calls)


def graph_counts() -> Dict[str, int]:
    """``{"captures": n, "replays": n}`` of the streaming step's graphs."""
    return {"captures": GRAPHS.captures, "replays": GRAPHS.replays}


def snapshot() -> Launches:
    """Every kernel's ``(launches, plain calls)`` so far."""
    return {name: (n.kernel, n.plain) for name, n in KERNELS.items()}


def record_capture(before: Launches, twin: bool = False) -> Launches:
    """What the wrappers counted since ``before`` (a :func:`snapshot` taken
    as a graph's capture began), taken back off the counts, since a capture
    runs nothing; returns it, the launches one replay of that graph makes.
    Counts one capture (``twin``: of a traced twin)."""
    held = {}
    for name, n in KERNELS.items():
        k, p = n.kernel - before[name][0], n.plain - before[name][1]
        if k or p:
            held[name] = (k, p)
            n.kernel -= k
            n.plain -= p
    if twin:
        GRAPHS.twins += 1
    else:
        GRAPHS.captures += 1
    return held


def restore(before: Launches) -> None:
    """Set every kernel's counts back to ``before`` (a :func:`snapshot`):
    what a capture that failed had counted."""
    for name, (k, p) in before.items():
        KERNELS[name].kernel, KERNELS[name].plain = k, p


def record_replay(held: Launches) -> None:
    """Count one replay of a graph that holds ``held`` (from
    :func:`record_capture`)."""
    for name, (k, p) in held.items():
        KERNELS[name].kernel += k
        KERNELS[name].plain += p
    GRAPHS.replays += 1


def reset_counts() -> None:
    for n in KERNELS.values():
        n.reset()
    GRAPHS.reset()
