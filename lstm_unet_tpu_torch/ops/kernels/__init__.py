"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``lstm_unet_tpu/ops/pallas``. Each wrapper takes its plain
version for CPU tensors and launches its CUDA kernel for CUDA tensors, and
counts both in its :class:`_build.LaunchCount` (see :func:`counts`).
"""

from __future__ import annotations

from typing import Dict

from . import ccl, conv_int8, convlstm_cell, lstm_gates, postprocess_loops

# kernel name -> its launch count (the K numbering of the TPU kernel table)
KERNELS = {
    "lstm_gate_update": lstm_gates.COUNT,           # K1
    "lstm_gate_update_bwd": lstm_gates.BWD_COUNT,   # K2
    "ccl": ccl.COUNT,                               # K3, cluster route
    "ccl_grid": ccl.GRID_COUNT,                     # K3, grid route
    "fused_convlstm_level": convlstm_cell.COUNT,    # K4, SIMT route
    "fused_convlstm_level_wgmma": convlstm_cell.WGMMA_COUNT,  # K4, bf16 tensor cores
    "fused_convlstm_level_tf32x3": convlstm_cell.TF32X3_COUNT,  # K4, f32 as 3xTF32
    "fused_convlstm_level_narrow": convlstm_cell.NARROW_COUNT,  # K4, narrow levels
    "conv2d_int8": conv_int8.COUNT,                 # the int8 conv (no TPU kernel), mma_sync
    "conv2d_int8_wgmma": conv_int8.WGMMA_COUNT,     # the int8 conv, wgmma, quantize folded in
    "conv2d_int8_smallk": conv_int8.SMALLK_COUNT,   # the int8 conv, small K, quantize folded in
    "grow_into_band": postprocess_loops.GROW_COUNT,   # the growth loop (no TPU kernel)
    "erosion_distance": postprocess_loops.ERODE_COUNT,  # the erosion loop (no TPU kernel)
}


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"kernel": launches, "plain": plain calls}}``."""
    return {name: {"kernel": n.kernel, "plain": n.plain}
            for name, n in KERNELS.items()}


def reset_counts() -> None:
    for n in KERNELS.values():
        n.reset()
