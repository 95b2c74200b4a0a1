"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``lstm_unet_tpu/ops/pallas``. Each wrapper takes its plain
version for CPU tensors and launches its CUDA kernel for CUDA tensors, and
counts both in its module's ``COUNT`` (see :func:`counts`).
"""

from __future__ import annotations

from typing import Dict

from . import ccl, convlstm_cell, lstm_gates

# kernel name -> its module (the K numbering of the TPU kernel table)
KERNELS = {
    "lstm_gate_update": lstm_gates,       # K1
    "ccl": ccl,                           # K3
    "fused_convlstm_level": convlstm_cell,  # K4
}


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"kernel": launches, "plain": plain calls}}``."""
    return {name: {"kernel": m.COUNT.kernel, "plain": m.COUNT.plain}
            for name, m in KERNELS.items()}


def reset_counts() -> None:
    for m in KERNELS.values():
        m.COUNT.reset()
