"""K1 — fused ConvLSTM gate update, forward (CUDA kernel + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/lstm_gates.py::fused_lstm_gate_update``
(forward ``_fwd_pallas``); the plain version mirrors its XLA twin
``lstm_gate_update_xla``. From pre-activation gates ``[..., 4F]`` in the
order (i, f, g, o) and the cell state ``c [..., F]``::

    c' = act(f) * c + act(i) * tanh(g),   h' = act(o) * tanh(c')

with ``act`` sigmoid or hard_sigmoid ``clip(0.2x + 0.5, 0, 1)``, math in
f32, both outputs in c's dtype. Returns ``(c', h')`` — the reverse of K4's
``(h', c')``.

The kernel (``csrc/lstm_gates.cu``) is bound by device-memory bandwidth; it
reads each gate and state element once and keeps every intermediate in
registers. The backward kernel (the TPU's ``_bwd_pallas``) belongs to the
training slice and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

COUNT = _build.LaunchCount()


def recurrent_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "hard_sigmoid":
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)
    raise ValueError(f"unknown recurrent activation {kind!r}")


def gate_math(zi, zf, zg, zo, c32, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (c', h') from f32 pre-activations and f32 cell state."""
    i = recurrent_act(zi, kind)
    f = recurrent_act(zf, kind)
    g = torch.tanh(zg)
    o = recurrent_act(zo, kind)
    c_new = f * c32 + i * g
    return c_new, o * torch.tanh(c_new)


def lstm_gate_update_plain(gates: torch.Tensor, c: torch.Tensor,
                           recurrent_activation: str = "sigmoid"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: each gate slice is upcast after it is read, as
    the reference twin does."""
    COUNT.plain += 1
    feat = c.shape[-1]

    def g32(k):
        return gates[..., k * feat:(k + 1) * feat].float()

    c_new, h_new = gate_math(g32(0), g32(1), g32(2), g32(3), c.float(),
                             recurrent_activation)
    return c_new.to(c.dtype), h_new.to(c.dtype)


def fused_lstm_gate_update(gates: torch.Tensor, c: torch.Tensor,
                           recurrent_activation: str = "sigmoid"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c', h')`` from gates ``[..., 4F]`` and ``c [..., F]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). The gates may be f32 or bf16 and c f32 or bf16,
    independently; both must be contiguous.
    """
    feat = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * feat:
        raise ValueError(f"gates {tuple(gates.shape)} do not match c "
                         f"{tuple(c.shape)} (need [..., 4F] and [..., F])")
    if gates.device != c.device:
        raise ValueError(f"gates on {gates.device}, c on {c.device}")
    if c.device.type == "cpu":
        return lstm_gate_update_plain(gates, c, recurrent_activation)
    if c.device.type != "cuda":
        raise ValueError(f"no gate-update kernel for device {c.device}")
    if gates.dtype not in _build.DTYPES or c.dtype not in _build.DTYPES:
        raise TypeError(f"gate-update kernel takes float32/bfloat16, got "
                        f"{gates.dtype} gates and {c.dtype} c")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("gate-update kernel needs contiguous gates and c")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent activation {recurrent_activation!r}")
    c_out = torch.empty_like(c)
    h_out = torch.empty_like(c)
    rows = c.numel() // feat if feat else 0
    if rows == 0:
        return c_out, h_out
    lib = _build.library()
    with torch.cuda.device(c.device):
        err = lib.lut_gate_update(
            gates.data_ptr(), c.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
            rows, feat, _build.ACTIVATIONS[recurrent_activation],
            _build.DTYPES[gates.dtype], _build.DTYPES[c.dtype],
            _build.stream_handle(c))
    _build.check(err, "lut_gate_update")
    COUNT.kernel += 1
    return c_out, h_out
