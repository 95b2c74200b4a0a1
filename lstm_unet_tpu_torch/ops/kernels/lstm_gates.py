"""K1 / K2 — fused ConvLSTM gate update and its backward (CUDA kernels +
plain versions), joined in a ``torch.autograd.Function``.

Replaces ``lstm_unet_tpu/ops/pallas/lstm_gates.py::fused_lstm_gate_update``
(forward ``_fwd_pallas``); the plain version mirrors its XLA twin
``lstm_gate_update_xla``. From pre-activation gates ``[..., 4F]`` in the
order (i, f, g, o) and the cell state ``c [..., F]``::

    c' = act(f) * c + act(i) * tanh(g),   h' = act(o) * tanh(c')

with ``act`` sigmoid or hard_sigmoid ``clip(0.2x + 0.5, 0, 1)``, math in
f32, both outputs in c's dtype. Returns ``(c', h')`` — the reverse of K4's
``(h', c')``.

K2 replaces the backward ``_bwd_pallas``: from the forward's inputs and the
cotangents ``(dc', dh')`` it recomputes the gates in registers and writes
``dgates [..., 4F]`` (gates' dtype) and ``dc [..., F]`` (c's dtype).
:func:`lstm_gate_update` is the op with a gradient, as the reference's
custom VJP: forward K1, saving only ``(gates, c)``, backward K2. On CPU
tensors the same Function runs the two plain versions, so both devices share
one gradient rule: ``_bwd_kernel``'s, whose hard_sigmoid derivative is 0.2
strictly inside (-2.5, 2.5) and 0 at z = +-2.5 (autograd through
``torch.clamp`` would give 0.2 there).

Both kernels (``csrc/lstm_gates.cu``) are bound by device-memory bandwidth;
they read each element once and keep every intermediate in registers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

COUNT = _build.LaunchCount()      # K1
BWD_COUNT = _build.LaunchCount()  # K2


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


def lstm_gate_update_bwd_plain(gates: torch.Tensor, c: torch.Tensor,
                               dc_out: torch.Tensor, dh: torch.Tensor,
                               recurrent_activation: str = "sigmoid"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: the reference ``_bwd_kernel``'s formulas
    in its order of operations, math in f32; ``(dgates, dc)``."""
    BWD_COUNT.plain += 1
    feat = c.shape[-1]

    def g32(k):
        return gates[..., k * feat:(k + 1) * feat].float()

    zi, zf, zg, zo = g32(0), g32(1), g32(2), g32(3)
    act = recurrent_activation
    i, f, o = recurrent_act(zi, act), recurrent_act(zf, act), recurrent_act(zo, act)
    cand = torch.tanh(zg)
    c_prev = c.float()
    tc = torch.tanh(f * c_prev + i * cand)
    dh32 = dh.float()
    dc_new = dc_out.float() + dh32 * o * (1.0 - tc * tc)
    if act == "sigmoid":
        d_zi = dc_new * cand * i * (1.0 - i)
        d_zf = dc_new * c_prev * f * (1.0 - f)
        d_zo = dh32 * tc * o * (1.0 - o)
    else:  # hard_sigmoid: 0.2 strictly inside the linear band, 0 outside

        def band(z):
            return torch.where((z > -2.5) & (z < 2.5), 0.2, 0.0)

        d_zi = dc_new * cand * band(zi)
        d_zf = dc_new * c_prev * band(zf)
        d_zo = dh32 * tc * band(zo)
    d_zg = dc_new * i * (1.0 - cand * cand)
    dgates = torch.cat([d_zi, d_zf, d_zg, d_zo], dim=-1).to(gates.dtype)
    return dgates, (dc_new * f).to(c.dtype)


def _check(gates: torch.Tensor, c: torch.Tensor, *grads: torch.Tensor) -> None:
    feat = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * feat:
        raise ValueError(f"gates {tuple(gates.shape)} do not match c "
                         f"{tuple(c.shape)} (need [..., 4F] and [..., F])")
    for t in grads:
        if t.shape != c.shape or t.dtype != c.dtype:
            raise ValueError(f"cotangent {tuple(t.shape)} {t.dtype} does not "
                             f"match c {tuple(c.shape)} {c.dtype}")
    if len({t.device for t in (gates, c, *grads)}) != 1:
        raise ValueError(f"gates on {gates.device}, c on {c.device}: one device")


def _check_cuda(gates: torch.Tensor, c: torch.Tensor, recurrent_activation: str,
                *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take; raises on anything else."""
    if c.device.type != "cuda":
        raise ValueError(f"no gate-update kernel for device {c.device}")
    if gates.dtype not in _build.DTYPES or c.dtype not in _build.DTYPES:
        raise TypeError(f"gate-update kernel takes float32/bfloat16, got "
                        f"{gates.dtype} gates and {c.dtype} c")
    if not all(t.is_contiguous() for t in (gates, c, *tensors)):
        raise ValueError("gate-update kernel needs contiguous gates and c")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent activation {recurrent_activation!r}")


def lstm_gate_update_bwd(gates: torch.Tensor, c: torch.Tensor,
                         dc_out: torch.Tensor, dh: torch.Tensor,
                         recurrent_activation: str = "sigmoid"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dgates, dc)`` from the forward's ``gates [..., 4F]``, ``c [...,
    F]`` and the cotangents ``dc_out``, ``dh`` of ``(c', h')`` (c's shape and
    dtype). CPU tensors take the plain version; CUDA tensors launch the
    kernel (any other device raises)."""
    _check(gates, c, dc_out, dh)
    if c.device.type == "cpu":
        return lstm_gate_update_bwd_plain(gates, c, dc_out, dh, recurrent_activation)
    _check_cuda(gates, c, recurrent_activation, dc_out, dh)
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    feat = c.shape[-1]
    rows = c.numel() // feat if feat else 0
    if rows == 0:
        return dgates, dc
    lib = _build.library()
    with torch.cuda.device(c.device):
        err = lib.lut_gate_update_bwd(
            gates.data_ptr(), c.data_ptr(), dc_out.data_ptr(), dh.data_ptr(),
            dgates.data_ptr(), dc.data_ptr(), rows, feat,
            _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[gates.dtype],
            _build.DTYPES[c.dtype], _build.stream_handle(c))
    _build.check(err, "lut_gate_update_bwd")
    BWD_COUNT.kernel += 1
    return dgates, dc


def _outputs(c: torch.Tensor, out: Optional[Tuple[torch.Tensor, torch.Tensor]]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out`` checked as two contiguous tensors like ``c``, or two new
    ones."""
    if out is None:
        return torch.empty_like(c), torch.empty_like(c)
    for t in out:
        if (t.shape != c.shape or t.dtype != c.dtype or t.device != c.device
                or not t.is_contiguous()):
            raise ValueError(f"out {tuple(t.shape)} {t.dtype} on {t.device} is not a "
                             f"contiguous tensor like c {tuple(c.shape)} {c.dtype}")
    return out


def fused_lstm_gate_update(gates: torch.Tensor, c: torch.Tensor,
                           recurrent_activation: str = "sigmoid",
                           out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(c', h')`` from gates ``[..., 4F]`` and ``c [..., F]``; the op
    to differentiate is :func:`lstm_gate_update`. ``out``: two contiguous
    tensors like ``c``, aliasing no input, that receive ``(c', h')`` and are
    returned (the streaming step's buffers, ``engine/graph.py``).

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). The gates may be f32 or bf16 and c f32 or bf16,
    independently; both must be contiguous.
    """
    _check(gates, c)
    if c.device.type == "cpu":
        got = lstm_gate_update_plain(gates, c, recurrent_activation)
        if out is None:
            return got
        for dst, src in zip(_outputs(c, out), got):
            dst.copy_(src)
        return out
    _check_cuda(gates, c, recurrent_activation)
    feat = c.shape[-1]
    c_out, h_out = _outputs(c, out)
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


class _GateUpdate(torch.autograd.Function):
    """Forward K1, backward K2 (the reference's ``_fwd_rule`` / ``_bwd_rule``):
    only the inputs are saved, the backward recomputes the gates."""

    @staticmethod
    def forward(ctx, gates, c, recurrent_activation):
        ctx.recurrent_activation = recurrent_activation
        ctx.save_for_backward(gates, c)
        return fused_lstm_gate_update(gates, c, recurrent_activation)

    @staticmethod
    def backward(ctx, dc_out, dh):
        gates, c = ctx.saved_tensors
        dgates, dc = lstm_gate_update_bwd(gates, c, dc_out.contiguous(),
                                          dh.contiguous(), ctx.recurrent_activation)
        return dgates, dc, None


def lstm_gate_update(gates: torch.Tensor, c: torch.Tensor,
                     recurrent_activation: str = "sigmoid",
                     out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c', h')`` as :func:`fused_lstm_gate_update`, differentiable: its
    backward is K2 on CUDA tensors and K2's plain version on CPU tensors.
    ``out`` (inference only: it raises when a gradient is wanted) writes
    ``(c', h')`` into given tensors."""
    if out is None:
        return _GateUpdate.apply(gates, c, recurrent_activation)
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        raise RuntimeError("lstm_gate_update(out=...) has no gradient: run it under "
                           "torch.no_grad()/inference_mode")
    return fused_lstm_gate_update(gates, c, recurrent_activation, out)
