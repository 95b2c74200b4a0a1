"""K4 — fused ConvLSTM level, inference (CUDA kernel + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level``.
From ``gx [B,H,W,4F]`` (x-conv + bias, computed outside), ``h, c [B,H,W,F]``
and ``wh [K,K,F,4F]``: the KxK SAME recurrent conv of ``h`` (rounded to wh's
dtype) with f32 accumulation, plus ``gx``, then the K1 gate math. Only
``h'`` and ``c'`` are written; the 4F gates never reach device memory.
Returns ``(h', c')`` — the reverse of K1's ``(c', h')`` — in h's and c's
dtypes.

The TPU kernel's limits (B = 1, F and W multiples of 128, H of 4, 5x5 only,
its VMEM budget) were the TPU's. The CUDA kernel (``csrc/
convlstm_cell.cu``) takes any B, H, W and F and an odd square kernel up to
7x7; its limit is that one block's shared memory — the halo'd h tile for all
F channels plus one Wh chunk — stays within the 227 KB a Hopper block can
use (:func:`supported`). Flagship level 0 (F = 128, 5x5) and the tiny
model's levels fit; F >= 256 at 5x5 does not, and the cell takes the plain
conv + K1 path there.

Inference only, as the reference (which defines no VJP for it): with grad
mode on and any input requiring grad the wrapper raises, on every device,
rather than return outputs that carry no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .lstm_gates import gate_math

COUNT = _build.LaunchCount()

# block geometry of csrc/convlstm_cell.cu
TILE_H, TILE_W, FEAT_SLICE, CHUNK = 8, 16, 32, 4
KERNEL_SIZES = (1, 3, 5, 7)
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use


def smem_bytes(k: int, feat: int) -> int:
    """Shared memory one block needs: the f32 halo'd h tile for all ``feat``
    channels plus one f32 Wh chunk (all taps, 4 gates, one feature slice)."""
    return 4 * (feat * (TILE_H + k - 1) * (TILE_W + k - 1)
                + k * k * CHUNK * 4 * FEAT_SLICE)


def supported(h: int, w: int, feat: int, kh: int, kw: int, batch: int) -> bool:
    """Whether the fused kernel takes this level (else: plain conv + K1)."""
    slices = -(-feat // FEAT_SLICE)
    return (kh == kw and kh in KERNEL_SIZES and min(h, w, feat, batch) > 0
            and batch * slices <= 65535
            and smem_bytes(kh, feat) <= SMEM_LIMIT)


def fused_convlstm_level_plain(gx: torch.Tensor, h: torch.Tensor,
                               c: torch.Tensor, wh: torch.Tensor,
                               recurrent_activation: str = "sigmoid"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the recurrent conv in f32 on the h rounded to
    wh's dtype (exact products, f32 sums, as the kernel), then the gate math."""
    COUNT.plain += 1
    k = wh.shape[0]
    feat = c.shape[-1]
    hx = h.to(wh.dtype).float().permute(0, 3, 1, 2)
    acc = F.conv2d(hx, wh.float().permute(3, 2, 0, 1), padding=k // 2)
    z = acc.permute(0, 2, 3, 1) + gx.float()
    c_new, h_new = gate_math(z[..., :feat], z[..., feat:2 * feat],
                             z[..., 2 * feat:3 * feat], z[..., 3 * feat:],
                             c.float(), recurrent_activation)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def fused_convlstm_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                         wh: torch.Tensor, recurrent_activation: str = "sigmoid"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', c')`` of one ConvLSTM level, layouts as in the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). ``gx`` and ``wh`` share the compute dtype, ``h``
    and ``c`` the state dtype, each float32 or bfloat16.
    """
    if gx.dim() != 4 or h.dim() != 4 or wh.dim() != 4:
        raise ValueError("need gx [B,H,W,4F], h and c [B,H,W,F], wh [K,K,F,4F]")
    b, hh, ww, feat = h.shape
    k = wh.shape[0]
    if (c.shape != h.shape or gx.shape != (b, hh, ww, 4 * feat)
            or wh.shape != (k, k, feat, 4 * feat)):
        raise ValueError(f"shape mismatch: gx {tuple(gx.shape)}, h "
                         f"{tuple(h.shape)}, c {tuple(c.shape)}, wh "
                         f"{tuple(wh.shape)}")
    if len({gx.device, h.device, c.device, wh.device}) != 1:
        raise ValueError("gx, h, c and wh must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gx, h, c, wh)):
        raise RuntimeError(
            "fused_convlstm_level is inference-only (no backward, as in the "
            "reference): run it under torch.no_grad()/inference_mode, or train "
            "with fused_cell=False")
    if h.device.type == "cpu":
        return fused_convlstm_level_plain(gx, h, c, wh, recurrent_activation)
    if h.device.type != "cuda":
        raise ValueError(f"no fused ConvLSTM kernel for device {h.device}")
    if (gx.dtype != wh.dtype or h.dtype != c.dtype
            or gx.dtype not in _build.DTYPES or h.dtype not in _build.DTYPES):
        raise TypeError(f"fused ConvLSTM kernel takes float32/bfloat16 with "
                        f"gx/wh and h/c dtypes equal, got gx {gx.dtype}, wh "
                        f"{wh.dtype}, h {h.dtype}, c {c.dtype}")
    if not all(t.is_contiguous() for t in (gx, h, c, wh)):
        raise ValueError("fused ConvLSTM kernel needs contiguous operands")
    if not supported(hh, ww, feat, k, k, b):
        raise ValueError(f"fused ConvLSTM kernel does not take {k}x{k}, F={feat}, "
                         f"B={b}; check supported() first")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent activation {recurrent_activation!r}")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = _build.library()
    with torch.cuda.device(h.device):
        err = lib.lut_convlstm_level(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), wh.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k,
            _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[gx.dtype],
            _build.DTYPES[h.dtype], _build.stream_handle(h))
    _build.check(err, "lut_convlstm_level")
    COUNT.kernel += 1
    return h_out, c_out
