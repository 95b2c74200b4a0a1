"""The int8 conv: s8 x s8 -> s32 implicit GEMM (CUDA kernel + plain version).

Replaces the int8 conv of ``lstm_unet_tpu/ops/quant.py::conv2d_q`` (the XLA
conv of ``_conv_int8``, ``quant.py:91``; the JAX package wrote no Pallas
kernel for it) together with its dequant epilogue. From an int8 NHWC
activation ``xq [B,H,W,Cin]``, its f32 scale ``s_x`` (0-d), int8 weights and
their per-output-channel f32 scales ``w_scale [N]``::

    acc = SAME stride-1 conv(xq, kernel_q)          exact, int32
    y   = float32(acc) * (s_x * w_scale) [+ bias]   each op rounded in f32

then ``y`` is rounded once to ``out_dtype`` (float32 or bfloat16). With no
bias the add is skipped, as the reference skips it.

The weights go in packed once (:func:`pack_weight`, made when the model is
quantized): ``[N_pad, K_pad]`` int8, K ordered (tap, input channel), N padded
to a multiple of 128 and K to one of 64 with zeros, the layout
``csrc/conv_int8.cu`` reads as the GEMM's B.

:func:`conv2d_int8` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; both are counted in :data:`COUNT`. The plain version
is exact on both devices, so the two are compared bit for bit: on the CPU
``F.conv2d`` on int32 tensors; on the card a float64 conv with cuDNN off
(every partial sum is an integer below 2^53, so any order of summation is
exact), rounded back to int32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

COUNT = _build.LaunchCount()

BLOCK_N, BLOCK_K = 128, 64  # tile of csrc/conv_int8.cu: N and K padding


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 ``kernel_q [N,Cin,KH,KW]`` -> ``[N_pad, K_pad]`` int8, row n
    holding ``kernel_q[n]`` in (ky, kx, ci) order, zero padded."""
    if kernel_q.dtype != torch.int8 or kernel_q.dim() != 4:
        raise ValueError(f"pack_weight takes an OIHW int8 kernel, got "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    n, cin, kh, kw = kernel_q.shape
    kdim = kh * kw * cin
    packed = torch.zeros(_ceil_to(n, BLOCK_N), _ceil_to(kdim, BLOCK_K), dtype=torch.int8,
                         device=kernel_q.device)
    packed[:n, :kdim] = kernel_q.permute(0, 2, 3, 1).reshape(n, kdim)
    return packed


def unpack_weight(packed: torch.Tensor, n: int, cin: int, kh: int, kw: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight`: the OIHW int8 kernel (a view)."""
    return packed[:n, :kh * kw * cin].reshape(n, kh, kw, cin).permute(0, 3, 1, 2)


def conv_acc_plain(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums ``[B,H,W,N]`` of the SAME conv of int8 ``xq
    [B,H,W,Cin]`` with the OIHW int8 ``kernel_q``."""
    kh, kw = kernel_q.shape[2], kernel_q.shape[3]
    pad = (kh // 2, kw // 2)
    x = xq.permute(0, 3, 1, 2)
    if xq.device.type == "cpu":
        acc = F.conv2d(x.to(torch.int32), kernel_q.to(torch.int32), padding=pad)
    else:
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(x.double(), kernel_q.double(), padding=pad)
        acc = acc.round().to(torch.int32)
    return acc.permute(0, 2, 3, 1)


def conv2d_int8_plain(xq: torch.Tensor, s_x: torch.Tensor, packed: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int,
                      kw: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments): the exact sums,
    then ``acc * (s_x * w_scale) [+ bias]`` in f32, in the reference's order."""
    COUNT.plain += 1
    kq = unpack_weight(packed, w_scale.shape[0], xq.shape[-1], kh, kw)
    y = conv_acc_plain(xq, kq).float() * (s_x * w_scale)
    return (y if bias is None else y + bias).to(out_dtype)


def _present(*ts):
    return [t for t in ts if t is not None]


def _check(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8 [B,H,W,Cin], got {tuple(xq.shape)} {xq.dtype}")
    n, cin = w_scale.shape[0], xq.shape[-1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME conv needs odd kernel sizes, got {kh}x{kw}")
    want = (_ceil_to(n, BLOCK_N), _ceil_to(kh * kw * cin, BLOCK_K))
    if packed.dtype != torch.int8 or tuple(packed.shape) != want:
        raise ValueError(f"packed weight {tuple(packed.shape)} {packed.dtype} is not the "
                         f"pack of a {kh}x{kw} kernel, Cin={cin}, N={n}: want {want}")
    if s_x.numel() != 1 or s_x.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("s_x (0-d) and w_scale must be float32")
    if bias is not None and (bias.shape != w_scale.shape or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 [{n}]")
    if out_dtype not in _build.DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if len({t.device for t in _present(xq, s_x, packed, w_scale, bias)}) != 1:
        raise ValueError("xq, s_x, the weights and the bias must be on one device")


def conv2d_int8(xq: torch.Tensor, s_x: torch.Tensor, packed: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int, kw: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y [B,H,W,N]`` in ``out_dtype`` of the int8 conv described above.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). ``xq`` must be contiguous and 16-byte aligned.
    """
    _check(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype)
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    if not all(t.is_contiguous() for t in _present(xq, s_x, packed, w_scale, bias)):
        raise ValueError("the int8 conv kernel needs contiguous xq, weights and bias")
    if xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the int8 conv kernel needs 16-byte aligned xq and weights")
    b, h, w, cin = xq.shape
    n = w_scale.shape[0]
    y = torch.empty(b, h, w, n, dtype=out_dtype, device=xq.device)
    if y.numel() == 0:
        return y
    fn = _build.library().lut_conv2d_int8
    args = (xq.data_ptr(), packed.data_ptr(), s_x.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w, cin, kh, kw,
            n, packed.shape[1], _build.DTYPES[out_dtype], _build.stream_handle(xq))
    if xq.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(xq.device):
            err = fn(*args)
    _build.check(err, "lut_conv2d_int8")
    COUNT.kernel += 1
    return y
