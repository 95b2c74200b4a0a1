"""2D conv / pool / upsample primitives on NHWC tensors.

Counterpart of ``lstm_unet_tpu/ops/conv.py``. Tensors keep the reference's
NHWC layout ``[B, H, W, C]``; each op views it as NCHW with
``torch.channels_last`` strides (a free permute), so cuDNN and oneDNN run
their NHWC kernels and no layout copy is made. Conv weights are OIHW. The
plain convs are left to cuDNN, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    # a no-op view when x is channels_last, which the ops below produce
    return x.permute(0, 2, 3, 1).contiguous()


def init_conv(kh: int, kw: int, cin: int, cout: int, *,
              generator: Optional[torch.Generator] = None,
              device=None, dtype=torch.float32):
    """Glorot-uniform OIHW kernel and zero bias (Keras Conv2D default)."""
    limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
    kernel = torch.empty((cout, cin, kh, kw), device=device, dtype=dtype)
    kernel.uniform_(-limit, limit, generator=generator)
    return kernel, torch.zeros((cout,), device=device, dtype=dtype)


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME, stride-1 conv of ``x [B,H,W,Cin]`` with an odd OIHW kernel, in
    x's dtype; returns ``[B,H,W,Cout]``."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME conv needs odd kernel sizes, got {kh}x{kw}")
    y = F.conv2d(_nchw(x), kernel.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 padding=(kh // 2, kw // 2))
    return _nhwc(y)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "leaky_relu":
        return F.leaky_relu(x, negative_slope=0.2)  # the reference's slope
    if kind == "relu":
        return F.relu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind in ("none", "linear"):
        return x
    raise ValueError(f"unknown activation {kind!r}")


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 VALID max pool."""
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def upsample_2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x upsample: nearest repeats each pixel; bilinear samples half-pixel
    centres with edge clamping, as ``jax.image.resize`` does when enlarging."""
    if method == "nearest":
        return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
    if method == "bilinear":
        y = F.interpolate(_nchw(x).float(), scale_factor=2, mode="bilinear",
                          align_corners=False)
        return _nhwc(y).to(x.dtype)
    raise ValueError(f"unknown upsample method {method!r}")
