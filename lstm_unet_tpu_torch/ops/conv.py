"""2D conv / pool / upsample primitives on NHWC tensors.

Counterpart of ``lstm_unet_tpu/ops/conv.py``. Tensors keep the reference's
NHWC layout ``[B, H, W, C]``; each op views it as NCHW with
``torch.channels_last`` strides (a free permute), so cuDNN and oneDNN run
their NHWC kernels and no layout copy is made. Conv weights are OIHW. The
plain convs are left to cuDNN, as the reference leaves them to XLA.

A ``split`` (``parallel/mesh.py::Split``) whose rows are split over the
'spatial' group makes :func:`conv2d` a halo conv (``parallel/halo.py``) and
:func:`upsample_2x` exchange the row a bilinear sample needs; max-pool and
nearest upsampling need no neighbour row.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.halo import exchange_halo_h, on_extended_rows


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
           bias: Optional[torch.Tensor] = None, split=None) -> torch.Tensor:
    """SAME, stride-1 conv of ``x [B,H,W,Cin]`` with an odd OIHW kernel, in
    x's dtype; returns ``[B,H,W,Cout]``. Under a ``split`` of the rows, x
    is this rank's rows and so is the result (a halo conv)."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME conv needs odd kernel sizes, got {kh}x{kw}")

    def conv(xe):
        y = F.conv2d(_nchw(xe), kernel.to(xe.dtype),
                     None if bias is None else bias.to(xe.dtype),
                     padding=(kh // 2, kw // 2))
        return _nhwc(y)

    return on_extended_rows(conv, x, kh // 2, None if split is None else split.spatial)


@functools.lru_cache(maxsize=None)
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "leaky_relu":
        # the reference's slope 0.2, rounded to x's dtype as jax.nn.leaky_relu
        # multiplies by it: in bf16 the product then equals the reference's
        return F.leaky_relu(x, negative_slope=_in_dtype(0.2, x.dtype))
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


def upsample_2x(x: torch.Tensor, method: str = "nearest", split=None) -> torch.Tensor:
    """2x upsample: nearest repeats each pixel; bilinear samples half-pixel
    centres with edge clamping, as ``jax.image.resize`` does when enlarging.
    Under a ``split`` of the rows, bilinear takes one row of each neighbour
    and drops the two output rows each adds; at the frame's top and bottom
    its own clamping is the frame's."""
    if method == "nearest":
        return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
    if method != "bilinear":
        raise ValueError(f"unknown upsample method {method!r}")
    group = None if split is None else split.spatial
    top = bottom = 0
    if group is not None:
        xe = exchange_halo_h(x, 1, group)
        top, bottom = (int(split.mesh.index("spatial") > 0),
                       int(split.mesh.index("spatial") < split.mesh.axis_size("spatial") - 1))
        x = xe[:, 1 - top:xe.shape[1] - 1 + bottom]
    y = F.interpolate(_nchw(x).float(), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return _nhwc(y)[:, 2 * top:y.shape[2] - 2 * bottom].contiguous().to(x.dtype)
