"""Spatial parallelism: convolutions on H-split row blocks with halo rows.

Counterpart of ``lstm_unet_tpu/parallel/halo.py``. A frame whose rows are
split over the 'spatial' group (``mesh.py``) convolves block by block: each
rank adds ``halo = k // 2`` rows from each neighbour to its ``[B, Hs, W, C]``
block (zeros at the frame's top and bottom, the SAME conv's padding), runs
the SAME conv on the ``Hs + 2 * halo`` rows, and keeps output rows ``halo
.. halo + Hs - 1``, which saw exactly the rows the whole frame's conv sees.
The kernels (cuDNN, the int8 routes, K4) run unchanged on the taller block:
the extra rows and the discarded output rows are the cost.

The reference leaves the exchange's gradient to XLA; here
:func:`exchange_halo_h` is an autograd Function whose backward returns the
halo rows' gradient to the rank that owns those rows, which adds it into
its boundary rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .comm import Group, exchange, group_ranks


def _neighbours(group: Group):
    ranks = group_ranks(group)
    i = ranks.index(dist.get_rank())
    return (ranks[i - 1] if i > 0 else None,
            ranks[i + 1] if i + 1 < len(ranks) else None)


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, group: Group) -> torch.Tensor:
        prev, nxt = _neighbours(group)
        ctx.halo, ctx.group, ctx.peers = halo, group, (prev, nxt)
        above, below = exchange(x[:, :halo], x[:, -halo:], prev, nxt, group)
        zeros = x.new_zeros((x.shape[0], halo) + tuple(x.shape[2:]))
        return torch.cat([zeros if above is None else above, x,
                          zeros if below is None else below], dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        halo, (prev, nxt) = ctx.halo, ctx.peers
        # the gradient of the rows I took from a neighbour goes back to it;
        # theirs of my boundary rows comes here
        g_top, g_bottom = exchange(g[:, :halo], g[:, -halo:], prev, nxt, ctx.group)
        gx = g[:, halo:-halo].clone()
        if g_top is not None:
            gx[:, :halo] += g_top
        if g_bottom is not None:
            gx[:, -halo:] += g_bottom
        return gx, None, None


def exchange_halo_h(x: torch.Tensor, halo: int, group: Group) -> torch.Tensor:
    """``x [B, Hs, W, C]`` (this rank's rows of a frame split over
    ``group``, in group-rank order) with ``halo`` rows of each neighbour
    above and below: ``[B, Hs + 2 * halo, W, C]``, zeros where the frame
    ends. Differentiable."""
    if halo < 1:
        return x
    if x.shape[1] < halo:
        raise ValueError(f"a block of {x.shape[1]} rows cannot give a halo of {halo} rows")
    return _ExchangeHalo.apply(x, halo, group)


def on_extended_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                     halo: int, group: Group) -> torch.Tensor:
    """``fn`` (a SAME, row-local op such as a conv with a ``2 * halo + 1``
    row kernel) of the whole frame, on this rank's rows: ``fn`` of the block
    extended by :func:`exchange_halo_h`, cropped back to ``Hs`` rows (a
    contiguous copy, as the kernels take). ``group`` None: ``fn(x)``."""
    if group is None or halo < 1:
        return fn(x)
    y = fn(exchange_halo_h(x, halo, group))
    return y[:, halo:y.shape[1] - halo].contiguous()


def halo_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, group: Group) -> torch.Tensor:
    """SAME, stride-1 conv of this rank's rows ``x [B, Hs, W, Cin]`` of an
    H-split frame with an odd OIHW ``kernel``: the rows of the whole
    frame's conv that this rank holds (the reference's ``halo_conv2d``)."""
    from ..ops.conv import conv2d  # ops/conv.py imports this module

    return on_extended_rows(lambda xe: conv2d(xe, kernel, bias), x, kernel.shape[2] // 2,
                            group)
