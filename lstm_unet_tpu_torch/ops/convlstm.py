"""ConvLSTM2D cell.

Counterpart of ``lstm_unet_tpu/ops/convlstm.py`` (Keras ``ConvLSTM2D``
semantics): gate pre-activations ``conv(x, Wx) + bias + conv(h, Wh)`` over
4F channels in the order (i, f, g, o), a unit forget-gate bias, sigmoid or
hard_sigmoid recurrent activation, and an explicit ``(h, c)`` carry of
``[B, H, W, F]`` tensors.

With ``fused_cell`` and a level that :func:`kernels.convlstm_cell.supported`
takes, the recurrent conv and the gate math run in the fused kernel (K4) with
the x-conv + bias computed outside; otherwise the two convs run on cuDNN and
the gate math in the gate-update kernel (K1). On the CPU both routes take
the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .conv import conv2d
from .kernels.convlstm_cell import fused_convlstm_level, supported
from .kernels.lstm_gates import fused_lstm_gate_update

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B,H,W,F]


class ConvLSTMCell(nn.Module):
    """Parameters ``kernel_x [4F,Cin,K,K]``, ``kernel_h [4F,F,K,K]`` (OIHW)
    and ``bias [4F]``."""

    def __init__(self, kernel_size: int, in_channels: int, filters: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        k, cout = kernel_size, 4 * filters
        lim_x = math.sqrt(6.0 / (k * k * in_channels + k * k * cout))
        lim_h = math.sqrt(6.0 / (k * k * filters + k * k * cout))
        kw = dict(device=device, dtype=dtype)
        self.kernel_x = nn.Parameter(torch.empty(cout, in_channels, k, k, **kw)
                                     .uniform_(-lim_x, lim_x, generator=generator))
        self.kernel_h = nn.Parameter(torch.empty(cout, filters, k, k, **kw)
                                     .uniform_(-lim_h, lim_h, generator=generator))
        bias = torch.zeros(cout, **kw)
        bias[filters:2 * filters] = 1.0  # unit forget-gate bias
        self.bias = nn.Parameter(bias)
        self.filters = filters

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Carry:
        shape = (batch, height, width, self.filters)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, carry: Carry, x: torch.Tensor, *,
                recurrent_activation: str = "sigmoid",
                fused_cell: bool = False) -> Tuple[Carry, torch.Tensor]:
        """One timestep: ``((h, c), x [B,H,W,Cin]) -> ((h', c'), h')``; the
        carry keeps its dtype, the convs run in x's dtype."""
        h, c = carry
        b, hh, ww, _ = x.shape
        k = self.kernel_h.shape[-1]
        if fused_cell and supported(hh, ww, self.filters, k, k, b):
            gx = conv2d(x, self.kernel_x, self.bias)
            wh = self.kernel_h.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # HWIO
            h_new, c_new = fused_convlstm_level(gx, h, c, wh, recurrent_activation)
            return (h_new, c_new), h_new
        gates = conv2d(x, self.kernel_x, self.bias) + conv2d(h.to(x.dtype),
                                                             self.kernel_h)
        c_new, h_new = fused_lstm_gate_update(gates, c, recurrent_activation)
        return (h_new, c_new), h_new
