"""ConvLSTM2D cell.

Counterpart of ``lstm_unet_tpu/ops/convlstm.py`` (Keras ``ConvLSTM2D``
semantics): gate pre-activations ``conv(x, Wx) + bias + conv(h, Wh)`` over
4F channels in the order (i, f, g, o), a unit forget-gate bias, sigmoid or
hard_sigmoid recurrent activation, and an explicit ``(h, c)`` carry of
``[B, H, W, F]`` tensors.

With ``fused_cell`` and a level that :func:`kernels.convlstm_cell.supported`
takes in the compute dtype, the recurrent conv and the gate math run in the
fused kernel (K4) with the x-conv + bias computed outside: its
tensor-core routes take every level with F % 64 == 0 at K in {1, 3, 5} (all
four of the flagship model; bf16 as bf16, f32 as 3xTF32), its narrow route
the other levels with F % 8 == 0 at K up to 7 (the tiny model's), on Wh
packed once and kept by the cell. Otherwise (and at every level K4 does not
take, as the reference) the two convs run on cuDNN and the gate math in
:func:`lstm_gate_update` (forward K1, backward K2). On the CPU both routes
take the kernels' plain versions. The fused route is inference-only, as in
the reference: under grad the fused kernel raises.

:class:`QConvLSTMCell` is the int8 cell (``ops/quant.py``), with the
reference's two routes: fused, ``gx = conv2d_q(x)`` with the bias in x's
dtype and Wh dequantized to that dtype (h is not quantized), then K4;
unfused, ``conv2d_q(x) + conv2d_q(h)`` each in x's dtype (the bias in the
x-conv only), then K1's gate math. The two differ by design (the reference
holds them within 5e-3). Where F % 64 == 0 (the flagship's four levels) the
unfused route's h-conv is the int8 wgmma conv with the gate epilogue
(``quant.py::conv2d_q_gates``): it adds gx, runs K1's gate math and writes
only h' and c', on a Wh packed once in the gate order; on the CPU its plain
version runs the same three steps. Elsewhere the h-conv writes its 4F gates
and K1 follows.

Under a ``split`` of the rows (``parallel/mesh.py::Split``) both convs are
halo convs (``ops/conv.py``, ``ops/quant.py``) and the fused kernel (and
the int8 gate epilogue, likewise) runs on the extended block: h with
``k // 2`` rows of each neighbour, gx and c with as many zero rows, whose
outputs are cropped off (an output row of K4 reads only its own row of gx
and c).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import exchange_halo_h
from .conv import conv2d
from .kernels.convlstm_cell import fused_convlstm_level, pack_for_route, route, supported
from .kernels.lstm_gates import lstm_gate_update
from .quant import ActScales, QWeight, conv2d_q, conv2d_q_gates, split_scale, static_scale

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B,H,W,F]


def _kept_pack(cache: dict, key: tuple, wh: torch.Tensor, b: int, hh: int, ww: int,
               x: torch.Tensor) -> Optional[torch.Tensor]:
    """The Wh pack K4's route takes for this level on the card, made on first
    use and kept in ``cache`` under ``key`` (the weights' identity and
    version: an update in place makes it anew); None for the routes that
    pack per call, and on the CPU."""
    if x.device.type != "cuda":
        return None
    which = route(hh, ww, wh.shape[2], wh.shape[0], b, x.dtype)
    hit = cache.get(x.dtype)
    if hit is None or hit[0] != (which, *key):
        hit = cache[x.dtype] = ((which, *key), pack_for_route(wh, which))
    return hit[1]


def _on_rows(level, gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor, halo: int, split,
             out: Optional[Carry]) -> Carry:
    """``level(gx, h, c, out) -> (h', c')``, a ConvLSTM level's new state, on
    this rank's rows: on the block extended by ``halo`` rows when the rows
    are split (h with its neighbours' rows, gx and c with zero rows: an
    output row reads only its own row of gx and c), cropped back; into
    ``out`` when given."""
    group = None if split is None else split.spatial
    if group is None or halo == 0:
        return level(gx, h, c, out)
    rows = (0, 0, 0, 0, halo, halo)  # zero rows above and below, NHWC
    h_new, c_new = level(F.pad(gx, rows), exchange_halo_h(h, halo, group), F.pad(c, rows), None)
    keep = slice(halo, halo + h.shape[1])
    return _into(out, (h_new[:, keep].contiguous(), c_new[:, keep].contiguous()))


def _fused_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor, wh: torch.Tensor,
                 recurrent_activation: str, packed: Optional[torch.Tensor], split,
                 out: Optional[Carry]) -> Carry:
    """K4 on this rank's rows (:func:`_on_rows`): ``fused_convlstm_level``."""
    return _on_rows(lambda g, hb, cb, o: fused_convlstm_level(g, hb, cb, wh, recurrent_activation,
                                                              packed, o),
                    gx, h, c, wh.shape[0] // 2, split, out)


def _into(out: Optional[Carry], carry: Carry) -> Carry:
    """``carry``, or ``out`` with ``carry`` copied into it when given."""
    if out is None:
        return carry
    for dst, src in zip(out, carry):
        dst.copy_(src)
    return out


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
        self._packs: dict = {}

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Carry:
        shape = (batch, height, width, self.filters)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, carry: Carry, x: torch.Tensor, *,
                recurrent_activation: str = "sigmoid",
                fused_cell: bool = False, split=None,
                out: Optional[Carry] = None) -> Tuple[Carry, torch.Tensor]:
        """One timestep: ``((h, c), x [B,H,W,Cin]) -> ((h', c'), h')``; the
        carry keeps its dtype, the convs run in x's dtype. Under a ``split``
        of the rows, of this rank's rows. ``out``: an ``(h, c)`` pair like
        the carry, aliasing no input, into which the new carry is written by
        the kernel that computes it (inference only)."""
        h, c = carry
        b, hh, ww, _ = x.shape
        k = self.kernel_h.shape[-1]
        if fused_cell and supported(hh, ww, self.filters, k, k, b, x.dtype):
            gx = conv2d(x, self.kernel_x, self.bias, split)
            # an HWIO view: the kernel's wrapper packs or copies it once, or
            # takes the pack kept here
            wh = self.kernel_h.to(x.dtype).permute(2, 3, 1, 0)
            kh = self.kernel_h
            packed = _kept_pack(self._packs, (kh.device, kh.data_ptr(), kh._version), wh, b,
                                hh, ww, x)
            h_new, c_new = _fused_level(gx, h, c, wh, recurrent_activation, packed, split,
                                        out)
            return (h_new, c_new), h_new
        gates = (conv2d(x, self.kernel_x, self.bias, split)
                 + conv2d(h.to(x.dtype), self.kernel_h, None, split))
        c_new, h_new = lstm_gate_update(gates, c, recurrent_activation,
                                        None if out is None else out[::-1])
        return (h_new, c_new), h_new


class QConvLSTMCell(nn.Module):
    """The int8 form of a :class:`ConvLSTMCell`: ``wx`` (with the f32 bias)
    and ``wh`` as :class:`quant.QWeight` (packed in the gate order where the
    gate epilogue takes it), and the static ``x_scale`` / ``h_scale`` of
    sites ``<site>/x`` and ``<site>/h`` (None: dynamic)."""

    def __init__(self, cell: ConvLSTMCell, act_scales: ActScales = None, site: str = ""):
        super().__init__()
        dev = cell.kernel_x.device
        self.filters = cell.filters
        self.wx = QWeight(cell.kernel_x, cell.bias)
        self.wh = QWeight(cell.kernel_h, None, gates=True)
        static_scale(self, "x_scale", act_scales, site + "/x", dev)
        static_scale(self, "h_scale", act_scales, site + "/h", dev)
        self._wh_float = {}
        self._packs: dict = {}

    init_state = ConvLSTMCell.init_state

    @property
    def kernel_x_q(self) -> torch.Tensor:
        return self.wx.kernel_q

    @property
    def kernel_h_q(self) -> torch.Tensor:
        return self.wh.kernel_q

    def wh_dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        """HWIO ``kernel_h_q * wh_scale``, a product in ``dtype`` as the
        reference's fused route forms it; made once per dtype and device."""
        w = self._wh_float.get(dtype)
        if w is None or w.device != self.wh.packed.device:
            scale = self.wh.w_scale.to(dtype)[:, None, None, None]
            w = (self.kernel_h_q.to(dtype) * scale).permute(2, 3, 1, 0).contiguous()
            self._wh_float[dtype] = w
        return w

    def forward(self, carry: Carry, x: torch.Tensor, *,
                recurrent_activation: str = "sigmoid",
                fused_cell: bool = False, split=None,
                out: Optional[Carry] = None) -> Tuple[Carry, torch.Tensor]:
        """:meth:`ConvLSTMCell.forward` of the int8 cell. Unfused, with a
        gate-ordered Wh, the h-conv, the add and the gate math are one launch
        of the gate epilogue (:func:`quant.conv2d_q_gates`)."""
        h, c = carry
        b, hh, ww, _ = x.shape
        k = self.wh.shape[-1]
        gx = conv2d_q(x, self.wx, self.x_scale, x.dtype, split)
        if fused_cell and supported(hh, ww, self.filters, k, k, b, x.dtype):
            wh = self.wh_dequantized(x.dtype)
            packed = _kept_pack(self._packs, (wh.device, wh.data_ptr()), wh, b, hh, ww, x)
            h_new, c_new = _fused_level(gx, h, c, wh, recurrent_activation, packed, split,
                                        out)
            return (h_new, c_new), h_new
        if self.wh.gates:
            scale = self.h_scale
            if scale is None and split is not None:  # the whole tensor's, as conv2d_q's
                scale = split_scale(h, split)
            h_new, c_new = _on_rows(
                lambda g, hb, cb, o: conv2d_q_gates(hb, self.wh, scale, g, cb,
                                                    recurrent_activation, o),
                gx, h, c, k // 2, split, out)
            return (h_new, c_new), h_new
        gates = gx + conv2d_q(h, self.wh, self.h_scale, x.dtype, split)
        c_new, h_new = lstm_gate_update(gates, c, recurrent_activation,
                                        None if out is None else out[::-1])
        return (h_new, c_new), h_new
