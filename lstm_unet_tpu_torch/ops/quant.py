"""int8 quantized inference.

Counterpart of ``lstm_unet_tpu/ops/quant.py``. Symmetric, zero point 0, so
SAME zero padding stays exact:

- weights: per-output-channel scales ``s_w = max|k| / 127`` (at least
  1e-12), ``q = clip(round(k / s_w), -127, 127)``;
- activations: one scale per tensor, dynamic ``max(max|x|, 1e-8) / 127`` per
  call or static from calibration, ``q = clip(round(x_f32 / s_x), -127,
  127)`` (a true division; rounding half to even, as ``jnp.round``);
- conv: int8 x int8 -> exact int32 sums, dequantized in f32 as ``acc * (s_x *
  s_w) + bias`` and rounded once to the output dtype.

:func:`conv2d_q` runs a site on the route its :class:`QWeight` carries,
which ``kernels/conv_int8.py::pack_site`` chose by the kernel's shape when
it packed the weights. The kernels that take the model's sites quantize the
float activation as they stage it (with a dynamic scale one abs-max pass
stays outside the kernel); the route for what they do not take runs
:func:`quantize_act` as plain tensor code first, as the reference leaves it
to XLA outside any Pallas kernel. On the CPU all take the plain versions:
:func:`quantize_act`, then the exact conv and the dequant.

Under a ``split`` (``parallel/mesh.py::Split``) a dynamic scale stays the
reference's one scale over the whole ``[B,H,W,C]`` tensor, all its lanes and
rows: each rank's abs-max of its own block, all-reduced with MAX over
:attr:`Split.parts`, then formed as :func:`quantize_act` forms it and passed
to the kernel as a given scale (a static scale needs no collective); with
the rows split, each conv with ``k > 1`` runs on the halo-extended block.

Gate math, LayerNorm and softmax stay as in the float model, except that
on the card the unfused int8 ConvLSTM cell's h-conv takes the gate add and
the gate update into its epilogue (:func:`conv2d_q_gates`: the h-conv writes
h' and c', not its 4F gates). :class:`QWeight` holds one conv's int8
weights, packed once for its route's kernel (an h-conv that the gate
epilogue takes in the gate order); ``models/ulstm_unet.py::quantize_model_int8``
builds the model's quantized sites from it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.comm import all_reduce_
from ..parallel.halo import on_extended_rows
from .kernels import conv_int8
from .kernels.conv_int8 import div127, quantize_act  # noqa: F401 (quantize_act re-exported)

ActScales = Optional[Dict[str, float]]


def quantize_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float kernel -> (int8 kernel, per-cout f32 scale)."""
    k = kernel.float()
    s = torch.clamp(div127(k.abs().amax(dim=(1, 2, 3))), min=1e-12)
    q = torch.clamp(torch.round(k / s[:, None, None, None]), -127, 127).to(torch.int8)
    return q, s


def _scale_of(act_scales: ActScales, site: str) -> Optional[torch.Tensor]:
    """Calibrated absmax of a site -> static scale ``absmax / 127`` (computed
    in double, then f32, as the reference), or None."""
    if act_scales is None or site not in act_scales:
        return None
    return torch.tensor(max(float(act_scales[site]), 1e-8) / 127.0, dtype=torch.float32)


def parse_keep_float(keep_float) -> tuple:
    """A keep-float spec -> a tuple of site prefixes: a comma-separated string
    ('encoder/0, encoder/1'), an iterable of prefixes, or None / ''."""
    if keep_float is None:
        return ()
    if isinstance(keep_float, str):
        keep_float = keep_float.split(",")
    return tuple(s for s in (p.strip() for p in keep_float) if s)


def _site_kept(site: str, keep_float) -> bool:
    """True when ``site`` matches a keep-float prefix ('encoder/0' matches
    encoder/0/... but not encoder/01/...)."""
    for p in keep_float:
        p = p.strip().strip("/")
        if p and (site == p or site.startswith(p + "/")):
            return True
    return False


class QWeight(nn.Module):
    """One int8 conv's weights: ``route``, the kernel that
    ``kernels/conv_int8.py::pack_site`` chose for the site, ``packed`` (that
    kernel's layout, made once), per-cout ``w_scale`` f32 and the optional
    f32 ``bias``; ``kernel_q`` is the OIHW int8 kernel.

    ``gates``: a ConvLSTM h-conv (no bias). Where the gate epilogue takes it
    its one pack holds the output channels in the gate order (``gates`` is
    then True), with ``gate_scale`` (``w_scale`` in that order) and
    ``unorder`` (each natural channel's column, for ``kernel_q``); only
    :func:`conv2d_q_gates` runs it."""

    def __init__(self, kernel: torch.Tensor, bias: Optional[torch.Tensor], gates: bool = False):
        super().__init__()
        q, s = quantize_weight(kernel.detach())
        self.shape = tuple(q.shape)  # (cout, cin, kh, kw)
        self.route, packed, order = conv_int8.pack_site(q, gates and bias is None)
        self.gates = order is not None
        self.register_buffer("packed", packed)
        self.register_buffer("w_scale", s)
        self.register_buffer("bias", None if bias is None else bias.detach().float())
        self.register_buffer("gate_scale", None if order is None else s[order])
        self.register_buffer("unorder", None if order is None else torch.argsort(order))
        self._slices: Dict[Tuple[int, int], Tuple[str, torch.Tensor]] = {}

    @property
    def kernel_q(self) -> torch.Tensor:
        q = conv_int8.unpack_site(self.route, self.packed, self.shape)
        return q.index_select(0, self.unorder) if self.gates else q

    def packed_slice(self, c0: int, c1: int) -> Tuple[str, torch.Tensor]:
        """``(route, pack)`` of input channels ``c0:c1`` (for
        :func:`conv2d_q_pair`): the slice's own route, made on first use and
        kept."""
        hit = self._slices.get((c0, c1))
        if hit is None or hit[1].device != self.packed.device:
            which, packed, _ = conv_int8.pack_site(self.kernel_q[:, c0:c1].contiguous())
            hit = self._slices[(c0, c1)] = (which, packed)
        return hit


def split_scale(x: torch.Tensor, split) -> torch.Tensor:
    """The dynamic scale of the whole tensor whose block this rank holds:
    ``max(max|x|, 1e-8) / 127`` over every rank of ``split.parts``, formed
    as :func:`quantize_act` forms it from one tensor."""
    amax = torch.linalg.vector_norm(x, ord=float("inf")).float().reshape(1)
    return div127(torch.clamp(all_reduce_(amax, "max", split.parts)[0], min=1e-8))


def _conv(x: torch.Tensor, scale: Optional[torch.Tensor], which: str, packed: torch.Tensor,
          w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int, kw: int,
          out_dtype: torch.dtype, split=None) -> torch.Tensor:
    """The int8 conv of float ``x`` on route ``which``, whose pack
    :class:`QWeight` made; under a ``split``, of this rank's block."""
    if split is not None:
        if scale is None:
            scale = split_scale(x, split)
        return on_extended_rows(
            lambda xe: _conv(xe, scale, which, packed, w_scale, bias, kh, kw, out_dtype), x,
            kh // 2, split.spatial)
    return conv_int8.conv2d_int8_site(which, x, scale, packed, w_scale, bias, kh, kw, out_dtype)


def conv2d_q(x: torch.Tensor, weight: QWeight, x_scale: Optional[torch.Tensor] = None,
             out_dtype: torch.dtype = torch.float32, split=None) -> torch.Tensor:
    """NHWC int8 conv of ``x`` (quantized dynamically, or with the static
    ``x_scale``) with the f32 dequant epilogue, in ``out_dtype``; under a
    ``split``, of this rank's block. A gate-ordered pack is refused: it runs
    only as :func:`conv2d_q_gates`."""
    _, _, kh, kw = weight.shape
    if weight.gates:
        raise ValueError("an h-conv packed for the gate epilogue runs as conv2d_q_gates")
    return _conv(x, x_scale, weight.route, weight.packed, weight.w_scale, weight.bias, kh, kw,
                 out_dtype, split)


def conv2d_q_gates(h: torch.Tensor, weight: QWeight, h_scale: Optional[torch.Tensor],
                   gx: torch.Tensor, c: torch.Tensor, recurrent_activation: str = "sigmoid",
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused int8 ConvLSTM cell after its x-conv ``gx``: ``(h', c')`` of
    ``gx + conv2d_q(h, weight, h_scale, gx.dtype)`` through the gate math
    with ``c``, as one launch of the wgmma kernel with the gate epilogue
    (``kernels/conv_int8.py::conv2d_int8_wgmma_gates``; its plain version on
    the CPU) on ``weight``'s gate pack (``weight.gates``); into ``out`` (an
    ``(h, c)`` pair) when given. Of the rows given: under a split of the
    rows the cell runs it on the halo-extended block
    (``ops/convlstm.py::_on_rows``)."""
    if not weight.gates:
        raise ValueError("conv2d_q_gates takes an h-conv packed for the gate epilogue")
    return conv_int8.conv2d_int8_wgmma_gates(h, h_scale, weight.packed, weight.gate_scale, gx,
                                             c, weight.shape[-1], recurrent_activation, out)


def conv2d_q_pair(a: torch.Tensor, b: torch.Tensor, weight: QWeight,
                  scale_a: Optional[torch.Tensor] = None,
                  scale_b: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32, split=None) -> torch.Tensor:
    """Quantized ``conv(concat([a, b]), W)`` as two channel-sliced convs, each
    operand with its own scale: ``acc_a * (s_a * w) + acc_b * (s_b * w)``, then
    the bias, in f32 (the reference's order), then ``out_dtype``. Two launches
    of the int8 conv (each on its slice's route), each writing its f32
    product."""
    _, cin, kh, kw = weight.shape
    ca = a.shape[-1]
    ys = [_conv(x, scale, *weight.packed_slice(c0, c1), weight.w_scale, None, kh, kw,
                torch.float32, split)
          for x, c0, c1, scale in ((a, 0, ca, scale_a), (b, ca, cin, scale_b))]
    y = ys[0] + ys[1]
    if weight.bias is not None:
        y = y + weight.bias
    return y.to(out_dtype)


def static_scale(module: nn.Module, name: str, act_scales: ActScales, site: str,
                 device) -> None:
    """Register buffer ``name``: the static scale of ``site``, or None."""
    scale = _scale_of(act_scales, site)
    module.register_buffer(name, None if scale is None else scale.to(device))
