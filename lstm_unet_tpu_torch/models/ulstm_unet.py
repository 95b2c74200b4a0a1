"""ULSTMnet2D — recurrent ConvLSTM U-Net.

Counterpart of ``lstm_unet_tpu/models/ulstm_unet.py``::

    per encoder level: ConvLSTM(s) -> conv stack -> skip -> 2x2 max-pool
    per decoder level, deepest first: 2x upsample -> concat [up, skip] -> convs
    head: 1x1 conv -> num_classes logits (f32)

The per-level ``(h, c)`` ConvLSTM state is the only data carried from frame
to frame. Public tensors keep the reference layout: frames ``[B,H,W,C]``,
logits ``[B,H,W,K]``, state ``[[(h, c) [B,H,W,F]]]`` per level and layer.
Parameter names follow the reference tree, so ``encoder.0.lstm.0.kernel_x``
is the reference's ``encoder[0]["lstm"][0]["kernel_x"]``
(``checkpoint/convert.py``); conv kernels are OIHW.

Under ``quant='int8'`` the model is quantized in place by
:func:`quantize_model_int8` (the engine does it when it is built):
each quantized site becomes a :class:`QConv` or ``QConvLSTMCell`` and the
model dispatches on the module, as the reference on the presence of
``kernel_q``. ``step(..., collect_scales=d)`` records each conv site's
input abs-max under the reference's site names, for calibration.

Under a mesh the engine or the trainer sets :attr:`ULSTMnet2D.split`
(``parallel/mesh.py::Split``, None by default): ``step`` then runs on this
rank's block of lanes and rows, and every conv site takes the split (halo
convs, all-reduced int8 scales). State and logits are this rank's blocks.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import NetKernelParams
from ..ops.conv import activate, conv2d, init_conv, max_pool_2x2, upsample_2x
from ..ops.convlstm import ConvLSTMCell, QConvLSTMCell
from ..ops.quant import (ActScales, QWeight, _site_kept, conv2d_q, conv2d_q_pair,
                         parse_keep_float, static_scale)
from ..utils import trace

State = List[List[Tuple[torch.Tensor, torch.Tensor]]]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """Model options; the fields of the reference's ``ModelConfig``, read
    from ``model_params.json``.

    ``use_pallas`` is accepted and has no effect: it chose between the TPU
    gate kernel and its XLA twin, and here the tensor's device chooses (the
    CUDA kernel on a GPU, the plain version on the CPU). ``split_skip_convs``
    has no effect in float (it split a concat conv in two for a TPU layout,
    with the same math); under ``quant='int8'`` it changes the math as in
    the reference: the decoder's first convs quantize the upsampled input
    and the skip each with its own scale (sites ``.a`` and ``.b``).
    ``quant='int8'`` runs every conv of a quantized site as int8 x int8 ->
    int32 with an f32 dequant, the rest in ``dtype``.
    """

    net_kernel_params_json: str
    in_channels: int = 1
    num_classes: int = 3
    activation: str = "leaky_relu"
    recurrent_activation: str = "sigmoid"
    upsample: str = "nearest"
    norm: str = "none"            # or 'layernorm' over channels, eps 1e-6
    use_pallas: bool = False
    dtype: str = "float32"
    quant: str = "none"
    split_skip_convs: bool = False
    fused_cell: bool = False      # fused ConvLSTM kernel where supported
    state_dtype: str = "auto"     # LSTM carry dtype; 'auto' follows dtype

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant {self.quant!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.state_dtype != "auto" and self.state_dtype not in DTYPES:
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}")
        if self.norm not in ("none", "layernorm"):
            raise ValueError(f"unknown norm {self.norm!r}")

    @staticmethod
    def make(nkp: NetKernelParams, **kw) -> "ModelConfig":
        return ModelConfig(net_kernel_params_json=json.dumps(nkp.to_dict()), **kw)

    @property
    def nkp(self) -> NetKernelParams:
        return NetKernelParams.from_dict(json.loads(self.net_kernel_params_json))

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def carry_dtype(self) -> torch.dtype:
        return self.compute_dtype if self.state_dtype == "auto" else DTYPES[self.state_dtype]


class Conv(nn.Module):
    """A SAME conv (``kernel`` OIHW, ``bias``), with the optional channel
    LayerNorm (``ln_scale``, ``ln_bias``, kept f32) and activation of the
    conv stacks; the head uses it bare."""

    def __init__(self, k: int, cin: int, cout: int, *, norm: str = "none",
                 activation: Optional[str] = None, generator=None, device=None):
        super().__init__()
        kernel, bias = init_conv(k, k, cin, cout, generator=generator, device=device)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)
        if norm == "layernorm":
            self.ln_scale = nn.Parameter(torch.ones(cout, device=device))
            self.ln_bias = nn.Parameter(torch.zeros(cout, device=device))
        self.activation = activation

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        return _norm_act(self, conv2d(x, self.kernel, self.bias, split))

    def forward_pair(self, a: torch.Tensor, b: torch.Tensor, split=None) -> torch.Tensor:
        """``forward(concat([a, b]))``."""
        return self(torch.cat([a, b], dim=-1), split)


def _norm_act(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The optional f32 channel LayerNorm, then the activation (none for the
    head)."""
    if conv.activation is None:
        return x
    if hasattr(conv, "ln_scale"):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        x = ((x32 - mu) * torch.rsqrt(var + 1e-6) * conv.ln_scale
             + conv.ln_bias).to(x.dtype)
    return activate(x, conv.activation)


class QConv(nn.Module):
    """The int8 form of a :class:`Conv`: ``weight`` (``ops/quant.py::QWeight``,
    with the f32 bias), the static ``x_scale`` (concat input) and
    ``x_scale_a`` / ``x_scale_b`` (the two operands of :meth:`forward_pair`)
    of its site, or None (dynamic), and the f32 LayerNorm parameters as they
    were. Outputs are in the input's dtype."""

    def __init__(self, conv: Conv, act_scales: ActScales = None, site: str = ""):
        super().__init__()
        dev = conv.kernel.device
        self.weight = QWeight(conv.kernel, conv.bias)
        for name, suffix in (("x_scale", ""), ("x_scale_a", ".a"), ("x_scale_b", ".b")):
            static_scale(self, name, act_scales, site + suffix, dev)
        if hasattr(conv, "ln_scale"):
            self.ln_scale, self.ln_bias = conv.ln_scale, conv.ln_bias
        self.activation = conv.activation

    @property
    def kernel_q(self) -> torch.Tensor:
        return self.weight.kernel_q

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        return _norm_act(self, conv2d_q(x, self.weight, self.x_scale, x.dtype, split))

    def forward_pair(self, a: torch.Tensor, b: torch.Tensor, split=None) -> torch.Tensor:
        """``conv(concat([a, b]))`` with each operand quantized on its own
        scale (``conv2d_q_pair``)."""
        y = conv2d_q_pair(a, b, self.weight, self.x_scale_a, self.x_scale_b, a.dtype, split)
        return _norm_act(self, y)


def _collect(collect: Optional[dict], site: str, x: torch.Tensor) -> None:
    """Record max|x| (f32, on x's device) for int8 calibration."""
    if collect is not None:
        collect[site] = x.float().abs().amax()


def _direct(seg: str, fn, *args):
    """``fn(*args)``, the segment ``seg`` of a step (stamped while the tracer
    stamps, ``utils/trace.py::segment``)."""
    return trace.segment(seg, fn, *args)


def _recomputed(seg: str, fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward: only its
    inputs are kept (non-reentrant ``torch.utils.checkpoint``)."""
    return checkpoint(trace.segment, seg, fn, *args, use_reentrant=False)


class _EncoderLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.ModuleList()
        self.convs = nn.ModuleList()


class _DecoderLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()


def cast_params_for_inference(model: "ULSTMnet2D", dtype: torch.dtype
                              ) -> "ULSTMnet2D":
    """Cast conv and LSTM weights to the compute dtype once, in place; the
    LayerNorm ``ln_*`` parameters stay f32, as they are applied in f32.
    Conv kernels are stored channels_last, the layout the NHWC convs read."""
    for name, p in model.named_parameters():
        if not name.rsplit(".", 1)[-1].startswith("ln_"):
            p.data = p.data.to(dtype)
        if p.dim() == 4:
            p.data = p.data.contiguous(memory_format=torch.channels_last)
    return model


def quantize_model_int8(model: "ULSTMnet2D", act_scales: ActScales = None,
                        keep_float: Union[str, Iterable[str], None] = (),
                        float_dtype: Optional[torch.dtype] = None) -> "ULSTMnet2D":
    """Quantize a ``ULSTMnet2D`` in place (its weights as restored, f32) and
    return it. Sites are named as the reference's ``collect_scales`` keys
    (``encoder/{i}/lstm/{j}``, ``encoder/{i}/convs/{j}``,
    ``decoder/{i}/convs/{j}``, ``head``); a site with a calibrated absmax in
    ``act_scales`` gets a static scale, the others stay dynamic. Sites
    matching a ``keep_float`` prefix stay float, cast to ``float_dtype``
    (LayerNorm parameters stay f32)."""
    keep = parse_keep_float(keep_float)

    def quantize(modules, i, kind, group, qtype):
        for j, m in enumerate(modules):
            site = f"{kind}/{i}/{group}/{j}"
            if not _site_kept(site, keep):
                modules[j] = qtype(m, act_scales, site)

    for i, level in enumerate(model.encoder):
        quantize(level.lstm, i, "encoder", "lstm", QConvLSTMCell)
        quantize(level.convs, i, "encoder", "convs", QConv)
    for i, level in enumerate(model.decoder):
        quantize(level.convs, i, "decoder", "convs", QConv)
    if not _site_kept("head", keep):
        model.head = QConv(model.head, act_scales, "head")
    if float_dtype is not None:
        cast_params_for_inference(model, float_dtype)
    return model


class ULSTMnet2D(nn.Module):
    """The model; weights are drawn from ``generator`` (glorot-uniform, as
    the reference initialises them)."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        nkp = cfg.nkp
        kw = dict(generator=generator, device=device)
        self.encoder = nn.ModuleList()
        cin = cfg.in_channels
        skip_channels = []
        for lvl in range(nkp.depth):
            level = _EncoderLevel()
            for (k, f) in nkp.lstm_kernels[lvl]:
                level.lstm.append(ConvLSTMCell(k, cin, f, **kw))
                cin = f
            for (k, f) in nkp.down_conv_kernels[lvl]:
                level.convs.append(Conv(k, cin, f, norm=cfg.norm,
                                        activation=cfg.activation, **kw))
                cin = f
            skip_channels.append(cin)
            self.encoder.append(level)
        # decoder params stored per level index, applied deepest first; the
        # reference draws them deepest first too
        decoder = [None] * nkp.depth
        dec_cin = skip_channels[-1]
        for lvl in reversed(range(nkp.depth)):
            level = _DecoderLevel()
            c = dec_cin + skip_channels[lvl]  # concat [upsampled, skip]
            for (k, f) in nkp.up_conv_kernels[lvl]:
                level.convs.append(Conv(k, c, f, norm=cfg.norm,
                                        activation=cfg.activation, **kw))
                c = f
            dec_cin = c
            decoder[lvl] = level
        self.decoder = nn.ModuleList(decoder)
        self.head = Conv(1, dec_cin, cfg.num_classes, **kw)
        self.split = None  # this rank's block of a mesh (parallel/mesh.py::Split)

    # -- state ------------------------------------------------------------

    def init_state(self, batch: int, height: int, width: int,
                   device=None) -> State:
        """Zero state; H and W must be multiples of 2^depth."""
        mult = 2 ** len(self.encoder)
        if height % mult or width % mult:
            raise ValueError(
                f"H,W must be multiples of 2^depth={mult}, got {height}x{width}")
        if device is None:
            device = next(itertools.chain(self.parameters(), self.buffers())).device
        state: State = []
        h, w = height, width
        for level in self.encoder:
            state.append([cell.init_state(batch, h, w, self.cfg.carry_dtype, device)
                          for cell in level.lstm])
            h, w = h // 2, w // 2
        return state

    @staticmethod
    def reset_lanes(state: State, is_last: torch.Tensor) -> State:
        """Zero the state of batch lanes where ``is_last [B]`` is set."""
        def zero(x):
            mask = is_last.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            return x * (1 - mask)

        return [[(zero(h), zero(c)) for (h, c) in level] for level in state]

    # -- forward ----------------------------------------------------------

    def step(self, state: State, frame: torch.Tensor,
             collect_scales: Optional[dict] = None, *, recompute_segments: bool = False,
             out: Optional[State] = None) -> Tuple[State, torch.Tensor]:
        """One frame ``[B,H,W,C]`` -> (new state, f32 logits ``[B,H,W,K]``).
        The input state is not modified. ``collect_scales``: a dict the caller
        owns, which gets every conv site's input abs-max (0-d f32 tensors)
        under the reference's site names. ``out`` (inference only): a state
        like ``state`` (from :meth:`init_state`), aliasing none of it, into
        which each ConvLSTM layer's kernel writes the new state, which is
        returned: the streaming step's buffers (``engine/graph.py``), the
        counterpart of the reference's donated state.

        The frame runs as segments: each ConvLSTM layer (after the 2x2 pool
        of the level below's output), each encoder level's conv stack, the
        decoder with the head. ``recompute_segments`` checkpoints each
        segment, so the backward keeps only their inputs: the frame, the
        state, each ConvLSTM layer's output and each conv stack's output (the
        ``skip``), the tensors the reference's 'save_outputs' remat policy
        names ``lstm_out`` and ``skip``."""
        run = _recomputed if recompute_segments else _direct
        x = frame.to(self.cfg.compute_dtype)
        new_state: State = []
        skips = []
        for lvl, level in enumerate(self.encoder):
            lvl_state = []
            pool = lvl > 0  # the level below's skip, pooled by the first segment
            for j, cell in enumerate(level.lstm):
                site = f"encoder/{lvl}/lstm/{j}"
                carry, x = run(site, self._lstm_layer, cell, site, pool, state[lvl][j], x,
                               collect_scales, None if out is None else out[lvl][j])
                lvl_state.append(carry)
                pool = False
            site = f"encoder/{lvl}/convs"
            x = run(site, self._conv_stack, level.convs, site, pool, x, collect_scales,
                    self.split)
            skips.append(x)
            new_state.append(lvl_state)
        return new_state, run("decoder", self._decode, skips, collect_scales)

    def _lstm_layer(self, cell: nn.Module, site: str, pool: bool, carry, x: torch.Tensor,
                    collect: Optional[dict], out=None):
        if pool:
            x = max_pool_2x2(x)
        _collect(collect, site + "/x", x)
        _collect(collect, site + "/h", carry[0])
        carry, x = cell(carry, x, recurrent_activation=self.cfg.recurrent_activation,
                        fused_cell=self.cfg.fused_cell, split=self.split, out=out)
        return carry, x.to(self.cfg.compute_dtype)  # the carry may be f32 under bf16

    @staticmethod
    def _conv_stack(convs: nn.ModuleList, site: str, pool: bool, x: torch.Tensor,
                    collect: Optional[dict], split):
        if pool:
            x = max_pool_2x2(x)
        for j, conv in enumerate(convs):
            _collect(collect, f"{site}/{j}", x)
            x = conv(x, split)
        return x

    def _decode(self, skips: List[torch.Tensor], collect: Optional[dict]) -> torch.Tensor:
        cfg, split = self.cfg, self.split
        x = max_pool_2x2(skips[-1])
        for lvl in reversed(range(len(self.decoder))):
            x = upsample_2x(x, cfg.upsample, split)
            convs = self.decoder[lvl].convs
            site = f"decoder/{lvl}/convs/0"
            if cfg.split_skip_convs:
                _collect(collect, site + ".a", x)
                _collect(collect, site + ".b", skips[lvl])
                x = convs[0].forward_pair(x, skips[lvl], split)
            else:
                x = torch.cat([x, skips[lvl]], dim=-1)
                _collect(collect, site, x)
                x = convs[0](x, split)
            for j, conv in enumerate(convs[1:], start=1):
                _collect(collect, f"decoder/{lvl}/convs/{j}", x)
                x = conv(x, split)
        _collect(collect, "head", x)
        return self.head(x, split).float()

    def apply(self, state: State, x: torch.Tensor, remat: Union[bool, str] = False
              ) -> Tuple[State, torch.Tensor]:
        """Unrolled window ``[B,T,H,W,C]`` -> (state, logits ``[B,T,H,W,K]``).

        ``remat`` trades compute for memory in the backward pass, as the
        reference's ``apply(..., remat)``: False saves every intermediate;
        True or 'full' saves only each frame's inputs and recomputes the
        frame's ``step`` during the backward (``torch.utils.checkpoint``,
        non-reentrant); 'save_outputs' checkpoints each segment of ``step``
        instead (``recompute_segments``), so the ConvLSTM and conv-stack
        outputs are kept too, the reference's ``lstm_out`` and ``skip``.
        """
        if remat not in (False, True, "full", "save_outputs"):
            raise ValueError(f"unknown remat {remat!r}")
        recompute = bool(remat) and torch.is_grad_enabled()
        logits = []
        for t in range(x.shape[1]):
            if recompute and remat == "save_outputs":
                state, lg = self.step(state, x[:, t], recompute_segments=True)
            elif recompute:
                state, lg = checkpoint(self.step, state, x[:, t], use_reentrant=False)
            else:
                state, lg = self.step(state, x[:, t])
            logits.append(lg)
        return state, torch.stack(logits, dim=1)
