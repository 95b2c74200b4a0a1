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
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..config import NetKernelParams
from ..ops.conv import activate, conv2d, init_conv, max_pool_2x2, upsample_2x
from ..ops.convlstm import ConvLSTMCell

State = List[List[Tuple[torch.Tensor, torch.Tensor]]]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """Model options; the fields of the reference's ``ModelConfig``, read
    from ``model_params.json``.

    ``use_pallas`` and ``split_skip_convs`` are accepted and have no effect:
    the first chose between the TPU gate kernel and its XLA twin, and here
    the tensor's device chooses (the CUDA kernel on a GPU, the plain version
    on the CPU); the second split a concat conv in two for a TPU layout, with
    the same math. ``quant`` other than 'none' (int8) is not ported yet.
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
        if self.quant != "none":
            raise NotImplementedError(
                f"quant={self.quant!r} is not ported yet (ROADMAP.md queue 1 "
                "item 9, int8 inference)")
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.kernel, self.bias)
        if self.activation is None:
            return x
        if hasattr(self, "ln_scale"):
            x32 = x.float()
            mu = x32.mean(dim=-1, keepdim=True)
            var = x32.var(dim=-1, keepdim=True, unbiased=False)
            x = ((x32 - mu) * torch.rsqrt(var + 1e-6) * self.ln_scale
                 + self.ln_bias).to(x.dtype)
        return activate(x, self.activation)


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

    # -- state ------------------------------------------------------------

    def init_state(self, batch: int, height: int, width: int,
                   device=None) -> State:
        """Zero state; H and W must be multiples of 2^depth."""
        mult = 2 ** len(self.encoder)
        if height % mult or width % mult:
            raise ValueError(
                f"H,W must be multiples of 2^depth={mult}, got {height}x{width}")
        device = device if device is not None else self.head.kernel.device
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

    def step(self, state: State, frame: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """One frame ``[B,H,W,C]`` -> (new state, f32 logits ``[B,H,W,K]``).
        The input state is not modified."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = frame.to(dt)
        new_state: State = []
        skips = []
        for lvl, level in enumerate(self.encoder):
            lvl_state = []
            for j, cell in enumerate(level.lstm):
                carry, x = cell(state[lvl][j], x,
                                recurrent_activation=cfg.recurrent_activation,
                                fused_cell=cfg.fused_cell)
                lvl_state.append(carry)
                x = x.to(dt)  # the carry may be f32 under bf16 compute
            for conv in level.convs:
                x = conv(x)
            skips.append(x)
            new_state.append(lvl_state)
            x = max_pool_2x2(x)
        for lvl in reversed(range(len(self.decoder))):
            x = upsample_2x(x, cfg.upsample)
            convs = self.decoder[lvl].convs
            x = convs[0](torch.cat([x, skips[lvl]], dim=-1))
            for conv in convs[1:]:
                x = conv(x)
        return new_state, self.head(x).float()

    def apply(self, state: State, x: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """Unrolled window ``[B,T,H,W,C]`` -> (state, logits ``[B,T,H,W,K]``)."""
        logits = []
        for t in range(x.shape[1]):
            state, lg = self.step(state, x[:, t])
            logits.append(lg)
        return state, torch.stack(logits, dim=1)
