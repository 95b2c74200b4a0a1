"""Plain PyTorch reference of the ULSTMnet2D step, in float32.

Written from the model's description (the recurrent ConvLSTM U-Net of
arbellea/LSTM-UNet as the repository reconstructs it), not from the port,
and importing nothing of it: per encoder level a 2x2 max-pool (past level
0), ConvLSTM layers (Keras semantics: gates ``conv(x, Wx) + b + conv(h,
Wh)`` in the order i, f, g, o, sigmoid recurrent activation) and a stack of
SAME convs with leaky ReLU (slope 0.2); the deepest output pooled, then per
decoder level, deepest first, a nearest 2x upsample, the skip concatenated
and a conv stack; a 1x1 head to three logits. Tensors are NCHW here; the
state is ``[[(h, c)]]`` per level and layer.

``precision`` picks the arithmetic of every conv, the rest staying f32:

- ``float``: f32 convs (TF32 off);
- ``int8``: the int8 serving scheme, worked out again from the float
  weights: per-output-channel weight scales ``max|w| / 127``, one static
  activation scale a site ``max(absmax, 1e-8) / 127`` from this reference's
  own calibration (:meth:`Reference.calibrate`), codes ``round`` half to
  even and clipped to +-127, the integer products summed and dequantized
  ``acc * (s_x * s_w) + b``;
- ``int4``: the same scheme with 7 in place of 127, the control of an int8
  configuration;
- ``fp8``: operands scaled to e4m3's range (weights per output channel,
  activations per call) and rounded to float8_e4m3fn, the control of a
  bf16 configuration. Under autograd the rounding passes its gradient
  straight through.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Q_LEVELS = {"int8": 127.0, "int4": 7.0}
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _round_ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach() if x.requires_grad else q


class Reference:
    """The step of a configuration (``cfg``: the config file's dict) with
    float weights ``weights`` (name -> f32 tensor, the port's parameter
    names), on the weights' device."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], precision: str = "float",
                 act_absmax: Optional[Dict[str, float]] = None):
        if precision not in ("float", "int8", "int4", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.w = weights
        self.precision = precision
        self.absmax = act_absmax or {}
        self.collect: Optional[Dict[str, torch.Tensor]] = None
        self.depth = len(cfg["down_conv_kernels"])
        self._qw: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        if precision in Q_LEVELS and not act_absmax:
            raise ValueError(f"{precision} needs the calibrated activation abs-maxima")

    # ------------------------------------------------------------ convs

    def _weight(self, name: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        w = self.w[name]
        if self.precision == "float":
            return w, None
        if self.precision == "fp8":
            s = torch.clamp(w.detach().abs().amax(dim=(1, 2, 3)), min=1e-12) / FP8_MAX
            s = s[:, None, None, None]
            q = (w / s).to(torch.float8_e4m3fn).float() * s
            return _round_ste(w, q), None
        hit = self._qw.get(name)
        if hit is None or hit[0] is not w:
            levels = Q_LEVELS[self.precision]
            s = torch.clamp(w.detach().abs().amax(dim=(1, 2, 3)) / levels, min=1e-12)
            q = torch.clamp(torch.round(w.detach() / s[:, None, None, None]), -levels, levels)
            hit = self._qw[name] = (w, (q, s))
        return hit[1]

    def conv(self, x: torch.Tensor, site: str, kernel: str, bias: Optional[str]) -> torch.Tensor:
        """SAME stride-1 conv of ``x`` with weights ``kernel`` (OIHW) and the
        optional ``bias`` at ``site`` (the calibration's site name)."""
        if self.collect is not None:
            self.collect[site] = torch.maximum(self.collect.get(site, torch.zeros((), device=x.device)),
                                               x.detach().abs().amax().float())
        b = None if bias is None else self.w[bias]
        k = self.w[kernel].shape[-1]
        pad = k // 2
        if self.precision in ("float", "fp8"):
            w, _ = self._weight(kernel)
            if self.precision == "fp8":
                s = torch.clamp(x.detach().abs().amax(), min=1e-12) / FP8_MAX
                x = _round_ste(x, (x / s).to(torch.float8_e4m3fn).float() * s)
            return F.conv2d(x, w, b, padding=pad)
        levels = Q_LEVELS[self.precision]
        q, s_w = self._weight(kernel)
        s_x = torch.tensor(max(float(self.absmax[site]), 1e-8) / levels, dtype=torch.float32,
                           device=x.device)
        qx = torch.clamp(torch.round(x / s_x), -levels, levels)
        acc = F.conv2d(qx, q, None, padding=pad)
        y = acc * (s_x * s_w)[None, :, None, None]
        return y if b is None else y + b[None, :, None, None]

    # ------------------------------------------------------------ the step

    def init_state(self, batch: int, height: int, width: int, device) -> List:
        state = []
        for lvl in range(self.depth):
            h, w = height >> lvl, width >> lvl
            state.append([(torch.zeros(batch, f, h, w, device=device),
                           torch.zeros(batch, f, h, w, device=device))
                          for _, f in self.cfg["lstm_kernels"][lvl]])
        return state

    def _lstm(self, lvl: int, j: int, carry, x: torch.Tensor):
        h, c = carry
        pre = f"encoder.{lvl}.lstm.{j}."
        site = f"encoder/{lvl}/lstm/{j}"
        gates = (self.conv(x, site + "/x", pre + "kernel_x", pre + "bias")
                 + self.conv(h, site + "/h", pre + "kernel_h", None))
        zi, zf, zg, zo = torch.chunk(gates, 4, dim=1)
        c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h_new = torch.sigmoid(zo) * torch.tanh(c_new)
        return h_new, c_new

    def _stack(self, x: torch.Tensor, part: str, lvl: int) -> torch.Tensor:
        for j in range(len(self.cfg[f"{'down' if part == 'encoder' else 'up'}_conv_kernels"][lvl])):
            pre = f"{part}.{lvl}.convs.{j}."
            x = F.leaky_relu(self.conv(x, f"{part}/{lvl}/convs/{j}", pre + "kernel", pre + "bias"),
                             0.2)
        return x

    def step(self, state: List, frame: torch.Tensor) -> Tuple[List, torch.Tensor]:
        """One frame ``[B, 1, H, W]`` (normalised) -> (new state, logits
        ``[B, 3, H, W]``)."""
        x = frame
        new_state, skips = [], []
        for lvl in range(self.depth):
            if lvl > 0:
                x = F.max_pool2d(x, 2)
            carries = []
            for j in range(len(self.cfg["lstm_kernels"][lvl])):
                carry = self._lstm(lvl, j, state[lvl][j], x)
                carries.append(carry)
                x = carry[0]
            new_state.append(carries)
            x = self._stack(x, "encoder", lvl)
            skips.append(x)
        x = F.max_pool2d(skips[-1], 2)
        for lvl in reversed(range(self.depth)):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self._stack(torch.cat([x, skips[lvl]], dim=1), "decoder", lvl)
        return new_state, self.conv(x, "head", "head.kernel", "head.bias")

    @torch.no_grad()
    def calibrate(self, frames: List[torch.Tensor]) -> Dict[str, float]:
        """Each conv site's input abs-max over ``frames`` (``[1, 1, H, W]``,
        normalised), streamed from a zero state through this reference in
        float: the static int8 scales' abs-maxima."""
        if self.precision != "float":
            raise ValueError("calibrate the float reference")
        _, _, h, w = frames[0].shape
        state = self.init_state(1, h, w, frames[0].device)
        self.collect = {}
        try:
            for f in frames:
                state, _ = self.step(state, f)
            return {k: float(v) for k, v in self.collect.items()}
        finally:
            self.collect = None


def class_weighted_ce(logits: torch.Tensor, seg: torch.Tensor,
                      class_weights) -> torch.Tensor:
    """Mean over every pixel of ``-w[y] log softmax(logits)[y]`` (logits
    ``[N, 3, H, W]``, seg ``[N, H, W]``): the training loss of fully
    annotated frames."""
    logp = torch.log_softmax(logits, dim=1)
    w = torch.tensor(list(class_weights), dtype=torch.float32, device=logits.device)
    picked = torch.gather(logp, 1, seg[:, None].long())[:, 0]
    return -(picked * w[seg.long()]).mean()
