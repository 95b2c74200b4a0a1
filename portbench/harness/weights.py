"""The cell's weights, made on the device from the seed.

The benchmark's own initialiser, handed to both sides: the port's model
loads the dict by parameter name, the reference reads it as it is. Kernels
are glorot-uniform (the limit ``sqrt(6 / (K²·cin + K²·cout))``), biases 0
but for a ConvLSTM layer's forget-gate bias of 1, all drawn in one call
from a generator seeded with the run's seed. With ``weights_dtype`` bfloat16
every value is rounded to bf16 (what such a model serves), and kept as f32.

A served model's head is then fitted (:func:`fit_head`), so that random
weights answer the frames with instances and the postprocess has real work.
Random features drift by seed in scale and offset by more than their
spread across a frame, so a fixed head gives one seed an empty mask and
another a full one. The fitted head reads one projection ``r = v·x`` of its
input ``x``: the plain reference, in bf16, streams the sequence's first
:data:`FIT_STREAM` frames, and over the last :data:`FIT_FRAMES` of them
``v`` is the direction in which ``x`` varies most across the pixels (so
that int8 rounding of ``x`` moves ``r`` least against its spread), ``t``
the :data:`FIT_QUANTILE` quantile of ``r`` and ``s`` its spread. The logits
are ``(-g, g, 0) * (r - t) / s`` plus :data:`HEAD_BIAS`, with ``g`` =
:data:`HEAD_GAIN`: interior where ``r`` is above ``t``, about
``1 - FIT_QUANTILE`` of the frame, the boundary class a shell where ``r``
crosses ``t``. These are the harness's constants, the same for every
configuration and seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float]  # name, shape, glorot limit (0: not random)


def param_specs(cfg: Dict) -> List[Spec]:
    """Every parameter of the configuration's model, with the port's names."""
    specs: List[Spec] = []

    def conv(prefix, k, cin, cout):
        specs.append((prefix + "kernel", (cout, cin, k, k),
                      math.sqrt(6.0 / (k * k * cin + k * k * cout))))
        specs.append((prefix + "bias", (cout,), 0.0))

    depth = len(cfg["down_conv_kernels"])
    cin, skips = cfg.get("in_channels", 1), []
    for lvl in range(depth):
        for j, (k, f) in enumerate(cfg["lstm_kernels"][lvl]):
            pre = f"encoder.{lvl}.lstm.{j}."
            specs.append((pre + "kernel_x", (4 * f, cin, k, k),
                          math.sqrt(6.0 / (k * k * cin + k * k * 4 * f))))
            specs.append((pre + "kernel_h", (4 * f, f, k, k),
                          math.sqrt(6.0 / (k * k * f + k * k * 4 * f))))
            specs.append((pre + "bias", (4 * f,), 0.0))
            cin = f
        for j, (k, f) in enumerate(cfg["down_conv_kernels"][lvl]):
            conv(f"encoder.{lvl}.convs.{j}.", k, cin, f)
            cin = f
        skips.append(cin)
    for lvl in reversed(range(depth)):
        c = cin + skips[lvl]
        for j, (k, f) in enumerate(cfg["up_conv_kernels"][lvl]):
            conv(f"decoder.{lvl}.convs.{j}.", k, c, f)
            c = f
        cin = c
    conv("head.", 1, cin, cfg.get("num_classes", 3))
    return specs


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device``, from ``seed``."""
    specs = param_specs(cfg)
    total = sum(math.prod(s) for _, s, lim in specs if lim > 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for name, shape, lim in specs:
        if lim > 0:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * lim
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
            if ".lstm." in name:
                f = shape[0] // 4
                out[name][f:2 * f] = 1.0
    return _rounded(cfg, out)


def _rounded(cfg: Dict, w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if cfg.get("weights_dtype", "float32") == "bfloat16":
        return {k: v.to(torch.bfloat16).float() for k, v in w.items()}
    return w


HEAD = ("head.kernel", "head.bias")
HEAD_GAIN = 2.0
HEAD_BIAS = (0.0, 0.0, -0.1)
FIT_STREAM = 36  # frames streamed, at most the sequence's
FIT_FRAMES = 4   # the last of them, read
FIT_QUANTILE = 0.85


@torch.no_grad()
def fit_head(cfg: Dict, weights: Dict[str, torch.Tensor], frames: List[torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """The fitted head (``head.kernel``, ``head.bias``) of ``weights`` on
    ``frames`` (normalised ``[1, 1, H, W]``, streamed from a zero state)."""
    from ..reference.model import Reference, no_tf32

    no_tf32()
    cin = weights["head.kernel"].shape[1]
    dev = frames[0].device
    probe = dict(weights)  # a head that passes its input through
    probe["head.kernel"] = torch.eye(cin, device=dev)[:, :, None, None]
    probe["head.bias"] = torch.zeros(cin, device=dev)
    ref = Reference(cfg, probe, "float")
    state = ref.init_state(1, frames[0].shape[2], frames[0].shape[3], dev)
    xs = []
    with torch.autocast(dev.type, dtype=torch.bfloat16):
        for i, f in enumerate(frames):
            state, x = ref.step(state, f)
            if i >= len(frames) - FIT_FRAMES:
                xs.append(x[0].float().flatten(1))
    x = torch.cat(xs, dim=1)
    x = x - x.mean(dim=1, keepdim=True)
    v = torch.linalg.eigh(x @ x.T)[1][:, -1]
    r = v @ x
    t = torch.quantile(r[:: max(1, r.numel() // 2 ** 22)], FIT_QUANTILE)
    g = HEAD_GAIN / torch.clamp(r.std(), min=1e-30)
    v = v[:, None, None]
    kernel = torch.stack([-g * v, g * v, torch.zeros_like(v)])
    bias = torch.stack([g * t, -g * t, torch.zeros_like(t)])
    bias = bias + torch.tensor(HEAD_BIAS, device=dev)
    return _rounded(cfg, {"head.kernel": kernel, "head.bias": bias})
