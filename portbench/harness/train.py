"""Training cells: the port's truncated-BPTT step, driven as its trainer does.

Set-up builds one training step (the model with the benchmark's weights,
``ClippedAdam`` and ``make_train_step``), then drives that same step
through its first ``check_steps`` steps on the cell's first batches, each
uploaded as ``Trainer._put`` uploads one and each loss read one step late,
and hands the same objects to the window. Those steps are the warm-up and
what the output check reads: each step's loss, the first gradient as
Adam's first moment holds it after step 1, the parameters' change over the
steps, the state step 1 carries on and the state a step that ends a
sequence leaves (zeros). The traffic starts them two windows before the
sequence's end, so that the second resets every lane's state and the third
starts from zeros. The window goes on with the next
batches; the LSTM state is carried from step to step and reset where a
lane's sequence ends.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.utils.checkpoint

from . import check, port, trace, traffic
from .stream import settle
from .weights import make_weights
from ..reference import model as ref_model

B1 = 0.9


def _put(batch, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) for k, v in tensors.items()}


class Training:
    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, device
        tr = cell.traffic
        self.batches = traffic.train_batches(tr, seed)
        weights = make_weights(cell.config, seed, device)
        self.model = port.load_model(cell.config, weights, device, training=True)
        del weights
        self.opt, self.step_fn = port.train_step(self.model, tr["optimizer"],
                                                 tr["class_weights"], tr["remat"])
        b, (h, w) = tr["batch"], tr["crop"]
        self.state = self.model.init_state(b, h, w, device=device)
        self.pending = None
        self.ended = False  # whether the last step ended a lane's sequence

    def step(self, traced: bool = False):
        """One step as the trainer takes it; returns the previous step's loss
        (read now that this one is queued), or None."""
        with trace.span("batch_put", traced):
            batch = next(self.batches)
            img, seg, valid, full, last = _put(batch, self.device)
        self.ended = bool(batch[4].any())
        with trace.span("train_step", traced):
            self.state, m = self.step_fn(self.state, img, seg, valid, full, last)
        prev, self.pending = self.pending, m["loss"]
        if prev is None:
            return None
        with trace.span("loss_read", traced):
            return float(prev)

    def drain(self):
        prev, self.pending = self.pending, None
        return None if prev is None else float(prev)


def loop(tr: Training, seconds: float, traced: bool = False) -> Dict:
    steps = 0
    t0 = time.perf_counter()
    stop = t0 + seconds
    while time.perf_counter() < stop or steps == 0:
        tr.step(traced)
        steps += 1
    with trace.span("loss_read", traced):
        tr.drain()
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(steps=steps, window_s=time.perf_counter() - t0)


# ------------------------------------------------------------ the reference


class ReferenceTraining:
    """The plain f32 reference of the cell's first steps: the same weights
    and batches, the class-weighted loss, autograd's gradients (each
    frame's step recomputed in the backward, to fit), clipping and Adam
    with optax's arithmetic. ``precision`` and ``half_batch`` put a control
    or a fault in the program's place."""

    def __init__(self, cell, seed: int, device, precision: str = "float",
                 half_batch: bool = False):
        ref_model.no_tf32()
        self.cell, self.device, self.half = cell, device, half_batch
        tr = cell.traffic
        self.params = {k: v.requires_grad_(True)
                       for k, v in make_weights(cell.config, seed, device).items()}
        self.model = ref_model.Reference(cell.config, self.params, precision)
        self.batches = traffic.train_batches(tr, seed)
        self.opt = tr["optimizer"]
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        b, (h, w) = tr["batch"], tr["crop"]
        self.state = self.model.init_state(b, h, w, device)
        self.ended = False

    def _nest(self, flat):
        """The flat list of state tensors back in the state's levels and layers."""
        out, at = [], 0
        for lvl in self.state:
            out.append([(flat[at + 2 * j], flat[at + 2 * j + 1]) for j in range(len(lvl))])
            at += 2 * len(lvl)
        return out

    def _frame(self, x, *flat):
        new, logits = self.model.step(self._nest(flat), x)
        return (logits,) + tuple(t for lvl in new for pair in lvl for t in pair)

    def step(self) -> float:
        tr = self.cell.traffic
        batch = next(self.batches)
        img, seg, _, _, last = _put(batch, self.device)
        self.ended = bool(batch[4].any())
        lanes = img.shape[0] // 2 if self.half else img.shape[0]
        flat = [t for lvl in self.state for pair in lvl for t in pair]
        losses = []
        for t in range(img.shape[1]):
            x = img[:, t].permute(0, 3, 1, 2).contiguous()
            out = torch.utils.checkpoint.checkpoint(self._frame, x, *flat, use_reentrant=False)
            logits, flat = out[0], list(out[1:])
            losses.append(ref_model.class_weighted_ce(logits[:lanes], seg[:lanes, t],
                                                      tr["class_weights"]))
        loss = torch.stack(losses).mean()
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = self.opt["grad_clip_norm"]
        if clip > 0 and float(g_norm) >= clip:
            grads = [g / g_norm * clip for g in grads]
        self.count += 1
        b2, eps, lr = 0.999, 1e-8, self.opt["learning_rate"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                self.mu[k].mul_(B1).add_((1 - B1) * g)
                self.nu[k].mul_(b2).add_((1 - b2) * g * g)
                upd = (self.mu[k] / (1 - B1 ** self.count)) / (
                    torch.sqrt(self.nu[k] / (1 - b2 ** self.count)) + eps)
                self.params[k].add_(upd * -lr)
            keep = (1 - last)[:, None, None, None]
            flat = [t.detach() * keep for t in flat]
        self.state = self._nest(flat)
        return float(loss.detach())


def reference_readings(ref: ReferenceTraining, steps: int) -> Dict:
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    losses, grad, states = [], None, {}
    for s in range(steps):
        losses.append(ref.step())
        if s == 0:
            grad = {k: float(torch.linalg.vector_norm(m)) / (1 - B1) for k, m in ref.mu.items()}
        if s == 0 or ref.ended:
            states[s] = ref.state
    change = {k: float(torch.linalg.vector_norm(ref.params[k].detach() - p0[k])) for k in p0}
    return dict(losses=losses, grad=grad, change=change, states=states)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``states`` maps a step to the state it left: step 0's, and each one's
    that ended a sequence. The program's are NHWC, as it carries them; the
    reference's NCHW."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    med = float(np.median(list(ref["grad"].values())))
    silent = [k for k, g in ref["grad"].items() if g < 1e-3 * med]
    out = {"loss_gap": loss_gap,
           "grad_gap": check.norm_gaps(prog["grad"], ref["grad"]),
           "change_gap": check.norm_gaps(prog["change"], ref["change"], silent),
           "state_gap": check.state_gap(prog["states"][0], ref["states"][0])}
    ends = [s for s in ref["states"] if s > 0]
    if ends:
        out["reset_gap"] = max(check.max_abs_gap(prog["states"].get(s), ref["states"][s])
                               for s in ends)
    return out


# ------------------------------------------------------------ a run


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict:
    tr = Training(cell, seed, device)
    n_check = cell.traffic["check_steps"]
    p0 = {k: v.detach().to("cpu", copy=True) for k, v in tr.model.named_parameters()}
    losses: List = []
    grad, states = None, {}
    for s in range(n_check):
        prev = tr.step()
        if prev is not None:
            losses.append(prev)
        if s == 0:
            grad = {k: v / (1 - B1) for k, v in leaf_norms(tr.opt.mu).items()}
        if s == 0 or tr.ended:
            states[s] = [[tuple(t.detach().to("cpu", copy=True) for t in pair) for pair in lvl]
                         for lvl in tr.state]
    losses.append(tr.drain())
    change = {k: float(torch.linalg.vector_norm(v.detach().to("cpu").float() - p0[k]))
              for k, v in tr.model.named_parameters()}
    del p0
    setup_s = time.perf_counter() - t_start
    settle()

    out: Dict = {"setup_s": setup_s}
    if not traced:
        w = loop(tr, seconds)
    else:
        profiled = min(seconds / 2, trace.PROFILED_S)
        w = loop(tr, seconds - profiled)
        out["rate"] = w["steps"] / w["window_s"]
        with trace.profiler() as prof:
            t0 = time.perf_counter()
            w = loop(tr, profiled, traced=True)
            out["profiled_s"] = time.perf_counter() - t0
        out["trace"] = trace.reduce(prof)
    out.update(steps=w["steps"], window_s=w["window_s"])
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del tr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(ReferenceTraining(cell, seed, device), n_check)
    out["numbers"] = compare(dict(losses=losses, grad=grad, change=change, states=states), ref)
    return out
