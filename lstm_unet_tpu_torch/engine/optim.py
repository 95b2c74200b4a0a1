"""The reference's optimizer, with optax's arithmetic, on PyTorch tensors.

The reference trains with ``optax.apply_if_finite(chain(clip_by_global_norm(
grad_clip_norm), adam(learning_rate)), max_consecutive_errors=10)``
(``lstm_unet_tpu/engine/train.py:242-250``). :class:`ClippedAdam` does the
same, in the same order of operations:

- clipping scales the grads by ``max_norm / g_norm`` only when ``g_norm >=
  max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- Adam as optax: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, the
  step count incremented first, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``;
- a step whose grads hold a non-finite value leaves the params, the moments
  and the count as they were, unless more than ``max_consecutive_errors``
  such steps came in a row: then the update is applied anyway;
- ``mu_dtype=torch.bfloat16`` stores ``mu`` in bf16 as ``adam(mu_dtype=
  bfloat16)`` under ``apply_if_finite`` does: the new moment is ``(1-b1) g +
  b1 mu`` in f32 with ``b1`` rounded to bf16 (JAX rounds the Python float to
  the array's dtype), the step's update uses that f32 moment, and only the
  stored ``mu`` is rounded to bf16. ``apply_if_finite`` runs the update
  inside ``lax.cond``, so XLA compiles it: the bf16 product stays exact in
  f32 and the sum is one fused multiply-add. Eager optax would round the
  product to bf16 first; the reference's train step is compiled too.

The decision is taken on the device (``torch.where``), so a step never waits
for the host. Params are updated in place. While the tracer stamps
(``utils/trace.py``), the norm with the finite and clip decisions is
stamped ``optimizer.norm`` and the per-parameter clip and update
``optimizer.update``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from ..utils import trace

INT32_MAX = 2 ** 31 - 1


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, as ``optax.global_norm``."""
    total = None
    for t in tensors:
        s = torch.sum(t * t)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < INT32_MAX, count + 1, count)


class ClippedAdam:
    """Adam state and update for the named parameters ``params``; the state
    is the reference's ``ApplyIfFiniteState`` around ``ScaleByAdamState``."""

    def __init__(self, params: Mapping[str, torch.Tensor], learning_rate: float,
                 grad_clip_norm: float = 0.0, skip_nonfinite_updates: bool = True,
                 max_consecutive_errors: int = 10, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32):
        self.lr = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.skip_nonfinite = skip_nonfinite_updates
        self.max_consecutive_errors = max_consecutive_errors
        self.b1, self.b2, self.eps = b1, b2, eps
        self.names = list(params)
        dev = next(iter(params.values())).device
        self.mu_dtype = mu_dtype
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype,
                                       memory_format=torch.preserve_format)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                   for n, p in params.items()}

        def scalar(v, dtype=torch.int32):
            return torch.tensor(v, dtype=dtype, device=dev)

        self.count = scalar(0)
        self.notfinite_count = scalar(0)
        self.last_finite = scalar(True, torch.bool)
        self.total_notfinite = scalar(0)

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Update ``params`` in place from ``grads``; returns the global norm
        of the raw grads (before clipping)."""
        gs = [grads[n] for n in self.names]
        with trace.stamp("optimizer.norm"):
            g_norm = global_norm(gs)
            apply = None
            if self.skip_nonfinite:
                finite = torch.stack([torch.isfinite(g).all() for g in gs]).all()
                self.notfinite_count = torch.where(
                    finite, torch.zeros_like(self.notfinite_count),
                    _safe_increment(self.notfinite_count))
                self.total_notfinite = torch.where(
                    finite, self.total_notfinite, _safe_increment(self.total_notfinite))
                self.last_finite = finite
                apply = finite | (self.notfinite_count > self.max_consecutive_errors)
            clip = None
            if self.grad_clip_norm and self.grad_clip_norm > 0:
                clip = g_norm < self.grad_clip_norm
            count = _safe_increment(self.count)
            bc1 = 1 - torch.pow(torch.tensor(self.b1, device=count.device), count.float())
            bc2 = 1 - torch.pow(torch.tensor(self.b2, device=count.device), count.float())
        # a low-precision mu: b1 rounded to mu's dtype, as JAX rounds the
        # Python float; the product of two bf16 values is exact in f32
        b1_mu = float(torch.tensor(self.b1, dtype=self.mu_dtype))
        c1 = float(np.float32(1 - self.b1))
        with trace.stamp("optimizer.update"):
            for n, g in zip(self.names, gs):
                p, mu, nu = params[n], self.mu[n], self.nu[n]
                if clip is not None:
                    g = torch.where(clip, g, (g / g_norm) * self.grad_clip_norm)
                if self.mu_dtype == torch.float32:
                    mu_new = (1 - self.b1) * g + self.b1 * mu
                else:
                    # optax's update runs compiled (apply_if_finite's lax.cond):
                    # XLA keeps b1 * mu in f32 and sums it with (1-b1) g in one
                    # FMA, a single rounding, which float64 reproduces
                    mu_new = (c1 * g.double() + (b1_mu * mu.float()).double()).float()
                nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
                upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
                p_new = p + upd * -self.lr
                mu_new = mu_new.to(self.mu_dtype)
                if apply is not None:
                    mu_new = torch.where(apply, mu_new, mu)
                    nu_new = torch.where(apply, nu_new, nu)
                    p_new = torch.where(apply, p_new, p)
                mu.copy_(mu_new)
                nu.copy_(nu_new)
                p.copy_(p_new)
        self.count = count if apply is None else torch.where(apply, count, self.count)
        return g_norm

    # -- state in the checkpoint layout -------------------------------------

    SCALARS = ("count", "notfinite_count", "last_finite", "total_notfinite")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``{"mu": {name: tensor}, "nu": {...}, "count": tensor, ...}``."""
        out = {"mu": dict(self.mu), "nu": dict(self.nu)}
        out.update({k: getattr(self, k) for k in self.SCALARS})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a :meth:`state_dict` (e.g. from :func:`checkpoint.convert.
        opt_state_from_jax`) into this optimizer's tensors."""
        for moment in ("mu", "nu"):
            mine, theirs = getattr(self, moment), state[moment]
            if set(mine) != set(theirs):
                raise KeyError(f"{moment}: names differ: "
                               f"{sorted(set(mine) ^ set(theirs))[:5]}")
            for n, t in theirs.items():
                mine[n].copy_(torch.as_tensor(t))
        for k in self.SCALARS:
            cur = getattr(self, k)
            setattr(self, k, torch.as_tensor(np.asarray(state[k])).to(cur))
