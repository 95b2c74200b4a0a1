"""Training loss (counterpart of ``lstm_unet_tpu/engine/loss.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..parallel.comm import all_reduce_


def weighted_ce_terms(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                      class_weights: Sequence[float],
                      full_seg: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sums of :func:`weighted_ce_loss`: ``(sum of the masked per-pixel
    loss, masked correct pixels, sum(mask))``, three f32 scalars."""
    k = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = (labels[..., None] == torch.arange(k, device=labels.device)).float()
    w = torch.tensor(list(class_weights), dtype=torch.float32, device=logits.device)
    per_pixel = -torch.sum(onehot * logp * w, dim=-1)
    mask = valid[:, :, None, None].float().expand(per_pixel.shape)
    if full_seg is not None:
        fg = (labels > 0).float()
        mask = mask * torch.maximum(full_seg[:, :, None, None].float(), fg)
    pred = torch.argmax(logits, dim=-1)
    return (torch.sum(per_pixel * mask), torch.sum((pred == labels).float() * mask),
            mask.sum())


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                     class_weights: Sequence[float],
                     full_seg: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-weighted softmax cross-entropy and pixel accuracy over the
    annotated frames: ``(loss, acc)``, two f32 scalars.

    ``logits [B,T,H,W,K]``, ``labels [B,T,H,W]`` in {0..K-1} (another value,
    such as -1, matches no class and adds nothing), ``valid [B,T]`` (frame
    annotated), ``full_seg [B,T]`` (annotation covers every cell): on a valid
    but partial frame only labelled (non-background) pixels count, since the
    unannotated cells sit in the background class. Both means divide by
    ``max(sum(mask), 1)``; log-softmax in f32.
    """
    total, hits, count = weighted_ce_terms(logits, labels, valid, class_weights, full_seg)
    denom = torch.clamp(count, min=1.0)
    return total / denom, hits / denom


def split_ce_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                  class_weights: Sequence[float], full_seg: Optional[torch.Tensor],
                  group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The loss of a batch split over the ranks of ``group`` (each holds its
    block of lanes and rows): ``(objective, loss, acc)``. ``loss`` and
    ``acc`` are :func:`weighted_ce_loss` of the whole batch, the numerators
    and ``sum(mask)`` all-reduced apart (not a mean of the ranks' means);
    ``objective`` is this rank's numerator over the whole batch's
    denominator, so the ranks' gradients of it sum to the gradient of
    ``loss``."""
    total, hits, count = weighted_ce_terms(logits, labels, valid, class_weights, full_seg)
    sums = all_reduce_(torch.stack([total.detach(), hits, count]), "sum", group)
    denom = torch.clamp(sums[2], min=1.0)
    return total / denom, sums[0] / denom, sums[1] / denom
