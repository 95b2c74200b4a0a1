"""Training loss (counterpart of ``lstm_unet_tpu/engine/loss.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


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
    k = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = (labels[..., None] == torch.arange(k, device=labels.device)).float()
    w = torch.tensor(list(class_weights), dtype=torch.float32, device=logits.device)
    per_pixel = -torch.sum(onehot * logp * w, dim=-1)
    mask = valid[:, :, None, None].float().expand(per_pixel.shape)
    if full_seg is not None:
        fg = (labels > 0).float()
        mask = mask * torch.maximum(full_seg[:, :, None, None].float(), fg)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(per_pixel * mask) / denom
    pred = torch.argmax(logits, dim=-1)
    acc = torch.sum((pred == labels).float() * mask) / denom
    return loss, acc
