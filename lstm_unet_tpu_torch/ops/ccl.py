"""Connected-component labelling and compaction.

Counterpart of ``lstm_unet_tpu/ops/ccl.py``. :func:`connected_components`
labels each 8-connected component with its minimum linear index + 1 (the
CUDA kernel K3 on the card, its plain version on the CPU; both in
``kernels/ccl.py``). :func:`relabel_compact` follows the reference's scatter
contract. The reference's MXU emulations of scatter and gather
(``relabel_compact_mm``, ``mm_histogram*``, ``mm_lookup``) exist to work
around the TPU and give the same outputs; they have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels.ccl import connected_components  # noqa: F401


def bincount(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 histogram of int64 ``idx`` in ``[0, n)`` (scatter-add: unlike
    ``torch.bincount`` it needs no host read of the maximum on a GPU)."""
    counts = torch.zeros((n,), dtype=torch.int32, device=idx.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def relabel_compact(labels: torch.Tensor, min_size: int = 0, max_size: int = 0,
                    num_bins: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact sparse labels ``[H, W]`` to 1..N in raster order of their
    seeds, dropping components outside ``[min_size, max_size]`` (0 = no
    bound). Returns ``(int32 labels, int32 scalar N)``.

    ``num_bins`` bounds the histogram when the labels are known to be
    already compact; larger labels are clamped into the last bin."""
    h, w = labels.shape
    n = num_bins or (h * w + 1)
    idx = labels.reshape(-1).long()
    if num_bins:
        idx = idx.clamp(max=n - 1)
    counts = bincount(idx, n)
    keep = counts > 0
    keep[0] = False
    if min_size:
        keep &= counts >= min_size
    if max_size:
        keep &= counts <= max_size
    new_ids = torch.cumsum(keep.int(), 0, dtype=torch.int32) * keep
    return new_ids[idx].reshape(h, w), new_ids.max()
