"""Instance-segmentation postprocess on the device of the probabilities.

Counterpart of ``lstm_unet_tpu/ops/postprocess.py`` (its scatter branch):
threshold p(cell) -> 8-connected components -> size filter -> growth into
the boundary band -> FOV rule -> compact raster-ordered ids. Labels are
bit-identical to the reference for the same probabilities.
"""

from __future__ import annotations

import torch

from .ccl import bincount, connected_components, relabel_compact
from .kernels.ccl import INT_MAX, pad1

UINT16_MAX = 65535


def _neighbor_max(lbl: torch.Tensor) -> torch.Tensor:
    """Max over the 8-neighbourhood and the pixel itself, edges padded 0."""
    h, w = lbl.shape
    p = pad1(lbl, 0)
    out = lbl
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.maximum(out, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def _neighbor_min_nonzero(lbl: torch.Tensor) -> torch.Tensor:
    """Min nonzero label over the 8-neighbourhood (INT_MAX where none)."""
    h, w = lbl.shape
    masked = torch.where(lbl > 0, lbl, torch.full_like(lbl, INT_MAX))
    p = pad1(masked, INT_MAX)
    out = torch.full_like(lbl, INT_MAX)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.minimum(out, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def grow_into_band(lbl: torch.Tensor, band: torch.Tensor, max_rounds: int = 0
                   ) -> torch.Tensor:
    """Simultaneous-BFS growth of labels into ``band`` pixels: every round
    each unlabelled band pixel next to a label takes the smallest
    neighbouring label, so each band pixel goes to its geodesically nearest
    marker and ties go to the smaller label. Stops when a round changes
    nothing, after ``max_rounds`` rounds when > 0, and after H*W rounds."""
    h, w = lbl.shape
    bound = max_rounds if max_rounds > 0 else h * w
    it, changed = 0, True
    while changed and it < bound:
        nb = _neighbor_min_nonzero(lbl)
        new = torch.where((lbl == 0) & band & (nb != INT_MAX), nb, lbl)
        changed = bool((new != lbl).any())
        lbl, it = new, it + 1
    return lbl


def postprocess_frame(probs: torch.Tensor, cell_thresh: float = 0.5,
                      edge_thresh: float = 0.3, min_cell_size: int = 10,
                      max_cell_size: int = 0, size_filter: str = "pre",
                      fov: int = 0, boundary_growth: str = "marker",
                      grow_iters: int = 0, instance_split: bool = False
                      ) -> torch.Tensor:
    """3-class probabilities ``[H, W, 3]`` -> int32 instance labels ``[H, W]``.

    1. interior = p(cell) > cell_thresh; 2. 8-connected components;
    3. drop components outside [min_cell_size, max_cell_size] — before the
    growth (``size_filter='pre'``) or on the grown extent (``'post'``);
    4. grow into the band p(boundary) > edge_thresh outside the interior:
    'marker' to exhaustion (``grow_iters`` caps it), 'dilate' for
    ``grow_iters`` (default 3) rounds of max-label dilation, or 'none';
    5. with ``fov`` > 0, drop instances that never enter the region ``fov``
    pixels in from every border; 6. compact ids 1..N in raster order.
    More than 65535 surviving instances (past the uint16 mask contract)
    poison the whole map with INT_MAX, so the engine's check raises.
    """
    if instance_split:
        raise NotImplementedError(
            "instance_split is not ported yet (ROADMAP.md queue 1 item 10)")
    if size_filter not in ("pre", "post"):
        raise ValueError(f"unknown size_filter {size_filter!r}")
    if boundary_growth not in ("marker", "dilate", "none"):
        raise ValueError(f"unknown boundary_growth {boundary_growth!r}")
    probs = probs.float()
    h, w = probs.shape[0], probs.shape[1]
    interior = (probs[..., 1] > cell_thresh).contiguous()
    raw = connected_components(interior)
    pre_min = 0 if size_filter == "post" else min_cell_size
    pre_max = 0 if size_filter == "post" else max_cell_size
    lbl, n1 = relabel_compact(raw, min_size=pre_min, max_size=pre_max)
    overflowed = n1 > UINT16_MAX

    if boundary_growth != "none":
        band = (probs[..., 2] > edge_thresh) & ~interior
        if boundary_growth == "marker":
            lbl = grow_into_band(lbl, band, max_rounds=grow_iters)
        else:
            for _ in range(grow_iters if grow_iters > 0 else 3):
                lbl = torch.where((lbl == 0) & band, _neighbor_max(lbl), lbl)

    if size_filter == "post":
        lbl, n2 = relabel_compact(lbl, min_size=min_cell_size,
                                  max_size=max_cell_size)
        overflowed |= n2 > UINT16_MAX

    if fov > 0:
        # ids are compact here, and the mask contract is uint16: 65536 bins
        n = min(h * w + 1, UINT16_MAX + 1)
        rows = torch.arange(h, device=lbl.device)[:, None]
        cols = torch.arange(w, device=lbl.device)[None, :]
        inside = (rows >= fov) & (rows < h - fov) & (cols >= fov) & (cols < w - fov)
        touch_idx = torch.where(inside, lbl, torch.zeros_like(lbl))
        touches = bincount(touch_idx.reshape(-1).long().clamp(max=n - 1), n)
        keep = touches > 0
        keep[0] = False
        kept = keep[lbl.reshape(-1).long().clamp(max=n - 1)].reshape(h, w)
        lbl = torch.where(kept, lbl, torch.zeros_like(lbl))
        lbl, _ = relabel_compact(lbl, num_bins=n)
    return torch.where(overflowed, torch.full_like(lbl, INT_MAX), lbl)
