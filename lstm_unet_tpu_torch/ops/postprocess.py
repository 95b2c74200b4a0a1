"""Instance-segmentation postprocess on the device of the probabilities.

Counterpart of ``lstm_unet_tpu/ops/postprocess.py`` (its scatter branch):
threshold p(cell) -> 8-connected components -> optional split of touching
cells -> size filter -> growth into the boundary band -> FOV rule -> compact
raster-ordered ids. Labels are bit-identical to the reference for the same
probabilities.

The growth and erosion-distance loops are one kernel launch each on the
card and the 'dist' split's markers two (``kernels/postprocess_loops.py``),
so nothing here reads the device on the host; on the CPU the loops' plain
versions count their rounds in :data:`ROUNDS`. While the tracer stamps
(``utils/trace.py``), the components, the split and the growth are stamped
``ccl``, ``split`` and ``grow``.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .ccl import bincount, connected_components, relabel_compact
from .kernels.ccl import INT_MAX
from .kernels.postprocess_loops import ROUNDS, erosion_distance, grow_into_band  # noqa: F401
from .kernels.postprocess_loops import _f32, _neighbor_max, split_markers
from .kernels.postprocess_loops import erode as _erode

UINT16_MAX = 65535


def chebyshev_distance(mask: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
    """Chebyshev (8-connected) distance to background of each mask pixel (0
    outside the mask, 1 on a component's border) by iterated erosion;
    ``max_iters`` caps the rounds (0 = until the mask has eroded away)."""
    return erosion_distance(mask, max_iters, octagon=False)


def octagon_distance(mask: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
    """Octagonal distance to background: erosion by the 8- and the
    4-neighbourhood in turn, within ~8% of Euclidean in every direction. The
    marker stage of instance splitting uses this metric."""
    return erosion_distance(mask, max_iters, octagon=True)


def _component_sizes(lbl: torch.Tensor) -> torch.Tensor:
    """Per pixel, the pixel count of its label (of the background at 0)."""
    h, w = lbl.shape
    idx = lbl.reshape(-1).long()
    return bincount(idx, h * w + 1)[idx].reshape(h, w)


def _grow_markers(markers: torch.Tensor, lbl: torch.Tensor,
                  interior: torch.Tensor) -> torch.Tensor:
    """One seed per marker component, grown over the interior to the nearest
    marker; a component without a marker keeps its label of ``lbl`` (growth
    cannot cross background, and seed ids and kept labels are minimum indices
    of disjoint pixel sets, so they never collide)."""
    seeds = connected_components(markers.contiguous())
    grown = grow_into_band(seeds, interior.contiguous(), max_rounds=0)
    return torch.where(grown > 0, grown, lbl.clamp(min=0))


def split_touching_instances(lbl: torch.Tensor, interior: torch.Tensor,
                             window: int = 16, min_dist: int = 4,
                             slack: int = 1, rel: float = 0.65,
                             rel_window: int = 48, min_size: int = 0
                             ) -> torch.Tensor:
    """Partition merged components of touching cells along their distance
    ridge. Markers are the regional maxima of the octagon distance of
    ``interior``: pixels within ``slack`` of the maximum over their
    ``(2*window+1)``-square window, at least ``min_dist`` from background,
    reaching ``rel`` times the maximum over the wider ``rel_window`` window
    (compared in float32; 0 disables), in components of at least ``min_size``
    pixels (0 disables). Each marker plateau seeds one instance, grown over
    the interior to the nearest marker (:func:`grow_into_band`).

    ``lbl`` is the raw (or compact) labelling of ``interior``; returns int32
    labels of the same support, not compact."""
    interior = interior.contiguous()
    dist = octagon_distance(interior)
    markers = split_markers(dist, interior, window, min_dist, slack, rel, rel_window)
    if min_size > 0:
        # ineligible components get no markers, so they keep their labels
        markers &= _component_sizes(lbl) >= min_size
    return _grow_markers(markers, lbl, interior)


def split_touching_instances_prob(lbl: torch.Tensor, interior: torch.Tensor,
                                  p_cell: torch.Tensor, hi_thresh: float = 0.8,
                                  erode_iters: int = 1, min_size: int = 0
                                  ) -> torch.Tensor:
    """Partition merged components along the model's own confidence dips
    (two-threshold hysteresis): markers are ``interior & (p_cell >=
    hi_thresh)`` eroded ``erode_iters`` times, in components of at least
    ``min_size`` pixels; then one seed per marker component and the same
    growth as :func:`split_touching_instances`. A uniformly confident
    component has one marker and is reproduced exactly; one that never
    reaches ``hi_thresh`` keeps its label."""
    markers = interior & (p_cell >= _f32(hi_thresh))
    for _ in range(erode_iters):
        markers = _erode(markers, 8)
    if min_size > 0:
        markers &= _component_sizes(lbl) >= min_size
    return _grow_markers(markers, lbl, interior)


def postprocess_frame(probs: torch.Tensor, cell_thresh: float = 0.5,
                      edge_thresh: float = 0.3, min_cell_size: int = 10,
                      max_cell_size: int = 0, size_filter: str = "pre",
                      fov: int = 0, boundary_growth: str = "marker",
                      grow_iters: int = 0, instance_split: bool = False,
                      split_method: str = "dist", split_window: int = 16,
                      split_min_dist: int = 4, split_slack: int = 1,
                      split_rel: float = 0.65, split_rel_window: int = 48,
                      split_min_size: int = 0, split_hi_thresh: float = 0.8,
                      split_erode: int = 1) -> torch.Tensor:
    """3-class probabilities ``[H, W, 3]`` -> int32 instance labels ``[H, W]``.

    1. interior = p(cell) > cell_thresh; 2. 8-connected components;
    2b. with ``instance_split``, partition merged components of touching
    cells: ``split_method='dist'`` along distance ridges
    (:func:`split_touching_instances`) or ``'prob'`` along the model's
    confidence dips (:func:`split_touching_instances_prob`);
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
    if instance_split and split_method not in ("dist", "prob"):
        raise ValueError(f"unknown split_method {split_method!r}")
    if size_filter not in ("pre", "post"):
        raise ValueError(f"unknown size_filter {size_filter!r}")
    if boundary_growth not in ("marker", "dilate", "none"):
        raise ValueError(f"unknown boundary_growth {boundary_growth!r}")
    probs = probs.float()
    h, w = probs.shape[0], probs.shape[1]
    interior = (probs[..., 1] > cell_thresh).contiguous()
    with trace.stamp("ccl"):
        raw = connected_components(interior)
    if instance_split and split_method == "prob":
        with trace.stamp("split"):
            raw = split_touching_instances_prob(
                raw, interior, probs[..., 1], hi_thresh=split_hi_thresh,
                erode_iters=split_erode, min_size=split_min_size)
    elif instance_split:
        with trace.stamp("split"):
            raw = split_touching_instances(
                raw, interior, window=split_window, min_dist=split_min_dist,
                slack=split_slack, rel=split_rel, rel_window=split_rel_window,
                min_size=split_min_size)
    pre_min = 0 if size_filter == "post" else min_cell_size
    pre_max = 0 if size_filter == "post" else max_cell_size
    lbl, n1 = relabel_compact(raw, min_size=pre_min, max_size=pre_max)
    overflowed = n1 > UINT16_MAX

    if boundary_growth != "none":
        with trace.stamp("grow"):
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
        keep[:1].fill_(False)
        kept = keep[lbl.reshape(-1).long().clamp(max=n - 1)].reshape(h, w)
        lbl = torch.where(kept, lbl, torch.zeros_like(lbl))
        lbl, _ = relabel_compact(lbl, num_bins=n)
    return torch.where(overflowed, torch.full_like(lbl, INT_MAX), lbl)
