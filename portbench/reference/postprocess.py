"""Plain NumPy / SciPy reference of the instance postprocess.

From the description of the serving path's postprocess, importing nothing
of the port: interior = p(cell) > cell_thresh; 8-connected components, each
named by its first pixel in raster order; with ``instance_split`` and
``split_method='dist'`` merged components are split along their distance
ridge (markers are the regional maxima of the octagonal distance to the
background, grown back over the interior); components under
``min_cell_size`` pixels dropped; the rest grown into the band p(boundary)
> edge_thresh outside the interior, a pixel a round, each band pixel taking
the smallest label among its 8 neighbours, until nothing changes; ids made
compact 1..N in raster order of the components' first pixels. ``grow_iters``
> 0 caps the growth's rounds.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import ndimage

# the serving path's postprocess knobs at their defaults
DEFAULTS = dict(cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10, max_cell_size=0,
                size_filter="pre", FOV=0, boundary_growth="marker", grow_iters=0,
                instance_split=False, split_method="dist", split_window=16,
                split_min_dist=4, split_slack=1, split_rel=0.65, split_rel_window=48,
                split_min_size=0)
# knobs this reference implements only at these values
_FIXED = dict(max_cell_size=0, size_filter="pre", FOV=0, boundary_growth="marker",
              split_method="dist", split_min_size=0)
_EIGHT = np.ones((3, 3), bool)
_BIG = np.iinfo(np.int64).max


def components(mask: np.ndarray) -> np.ndarray:
    """8-connected components of ``mask``, each labelled with its first
    pixel's linear index + 1 (0 outside the mask), int64."""
    lab, n = ndimage.label(mask, structure=_EIGHT)
    if n == 0:
        return np.zeros(mask.shape, np.int64)
    _, first = np.unique(lab.ravel(), return_index=True)  # label 0 first when present
    ids = np.zeros(n + 1, np.int64)
    ids[1:] = first[-n:] + 1
    return ids[lab]


def _shifts(a: np.ndarray, fill):
    h, w = a.shape
    p = np.pad(a, 1, constant_values=fill)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                yield p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def grow(lbl: np.ndarray, band: np.ndarray, rounds: int = 0) -> np.ndarray:
    """Unlabelled ``band`` pixels take the smallest nonzero label of their 8
    neighbours, round after round, until a round changes nothing or after
    ``rounds`` rounds (0: no cap)."""
    lbl = lbl.copy()
    for _ in range(rounds) if rounds > 0 else iter(int, 1):
        masked = np.where(lbl > 0, lbl, _BIG)
        nb = np.full(lbl.shape, _BIG)
        for s in _shifts(masked, _BIG):
            np.minimum(nb, s, out=nb)
        take = (lbl == 0) & band & (nb != _BIG)
        if not take.any():
            return lbl
        lbl[take] = nb[take]
    return lbl


def _erode(mask: np.ndarray, eight: bool) -> np.ndarray:
    h, w = mask.shape
    p = np.pad(mask, 1, constant_values=False)
    out = mask.copy()
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)) + (
            ((1, 1), (1, -1), (-1, 1), (-1, -1)) if eight else ()):
        out &= p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return out


def octagon_distance(mask: np.ndarray) -> np.ndarray:
    """Rounds of erosion a pixel survives, plus one; the rounds alternate the
    8- and the 4-neighbourhood, the frame's border counting as background."""
    dist = mask.astype(np.int64)
    m, i = mask.copy(), 0
    while m.any():
        m = _erode(m, eight=i % 2 == 0)
        dist += m
        i += 1
    return dist


def _window_max(a: np.ndarray) -> np.ndarray:
    out = a.copy()
    for s in _shifts(a, 0):
        np.maximum(out, s, out=out)
    return out


def split_dist(lbl: np.ndarray, interior: np.ndarray, window: int, min_dist: int,
               slack: int, rel: float, rel_window: int) -> np.ndarray:
    dist = octagon_distance(interior)
    wmax = wide = dist
    for i in range(max(window, rel_window if rel > 0 else 0)):
        wide = _window_max(wide)
        if i + 1 == window:
            wmax = wide
    markers = interior & (dist >= wmax - slack) & (dist >= min_dist)
    if rel > 0:
        markers &= dist.astype(np.float32) >= np.float32(rel) * wide.astype(np.float32)
    grown = grow(components(markers), interior)
    return np.where(grown > 0, grown, lbl)


def compact(lbl: np.ndarray, min_size: int) -> np.ndarray:
    """Labels 1..N in increasing order of their old ids, components under
    ``min_size`` pixels dropped."""
    ids, inv, counts = np.unique(lbl.ravel(), return_inverse=True, return_counts=True)
    keep = (ids > 0) & (counts >= max(min_size, 1))
    new = np.cumsum(keep) * keep
    return new[inv].reshape(lbl.shape).astype(np.int32)


def postprocess(probs: np.ndarray, p: Dict) -> np.ndarray:
    """``[H, W, 3]`` probabilities -> int32 instance labels, for the
    serving parameters ``p`` (``cell_thresh``, ``edge_thresh``,
    ``min_cell_size``, ``instance_split`` and the 'dist' split's knobs)."""
    for k, v in _FIXED.items():
        if p.get(k, v) != v:
            raise ValueError(f"the reference postprocess implements {k}={v!r} only")
    interior = probs[..., 1] > np.float32(p["cell_thresh"])
    lbl = components(interior)
    if p.get("instance_split"):
        lbl = split_dist(lbl, interior, p["split_window"], p["split_min_dist"],
                         p["split_slack"], p["split_rel"], p["split_rel_window"])
    lbl = compact(lbl, p["min_cell_size"]).astype(np.int64)
    band = (probs[..., 2] > np.float32(p["edge_thresh"])) & ~interior
    return grow(lbl, band, p["grow_iters"]).astype(np.int32)


def label_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    """Share of the pixels labelled in ``a`` or ``b`` that lie outside the
    overlap of a mutually best-matched pair of instances (each instance's
    best match is the other map's instance it overlaps most): 0 for equal
    partitions, whatever the ids; a missing, extra, merged or split
    instance and every moved boundary pixel count."""
    fg = (a > 0) | (b > 0)
    total = int(fg.sum())
    if total == 0:
        return 0.0
    both = (a > 0) & (b > 0)
    pa, pb = a[both].astype(np.int64), b[both].astype(np.int64)
    if pa.size == 0:
        return 1.0
    pairs, counts = np.unique(np.stack([pa, pb]), axis=1, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    best_a: Dict[int, int] = {}
    best_b: Dict[int, int] = {}
    for i in order:
        ia, ib = int(pairs[0, i]), int(pairs[1, i])
        best_a.setdefault(ia, ib)
        best_b.setdefault(ib, ia)
    matched = sum(int(counts[i]) for i in range(counts.size)
                  if best_a[int(pairs[0, i])] == int(pairs[1, i])
                  and best_b[int(pairs[1, i])] == int(pairs[0, i]))
    return 1.0 - matched / total
