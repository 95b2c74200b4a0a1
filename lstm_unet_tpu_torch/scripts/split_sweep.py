"""Offline calibration sweep for instance splitting on saved masks.

Counterpart of the reference's ``scripts/split_sweep.py``, with the same
flags, grids and printed table. It takes saved prediction masks, re-splits
every saved component on its own bounding-box crop with the NumPy twins of
the splitters (``ops/postprocess.py::split_touching_instances`` and
``split_touching_instances_prob``), rebuilds the frame and re-scores SEG
against GT for a grid of splitter parameters. It runs on the host: an
offline proxy on saved masks, not the device pipeline. One proxy difference
is documented: saved masks are taken after the boundary growth, so their
footprints include the boundary band (sizes ~15-30% larger, distance peaks
~1-2 higher than the interior the pipeline splits). A winning config must be
re-run in the pipeline (``ctc_sweep --instance_split ...``) before any
default changes.

Usage:
    python -m lstm_unet_tpu_torch.scripts.split_sweep \
        --gt_root HELDOUT/eval --pred_root RESULTS [--method prob] [--seqs 02,03]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np
import scipy.ndimage as ndi

from ..io.tiff import read_tiff
from ..metrics import seg_measure


_S8 = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
_S4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
_INT_MAX = np.iinfo(np.int64).max
_STRUCT8 = np.ones((3, 3), bool)


def _erode(m, shifts):
    p = np.pad(m, 1)
    out = m.copy()
    for dy, dx in shifts:
        out &= p[1 + dy:1 + dy + m.shape[0], 1 + dx:1 + dx + m.shape[1]]
    return out


def octagon_distance(mask):
    m = mask.astype(bool)
    d = m.astype(np.int32)
    it = 0
    while m.any():
        m = _erode(m, _S8 if it % 2 == 0 else _S4)
        d += m
        it += 1
    return d


def window_max_snapshots(d, windows):
    """Chebyshev window max of ``d`` at every radius in ``windows``
    (ascending), returned as {radius: array} with one cumulative pass."""
    want = sorted(set(windows))
    out = {}
    cur = d.copy()
    if want and want[0] == 0:
        out[0] = cur.copy()
        want = want[1:]
    for r in range(1, (want[-1] if want else 0) + 1):
        cur = ndi.maximum_filter(cur, size=3, mode="constant")
        if r in want:
            out[r] = cur.copy()
    return out


def grow(lbl, band):
    cur = lbl.astype(np.int64)
    while True:
        masked = np.where(cur > 0, cur, _INT_MAX)
        p = np.pad(masked, 1, constant_values=_INT_MAX)
        nb = np.full(cur.shape, _INT_MAX, np.int64)
        for dy, dx in _S8:
            nb = np.minimum(
                nb, p[1 + dy:1 + dy + cur.shape[0], 1 + dx:1 + dx + cur.shape[1]])
        new = np.where((cur == 0) & band & (nb != _INT_MAX), nb, cur)
        if np.array_equal(new, cur):
            return cur.astype(np.int32)
        cur = new


class Component:
    """One pred component with its param-independent precomputes."""

    __slots__ = ("label", "size", "mask", "dist", "wmax", "slice", "p_cell")

    def __init__(self, label, mask_crop, slc):
        self.label = label
        self.size = int(mask_crop.sum())
        self.mask = mask_crop
        self.slice = slc
        self.dist = None  # filled lazily (only for eligible components)
        self.wmax = None
        self.p_cell = None  # prob mode: p(cell) crop


def components_of(pred):
    # saved masks may have touching distinct labels (post-growth); split on
    # the SAVED labels, not the binary CCL, to preserve existing boundaries
    out = []
    for p in np.unique(pred):
        if p == 0:
            continue
        m = pred == p
        slc = ndi.find_objects(m.astype(np.int8), max_label=1)[0]
        pad = 2
        y0 = max(slc[0].start - pad, 0)
        y1 = min(slc[0].stop + pad, pred.shape[0])
        x0 = max(slc[1].start - pad, 0)
        x1 = min(slc[1].stop + pad, pred.shape[1])
        s = (slice(y0, y1), slice(x0, x1))
        out.append(Component(int(p), m[s], s))
    return out


def split_component(comp, windows, cfg):
    """Return list of marker masks (crop coords) the component splits into,
    or None when the config leaves it unchanged."""
    window, min_dist, slack, rel, rel_window, min_size = cfg
    if min_size > 0 and comp.size < min_size:
        return None
    if comp.dist is None:
        comp.dist = octagon_distance(comp.mask)
        comp.wmax = window_max_snapshots(comp.dist, windows)
    dist = comp.dist
    wmax = comp.wmax[window]
    markers = comp.mask & (dist >= wmax - slack) & (dist >= min_dist)
    if rel > 0:
        wide = comp.wmax[max(window, rel_window)]
        markers &= dist.astype(np.float32) >= rel * wide.astype(np.float32)
    seeds, n = ndi.label(markers, structure=_STRUCT8)
    if n < 2:
        return None
    grown = grow(seeds, comp.mask)
    # marker-less remainder keeps the original label (twin semantics)
    return [(grown == i) for i in range(1, n + 1)]


def split_component_prob(comp, cfg):
    """Hysteresis variant (ops/postprocess.py::split_touching_instances_prob
    twin on the bbox crop): markers = p(cell) >= hi, eroded; same growth.

    Proxy note: saved masks are POST-growth; the band pixels are boundary-
    class (p(cell) < cell_thresh << hi) so the MARKERS are identical to the
    in-pipeline pre-growth ones — only the growth target (post-growth
    footprint vs interior) differs, same caveat as the dist mode.
    """
    hi, erode_iters, min_size = cfg
    if min_size > 0 and comp.size < min_size:
        return None
    markers = comp.mask & (comp.p_cell >= hi)
    for _ in range(erode_iters):
        markers = _erode(markers, _S8)
    seeds, n = ndi.label(markers, structure=_STRUCT8)
    if n < 2:
        return None
    grown = grow(seeds, comp.mask)
    return [(grown == i) for i in range(1, n + 1)]


def apply_config(pred, comps, windows, cfg, method="dist"):
    out = pred.astype(np.int32).copy()
    nxt = int(pred.max()) + 1
    changed = 0
    for comp in comps:
        if method == "prob":
            parts = split_component_prob(comp, cfg)
        else:
            parts = split_component(comp, windows, cfg)
        if parts is None:
            continue
        changed += 1
        for part in parts:
            out_sl = out[comp.slice]
            out_sl[part & comp.mask] = nxt
            nxt += 1
    return out, changed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--dataset", default="Synth-N2DH-SIM")
    ap.add_argument("--seqs", default="")
    ap.add_argument("--min_dist", type=int, default=4)
    ap.add_argument("--method", default="dist", choices=("dist", "prob"),
                    help="'prob' needs probs*.npy dumps in "
                         "<seq>_RES/intermediate/ (ctc_sweep "
                         "--save_intermediate)")
    args = ap.parse_args(argv)

    if args.method == "prob":
        # grid: hi_thresh x erode x min_size (post-growth footprint sizes)
        CONFIGS = [(hi, er, msz)
                   for hi in (0.6, 0.7, 0.8, 0.9)
                   for er in (0, 1, 2)
                   for msz in (0, 3500, 6000)]
        windows = []
    else:
        # grid: window x slack x rel(window) x min_size, min_dist fixed.
        # sizes here are POST-growth footprints (see module docstring).
        CONFIGS = []
        for window in (12, 16):
            for slack in (1, 2):
                for rel, rel_window in ((0.65, 48), (0.5, 48), (0.0, 0)):
                    for min_size in (0, 3500, 6000):
                        CONFIGS.append((window, args.min_dist, slack, rel,
                                        rel_window, min_size))
        windows = sorted({c[0] for c in CONFIGS} |
                         {max(c[0], c[4]) for c in CONFIGS if c[3] > 0})

    ds_gt = os.path.join(args.gt_root, args.dataset)
    seqs = sorted(d[:-3] for d in os.listdir(ds_gt) if d.endswith("_GT"))
    if args.seqs:
        keep = set(args.seqs.split(","))
        seqs = [s for s in seqs if s in keep]

    # totals[cfg] = [seg_sum, n_objects]; baseline separate
    base = defaultdict(lambda: [0.0, 0])
    totals = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    splits = defaultdict(int)
    for seq in seqs:
        gt_dir = os.path.join(ds_gt, f"{seq}_GT", "SEG")
        pred_dir = os.path.join(args.pred_root, args.dataset, f"{seq}_RES")
        if not os.path.isdir(pred_dir):
            # a GT sequence with no predictions at all is not part of this
            # calibration run (e.g. dumps made with ctc_sweep --seqs) —
            # scoring it 0 would poison the seq-avg mean
            print(f"baseline seq {seq}: no predictions — skipped", flush=True)
            continue
        for gp in sorted(glob.glob(os.path.join(gt_dir, "man_seg*.tif"))):
            t = int(re.search(r"(\d+)\.tif$", gp).group(1))
            pp = os.path.join(pred_dir, f"mask{t:03d}.tif")
            if not os.path.exists(pp):
                continue
            gt = np.asarray(read_tiff(gp))
            pred = np.asarray(read_tiff(pp))
            s, n = seg_measure(gt, pred)
            base[seq][0] += s
            base[seq][1] += n
            comps = components_of(pred)
            if args.method == "prob":
                probp = os.path.join(pred_dir, "intermediate",
                                     f"probs{t:03d}.npy")
                p_cell = np.load(probp)[..., 1]
                for comp in comps:
                    comp.p_cell = p_cell[comp.slice]
            for cfg in CONFIGS:
                new_pred, changed = apply_config(pred, comps, windows, cfg,
                                                 method=args.method)
                s2, n2 = seg_measure(gt, new_pred)
                totals[cfg][seq][0] += s2
                totals[cfg][seq][1] += n2
                splits[cfg] += changed
        b = base[seq]
        print(f"baseline seq {seq}: SEG {b[0] / max(b[1], 1):.4f}", flush=True)

    def seq_mean(per_seq):
        vals = [v[0] / max(v[1], 1) for v in per_seq.values()]
        return sum(vals) / len(vals)

    base_mean = seq_mean(base)
    print(f"\nbaseline mean (seq-avg, CTC convention): {base_mean:.4f}\n")
    rows = []
    for cfg in CONFIGS:
        m = seq_mean(totals[cfg])
        rows.append((m, cfg))
    rows.sort(reverse=True)
    if args.method == "prob":
        print(f"{'mean':>7} {'delta':>8} {'hi':>5} {'er':>3} {'minsz':>6} "
              f"{'nsplit':>6}")
        for m, cfg in rows:
            hi, er, msz = cfg
            print(f"{m:7.4f} {m - base_mean:+8.4f} {hi:5.2f} {er:3d} "
                  f"{msz:6d} {splits[cfg]:6d}")
    else:
        print(f"{'mean':>7} {'delta':>8} {'w':>3} {'sl':>3} {'rel':>5} "
              f"{'relw':>5} {'minsz':>6} {'nsplit':>6}")
        for m, cfg in rows:
            w, md, sl, rel, relw, msz = cfg
            print(f"{m:7.4f} {m - base_mean:+8.4f} {w:3d} {sl:3d} {rel:5.2f} "
                  f"{relw:5d} {msz:6d} {splits[cfg]:6d}")


if __name__ == "__main__":
    main()
