"""The port's instance splitting against the JAX reference: both erosion
distances, both splitters and ``postprocess_frame(instance_split=True)`` give
equal labels, exactly, for the same inputs (made from a numpy seed). The
behavioural cases of ``tests/test_split.py`` (two touching cells split, a
single cell untouched, ``min_size`` eligibility, a marker-less component keeps
its label) are held on the port's functions too, and the split's plain
markers to a numpy twin of the markers kernel's walk."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from lstm_unet_tpu.ops import postprocess as jax_pp
from lstm_unet_tpu_torch.io.synthetic import cell_like_probs
from lstm_unet_tpu_torch.ops import postprocess as pp
from lstm_unet_tpu_torch.ops.kernels import ccl, counts, postprocess_loops, reset_counts


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ccl_np(mask):
    """Component-min linear index + 1, from scipy's labelling."""
    ref, n = ndi.label(mask, structure=np.ones((3, 3)))
    out = np.zeros(mask.shape, np.int32)
    idx = np.arange(mask.size).reshape(mask.shape)
    for lab in range(1, n + 1):
        sel = ref == lab
        out[sel] = idx[sel].min() + 1
    return out


def _ellipse(h, w, cy, cx, ry, rx):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def _blobs(seed, h=64, w=64, pct=60):
    field = ndi.gaussian_filter(np.random.default_rng(seed).random((h, w)), 3.0)
    return field > np.percentile(field, pct)


@pytest.mark.parametrize("max_iters", [0, 3])
@pytest.mark.parametrize("name", ["chebyshev_distance", "octagon_distance"])
def test_distance_equals_jax(name, max_iters):
    for mask in (np.random.default_rng(0).random((40, 56)) > 0.55, _blobs(1, 48, 70),
                 np.ones((9, 13), bool), np.zeros((5, 5), bool)):
        got = getattr(pp, name)(_t(mask), max_iters)
        want = np.asarray(getattr(jax_pp, name)(jnp.asarray(mask), max_iters))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_erode_equals_jax(connectivity):
    mask = _blobs(2, 33, 47, 40)
    np.testing.assert_array_equal(
        pp._erode(_t(mask), connectivity).numpy(),
        np.asarray(jax_pp._erode(jnp.asarray(mask), connectivity)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window,min_dist,slack,rel,rel_window",
                         [(3, 2, 0, 0.0, 0), (8, 4, 1, 0.65, 24),
                          (16, 4, 2, 0.5, 20)])
def test_split_equals_jax(seed, window, min_dist, slack, rel, rel_window):
    interior = _blobs(seed)
    lbl = _ccl_np(interior)
    kw = dict(window=window, min_dist=min_dist, slack=slack, rel=rel,
              rel_window=rel_window)
    got = pp.split_touching_instances(_t(lbl), _t(interior), **kw)
    want = np.asarray(jax_pp.split_touching_instances(
        jnp.asarray(lbl), jnp.asarray(interior), **kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# the marker cases test_split_equals_jax lacks: (shape, window, min_dist,
# slack, rel, rel_window); 2R+1 = 97 exceeds the 40x56 frame
MARKER_CASES = {
    "window > rel_window": ((64, 64), 12, 3, 1, 0.65, 5),
    "rel = 0": ((64, 64), 8, 3, 1, 0.0, 48),
    "window = 0": ((64, 64), 0, 3, 0, 0.65, 10),
    "frame below 2R+1": ((40, 56), 16, 3, 1, 0.65, 48),
    "non-square": ((48, 96), 6, 3, 2, 0.5, 20),
}


@pytest.mark.parametrize("case", list(MARKER_CASES))
def test_split_equals_jax_at_the_marker_edge_cases(case):
    (h, w), window, min_dist, slack, rel, rel_window = MARKER_CASES[case]
    interior = _blobs(7, h, w, 50)
    lbl = _ccl_np(interior)
    kw = dict(window=window, min_dist=min_dist, slack=slack, rel=rel, rel_window=rel_window)
    got = pp.split_touching_instances(_t(lbl), _t(interior), **kw)
    want = np.asarray(jax_pp.split_touching_instances(
        jnp.asarray(lbl), jnp.asarray(interior), **kw))
    np.testing.assert_array_equal(got.numpy(), want)


def _window_max(a, axis, frm, to, m):
    """The kernel's walk (``csrc/postprocess_loops.cu::window_max``): ``m``
    raised by the neighbours at d = frm .. to along ``axis``, their indices
    clamped to the frame."""
    n = a.shape[axis]
    at = np.arange(n)
    for d in range(frm, to + 1):
        lo = np.take(a, np.maximum(at - d, 0), axis)
        hi = np.take(a, np.minimum(at + d, n - 1), axis)
        m = np.maximum(m, np.maximum(lo, hi))
    return m


def _kernel_markers(dist, interior, window, min_dist, slack, rel, rel_window):
    """numpy twin of the split kernels with the wrapper's radii: the row pass
    (both radii in one walk, cut to the width), the column pass (cut to the
    height) and the predicate with one float32 multiply."""
    h, w = dist.shape
    window = min(max(window, 0), max(h, w))
    radius = min(max(window, rel_window if rel > 0 else 0), max(h, w))
    wx, rx, wy, ry = min(window, w - 1), min(radius, w - 1), min(window, h - 1), min(radius, h - 1)
    row_win = _window_max(dist, 1, 1, wx, dist)
    wmax = _window_max(row_win, 0, 1, wy, row_win)
    wide = wmax
    if radius > window:
        row_wide = _window_max(dist, 1, wx + 1, rx, row_win)
        wide = _window_max(row_wide, 0, 1, ry, row_wide)
    markers = interior & (dist >= wmax - slack) & (dist >= min_dist)
    if rel > 0:
        markers &= dist.astype(np.float32) >= np.float32(rel) * wide.astype(np.float32)
    return markers


@pytest.mark.parametrize("dist_of", ["octagon distance", "random"])
@pytest.mark.parametrize("case", ["defaults 96x96", *MARKER_CASES])
def test_split_markers_plain_equals_the_kernels_twin(case, dist_of):
    """The plain markers (rounds of a 3x3 maximum) equal a numpy twin of the
    kernels' separable, clamped walk: what the card tests check bit for bit,
    checked here on the algorithm."""
    (h, w), *args = MARKER_CASES.get(case, ((96, 96), 16, 4, 1, 0.65, 48))
    interior = _blobs(11, h, w, 45)
    if dist_of == "random":
        dist = np.random.default_rng(3).integers(0, 24, (h, w)).astype(np.int32)
    else:
        dist = pp.octagon_distance(_t(interior)).numpy()
    got = postprocess_loops.split_markers_plain(_t(dist), _t(interior), *args)
    want = _kernel_markers(dist, interior, *args)
    assert got.dtype == torch.bool and want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_markers_takes_the_plain_version_on_the_cpu_and_counts_it():
    interior = _blobs(2, 48, 64, 50)
    dist = pp.octagon_distance(_t(interior))
    reset_counts()
    got = postprocess_loops.split_markers(dist, _t(interior), 16, 4, 1, 0.65, 48)
    assert counts()["split_markers"] == {"kernel": 0, "plain": 1}
    assert torch.equal(got, postprocess_loops.split_markers_plain(dist, _t(interior), 16, 4,
                                                                   1, 0.65, 48))
    probs = _t(_cell_probs(0))
    for method, calls in (("dist", 1), ("prob", 0)):
        reset_counts()
        pp.postprocess_frame(probs, instance_split=True, split_method=method)
        assert counts()["split_markers"] == {"kernel": 0, "plain": calls}


def _bumps(seed=5, h=96, w=96, n=6):
    rng = np.random.default_rng(seed)
    p_cell = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(n):
        cy, cx = rng.uniform(12, h - 12), rng.uniform(12, w - 12)
        sig, pk = rng.uniform(4, 9), rng.uniform(0.6, 1.0)
        g = pk * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
        p_cell = np.maximum(p_cell, g.astype(np.float32))
    return p_cell


@pytest.mark.parametrize("hi,erode,min_size",
                         [(0.8, 1, 0), (0.7, 0, 0), (0.85, 2, 0), (0.8, 1, 200)])
def test_prob_split_equals_jax(hi, erode, min_size):
    p_cell = _bumps()
    interior = p_cell > 0.5
    lbl = _ccl_np(interior)
    kw = dict(hi_thresh=hi, erode_iters=erode, min_size=min_size)
    got = pp.split_touching_instances_prob(_t(lbl), _t(interior), _t(p_cell), **kw)
    want = np.asarray(jax_pp.split_touching_instances_prob(
        jnp.asarray(lbl), jnp.asarray(interior), jnp.asarray(p_cell), **kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prob_split_threshold_is_compared_in_float32():
    """p(cell) equal to float32(0.8) is a marker, as in the reference, though
    float32(0.8) > 0.8 and float32(0.7) < 0.7 as doubles."""
    for hi in (0.8, 0.7):
        p_cell = np.full((9, 9), np.float32(hi))
        interior = np.ones((9, 9), bool)
        lbl = _ccl_np(interior)
        got = pp.split_touching_instances_prob(_t(lbl), _t(interior), _t(p_cell),
                                               hi_thresh=hi, erode_iters=0)
        want = np.asarray(jax_pp.split_touching_instances_prob(
            jnp.asarray(lbl), jnp.asarray(interior), jnp.asarray(p_cell),
            hi_thresh=hi, erode_iters=0))
        np.testing.assert_array_equal(got.numpy(), want)


def test_two_touching_cells_split():
    interior = _ellipse(64, 64, 32, 20, 12, 12) | _ellipse(64, 64, 32, 42, 12, 12)
    lbl = _ccl_np(interior)
    assert lbl.max() == lbl[interior].min()  # one merged component
    out = pp.split_touching_instances(_t(lbl), _t(interior), window=8, min_dist=4).numpy()
    assert len(np.unique(out[interior])) == 2
    assert out[32, 20] != out[32, 42]
    np.testing.assert_array_equal(out > 0, interior)  # the support is unchanged


def test_single_cell_not_split():
    interior = _ellipse(48, 48, 24, 24, 14, 9)
    out = pp.split_touching_instances(_t(_ccl_np(interior)), _t(interior), window=8,
                                      min_dist=4).numpy()
    assert len(np.unique(out[interior])) == 1
    np.testing.assert_array_equal(out > 0, interior)


def test_markerless_component_keeps_original_label():
    interior = np.zeros((32, 32), bool)
    interior[4:24, 4:6] = True       # 2-px bar: nowhere min_dist from background
    interior[10:20, 15:28] = True    # fat blob: gets a marker
    lbl = _ccl_np(interior)
    kw = dict(window=4, min_dist=4, slack=1)
    out = pp.split_touching_instances(_t(lbl), _t(interior), **kw).numpy()
    assert np.all(out[4:24, 4:6] == lbl[4, 4])
    assert len(np.unique(out[interior])) == 2
    np.testing.assert_array_equal(out, np.asarray(jax_pp.split_touching_instances(
        jnp.asarray(lbl), jnp.asarray(interior), **kw)))


def test_min_size_gates_split_eligibility():
    h, w = 96, 160
    small = _ellipse(h, w, 20, 20, 9, 9) | _ellipse(h, w, 20, 36, 9, 9)
    big = _ellipse(h, w, 64, 60, 20, 20) | _ellipse(h, w, 64, 96, 20, 20)
    interior = small | big
    lbl = _ccl_np(interior)
    kw = dict(window=8, min_dist=3, slack=1, rel=0.65, rel_window=48,
              min_size=int(small.sum()) + 1)
    out = pp.split_touching_instances(_t(lbl), _t(interior), **kw).numpy()
    np.testing.assert_array_equal(out[small], lbl[small])  # ineligible: untouched
    assert len(np.unique(out[big])) == 2                   # eligible: split
    np.testing.assert_array_equal(out, np.asarray(jax_pp.split_touching_instances(
        jnp.asarray(lbl), jnp.asarray(interior), **kw)))


def test_rel_rule_suppresses_minor_lobe():
    interior = _ellipse(64, 96, 32, 30, 20, 20) | _ellipse(64, 96, 32, 56, 7, 7)
    lbl = _ccl_np(interior)
    kw = dict(window=8, min_dist=3, slack=1)
    with_rel = pp.split_touching_instances(_t(lbl), _t(interior), rel=0.65,
                                           rel_window=48, **kw).numpy()
    assert len(np.unique(with_rel[interior])) == 1
    no_rel = pp.split_touching_instances(_t(lbl), _t(interior), rel=0.0, **kw).numpy()
    assert len(np.unique(no_rel[interior])) == 2


def _two_bumps(h=64, w=64, cy=32, cx1=22, cx2=42, sigma=9.0, peak=0.95):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g1 = peak * np.exp(-(((yy - cy) ** 2 + (xx - cx1) ** 2) / (2 * sigma ** 2)))
    g2 = peak * np.exp(-(((yy - cy) ** 2 + (xx - cx2) ** 2) / (2 * sigma ** 2)))
    return np.maximum(g1, g2).astype(np.float32)


def _probs_of(p_cell):
    return np.stack([1 - p_cell, p_cell, np.zeros_like(p_cell)], -1)


def test_postprocess_dist_split_end_to_end():
    """Two touching cells with no predicted boundary: merged by default, two
    instances with instance_split, equal to the reference."""
    interior = (_ellipse(64, 64, 32, 20, 11, 11)
                | _ellipse(64, 64, 32, 42, 11, 11)).astype(np.float32)
    probs = _probs_of(interior)
    assert int(pp.postprocess_frame(_t(probs), min_cell_size=5).max()) == 1
    split = pp.postprocess_frame(_t(probs), min_cell_size=5, instance_split=True).numpy()
    assert split.max() == 2 and split[32, 20] != split[32, 42]
    np.testing.assert_array_equal(split, np.asarray(jax_pp.postprocess_frame(
        jnp.asarray(probs), min_cell_size=5, instance_split=True)))


def test_postprocess_prob_split_fires_on_confidence_dip():
    p_cell = _two_bumps()
    assert p_cell[32, 32] > 0.5 and p_cell[32, 32] < 0.8
    probs = _probs_of(p_cell)
    kw = dict(min_cell_size=5, instance_split=True, split_method="prob",
              split_hi_thresh=0.8, split_erode=1)
    assert int(pp.postprocess_frame(_t(probs), min_cell_size=5).max()) == 1
    split = pp.postprocess_frame(_t(probs), **kw).numpy()
    assert split.max() == 2 and split[32, 22] != split[32, 42]
    np.testing.assert_array_equal(split, np.asarray(jax_pp.postprocess_frame(
        jnp.asarray(probs), **kw)))


def test_postprocess_prob_split_without_marker_keeps_labels():
    p_cell = 0.65 * _ellipse(64, 64, 32, 32, 10, 10).astype(np.float32)
    probs = _t(_probs_of(p_cell))
    base = pp.postprocess_frame(probs, min_cell_size=5)
    split = pp.postprocess_frame(probs, min_cell_size=5, instance_split=True,
                                 split_method="prob", split_hi_thresh=0.8)
    assert int(base.max()) == 1 and torch.equal(base, split)


def test_postprocess_prob_split_min_size_gates_eligibility():
    p_cell = _two_bumps()
    size = int((p_cell > 0.5).sum())
    probs = _t(_probs_of(p_cell))
    kw = dict(min_cell_size=5, instance_split=True, split_method="prob")
    assert int(pp.postprocess_frame(probs, split_min_size=size + 1, **kw).max()) == 1
    assert int(pp.postprocess_frame(probs, split_min_size=size, **kw).max()) == 2


def _cell_probs(seed):
    probs, n = cell_like_probs(96, 128, num_cells=24, seed=seed, radius=(5.0, 10.0))
    assert n == 24 and probs.shape == (96, 128, 3) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)
    return probs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [
    dict(split_method="dist"),
    dict(split_method="dist", split_window=4, split_min_dist=2, split_rel=0.0),
    dict(split_method="dist", split_window=6, split_min_dist=3, split_slack=0,
         split_rel=0.5, split_rel_window=12, split_min_size=150),
    dict(split_method="prob"),
    dict(split_method="prob", split_hi_thresh=0.85, split_erode=2),
    dict(split_method="prob", split_hi_thresh=0.78, split_erode=0, split_min_size=200,
         size_filter="post", fov=4),
])
def test_postprocess_with_split_equals_jax_on_cell_like_probs(seed, kw):
    """The whole postprocess with both splitters on cell-like probabilities
    with touching pairs: labels equal the reference's, and the split changes
    them (the case exercises it)."""
    probs = _cell_probs(seed)
    kw = dict(min_cell_size=6, instance_split=True, **kw)
    got = pp.postprocess_frame(_t(probs), **kw).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_pp.postprocess_frame(jnp.asarray(probs), **kw)))
    unsplit = pp.postprocess_frame(_t(probs), **{**kw, "instance_split": False}).numpy()
    assert got.max() > unsplit.max() > 1


def test_postprocess_split_calls_ccl_twice_and_counts_rounds():
    probs = _t(_cell_probs(0))
    for method, loops in (("dist", ("grow", "erode")), ("prob", ("grow",))):
        before = ccl.COUNT.plain
        pp.ROUNDS.update(grow=0, erode=0)
        pp.postprocess_frame(probs, instance_split=True, split_method=method)
        assert ccl.COUNT.plain - before == 2
        assert all(pp.ROUNDS[k] > 0 for k in loops)
    before = ccl.COUNT.plain
    pp.postprocess_frame(probs)
    assert ccl.COUNT.plain - before == 1


def test_unknown_split_method_raises():
    with pytest.raises(ValueError, match="split_method"):
        pp.postprocess_frame(torch.zeros(8, 8, 3), instance_split=True,
                             split_method="watershed")
    # as in the reference, the method is not looked at while the split is off
    assert int(pp.postprocess_frame(torch.zeros(8, 8, 3), split_method="watershed").max()) == 0
