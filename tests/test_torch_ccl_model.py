"""A numpy model of the phases of the K3 kernel (``csrc/ccl.cu``), at its strip
geometry, against ``connected_components_plain``.

The CUDA kernel runs only on a GPU; its algorithm is checked here: rows cut
into 32-pixel words and words into runs (the same bit formulas), the pieces of
a run that spans words seeded with its real start, a union-find over run
starts that links the larger root under the smaller, unions inside
each of the 8 strips, every run start pointed at its strip root with the
roots flagged, unions across the seams, the flagged roots resolved, and each
pixel labelled through its run start. The unions run in a shuffled order, as
the atomics of a launch may. A model whose seam skips the upper-right
neighbour must fail.
"""

import numpy as np
import pytest
import torch

from lstm_unet_tpu_torch.io.synthetic import (cell_like_probs, dense_components_mask,
                                              spiral_mask)
from lstm_unet_tpu_torch.ops.kernels import ccl

BLOCKS = ccl.CLUSTER_BLOCKS
M32 = 0xFFFFFFFF


def run_start(w, b):
    """csrc/ccl.cu::run_start: first bit of the run of ``w`` that holds bit b."""
    zeros_below = ~w & ((1 << b) - 1) & M32
    return zeros_below.bit_length() if zeros_below else 0  # 32 - clz


def starts_run(w, b):
    return bool((w >> b) & 1) and (b == 0 or not (w >> (b - 1)) & 1)


def ffs(x):
    return (x & -x).bit_length()  # 1-based index of the lowest set bit


class Forest:
    def __init__(self, n):
        self.par = np.full(n, -1, np.int64)  # -1: never seeded, must never be read

    def load(self, x):
        assert self.par[x] >= 0, "walk reached a pixel that is not a run start"
        return int(self.par[x])

    def find(self, x):
        y = self.load(x)
        while y != x:
            z = self.load(y)
            if z != y:
                self.par[x] = min(self.par[x], z)  # path splitting
            x, y = y, z
        return x

    def unite(self, a, b):
        a, b = self.find(self.load(a)), self.find(self.load(b))
        if a != b:
            lo, hi = min(a, b), max(a, b)
            assert self.par[hi] == hi
            self.par[hi] = lo  # the larger root under the smaller


def row_run_start(row, wx):
    """csrc/ccl.cu::row_run_start: the column where the run that holds bit 0
    of word wx really starts."""
    k = wx
    while k > 0 and row[k - 1] >> 31:
        k -= 1
        if row[k] != M32:
            return k * 32 + run_start(row[k], 31)
    return k * 32


def link_up(f, p, cur, s, wx, up, w, skip_upper_right=False):
    """csrc/ccl.cu::link_up with Python integers."""
    ww = len(up)
    mid = up[wx]
    left = up[wx - 1] if wx > 0 else 0
    right = up[wx + 1] if wx + 1 < ww else 0
    above = (left >> 31) | (mid << 1) | ((right & 1) << 33)
    rest = (~cur & M32) >> s
    length = ffs(rest) - 1 if rest else 32 - s
    window = ((1 << (length + (1 if skip_upper_right else 2))) - 1) << s
    touched = above & window
    starts = touched & ~(touched << 1)
    base = p - s - w
    while starts:
        j = ffs(starts) - 1
        starts &= starts - 1
        if j == 0:
            q = base - 32 + run_start(left, 31)
        elif j == 33:
            q = base + 32
        else:
            q = base + run_start(mid, j - 1)
        f.unite(p, q)


def ccl_model(mask, seed=0, skip_upper_right_at_seams=False):
    mask = np.asarray(mask, bool)
    h, w = mask.shape
    ww, rows_per = -(-w // 32), -(-h // BLOCKS)
    rng = np.random.default_rng(seed)
    # (0) bit words and seeds
    bits = [[int(sum(1 << b for b in range(32)
                     if wx * 32 + b < w and mask[y, wx * 32 + b])) for wx in range(ww)]
            for y in range(h)]
    f = Forest(h * w)
    starts = [(y, wx, b) for y in range(h) for wx in range(ww) for b in range(32)
              if starts_run(bits[y][wx], b)]
    for y, wx, b in starts:  # a run that continues a word points at its real start
        f.par[y * w + wx * 32 + b] = y * w + (wx * 32 + b if b else row_run_start(bits[y], wx))
    strip_of = lambda y: y // rows_per
    # (1) unions inside each strip, in any order
    for i in rng.permutation(len(starts)):
        y, wx, b = starts[i]
        if y % rows_per:
            link_up(f, y * w + wx * 32 + b, bits[y][wx], b, wx, bits[y - 1], w)
    # every run start points at its strip root; the roots are flagged
    flagged = set()
    for y, wx, b in starts:
        p = y * w + wx * 32 + b
        r = f.find(p)
        assert strip_of(r // w) == strip_of(y)
        f.par[p] = r
        if r == p:
            flagged.add(p)
    # (2) unions across the seams: only flagged nodes are ever rewritten
    before = f.par.copy()
    for i in rng.permutation(len(starts)):
        y, wx, b = starts[i]
        if y and y % rows_per == 0:
            link_up(f, y * w + wx * 32 + b, bits[y][wx], b, wx, bits[y - 1], w,
                    skip_upper_right=skip_upper_right_at_seams)
    changed = set(np.nonzero(f.par != before)[0].tolist())
    assert changed <= flagged
    # (3) the flagged roots resolve; every pixel reads through its run start
    for p in flagged:
        f.par[p] = f.find(p)
    labels = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            cur = bits[y][x // 32]
            if (cur >> (x % 32)) & 1:
                start = y * w + (x // 32) * 32 + run_start(cur, x % 32)
                v = f.load(start)
                if start not in flagged:
                    v = f.load(v)
                labels[y, x] = v + 1
    return labels


def _cases():
    r = np.random.default_rng(7)
    cell = cell_like_probs(64, 96, num_cells=20, seed=3, radius=(4.0, 8.0))[0][..., 1] > 0.5
    isolated = np.zeros((20, 40), bool)
    isolated[::2, ::2] = True
    return {
        "random_0.3": r.random((40, 70)) < 0.3,
        "random_0.5": r.random((64, 64)) < 0.5,
        "random_0.6_ragged": r.random((37, 45)) < 0.6,
        "random_0.8": r.random((24, 100)) < 0.8,
        "one_strip_row_each": r.random((8, 33)) < 0.5,
        "fewer_rows_than_strips": r.random((5, 50)) < 0.6,
        "spiral": spiral_mask(48),
        "dense": dense_components_mask(48, 72),
        "cell_like": cell,
        "isolated": isolated,
        "empty": np.zeros((16, 40), bool),
        "full": np.ones((19, 67), bool),
        "row": r.random((1, 70)) < 0.5,
        "column": r.random((70, 1)) < 0.5,
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_model_of_the_kernel_equals_plain(name):
    mask = _cases()[name]
    want = ccl.connected_components_plain(torch.from_numpy(mask)).numpy()
    for seed in (0, 1):
        np.testing.assert_array_equal(ccl_model(mask, seed), want)


def test_bit_formulas():
    for w, b, want in ((0b0110, 2, 1), (0b0110, 1, 1), (M32, 31, 0), (1 << 31, 31, 31),
                       (0b1011, 3, 3), (0b1011, 1, 0)):
        assert run_start(w, b) == want
    assert [b for b in range(8) if starts_run(0b11011001, b)] == [0, 3, 6]
    row = [0b1 << 31, M32, M32, 0b0111, 0, 0b11 << 30, 0b1]
    assert [row_run_start(row, wx) for wx in (1, 2, 3, 6)] == [31, 31, 31, 5 * 32 + 30]
    assert row_run_start([M32, M32], 1) == 0 and row_run_start([0, 1], 1) == 32


def test_a_seam_without_the_upper_right_neighbour_fails():
    """An anti-diagonal crosses every seam through upper-right neighbours
    only: the mutated model splits it, the kernel's model does not."""
    mask = np.fliplr(np.eye(32, dtype=bool)).copy()
    want = ccl.connected_components_plain(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(ccl_model(mask), want)
    broken = ccl_model(mask, skip_upper_right_at_seams=True)
    assert len(np.unique(broken)) - 1 == BLOCKS and not np.array_equal(broken, want)
    r = np.random.default_rng(11).random((64, 64)) < 0.45
    assert not np.array_equal(
        ccl_model(r, skip_upper_right_at_seams=True),
        ccl.connected_components_plain(torch.from_numpy(r)).numpy())


@pytest.mark.parametrize("h,w,want", [(512, 512, "cluster"), (32, 32, "cluster"),
                                      (640, 640, "cluster"), (672, 672, "grid"),
                                      (1, 50000, "cluster"),
                                      (1024, 1024, "grid"), (512, 1024, "grid"),
                                      (6000, 100, "grid")])
def test_route_by_shape(h, w, want):
    assert ccl.route(h, w) == want
    assert (ccl.cluster_smem_bytes(h, w) <= ccl.SMEM_LIMIT) == (want == "cluster")


def test_cluster_smem_formula():
    # 512^2: 64 rows x 512 parents, 65 rows x 16 bit words, 64 x 16 flag words
    assert ccl.cluster_smem_bytes(512, 512) == 4 * (64 * 512 + 65 * 16 + 64 * 16)


def test_plain_calls_are_counted_on_their_route():
    ccl.COUNT.reset()
    ccl.GRID_COUNT.reset()
    ccl.connected_components(torch.zeros(8, 8, dtype=torch.bool))
    assert (ccl.COUNT.plain, ccl.GRID_COUNT.plain) == (1, 0)
    ccl.connected_components_plain(torch.zeros(4, 70000, dtype=torch.bool), max_iters=4)
    assert (ccl.COUNT.plain, ccl.GRID_COUNT.plain, ccl.COUNT.kernel) == (1, 1, 0)
