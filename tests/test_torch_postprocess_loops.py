"""The postprocess's two loops (``ops/kernels/postprocess_loops.py``) against
the reference's ``lax.while_loop``s: the plain growth and erosion loops equal
``grow_into_band``, ``chebyshev_distance`` and ``octagon_distance`` of
``lstm_unet_tpu/ops/postprocess.py`` bit for bit, and run as many rounds as
the reference's loops (counted by wrapping ``jax.lax.while_loop``). Inputs are
made with numpy from fixed seeds. The CUDA kernels are held to these plain
versions in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase p."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu.ops import postprocess as jax_pp
from lstm_unet_tpu_torch.io.synthetic import serpentine_band
from lstm_unet_tpu_torch.ops import postprocess as pp
from lstm_unet_tpu_torch.ops.kernels import counts, postprocess_loops, reset_counts


def _blobs(seed, h, w, frac=0.5):
    """A smooth random bool field: blobs of ~``frac`` of the frame."""
    r = np.random.default_rng(seed)
    field = np.kron(r.random((h // 4 + 2, w // 4 + 2)), np.ones((4, 4)))[:h, :w]
    field += r.random((h, w)) * 0.3
    return field > np.quantile(field, 1 - frac)


def _markers_and_band(seed, h, w):
    """Labels on some blobs of a frame and the band around them."""
    blobs = _blobs(seed, h, w, 0.6)
    inner = _blobs(seed + 100, h, w, 0.3) & blobs
    ids = np.random.default_rng(seed).integers(1, 9, (h, w)).astype(np.int32)
    return np.where(inner, ids, 0).astype(np.int32), blobs & ~inner


def _ties():
    """Two markers, the larger label first in raster order, with a band
    between them whose middle column is equidistant from both."""
    lbl = np.zeros((8, 15), np.int32)
    lbl[:, 0:3], lbl[:, 12:15] = 7, 3
    band = np.zeros((8, 15), bool)
    band[:, 3:12] = True
    return lbl, band


def _border():
    """Markers on the frame's edge, growing along it."""
    lbl = np.zeros((20, 24), np.int32)
    lbl[0, 0], lbl[19, 23], lbl[0, 12] = 2, 1, 4
    band = np.ones((20, 24), bool)
    band[5:15, 5:19] = False
    return lbl, band


# name -> ("grow", (labels, band), max_rounds) or ("erode", mask, max_iters)
CASES = {
    "grow serpentine 48^2": ("grow", serpentine_band(48, 48), 0),
    "grow cap 1": ("grow", _markers_and_band(1, 40, 40), 1),
    "grow cap 2": ("grow", _markers_and_band(1, 40, 40), 2),
    "grow cap 3": ("grow", _markers_and_band(2, 40, 40), 3),
    "grow cap 4": ("grow", _markers_and_band(2, 40, 40), 4),
    "grow uncapped": ("grow", _markers_and_band(3, 40, 40), 0),
    "grow ties": ("grow", _ties(), 0),
    "grow empty band": ("grow", (_markers_and_band(4, 24, 24)[0], np.zeros((24, 24), bool)), 0),
    "grow no labels": ("grow", (np.zeros((16, 16), np.int32), np.ones((16, 16), bool)), 0),
    "grow border": ("grow", _border(), 0),
    "grow non-square": ("grow", _markers_and_band(5, 23, 61), 0),
    "erode blobs": ("erode", _blobs(6, 40, 40), 0),
    "erode cap 1": ("erode", _blobs(7, 40, 40, 0.8), 1),
    "erode cap 4": ("erode", _blobs(7, 40, 40, 0.8), 4),
    "erode empty mask": ("erode", np.zeros((12, 12), bool), 0),
    "erode full mask": ("erode", np.ones((17, 17), bool), 0),
    "erode full non-square": ("erode", np.ones((9, 30), bool), 0),
    "erode border blobs": ("erode", _blobs(8, 24, 24, 0.9), 0),
    "erode non-square": ("erode", _blobs(9, 23, 61), 0),
}


@pytest.fixture
def reference_rounds(monkeypatch):
    """The iterations of every ``jax.lax.while_loop`` the reference runs, in
    order: the loop is wrapped to carry a counter beside its state."""
    seen = []
    real = jax.lax.while_loop

    def counted(cond, body, init):
        state, n = real(lambda s: cond(s[0]), lambda s: (body(s[0]), s[1] + 1),
                        (init, jnp.int32(0)))
        seen.append(int(n))
        return state

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    return seen


@pytest.mark.parametrize("name", list(CASES))
def test_loop_equals_the_reference(name, reference_rounds):
    kind, inputs, cap = CASES[name]
    postprocess_loops.clear_rounds()
    if kind == "grow":
        lbl, band = inputs
        got = pp.grow_into_band(torch.from_numpy(lbl), torch.from_numpy(band), cap)
        want = np.asarray(jax_pp.grow_into_band(jnp.asarray(lbl), jnp.asarray(band), cap))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert postprocess_loops.ROUNDS == {"grow": reference_rounds[0], "erode": 0}
        assert reference_rounds[0] > (600 if "serpentine" in name else 0)
        if cap:
            assert reference_rounds[0] == cap
        return
    for fn in ("chebyshev_distance", "octagon_distance"):
        got = getattr(pp, fn)(torch.from_numpy(inputs), cap)
        want = np.asarray(getattr(jax_pp, fn)(jnp.asarray(inputs), cap))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert postprocess_loops.ROUNDS == {"grow": 0, "erode": sum(reference_rounds)}
    assert len(reference_rounds) == 2
    assert (reference_rounds == [0, 0]) == (not inputs.any())


def test_rounds_are_the_module_counters():
    """``ops.postprocess.ROUNDS`` is the plain loops' counter, and
    ``clear_rounds`` zeroes it in place."""
    assert pp.ROUNDS is postprocess_loops.ROUNDS
    lbl, band = _ties()
    pp.grow_into_band(torch.from_numpy(lbl), torch.from_numpy(band))
    assert pp.ROUNDS["grow"] > 0
    postprocess_loops.clear_rounds()
    assert pp.ROUNDS == {"grow": 0, "erode": 0}


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_it():
    lbl, band = _ties()
    reset_counts()
    pp.grow_into_band(torch.from_numpy(lbl), torch.from_numpy(band))
    pp.chebyshev_distance(torch.from_numpy(band))
    pp.octagon_distance(torch.from_numpy(band), 2)
    ran = counts()
    assert ran["grow_into_band"] == {"kernel": 0, "plain": 1}
    assert ran["erosion_distance"] == {"kernel": 0, "plain": 2}


@pytest.mark.parametrize("call", [
    lambda: postprocess_loops.grow_into_band(
        torch.zeros(4, 4, dtype=torch.int32, device="meta"),
        torch.zeros(4, 4, dtype=torch.bool, device="meta")),
    lambda: postprocess_loops.erosion_distance(torch.zeros(4, 4, dtype=torch.bool,
                                                           device="meta")),
    lambda: postprocess_loops.split_markers(
        torch.zeros(4, 4, dtype=torch.int32, device="meta"),
        torch.zeros(4, 4, dtype=torch.bool, device="meta"), 2, 1, 0, 0.5, 3),
], ids=["grow", "erode", "split"])
def test_wrappers_raise_for_another_device(call):
    reset_counts()
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        call()
    assert all(v == {"kernel": 0, "plain": 0} for v in counts().values())


def test_wrappers_refuse_mismatched_inputs():
    with pytest.raises(ValueError, match="different shapes"):
        postprocess_loops.grow_into_band(torch.zeros(4, 4, dtype=torch.int32),
                                         torch.zeros(4, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        postprocess_loops.erosion_distance(torch.zeros(2, 4, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="different shapes"):
        postprocess_loops.split_markers(torch.zeros(4, 4, dtype=torch.int32),
                                        torch.zeros(5, 4, dtype=torch.bool), 2, 1, 0, 0.5, 3)
