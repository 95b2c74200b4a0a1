"""The port's postprocess_frame against the JAX reference: equal labels for
the same probabilities (the reference's scatter branch, which it takes on the
CPU), over every growth mode, size-filter order and FOV setting."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_unet_tpu.ops.postprocess import postprocess_frame as jax_postprocess
from lstm_unet_tpu_torch.ops.kernels.ccl import INT_MAX
from lstm_unet_tpu_torch.ops.postprocess import grow_into_band, postprocess_frame


def _probs(seed=0, h=64, w=56):
    """Smooth random 3-class probabilities: blobs of cells with boundary rims."""
    r = np.random.default_rng(seed)
    logits = r.normal(size=(h // 4 + 2, w // 4 + 2, 3)).astype(np.float32) * 3
    logits = np.kron(logits, np.ones((4, 4, 1), np.float32))[:h, :w]
    logits += r.normal(size=(h, w, 3)).astype(np.float32) * 0.7
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fov", [0, 6])
@pytest.mark.parametrize("size_filter", ["pre", "post"])
@pytest.mark.parametrize("growth", ["marker", "dilate", "none"])
def test_postprocess_equals_jax(growth, size_filter, fov):
    probs = _probs()
    kw = dict(cell_thresh=0.4, edge_thresh=0.3, min_cell_size=6, max_cell_size=200,
              size_filter=size_filter, fov=fov, boundary_growth=growth)
    want = np.asarray(jax_postprocess(jnp.asarray(probs), **kw))
    got = postprocess_frame(torch.from_numpy(probs), **kw)
    assert got.dtype == torch.int32
    assert want.max() > 1  # the case has several instances
    np.testing.assert_array_equal(got.numpy(), want)


def test_grow_iters_cap_equals_jax():
    probs = _probs(seed=1)
    kw = dict(min_cell_size=3, grow_iters=2)
    np.testing.assert_array_equal(
        postprocess_frame(torch.from_numpy(probs), **kw).numpy(),
        np.asarray(jax_postprocess(jnp.asarray(probs), **kw)))


def test_marker_growth_tie_goes_to_smaller_label():
    """A 9-px band between two cells: each band pixel goes to the nearer
    cell, the equidistant column to the raster-first label."""
    lbl = torch.zeros(8, 15, dtype=torch.int32)
    lbl[:, 0:3] = 1
    lbl[:, 12:15] = 2
    band = torch.zeros(8, 15, dtype=torch.bool)
    band[:, 3:12] = True
    out = grow_into_band(lbl, band)
    assert bool((out[:, 3:8] == 1).all()) and bool((out[:, 8:12] == 2).all())


def test_more_than_uint16_instances_poisons_the_map():
    """65536 isolated pixels survive: every label becomes INT_MAX, as in the
    reference, so the engine's uint16 check raises."""
    probs = np.zeros((512, 512, 3), np.float32)
    probs[..., 0] = 1.0
    probs[::2, ::2, 1], probs[::2, ::2, 0] = 1.0, 0.0
    kw = dict(min_cell_size=0, boundary_growth="none")
    got = postprocess_frame(torch.from_numpy(probs), **kw)
    assert bool((got == INT_MAX).all())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_postprocess(jnp.asarray(probs), **kw)))
