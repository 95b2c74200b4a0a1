"""The port's ops and the kernels' plain versions against the JAX reference.

Same inputs, made with numpy from a seed, go through both frameworks on the
CPU. Where the reference reaches a Pallas kernel it runs in interpret mode
(as tests/test_ops.py runs it). Tolerances:

- conv / pool / upsample / activation: 1e-6 (f32; the convs sum <= 75 terms
  of magnitude <= 1 in another order);
- K1 gate update: 1e-6, the reference's own bound (tests/test_ops.py);
- K4 fused level: 2e-5 in f32, the reference's fused-vs-XLA bound;
- K3 CCL: equal.

The CUDA kernels themselves are compared with these plain versions in
tests/test_torch_cuda.py, on a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_unet_tpu.ops import conv as jconv
from lstm_unet_tpu.ops.ccl import connected_components as jax_ccl
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell as JaxCell
from lstm_unet_tpu.ops.pallas import lstm_gates as jax_lg
from lstm_unet_tpu.ops.pallas.ccl import connected_components_pallas
from lstm_unet_tpu.ops.pallas.convlstm_cell import fused_convlstm_level as jax_fused
from lstm_unet_tpu_torch.io.synthetic import dense_components_mask, spiral_mask
from lstm_unet_tpu_torch.ops import conv as tconv
from lstm_unet_tpu_torch.ops.convlstm import ConvLSTMCell
from lstm_unet_tpu_torch.ops.kernels import ccl, convlstm_cell, counts, lstm_gates, reset_counts


def _hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


# ---------------------------------------------------------------- conv ops


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_matches_jax(k):
    r = np.random.default_rng(k)
    x = r.uniform(-1, 1, (2, 12, 10, 3)).astype(np.float32)
    kern = r.uniform(-0.3, 0.3, (k, k, 3, 5)).astype(np.float32)
    bias = r.uniform(-1, 1, (5,)).astype(np.float32)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias)))
    got = tconv.conv2d(torch.from_numpy(x), _hwio_to_oihw(kern), torch.from_numpy(bias))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_conv2d_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        tconv.conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(2, 1, 2, 2))


@pytest.mark.parametrize("op", ["max_pool", "nearest", "bilinear"])
def test_pool_and_upsample_match_jax(op):
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 4)).astype(np.float32)
    if op == "max_pool":
        want = jconv.max_pool_2x2(jnp.asarray(x))
        got = tconv.max_pool_2x2(torch.from_numpy(x))
    else:
        want = jconv.upsample_2x(jnp.asarray(x), op)
        got = tconv.upsample_2x(torch.from_numpy(x), op)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kind", ["leaky_relu", "relu", "tanh", "none"])
def test_activate_matches_jax(kind):
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_allclose(tconv.activate(torch.from_numpy(x), kind).numpy(),
                               np.asarray(jconv.activate(jnp.asarray(x), kind)),
                               atol=1e-6)


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_gate_update_plain_matches_xla_twin_and_pallas(act, monkeypatch):
    r = np.random.default_rng(1)
    rows, feat = 100, 8  # not a multiple of the reference's row block
    gates = (r.normal(size=(rows, 4 * feat)) * 3).astype(np.float32)
    c = r.normal(size=(rows, feat)).astype(np.float32)
    reset_counts()
    got = lstm_gates.fused_lstm_gate_update(torch.from_numpy(gates),
                                            torch.from_numpy(c), act)
    assert counts()["lstm_gate_update"] == {"kernel": 0, "plain": 1}
    xla = jax_lg.lstm_gate_update_xla(jnp.asarray(gates), jnp.asarray(c), act)
    monkeypatch.setattr(jax_lg, "FORCE_INTERPRET", True)
    pallas = jax_lg.fused_lstm_gate_update(jnp.asarray(gates), jnp.asarray(c), act)
    for want in (xla, pallas):  # both (c', h')
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_gate_update_checks_its_inputs():
    with pytest.raises(ValueError, match="do not match"):
        lstm_gates.fused_lstm_gate_update(torch.zeros(4, 12), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="device"):
        lstm_gates.fused_lstm_gate_update(torch.zeros(4, 16, device="meta"),
                                          torch.zeros(4, 4, device="meta"))


# ---------------------------------------------------------------- K4


def _level_inputs(seed, hw, feat, k, batch=1):
    r = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (k * k * feat + k * k * 4 * feat))
    h, w = hw
    return (r.normal(0, 0.5, (batch, h, w, 4 * feat)).astype(np.float32),
            r.uniform(-1, 1, (batch, h, w, feat)).astype(np.float32),
            r.normal(size=(batch, h, w, feat)).astype(np.float32),
            r.uniform(-lim, lim, (k, k, feat, 4 * feat)).astype(np.float32))


def test_fused_level_plain_matches_interpreted_pallas():
    """At a shape the TPU kernel supports (B=1, 8x128, F=128, 5x5)."""
    gx, h, c, wh = _level_inputs(2, (8, 128), 128, 5)
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*map(torch.from_numpy, (gx, h, c, wh)))
    assert counts()["fused_convlstm_level"] == {"kernel": 0, "plain": 1}
    want = jax_fused(jnp.asarray(gx[0]), jnp.asarray(h[0]), jnp.asarray(c[0]),
                     jnp.asarray(wh))
    for g, w in zip(got, want):  # both (h', c')
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("k,feat,hw,batch", [(5, 128, (8, 128), 1), (3, 8, (12, 10), 2),
                                             (3, 16, (8, 8), 1)])
@pytest.mark.parametrize("fused", [False, True])
def test_convlstm_cell_matches_unfused_jax_cell(k, feat, hw, batch, fused):
    """The port's cell, fused (K4 plain) or not (convs + K1 plain), against
    the reference's unfused cell with the same weights."""
    r = np.random.default_rng(3)
    cin = 3
    jcell = {"kernel_x": r.uniform(-0.3, 0.3, (k, k, cin, 4 * feat)).astype(np.float32),
             "kernel_h": r.uniform(-0.1, 0.1, (k, k, feat, 4 * feat)).astype(np.float32),
             "bias": r.normal(size=(4 * feat,)).astype(np.float32)}
    x = r.normal(size=(batch, *hw, cin)).astype(np.float32)
    h0 = r.uniform(-1, 1, (batch, *hw, feat)).astype(np.float32)
    c0 = r.normal(size=(batch, *hw, feat)).astype(np.float32)
    (jh, jc), _ = JaxCell.apply({n: jnp.asarray(v) for n, v in jcell.items()},
                                (jnp.asarray(h0), jnp.asarray(c0)), jnp.asarray(x),
                                use_pallas=False)
    cell = ConvLSTMCell(k, cin, feat)
    cell.kernel_x.data = _hwio_to_oihw(jcell["kernel_x"])
    cell.kernel_h.data = _hwio_to_oihw(jcell["kernel_h"])
    cell.bias.data = torch.from_numpy(jcell["bias"])
    reset_counts()
    with torch.no_grad():
        (th, tc), out = cell((torch.from_numpy(h0), torch.from_numpy(c0)),
                             torch.from_numpy(x), fused_cell=fused)
    ran = counts()
    assert ran["fused_convlstm_level"]["plain"] == int(fused)
    assert ran["lstm_gate_update"]["plain"] == int(not fused)
    assert out is th
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)


def test_cell_init_matches_reference_scheme():
    cell = ConvLSTMCell(5, 2, 8, generator=torch.Generator().manual_seed(0))
    lim_x = np.sqrt(6.0 / (25 * 2 + 25 * 32))
    assert cell.kernel_x.shape == (32, 2, 5, 5)
    assert float(cell.kernel_x.detach().abs().max()) <= lim_x
    np.testing.assert_array_equal(cell.bias.detach().numpy(),
                                  np.repeat([0.0, 1.0, 0.0, 0.0], 8))


def test_fused_supported_limits():
    assert convlstm_cell.supported(512, 512, 128, 5, 5, 1)      # flagship level 0
    assert convlstm_cell.supported(32, 32, 8, 3, 3, 1)          # tiny levels
    assert convlstm_cell.supported(16, 16, 16, 3, 3, 4)
    assert not convlstm_cell.supported(256, 256, 256, 5, 5, 1)  # smem budget
    assert not convlstm_cell.supported(64, 64, 8, 4, 4, 1)      # even kernel
    assert not convlstm_cell.supported(64, 64, 8, 3, 5, 1)      # not square


# ---------------------------------------------------------------- K3


def _ccl_cases():
    r = np.random.default_rng(4)
    return [r.random((48, 64)) < 0.3, r.random((64, 64)) < 0.55,
            r.random((33, 47)) < 0.7, r.random((1, 17)) < 0.5,
            spiral_mask(24), dense_components_mask(64, 64, seed=1)]


@pytest.mark.parametrize("case", range(6))
def test_ccl_plain_equals_jax(case):
    mask = _ccl_cases()[case]
    got = ccl.connected_components(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ccl(jnp.asarray(mask))))


@pytest.mark.parametrize("case", [0, 2, 4, 5])
def test_ccl_plain_equals_interpreted_pallas(case, monkeypatch):
    mask = _ccl_cases()[case]
    monkeypatch.setattr(jax_lg, "FORCE_INTERPRET", True)
    want = np.asarray(connected_components_pallas(jnp.asarray(mask)))
    np.testing.assert_array_equal(
        ccl.connected_components(torch.from_numpy(mask)).numpy(), want)


def test_ccl_spiral_is_one_component():
    labels = ccl.connected_components(torch.from_numpy(spiral_mask(24)))
    assert set(torch.unique(labels).tolist()) == {0, 1}
