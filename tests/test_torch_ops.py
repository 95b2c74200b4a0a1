"""The port's ops and the kernels' plain versions against the JAX reference.

Same inputs, made with numpy from a seed, go through both frameworks on the
CPU. Where the reference reaches a Pallas kernel it runs in interpret mode
(as tests/test_ops.py runs it). Tolerances:

- conv / pool / upsample / activation: 1e-6 (f32; the convs sum <= 75 terms
  of magnitude <= 1 in another order);
- K1 gate update: 1e-6, the reference's own bound (tests/test_ops.py);
- K2 gate backward: 1e-6 against the interpreted Pallas kernel (same
  formulas in f32); the Function's backward against torch autograd of the
  plain forward 1e-5, the reference's bound on grads;
- K4 fused level: 2e-5 in f32, the reference's fused-vs-XLA bound, also for
  the 3xTF32 tensor-core route's arithmetic (emulated here; plain TF32
  misses it); its Wh packs round-trip exactly; in bf16 the fused cell and the unfused cell
  differ by the unfused conv's bf16 rounding of the gates (see
  test_bf16_fused_cell_takes_the_tensor_core_route);
- K3 CCL: equal.

The CUDA kernels themselves are compared with these plain versions in
tests/test_torch_cuda.py, on a GPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu.ops import conv as jconv
from lstm_unet_tpu.ops.ccl import connected_components as jax_ccl
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell as JaxCell
from lstm_unet_tpu.ops.pallas import lstm_gates as jax_lg
from lstm_unet_tpu.ops.pallas.ccl import connected_components_pallas
from lstm_unet_tpu.ops.pallas.convlstm_cell import fused_convlstm_level as jax_fused
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
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


# ---------------------------------------------------------------- K2


def _bwd_inputs(seed, rows=100, feat=8):
    """Gates with z = +-2.5 exactly in every gate slice (hard_sigmoid's band
    edge), plus the state and the cotangents."""
    r = np.random.default_rng(seed)
    gates = (r.normal(size=(rows, 4 * feat)) * 3).astype(np.float32)
    gates[:6, :] = np.float32(2.5)
    gates[6:12, :] = np.float32(-2.5)
    return (gates, r.normal(size=(rows, feat)).astype(np.float32),
            r.normal(size=(rows, feat)).astype(np.float32),
            r.normal(size=(rows, feat)).astype(np.float32))


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_gate_bwd_plain_matches_interpreted_pallas(act, monkeypatch):
    gates, c, dc_out, dh = _bwd_inputs(7)
    reset_counts()
    got = lstm_gates.lstm_gate_update_bwd(*map(torch.from_numpy, (gates, c, dc_out, dh)),
                                          act)
    assert counts()["lstm_gate_update_bwd"] == {"kernel": 0, "plain": 1}
    # the reference's backward rule, with the Pallas kernel interpreted
    monkeypatch.setattr(jax_lg, "FORCE_INTERPRET", True)
    _, vjp = jax.vjp(lambda g, cc: jax_lg.fused_lstm_gate_update(g, cc, act),
                     jnp.asarray(gates), jnp.asarray(c))
    want = vjp((jnp.asarray(dc_out), jnp.asarray(dh)))
    direct = jax_lg._bwd_pallas(*map(jnp.asarray, (gates, c, dc_out, dh)), act)
    for w in (want, direct):  # both (dgates, dc)
        for g, ww in zip(got, w):
            np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=1e-6)
    if act == "hard_sigmoid":  # the strict band: z = +-2.5 has derivative 0
        dg = got[0].numpy()
        feat = c.shape[1]
        for k in (0, 1, 3):  # i, f, o
            assert (dg[:12, k * feat:(k + 1) * feat] == 0).all()


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("gdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
def test_gate_function_backward_matches_autograd(act, gdt, sdt):
    """Away from z = +-2.5 the Function's K2 rule is the derivative torch
    autograd takes through the plain forward."""
    r = np.random.default_rng(8)
    z = r.normal(size=(3, 50, 4 * 8)) * 3
    z[np.abs(np.abs(z) - 2.5) < 1e-2] = 0.0
    gates = torch.tensor(z, dtype=torch.float32).to(gdt)
    c = torch.tensor(r.normal(size=(3, 50, 8)), dtype=torch.float32).to(sdt)
    wc = torch.tensor(r.normal(size=(3, 50, 8)), dtype=torch.float32)
    grads = []
    for fn in (lstm_gates.lstm_gate_update, lstm_gates.lstm_gate_update_plain):
        g_in = gates.clone().requires_grad_()
        c_in = c.clone().requires_grad_()
        c1, h1 = fn(g_in, c_in, act)
        assert c1.dtype == h1.dtype == sdt
        loss = torch.sum(c1.float() * wc + h1.float() * 0.7)
        grads.append(torch.autograd.grad(loss, (g_in, c_in)))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        tol = 1e-5 if gdt == torch.float32 else 2.0 ** -7  # one bf16 ulp
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=tol)


def test_gate_bwd_checks_its_inputs():
    g, c = torch.zeros(4, 16), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="cotangent"):
        lstm_gates.lstm_gate_update_bwd(g, c, torch.zeros(4, 3), c)
    with pytest.raises(ValueError, match="cotangent"):
        lstm_gates.lstm_gate_update_bwd(g, c, c.double(), c)
    with pytest.raises(ValueError, match="device"):
        lstm_gates.lstm_gate_update_bwd(*(t.to("meta") for t in (g, c, c, c)))


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
    """At a shape the TPU kernel supports (B=1, 8x128, F=128, 5x5); in f32
    the 3xTF32 route takes it, so its plain version runs here."""
    gx, h, c, wh = _level_inputs(2, (8, 128), 128, 5)
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*map(torch.from_numpy, (gx, h, c, wh)))
    assert counts()["fused_convlstm_level_tf32x3"] == {"kernel": 0, "plain": 1}
    want = jax_fused(jnp.asarray(gx[0]), jnp.asarray(h[0]), jnp.asarray(c[0]),
                     jnp.asarray(wh))
    for g, w in zip(got, want):  # both (h', c')
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("k,feat,hw,batch", [(5, 128, (8, 128), 1), (3, 8, (12, 10), 2),
                                             (3, 16, (8, 8), 1), (5, 256, (8, 8), 1),
                                             (3, 10, (32, 32), 1)])
@pytest.mark.parametrize("fused", [False, True])
def test_convlstm_cell_matches_unfused_jax_cell(k, feat, hw, batch, fused):
    """The port's cell, fused (K4 plain) or not (convs + K1 plain), against
    the reference's unfused cell with the same weights. In f32 the fused cell
    takes K4 at every level here with F % 8 == 0: the narrow ones (F = 8, 16)
    on the narrow route, F = 128 and 256 on the 3xTF32 route; each counts its
    plain call. F = 10 no route takes: the fused cell runs it unfused."""
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
    k4 = fused and convlstm_cell.supported(*hw, feat, k, k, batch)
    assert k4 == (fused and feat % 8 == 0)
    name = ("fused_convlstm_level_tf32x3" if feat % 64 == 0 else "fused_convlstm_level_narrow")
    assert ran[name]["plain"] == int(k4)
    assert sum(ran[n]["plain"] for n in ("fused_convlstm_level_wgmma",
                                         "fused_convlstm_level_tf32x3",
                                         "fused_convlstm_level_narrow")) == int(k4)
    assert ran["lstm_gate_update"]["plain"] == int(not k4)
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


def test_fused_level_refuses_grad():
    """K4 is inference-only, as the reference: under grad it raises instead
    of returning outputs that carry no gradient; the cell raises with it."""
    gx, h, c, wh = map(torch.from_numpy, _level_inputs(2, (8, 8), 8, 3))
    wh.requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        convlstm_cell.fused_convlstm_level(gx, h, c, wh)
    with torch.no_grad():
        convlstm_cell.fused_convlstm_level(gx, h, c, wh)
    cell = ConvLSTMCell(3, 2, 8)
    carry = (torch.zeros(1, 8, 8, 8), torch.zeros(1, 8, 8, 8))
    reset_counts()
    with pytest.raises(RuntimeError, match="inference-only"):
        cell(carry, torch.zeros(1, 8, 8, 2), fused_cell=True)
    assert counts()["lstm_gate_update"]["plain"] == 0  # no quiet unfused route
    (h1, c1), _ = cell(carry, torch.zeros(1, 8, 8, 2), fused_cell=False)
    assert h1.requires_grad


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_cell_runs_a_level_no_route_takes_unfused(dtype, int8):
    """F % 8 != 0 (F = 10, 3x3, 32^2): K4 takes no route, so the cell with
    ``fused_cell`` runs the x- and h-convs and K1, as the reference runs every
    level its Pallas kernel does not take, bit for bit the unfused cell; the
    K4 wrapper itself refuses the level on the CPU too."""
    from lstm_unet_tpu_torch.ops.convlstm import QConvLSTMCell

    feat = 10
    assert not convlstm_cell.supported(32, 32, feat, 3, 3, 1, dtype)
    g = torch.Generator().manual_seed(4)
    cell = ConvLSTMCell(3, 3, feat, generator=g)
    cell = QConvLSTMCell(cell) if int8 else cell.to(dtype)
    x = torch.randn(1, 32, 32, 3, generator=g).to(dtype)
    carry = tuple(torch.randn(1, 32, 32, feat, generator=g).to(dtype) for _ in range(2))
    outs = {}
    for fused in (True, False):
        reset_counts()
        with torch.no_grad():
            outs[fused], _ = cell(carry, x, fused_cell=fused)
        ran = counts()
        assert ran["lstm_gate_update"]["plain"] == 1
        assert not any(v["plain"] or v["kernel"] for n, v in ran.items()
                       if n.startswith("fused_convlstm_level")), ran
    for a, b in zip(outs[True], outs[False]):
        assert a.dtype == dtype and torch.equal(a, b)
    gx, h, c, wh = (t.to(dtype) for t in map(torch.from_numpy,
                                             _level_inputs(6, (32, 32), feat, 3)))
    with pytest.raises(ValueError, match="check supported"):
        convlstm_cell.fused_convlstm_level(gx, h, c, wh)


def test_fused_supported_limits():
    assert convlstm_cell.supported(512, 512, 128, 5, 5, 1)      # flagship level 0
    assert convlstm_cell.supported(32, 32, 8, 3, 3, 1)          # tiny levels
    assert convlstm_cell.supported(16, 16, 16, 3, 3, 4)
    assert convlstm_cell.supported(256, 256, 256, 5, 5, 1)      # f32: 3xTF32
    assert not convlstm_cell.supported(64, 64, 204, 5, 5, 1)    # F % 8 != 0: none
    assert convlstm_cell.supported(64, 64, 200, 5, 5, 1)        # F % 64 != 0: narrow
    assert convlstm_cell.supported(64, 64, 160, 5, 5, 1)        # F % 64 != 0: narrow
    assert not convlstm_cell.supported(64, 64, 20, 5, 5, 1)     # F % 8 != 0: none
    assert convlstm_cell.supported(256, 256, 256, 5, 5, 1, torch.bfloat16)  # tensor cores
    assert not convlstm_cell.supported(64, 64, 8, 4, 4, 1)      # even kernel
    assert not convlstm_cell.supported(64, 64, 8, 3, 5, 1)      # not square
    assert convlstm_cell.supported(64, 64, 128, 7, 7, 1, torch.bfloat16)  # 7x7: narrow
    assert not convlstm_cell.supported(64, 64, 8, 9, 9, 1)      # 9x9: none


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_route_table(dtype):
    """Which K4 kernel takes each ConvLSTM level: the flagship's four on the
    tensor cores (bf16 as bf16, f32 as 3xTF32); the tiny model's narrow
    levels on the narrow tensor-core route in both dtypes."""
    bf16 = dtype == torch.bfloat16
    want = {"flagship": ["wgmma" if bf16 else "tf32x3"] * 4,
            "tiny": ["narrow", "narrow"]}
    for name, nkp, hw in (("flagship", default_net_kernel_params(), 512),
                          ("tiny", tiny_net_kernel_params(), 32)):
        got = [convlstm_cell.route(hw >> lvl, hw >> lvl, f, k, 1, dtype)
               for lvl, ((k, f),) in enumerate(nkp.lstm_kernels)]
        assert got == want[name], name
    assert convlstm_cell.route(9, 70, 128, 5, 2, dtype) == ("wgmma" if bf16 else "tf32x3")
    assert convlstm_cell.route(9, 70, 16, 7, 2, dtype) == "narrow"
    assert convlstm_cell.route(9, 70, 12, 7, 2, dtype) is None
    assert convlstm_cell.route(0, 70, 128, 5, 2, dtype) is None


@pytest.mark.parametrize("k,feat", [(5, 128), (5, 512), (3, 64), (1, 192)])
def test_wh_pack_round_trips(k, feat):
    """pack_wh is a permutation: unpack_wh inverts it exactly, and a view of
    the cell's OIHW kernel packs as its contiguous copy does."""
    wh = torch.from_numpy(np.random.default_rng(k + feat).normal(
        size=(k, k, feat, 4 * feat)).astype(np.float32)).to(torch.bfloat16)
    packed = convlstm_cell.pack_wh(wh)
    assert packed.shape == (feat // 64, feat // 64, k * k, 8, 256, 8)
    assert packed.is_contiguous()
    assert torch.equal(convlstm_cell.unpack_wh(packed), wh)
    view = wh.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # as the cell passes it
    assert torch.equal(convlstm_cell.pack_wh(view), packed)
    assert sorted(packed.flatten().tolist()) == sorted(wh.flatten().tolist())


def test_wh_pack_rejects_ragged_channels():
    with pytest.raises(ValueError, match="F % 64"):
        convlstm_cell.pack_wh(torch.zeros(3, 3, 96, 384))


def _fragment_gate_feature(col, per_thread=16):
    """(gate, feature within the tile) the kernel's epilogue reads from wgmma
    accumulator column ``col``: the fragment gives lane q of a quad columns
    8j + 2q + {0, 1}; the epilogue takes j = 2n as (i, f) and j = 2n + 1 as
    (g, o) of feature t q + n, t = ``per_thread`` features per thread (16 at
    N = 256, 8 at N = 128)."""
    j, q, b = col // 8, (col % 8) // 2, col % 2
    return 2 * (j % 2) + b, per_thread * q + j // 2


def test_packed_matmul_matches_interpreted_pallas():
    """The kernel's GEMM on the CPU: per column tile, 64-channel chunk and
    tap, a plain matmul of the shifted h tile with the packed Wh tile, then
    the columns de-interleaved as the epilogue reads them, plus gx and the
    gate math, equals the reference's fused level (Pallas, interpreted) at
    8x128, F = 128; a column-order mistake in the pack shows here."""
    gx, h, c, wh = _level_inputs(5, (8, 128), 128, 5)
    feat, k = 128, 5
    packed = convlstm_cell.pack_wh(torch.from_numpy(wh)).double()
    hp = torch.nn.functional.pad(torch.from_numpy(h[0]).double(), (0, 0, 2, 2, 2, 2))
    z = torch.zeros(8 * 128, 4 * feat, dtype=torch.float64)
    gate, fl = zip(*map(_fragment_gate_feature, range(256)))
    for nt in range(feat // 64):
        acc = torch.zeros(8 * 128, 256, dtype=torch.float64)
        for ch in range(feat // 64):
            for tap in range(k * k):
                ky, kx = divmod(tap, k)
                a = hp[ky:ky + 8, kx:kx + 128, ch * 64:(ch + 1) * 64].reshape(-1, 64)
                b = packed[nt, ch, tap].permute(0, 2, 1).reshape(64, 256)  # [channel, column]
                acc += a @ b
        cols = [g * feat + nt * 64 + f for g, f in zip(gate, fl)]
        z[:, cols] = acc
    z = z.reshape(1, 8, 128, 4 * feat) + torch.from_numpy(gx)
    c_new, h_new = lstm_gates.gate_math(*(z[..., i * feat:(i + 1) * feat].float()
                                          for i in range(4)),
                                        torch.from_numpy(c), "sigmoid")
    want = jax_fused(jnp.asarray(gx[0]), jnp.asarray(h[0]), jnp.asarray(c[0]),
                     jnp.asarray(wh))
    for g, w in zip((h_new, c_new), want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=2e-5)


def test_bf16_fused_cell_takes_the_tensor_core_route():
    """In bf16 a flagship-width level (F = 256, 5x5) goes to the tensor-core
    route (its plain version here) and agrees with the unfused bf16 cell.
    Tolerance: the unfused conv rounds the 4F gate pre-activations to bf16
    (relative 2^-9) before K1, the fused level keeps them in f32; through
    the gate math that moves h' and c' by a few bf16 ulps, so 2^-5 relative
    plus 2^-8 absolute."""
    r = np.random.default_rng(11)
    cell = ConvLSTMCell(5, 3, 256, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(r.normal(size=(1, 8, 8, 3)).astype(np.float32)).bfloat16()
    carry = tuple(torch.from_numpy(r.uniform(-1, 1, (1, 8, 8, 256)).astype(np.float32))
                  .bfloat16() for _ in range(2))
    cell = cell.to(torch.bfloat16)
    outs = {}
    for fused in (True, False):
        reset_counts()
        with torch.no_grad():
            outs[fused], _ = cell(carry, x, fused_cell=fused)
        ran = counts()
        assert ran["fused_convlstm_level_wgmma"] == {"kernel": 0, "plain": int(fused)}
        assert ran["lstm_gate_update"]["plain"] == int(not fused)
    for a, b in zip(outs[True], outs[False]):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=2.0 ** -8, rtol=2.0 ** -5)


def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero (cvt.rna), by the bit pattern."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_round_tf32_is_rna():
    r = np.random.default_rng(12)
    x = np.concatenate([r.normal(size=1000).astype(np.float32),
                        np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                                    1 + 2 ** -12, 0.0, 2.0 ** -130])])
    got = convlstm_cell.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32(x))
    np.testing.assert_array_equal(got[1000:1004], np.float32(  # ties away from zero
        [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0]))
    assert not (got.view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("k,feat", [(5, 128), (5, 512), (3, 64), (1, 192)])
def test_wh_pack_tf32x3_round_trips(k, feat):
    """The f32 pack holds hi = tf32(wh) and lo = tf32(wh - hi) of every
    weight, in the layout the 3xTF32 kernel reads; unpacking gives both back
    exactly, and hi + lo is wh to 2^-21 relative."""
    wh = torch.from_numpy(np.random.default_rng(k + feat).normal(
        size=(k, k, feat, 4 * feat)).astype(np.float32))
    packed = convlstm_cell.pack_wh_tf32x3(wh)
    assert packed.shape == (feat // 32, feat // 16, k * k, 2, 4, 128, 4)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    hi, lo = convlstm_cell.unpack_wh_tf32x3(packed)
    np.testing.assert_array_equal(hi.numpy(), _tf32(wh.numpy()))
    np.testing.assert_array_equal(lo.numpy(), _tf32(wh.numpy() - hi.numpy()))
    assert float(((hi + lo - wh).abs() / wh.abs()).max()) <= 2.0 ** -21
    view = wh.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # as the cell passes it
    assert torch.equal(convlstm_cell.pack_wh_tf32x3(view), packed)


@pytest.mark.parametrize("products", ["3xtf32", "1xtf32"])
def test_tf32x3_gemm_matches_interpreted_pallas(products):
    """The 3xTF32 kernel's arithmetic on the CPU at 8x128, F = 128, 5x5: per
    32-feature column tile, 16-channel chunk and tap, the split h tile
    against the packed hi/lo Wh as hi*lo + lo*hi + hi*hi (exact products),
    each chunk's sum rounded to f32 and added into an f32 sum as the kernel
    flushes it, then de-interleaved as the epilogue reads the m64n128
    fragment, plus gx and the gate math. It matches the reference's fused
    level (Pallas, interpreted) to 2e-5; the control, hi*hi alone (plain
    TF32), must miss 2e-5, so the test tells the two apart."""
    gx, h, c, wh = _level_inputs(5, (8, 128), 128, 5)
    feat, k, tile, chunk = 128, 5, 32, 16
    packed = convlstm_cell.pack_wh_tf32x3(torch.from_numpy(wh)).double()
    hp = np.pad(h[0], ((2, 2), (2, 2), (0, 0)))
    a_hi = _tf32(hp)
    a_lo = _tf32(hp - a_hi)
    a_hi, a_lo = torch.from_numpy(a_hi).double(), torch.from_numpy(a_lo).double()
    z = torch.zeros(8 * 128, 4 * feat, dtype=torch.float64)
    gate, fl = zip(*(_fragment_gate_feature(n, tile // 4) for n in range(4 * tile)))
    for nt in range(feat // tile):
        total = torch.zeros(8 * 128, 4 * tile, dtype=torch.float32)
        for ch in range(feat // chunk):
            part = torch.zeros(8 * 128, 4 * tile, dtype=torch.float64)
            for tap in range(k * k):
                ky, kx = divmod(tap, k)
                sl = (slice(ky, ky + 8), slice(kx, kx + 128), slice(ch * chunk, (ch + 1) * chunk))
                ah, al = a_hi[sl].reshape(-1, chunk), a_lo[sl].reshape(-1, chunk)
                # [hi/lo, group, column, channel] -> [channel, column]
                bh, bl = (packed[nt, ch, tap, s].permute(0, 2, 1).reshape(chunk, 4 * tile)
                          for s in (0, 1))
                if products == "3xtf32":
                    part += ah @ bl + al @ bh
                part += ah @ bh
            total += part.float()
        cols = [g * feat + nt * tile + f for g, f in zip(gate, fl)]
        z[:, cols] = total.double()
    z = z.reshape(1, 8, 128, 4 * feat) + torch.from_numpy(gx)
    c_new, h_new = lstm_gates.gate_math(*(z[..., i * feat:(i + 1) * feat].float()
                                          for i in range(4)),
                                        torch.from_numpy(c), "sigmoid")
    want = jax_fused(jnp.asarray(gx[0]), jnp.asarray(h[0]), jnp.asarray(c[0]),
                     jnp.asarray(wh))
    err = max(float(np.abs(g[0].numpy() - np.asarray(w)).max())
              for g, w in zip((h_new, c_new), want))
    if products == "3xtf32":
        assert err <= 2e-5, err
    else:
        assert err > 2e-5, err


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
