"""K4's narrow-level route (``csrc/convlstm_narrow.cu``) on the CPU.

The kernel runs only on the card; what surrounds it is held here: the route
table (the flagship's four levels unchanged, the narrow and 7x7 levels on the
new route), its Wh packs (round trips and column order), its shared-memory
formula against the constants of the kernel's layout, an emulation of its
tiling and arithmetic (feature tiles of 32, 16 or 8, input-channel chunks of
the instruction's k zero-filled past F, 3xTF32 with each chunk's sum rounded
into an f32 total) against the reference's fused level, and the plain
version against the JAX cell (XLA twin) at F = 8, 24, 96 and 7x7, to the
reference's 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_unet_tpu.ops import conv as jconv
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell as JaxCell
from lstm_unet_tpu.ops.pallas.lstm_gates import lstm_gate_update_xla
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
from lstm_unet_tpu_torch.ops.convlstm import ConvLSTMCell
from lstm_unet_tpu_torch.ops.kernels import convlstm_cell, counts, lstm_gates, reset_counts

BF16, F32 = torch.bfloat16, torch.float32


def _level_inputs(seed, hw, feat, k, batch=1):
    r = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (k * k * feat + k * k * 4 * feat))
    h, w = hw
    return (r.normal(0, 0.5, (batch, h, w, 4 * feat)).astype(np.float32),
            r.uniform(-1, 1, (batch, h, w, feat)).astype(np.float32),
            r.normal(size=(batch, h, w, feat)).astype(np.float32),
            r.uniform(-lim, lim, (k, k, feat, 4 * feat)).astype(np.float32))


def _tf32(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _jax_level(gx, h, c, wh):
    """The reference's fused level as its XLA twin computes it (the Pallas
    kernel takes only F % 128 == 0): the SAME conv of h with Wh in f32, plus
    gx, then the gate update; (h', c')."""
    feat = h.shape[-1]
    z = jconv.conv2d(jnp.asarray(h), jnp.asarray(wh)) + jnp.asarray(gx)
    c_new, h_new = lstm_gate_update_xla(z.reshape(-1, 4 * feat), jnp.asarray(c).reshape(-1, feat))
    return np.asarray(h_new).reshape(h.shape), np.asarray(c_new).reshape(c.shape)


def _gate_feature(col, per_thread):
    """(gate, feature within the tile) the epilogue reads from accumulator
    column ``col``: lane q of a quad holds columns 8j + 2q + {0, 1}, j = 2u as
    (i, f) and j = 2u + 1 as (g, o) of feature per_thread * q + u."""
    j, q, b = col // 8, (col % 8) // 2, col % 2
    return 2 * (j % 2) + b, per_thread * q + j // 2


# ---------------------------------------------------------------- the route


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_narrow_route_table(dtype):
    """The flagship's four levels keep their tensor-core routes; the tiny
    model's levels, F in {8, 16, 24, 32, 96} and every 7x7 level take the
    narrow route; F not a multiple of 8, a 9x9 kernel and float16 take no
    route (the cell runs such a level unfused)."""
    tc = "wgmma" if dtype == BF16 else "tf32x3"
    for nkp, hw, want in ((default_net_kernel_params(), 512, [tc] * 4),
                          (tiny_net_kernel_params(), 32, ["narrow"] * 2)):
        got = [convlstm_cell.route(hw >> lvl, hw >> lvl, f, k, 1, dtype)
               for lvl, ((k, f),) in enumerate(nkp.lstm_kernels)]
        assert got == want
    for feat in (8, 16, 24, 32, 96):
        for k in (1, 3, 5, 7):
            assert convlstm_cell.route(512, 512, feat, k, 1, dtype) == "narrow"
    for feat in (64, 128, 256, 512):
        assert convlstm_cell.route(64, 64, feat, 7, 2, dtype) == "narrow"
        assert convlstm_cell.route(64, 64, feat, 5, 2, dtype) == tc
    assert convlstm_cell.route(64, 64, 10, 3, 1, dtype) is None
    assert convlstm_cell.route(64, 64, 8, 9, 1, dtype) is None
    assert convlstm_cell.route(64, 64, 12, 7, 1, dtype) is None
    assert convlstm_cell.route(64, 64, 8, 3, 1, torch.float16) is None


def test_narrow_tile_and_smem_formula():
    # the largest of 32, 16, 8 that divides F
    assert [convlstm_cell.narrow_tile(f) for f in (8, 16, 24, 32, 40, 96, 128)] == \
        [8, 16, 8, 32, 8, 32, 32]
    # csrc/convlstm_narrow.cu::layout: S stages of K * planes * 4T * 16
    # bytes, two h tiles of planes * (((R+K-1) * (64+K-1)) | 1) * 16, 12
    # mbarriers of 8 bytes; S the largest of 4 .. 1 that fits 232,448;
    # bf16: 2 planes, R = 4 rows; 3xTF32: 4 planes, R = 2
    b5, b7 = (8 * 68 | 1) * 16, (10 * 70 | 1) * 16
    f5, f7 = (6 * 68 | 1) * 16, (8 * 70 | 1) * 16
    assert convlstm_cell.narrow_smem_bytes(5, 32, BF16) == 4 * 5 * 2 * 2048 + 2 * 2 * b5 + 96
    assert convlstm_cell.narrow_smem_bytes(7, 32, BF16) == 4 * 7 * 2 * 2048 + 2 * 2 * b7 + 96
    assert convlstm_cell.narrow_smem_bytes(5, 32, F32) == 4 * 5 * 4 * 2048 + 2 * 4 * f5 + 96
    assert convlstm_cell.narrow_smem_bytes(7, 32, F32) == 2 * 7 * 4 * 2048 + 2 * 4 * f7 + 96
    assert convlstm_cell.narrow_smem_bytes(3, 8, BF16) == (4 * 3 * 2 * 512
                                                           + 2 * 2 * (6 * 66 | 1) * 16 + 96)
    for k in (1, 3, 5, 7):
        for t in (8, 16, 32):
            for dt in (BF16, F32):
                assert convlstm_cell.narrow_smem_bytes(k, t, dt) <= convlstm_cell.SMEM_LIMIT


# ---------------------------------------------------------------- the packs


@pytest.mark.parametrize("k,feat", [(3, 8), (3, 16), (5, 24), (5, 32), (1, 96), (7, 64)])
def test_narrow_packs_round_trip(k, feat):
    wh = torch.from_numpy(np.random.default_rng(k + feat).normal(
        size=(k, k, feat, 4 * feat)).astype(np.float32))
    t, cb = convlstm_cell.narrow_tile(feat), 16
    packed = convlstm_cell.pack_wh_narrow(wh.to(BF16))
    assert packed.shape == (feat // t, -(-feat // cb), k * k, cb // 8, 4 * t, 8)
    assert packed.is_contiguous()
    assert torch.equal(convlstm_cell.unpack_wh_narrow(packed), wh.to(BF16))
    if feat % cb:  # the zero-filled channels of the last chunk
        assert not packed[:, -1, :, (feat % cb) // 8:].any()
    chunks8 = feat // 8
    view = wh.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # as the cell passes it
    assert torch.equal(convlstm_cell.pack_wh_narrow(view), convlstm_cell.pack_wh_narrow(wh))
    p3 = convlstm_cell.pack_wh_narrow_tf32x3(wh)
    assert p3.shape == (feat // t, chunks8, k * k, 2, 2, 4 * t, 4) and p3.dtype == F32
    hi, lo = convlstm_cell.unpack_wh_narrow_tf32x3(p3)
    np.testing.assert_array_equal(hi.numpy(), _tf32(wh.numpy()))
    np.testing.assert_array_equal(lo.numpy(), _tf32(wh.numpy() - hi.numpy()))
    assert torch.equal(convlstm_cell.pack_for_route(wh, "narrow"), p3)
    assert torch.equal(convlstm_cell.pack_for_route(wh.to(BF16), "narrow"), packed)
    assert convlstm_cell.pack_for_route(wh, "tf32x3") is None


def test_narrow_pack_column_order():
    """Column n of tile T's block holds gate 2 (r // 8) + r % 2 of feature
    T * tile + (tile / 4) ((r % 8) // 2) + n // 16, r = n % 16, for the
    channel of its chunk, plane and byte."""
    k, feat = 3, 24
    wh = torch.arange(k * k * feat * 4 * feat, dtype=torch.float32).reshape(k, k, feat, 4 * feat)
    packed = convlstm_cell.pack_wh_narrow_tf32x3(wh)[:, :, :, 0]  # the hi planes
    tile, t = 8, 2
    r = np.random.default_rng(0)
    for _ in range(200):
        nt, ch, tap, p, n, e = (int(r.integers(0, d)) for d in packed.shape)
        rr = n % 16
        gate, f = 2 * (rr // 8) + rr % 2, nt * tile + t * ((rr % 8) // 2) + n // 16
        ci = ch * 8 + p * 4 + e
        want = float(convlstm_cell.round_tf32(wh[tap // k, tap % k, ci, gate * feat + f]))
        assert float(packed[nt, ch, tap, p, n, e]) == want


# ---------------------------------------------------------------- the kernel's arithmetic


def _emulate(gx, h, c, wh, dt):
    """The narrow kernel's arithmetic at one level (B = 1), in torch: per
    column tile (T = narrow_tile(F) features, N = 4T columns in the packed
    order) and input-channel chunk (bf16 16, zero-filled past F; 3xTF32
    8), the shifted h tile of each tap against the packed Wh block;
    bf16: exact products summed in f64; 3xTF32: hi*lo + lo*hi + hi*hi, each
    chunk's sum rounded to f32 and added into an f32 total; then the
    fragment's columns de-interleaved, gx added, the gate math."""
    _, hh, ww, feat = h.shape
    k = wh.shape[0]
    tile, chunk = convlstm_cell.narrow_tile(feat), convlstm_cell.NARROW_CHUNK[dt]
    nchunks = -(-feat // chunk)
    hp = np.zeros((hh + k - 1, ww + k - 1, nchunks * chunk), np.float32)
    hp[k // 2:k // 2 + hh, k // 2:k // 2 + ww, :feat] = h[0]
    gate, fl = zip(*(_gate_feature(n, tile // 4) for n in range(4 * tile)))
    z = torch.zeros(hh * ww, 4 * feat, dtype=torch.float64)
    if dt == BF16:
        packed = convlstm_cell.pack_wh_narrow(torch.from_numpy(wh).to(BF16)).double()
        a = torch.from_numpy(hp).to(BF16).double()
    else:
        packed = convlstm_cell.pack_wh_narrow_tf32x3(torch.from_numpy(wh)).double()
        a_hi = torch.from_numpy(_tf32(hp)).double()
        a_lo = torch.from_numpy(_tf32(hp - _tf32(hp))).double()
    for nt in range(feat // tile):
        total = torch.zeros(hh * ww, 4 * tile, dtype=torch.float32)
        acc = torch.zeros(hh * ww, 4 * tile, dtype=torch.float64)
        for ch in range(nchunks):
            part = torch.zeros(hh * ww, 4 * tile, dtype=torch.float64)
            for tap in range(k * k):
                ky, kx = divmod(tap, k)
                sl = (slice(ky, ky + hh), slice(kx, kx + ww), slice(ch * chunk, (ch + 1) * chunk))
                if dt == BF16:
                    b = packed[nt, ch, tap].permute(0, 2, 1).reshape(chunk, 4 * tile)
                    acc += a[sl].reshape(-1, chunk) @ b
                else:
                    bh, bl = (packed[nt, ch, tap, s].permute(0, 2, 1).reshape(chunk, 4 * tile)
                              for s in (0, 1))
                    ah, al = a_hi[sl].reshape(-1, chunk), a_lo[sl].reshape(-1, chunk)
                    part += ah @ bl + al @ bh + ah @ bh
            total += part.float()
        cols = [g * feat + nt * tile + f for g, f in zip(gate, fl)]
        z[:, cols] = acc if dt == BF16 else total.double()
    z = z.float().reshape(1, hh, ww, 4 * feat) + torch.from_numpy(gx).to(dt).float()
    c_new, h_new = lstm_gates.gate_math(*(z[..., i * feat:(i + 1) * feat] for i in range(4)),
                                        torch.from_numpy(c), "sigmoid")
    return h_new, c_new


@pytest.mark.parametrize("k,feat,hw", [(3, 8, (6, 70)), (5, 24, (5, 9)), (7, 16, (4, 20)),
                                       (5, 32, (3, 66))])
def test_narrow_tf32x3_emulation_matches_the_reference(k, feat, hw):
    """The 3xTF32 arithmetic of the narrow tiles against the reference's fused
    level (its XLA twin), to the reference's 2e-5."""
    gx, h, c, wh = _level_inputs(k + feat, hw, feat, k)
    got = _emulate(gx, h, c, wh, F32)
    for g, w in zip(got, _jax_level(gx, h, c, wh)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5)


@pytest.mark.parametrize("k,feat,hw", [(3, 8, (6, 10)), (5, 24, (5, 9)), (3, 96, (3, 5))])
def test_narrow_bf16_emulation_equals_the_plain_version(k, feat, hw):
    """The bf16 tiles' sums (exact products of bf16 values, f64 here) in the
    packed column order equal the plain version's to f32 rounding."""
    gx, h, c, wh = _level_inputs(k * feat, hw, feat, k)
    got = _emulate(gx, h, c, wh, BF16)
    want = convlstm_cell.fused_convlstm_level_plain(
        torch.from_numpy(gx).to(BF16), torch.from_numpy(h), torch.from_numpy(c),
        torch.from_numpy(wh).to(BF16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=0)


# ---------------------------------------------------------------- against the reference


@pytest.mark.parametrize("k,feat,hw,batch", [(3, 8, (12, 10), 2), (3, 24, (8, 8), 1),
                                             (5, 96, (6, 7), 1), (7, 16, (9, 11), 1),
                                             (7, 64, (5, 5), 2)])
def test_fused_narrow_plain_matches_the_jax_cell(k, feat, hw, batch):
    """The port's fused cell on the narrow route (its plain version here,
    counted there) against the reference's cell with the same weights (the
    XLA twin, as the Pallas kernel takes only F % 128 == 0), to 2e-5."""
    r = np.random.default_rng(k * 100 + feat)
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
    for name in ("kernel_x", "kernel_h"):
        getattr(cell, name).data = torch.from_numpy(
            np.ascontiguousarray(jcell[name].transpose(3, 2, 0, 1)))
    cell.bias.data = torch.from_numpy(jcell["bias"])
    assert convlstm_cell.route(*hw, feat, k, batch, F32) == "narrow"
    reset_counts()
    with torch.no_grad():
        (th, tc), _ = cell((torch.from_numpy(h0), torch.from_numpy(c0)), torch.from_numpy(x),
                           fused_cell=True)
    ran = counts()
    assert ran["fused_convlstm_level_narrow"] == {"kernel": 0, "plain": 1}
    assert all(ran[n]["plain"] == 0 for n in ("lstm_gate_update", "fused_convlstm_level_tf32x3"))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)


def test_narrow_wrapper_checks():
    gx, h, c, wh = map(torch.from_numpy, _level_inputs(1, (4, 4), 8, 3))
    packed = convlstm_cell.pack_wh_narrow_tf32x3(wh)
    with pytest.raises(ValueError, match="F % 8"):
        convlstm_cell.pack_wh_narrow(torch.zeros(3, 3, 12, 48))
    with pytest.raises(ValueError, match="float32"):
        convlstm_cell.pack_wh_narrow_tf32x3(wh.to(BF16))
    # the CPU takes the plain version whatever pack is handed in
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(gx, h, c, wh, packed=packed)
    want = convlstm_cell.fused_convlstm_level_plain(gx, h, c, wh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts()["fused_convlstm_level_narrow"]["plain"] == 2
