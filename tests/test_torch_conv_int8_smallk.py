"""The int8 conv's small-K route (``csrc/conv_int8_smallk.cu``) on the CPU.

The kernel runs only on the card; what surrounds it is held here: its weight
pack (round trip and B-fragment layout), its shared-memory formula against
the constants the kernel's layout is built from, the route's K limit, an
emulation of the kernel's tile, window, offset table and fragment addressing
against the exact sums, and its plain version (``quantize_act`` + the exact
conv) against the JAX reference's ``conv2d_q``, bit for bit, at the sites it
takes: the flagship's cin = 1 5x5 x-conv and the tiny model's cin 8 and 24.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from lstm_unet_tpu.ops import quant as jq
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
from lstm_unet_tpu_torch.ops import quant
from lstm_unet_tpu_torch.ops.kernels import conv_int8, counts, reset_counts


def _kq(cout, cin, kh, kw, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-127, 128, (cout, cin, kh, kw)).astype(np.int8))


# ---------------------------------------------------------------- the pack


@pytest.mark.parametrize("cout,cin,kh,kw", [
    (512, 1, 5, 5),    # the flagship's level 0 x-conv: K = 25 -> 32
    (32, 8, 3, 3),     # tiny: K = 72 -> 96
    (8, 24, 3, 3),     # tiny decoder 0: K = 216 -> 224
    (3, 8, 1, 1),      # tiny head: N 3 -> 8, K 8 -> 32
    (20, 2, 1, 7),     # non-square
])
def test_smallk_pack_round_trips_and_layout(cout, cin, kh, kw):
    q = _kq(cout, cin, kh, kw, cout + cin)
    packed = conv_int8.pack_weight_smallk(q)
    kdim = kh * kw * cin
    kp, n8 = -(-kdim // 32) * 32, -(-cout // 8) * 8
    assert tuple(packed.shape) == (kp // 32, n8 // 8, 32, 8) and packed.is_contiguous()
    assert torch.equal(conv_int8.unpack_weight_smallk(packed, cout, cin, kh, kw), q)
    # element by element, independent of the unpack: step s, tile t, lane l,
    # byte e holds column 8t + l // 4 at k = 32s + 4(l % 4) + e % 4 + 16 (e // 4),
    # k = (ky * KW + kx) * cin + ci; zero past cout and K
    flat = q.permute(0, 2, 3, 1).reshape(cout, kdim)
    s, t, lane, e = torch.meshgrid(*(torch.arange(d) for d in packed.shape), indexing="ij")
    n = 8 * t + lane // 4
    k = 32 * s + 4 * (lane % 4) + e % 4 + 16 * (e // 4)
    inside = (n < cout) & (k < kdim)
    want = torch.zeros(packed.shape, dtype=torch.int8)
    want[inside] = flat[n[inside], k[inside]]
    assert torch.equal(packed, want)


def test_smallk_pack_refuses_what_the_route_does_not_take():
    with pytest.raises(ValueError, match="small-K"):
        conv_int8.pack_weight_smallk(_kq(8, 29, 3, 3, 0))  # K = 261
    with pytest.raises(ValueError, match="OIHW int8"):
        conv_int8.pack_weight_smallk(_kq(8, 8, 3, 3, 0).float())


# ---------------------------------------------------------------- smem and route


def test_smallk_smem_formula_mirrors_the_kernel_layout():
    # csrc/conv_int8_smallk.cu::layout: weights KP*N8, scale and bias 4*N8
    # each, table 4*KP, window KH*(64+KW-1)*C rounded to 16, A rows
    # 64*(KP+16), 8 warp slices of 16 rows of (64+8)*ob
    # flagship x-conv, bf16 out: window 5 * 68 = 340 -> 352, slices 128 * 144
    assert conv_int8.smallk_smem_bytes(5, 5, 1, 512, 2) == (16384 + 4096 + 128 + 352
                                                            + 64 * 48 + 128 * 144)
    assert conv_int8.smallk_smem_bytes(5, 5, 1, 512, 4) == (16384 + 4096 + 128 + 352
                                                            + 64 * 48 + 128 * 288)
    # tiny decoder 0 (cin 24, 3x3 -> 8): KP 224, N8 8, window 3 * 66 * 24
    assert conv_int8.smallk_smem_bytes(3, 3, 24, 8, 4) == (224 * 8 + 64 + 896 + 4752
                                                           + 64 * 240 + 128 * 288)
    # the widest weights the limit lets in: K 252 -> 256, N 600 (150 KB)
    assert conv_int8.smallk_smem_bytes(3, 3, 28, 600, 4) == (256 * 600 + 4800 + 1024 + 5552
                                                             + 64 * 272 + 128 * 288)
    assert conv_int8.smallk_smem_bytes(3, 3, 28, 700, 4) > conv_int8.SMEM_LIMIT
    # two blocks of the flagship's site fit an SM (the kernel asks for 2)
    assert 2 * (conv_int8.smallk_smem_bytes(5, 5, 1, 512, 4) + 1024) <= 233_472


@pytest.mark.parametrize("cin,kh,kw,cout,takes", [
    (1, 5, 5, 512, True), (8, 3, 3, 32, True), (24, 3, 3, 8, True),
    (28, 3, 3, 64, True),       # K 252 -> 256: the limit
    (29, 3, 3, 64, False),      # K 261 -> 288
    (2, 1, 127, 16, True), (1, 1, 257, 16, False),   # non-square at the limit
    (8, 4, 4, 16, False),       # even: no SAME centre
    (1, 1, 1, 30000, False),    # N too wide for a block's weights and tile
])
def test_smallk_takes_the_k_limit(cin, kh, kw, cout, takes):
    assert conv_int8.smallk_takes(cin, kh, kw, cout) == takes
    q = torch.zeros(cout, cin, kh, kw, dtype=torch.int8)
    if kh % 2:
        assert conv_int8.weight_route(q) == ("smallk" if takes
                                            else "wgmma" if cin % 16 == 0 and kh == kw
                                            and kh in (1, 3, 5) else "mma_sync")


def test_flagship_and_tiny_sites_by_route():
    """25 flagship sites: 24 wgmma + 1 small-K, 0 mma_sync; the tiny model's
    9: cin 1, 8 and 24 small-K, the rest wgmma."""
    for nkp, hw, want in ((default_net_kernel_params(), 512, (24, 1, 0)),
                          (tiny_net_kernel_params(), 32, (3, 6, 0))):
        routes = [conv_int8.route(h, h, cin, k, cout)
                  for _, h, cin, k, cout in chip_smoke.int8_conv_sites(nkp, hw)]
        assert tuple(routes.count(r) for r in ("wgmma", "smallk", "mma_sync")) == want


# ---------------------------------------------------------------- the kernel's addressing


def _emulate_smallk(xq, packed, kh, kw, cout):
    """The s32 sums [B,H,W,N8] as the small-K kernel forms them: per tile (a
    segment of 64 pixels of one row) the KH x (64 + KW - 1) x C window as
    bytes; the A rows through the offset table (byte k of pixel p at
    tab[k] + p * C); per warp item (16 pixels, 8 column tiles) the A
    fragments (rows g and g + 8, k = 4t .. 4t + 3 and + 16) and the B
    fragments read from the pack's lane order."""
    b, h, w, cin = xq.shape
    ksteps, ntiles = packed.shape[:2]
    n8 = 8 * ntiles
    tm = conv_int8.SMALLK_TILE
    hwin, rh, rw = tm + kw - 1, kh // 2, kw // 2
    kdim = kh * kw * cin
    tab = []
    for k in range(32 * ksteps):
        if k < kdim:
            tap, ci = divmod(k, cin)
            ky, kx = divmod(tap, kw)
            tab.append((ky * hwin + kx) * cin + ci)
        else:
            tab.append(-1)
    xp = torch.zeros(b, h + 2 * rh, -(-w // tm) * tm + 2 * rw, cin, dtype=torch.int64)
    xp[:, rh:rh + h, rw:rw + w] = xq
    out = torch.zeros(b, h, -(-w // tm) * tm, n8, dtype=torch.int64)
    pk = packed.to(torch.int64)
    lanes = torch.arange(32)
    g, t4 = lanes // 4, lanes % 4
    for bi in range(b):
        for yy in range(h):
            for x0 in range(0, w, tm):
                win = xp[bi, yy:yy + kh, x0:x0 + hwin].reshape(-1)
                for mb in range(tm // 16):
                    # A[16 rows, 32 k] per step, from each lane's gathers
                    for nt in range(ntiles):
                        acc = torch.zeros(16, 8, dtype=torch.int64)
                        for s in range(ksteps):
                            a = torch.zeros(16, 32, dtype=torch.int64)
                            for half in range(2):
                                for j in range(4):
                                    for kk in (0, 16):
                                        k = 32 * s + 4 * t4 + j + kk
                                        o = torch.tensor([tab[i] for i in k])
                                        row = 16 * mb + g + 8 * half
                                        v = torch.where(o < 0, 0, win[(o + row * cin).clamp(min=0)])
                                        a[g + 8 * half, 4 * t4 + j + kk] = v
                            bm = torch.zeros(32, 8, dtype=torch.int64)
                            for e in range(8):
                                bm[4 * t4 + e % 4 + 16 * (e // 4), g] = pk[s, nt, lanes, e]
                            acc += a @ bm
                        out[bi, yy, x0 + 16 * mb:x0 + 16 * mb + 16, 8 * nt:8 * nt + 8] = acc
    return out[:, :, :w]


@pytest.mark.parametrize("b,h,w,cin,kh,kw,cout", [
    (1, 3, 70, 1, 5, 5, 24),    # cin 1 5x5, a ragged second tile
    (2, 4, 9, 8, 3, 3, 16),     # cin 8 3x3 (K 72: three steps), B = 2
    (1, 3, 20, 24, 3, 3, 8),    # cin 24 (K 216: seven steps)
    (1, 2, 17, 3, 1, 3, 5),     # non-square, N 5 padded to 8
])
def test_tile_emulation_equals_the_exact_sums(b, h, w, cin, kh, kw, cout):
    r = np.random.default_rng(cin + cout)
    xq = torch.from_numpy(r.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    kq = torch.from_numpy(r.integers(-127, 128, (cout, cin, kh, kw)).astype(np.int8))
    got = _emulate_smallk(xq, conv_int8.pack_weight_smallk(kq), kh, kw, cout)
    want = conv_int8.conv_acc_plain(xq, kq)
    assert torch.equal(got[..., :cout], want.to(torch.int64))
    assert not got[..., cout:].any()


# ---------------------------------------------------------------- against the reference


def _jdt(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("in_dt,out_dt", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("cin,k,cout,hw", [
    (1, 5, 512, (7, 11)),   # the flagship's level 0 x-conv, odd edges
    (8, 3, 32, (5, 9)),     # the tiny model's cin 8 sites
    (24, 3, 8, (6, 7)),     # the tiny decoder's cin 16 + 8
])
def test_smallk_plain_equals_reference_conv2d_q(cin, k, cout, hw, in_dt, out_dt, scale):
    r = np.random.default_rng(cin * 7 + k)
    x = (r.normal(0, 1.0, (2, *hw, cin)) * 2).astype(np.float32)
    x[0, 0, 0, 0] = -0.0
    kern = r.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    bias = r.normal(0, 0.5, (cout,)).astype(np.float32)
    qk, sk = jq.quantize_weight(jnp.asarray(kern))
    qd = {"kernel_q": qk, "w_scale": sk, "bias": jnp.asarray(bias)}
    static = None
    if scale == "static":  # below max|x|: the clamp engages
        static = quant._scale_of({"s": 3.0}, "s")
        qd["x_scale"] = jq._scale_of({"s": 3.0}, "s")
    xj = jnp.asarray(x).astype(_jdt(in_dt))
    want = np.asarray(jq.conv2d_q(xj, qd, out_dtype=_jdt(out_dt)).astype(jnp.float32))
    weight = quant.QWeight(torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1))),
                           torch.from_numpy(bias))
    assert weight.route == "smallk"
    assert torch.equal(weight.kernel_q, torch.from_numpy(np.array(qk)).permute(3, 2, 0, 1))
    xt = torch.from_numpy(x).to(in_dt)
    reset_counts()
    got = conv_int8.conv2d_int8_smallk(xt, static, weight.packed, weight.w_scale, weight.bias,
                                       k, k, out_dt)
    assert counts()["conv2d_int8_smallk"] == {"kernel": 0, "plain": 1}
    assert got.dtype == out_dt
    np.testing.assert_array_equal(got.float().numpy(), want)
    # conv2d_q takes the same route and gives the same bits, with no other
    # route's call
    reset_counts()
    assert torch.equal(quant.conv2d_q(xt, weight, static, out_dt), got)
    ran = counts()
    assert ran["conv2d_int8_smallk"]["plain"] == 1
    assert ran["conv2d_int8"]["plain"] == ran["conv2d_int8_wgmma"]["plain"] == 0


def test_smallk_plain_equals_the_mma_sync_plain():
    """The same site on the old route (eager quantize_act + mma_sync plain)
    and the new one give the same bits."""
    r = np.random.default_rng(5)
    kq = torch.from_numpy(r.integers(-127, 128, (40, 1, 5, 5)).astype(np.int8))
    x = torch.from_numpy(r.normal(0, 1, (1, 9, 13, 1)).astype(np.float32)).bfloat16()
    ws = torch.from_numpy(r.uniform(1e-4, 1e-3, 40).astype(np.float32))
    bias = torch.from_numpy(r.normal(0, 1, 40).astype(np.float32))
    for scale in (None, torch.tensor(0.02)):
        got = conv_int8.conv2d_int8_smallk(x, scale, conv_int8.pack_weight_smallk(kq), ws, bias,
                                           5, 5, torch.bfloat16)
        xq, s_x = conv_int8.quantize_act(x, scale)
        want = conv_int8.conv2d_int8(xq, s_x, conv_int8.pack_weight(kq), ws, bias, 5, 5,
                                     torch.bfloat16)
        assert torch.equal(got, want)


def test_smallk_wrapper_checks():
    kq = _kq(24, 8, 3, 3, 1)
    packed = conv_int8.pack_weight_smallk(kq)
    x = torch.zeros(1, 4, 4, 8)
    ws = torch.ones(24)
    with pytest.raises(ValueError, match="pack"):
        conv_int8.conv2d_int8_smallk(x, None, packed[:2], ws, None, 3, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_int8.conv2d_int8_smallk(x.to(torch.int8), None, packed, ws, None, 3, 3)
    with pytest.raises(ValueError, match="does not take"):
        conv_int8.conv2d_int8_smallk(torch.zeros(1, 4, 4, 29), None, packed, ws, None, 3, 3)
    with pytest.raises(TypeError, match="scale"):
        conv_int8.conv2d_int8_smallk(x, torch.tensor(1.0).double(), packed, ws, None, 3, 3)
    with pytest.raises(ValueError, match="device"):
        conv_int8.conv2d_int8_smallk(x.to("meta"), None, packed, ws, None, 3, 3)
