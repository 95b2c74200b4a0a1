"""The int8 conv's wgmma route (``csrc/conv_int8_wgmma.cuh``) on the CPU.

The kernel runs only on the card; what surrounds it is held here: its weight
pack (round trip and element layout), the route table over the flagship's
and the tiny model's int8 sites, an emulation of the kernel's tile, chunk,
tap and plane addressing and of its quantize arithmetic (a multiply by
``1/s``, with the division where that could differ) against the exact plain
versions, and its plain version (``quantize_act`` + the exact conv) against
the JAX reference's ``conv2d_q``, bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from portbench.harness import arith, cell
from lstm_unet_tpu.ops import quant as jq
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, quantize_model_int8
from lstm_unet_tpu_torch.ops import quant
from lstm_unet_tpu_torch.ops.kernels import conv_int8, convlstm_cell, counts, reset_counts


def _kernel(cout, cin, k, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(0, 0.1, (cout, cin, k, k)).astype(np.float32))


# ---------------------------------------------------------------- the pack


@pytest.mark.parametrize("cout", [3, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin", [16, 32, 64, 128, 192, 384, 1024])
def test_wgmma_pack_round_trips_and_layout(cin, k, cout):
    w = quant.QWeight(_kernel(cout, cin, k, cin + 7 * k + cout), None)
    q, _ = quant.quantize_weight(_kernel(cout, cin, k, cin + 7 * k + cout))
    t = conv_int8.pack_tile_n(cout)
    assert t == {3: 8, 32: 32, 64: 64, 128: 128}.get(cout, 256)
    assert tuple(w.packed.shape) == (-(-cout // t), -(-cin // 128), k, k, 8, t, 16)
    assert w.packed.dtype == torch.int8
    assert torch.equal(w.kernel_q, q)
    # element by element at sampled positions, independent of the unpack:
    # stage (tile, chunk, ky, kx), plane p, column c, byte e holds
    # q[tile * t + c, 128 * chunk + 16 * p + e, ky, kx], 0 past cout and cin
    r = np.random.default_rng(1)
    idx = [torch.from_numpy(r.integers(0, d, 4096)) for d in w.packed.shape]
    tile, chunk, ky, kx, p, c, e = idx
    n, ci = tile * t + c, 128 * chunk + 16 * p + e
    inside = (n < cout) & (ci < cin)
    want = torch.zeros(4096, dtype=torch.int8)
    want[inside] = q[n[inside], ci[inside], ky[inside], kx[inside]]
    assert torch.equal(w.packed[tile, chunk, ky, kx, p, c, e], want)
    assert inside.any()


# ---------------------------------------------------------------- the routes


def _sites(model, x, h, conv):
    """{site: value} over a model's conv sites: ``x(cell)`` and ``h(cell)``
    of each ConvLSTM cell, ``conv(c)`` of each conv."""
    out = {}
    for i, level in enumerate(model.encoder):
        for j, cell in enumerate(level.lstm):
            out[f"encoder/{i}/lstm/{j}/x"] = x(cell)
            out[f"encoder/{i}/lstm/{j}/h"] = h(cell)
        for j, c in enumerate(level.convs):
            out[f"encoder/{i}/convs/{j}"] = conv(c)
    for i, level in enumerate(model.decoder):
        for j, c in enumerate(level.convs):
            out[f"decoder/{i}/convs/{j}"] = conv(c)
    out["head"] = conv(model.head)
    return out


def _model_sites(model):
    """{site: (cin, k, cout, route of its weight)} of a quantized model."""
    def row(qw):
        cout, cin, k, _ = qw.shape
        return cin, k, cout, qw.route

    return _sites(model, lambda c: row(c.wx), lambda c: row(c.wh), lambda c: row(c.weight))


def _routes(nkp, hw):
    sites = chip_smoke.int8_conv_sites(nkp, hw)
    return sites, {s: conv_int8.route(h, h, cin, k, cout) for s, h, cin, k, cout in sites}


def test_route_takes_24_of_the_flagships_25_int8_sites():
    sites, routes = _routes(default_net_kernel_params(), 512)
    assert len(sites) == 25
    assert [s for s, r in routes.items() if r != "wgmma"] == ["encoder/0/lstm/0/x"]
    assert routes["encoder/0/lstm/0/x"] == "smallk"  # 0 sites on mma_sync
    # fused: the four h-convs run in K4 (its bf16 tensor-core route) instead
    fused = [s for s in routes if not s.endswith("/h")]
    assert len(fused) == 21 and sum(routes[s] == "wgmma" for s in fused) == 20
    for s, h, cin, k, _ in sites:
        if s.endswith("/h"):
            assert convlstm_cell.route(h, h, cin, k, 1, torch.bfloat16) == "wgmma"
    # the quantized flagship (on the meta device: shapes only) packs each
    # site for the route the table gives it
    cfg = ModelConfig.make(default_net_kernel_params(), dtype="bfloat16", quant="int8")
    model = quantize_model_int8(ULSTMnet2D(cfg, device="meta"))
    assert _model_sites(model) == {s: (cin, k, cout, routes[s])
                                   for s, _, cin, k, cout in sites}


def test_route_of_the_tiny_models_int8_sites():
    # cin 1, 8 and 24 take the small-K kernel (K = 9, 72, 216 and the head's
    # 8); cin 16 and 32 the wgmma one; none the mma_sync one
    sites, routes = _routes(tiny_net_kernel_params(), 32)
    assert routes == {
        "encoder/0/lstm/0/x": "smallk",     # cin 1
        "encoder/0/lstm/0/h": "smallk",     # cin 8
        "encoder/0/convs/0": "smallk",      # cin 8
        "encoder/1/lstm/0/x": "smallk",     # cin 8
        "encoder/1/lstm/0/h": "wgmma",      # cin 16
        "encoder/1/convs/0": "wgmma",       # cin 16
        "decoder/1/convs/0": "wgmma",       # cin 16 + 16
        "decoder/0/convs/0": "smallk",      # cin 16 + 8
        "head": "smallk",                   # cin 8
    }
    cfg = ModelConfig.make(tiny_net_kernel_params(), dtype="bfloat16", quant="int8")
    model = quantize_model_int8(ULSTMnet2D(cfg, generator=torch.Generator().manual_seed(0)))
    assert _model_sites(model) == {s: (cin, k, cout, routes[s])
                                   for s, _, cin, k, cout in sites}


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_each_weight_carries_its_kernels_route_and_unpacks_to_it(name):
    """Every int8 site of the tiny model (on the CPU) and of the flagship (on
    the meta device: shapes only) keeps the route ``weight_route`` gives its
    int8 kernel, and its pack unpacks to that kernel (the h-convs' gate packs
    too, back in natural order)."""
    nkp, device = {"tiny": (tiny_net_kernel_params(), "cpu"),
                   "flagship": (default_net_kernel_params(), "meta")}[name]
    cfg = ModelConfig.make(nkp, dtype="bfloat16", quant="int8")
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    model = ULSTMnet2D(cfg, generator=gen, device=device)
    kernels = {s: quant.quantize_weight(k)[0] for s, k in _sites(
        model, lambda c: c.kernel_x, lambda c: c.kernel_h, lambda c: c.kernel).items()}
    weights = _sites(quantize_model_int8(model), lambda c: c.wx, lambda c: c.wh,
                     lambda c: c.weight)
    assert weights.keys() == kernels.keys()
    gates = 0
    for site, qw in weights.items():
        kq = kernels[site]
        assert qw.route == conv_int8.weight_route(kq), site
        got = qw.kernel_q
        assert got.shape == kq.shape and got.dtype == torch.int8, site
        if device == "cpu":
            assert torch.equal(got, kq), site
        gates += qw.gates
    assert gates == (4 if name == "flagship" else 0)


@pytest.mark.parametrize("args,want", [
    ((8, 8, 16, 3, 5), "wgmma"), ((8, 8, 32, 1, 3), "wgmma"), ((8, 8, 1024, 5, 2048), "wgmma"),
    ((8, 8, 8, 3, 16), "smallk"), ((8, 8, 24, 3, 8), "smallk"),
    ((8, 8, 1, 5, 512), "smallk"), ((8, 8, 16, 7, 16), "mma_sync"),
    ((8, 8, 28, 3, 64), "smallk"), ((8, 8, 29, 3, 64), "mma_sync"),  # K 252 / 261
    ((8, 8, 24, 5, 32), "mma_sync"),
    ((0, 8, 16, 3, 16), None), ((8, 8, 16, 3, 0), None),
])
def test_route_edges(args, want):
    assert conv_int8.route(*args) == want


def test_kernel_tile_n_and_smem():
    # 132 SMs (H100 SXM): the frames with fewer 256-column tiles than SMs
    # take 128-column tiles
    split = {(h, cin, k, cout)
             for _, h, cin, k, cout in chip_smoke.int8_conv_sites(default_net_kernel_params(), 512)
             if conv_int8.route(h, h, cin, k, cout) == "wgmma"
             and conv_int8.kernel_tile_n(1, h, h, cout, 132) != conv_int8.pack_tile_n(cout)}
    assert split == {(128, 256, 3, 256), (128, 768, 3, 256), (64, 512, 3, 512),
                     (64, 1024, 3, 512)}
    assert conv_int8.kernel_tile_n(1, 512, 512, 3, 132) == 8
    assert conv_int8.kernel_tile_n(1, 512, 512, 128, 132) == 128
    assert conv_int8.kernel_tile_n(2, 128, 128, 256, 132) == 256  # B = 2: 256 tiles
    # the narrow tiles: cout up to 32 or 64, never split
    assert {c: conv_int8.pack_tile_n(c) for c in (1, 8, 9, 16, 32, 33, 64, 65, 128, 129)} == {
        1: 8, 8: 8, 9: 32, 16: 32, 32: 32, 33: 64, 64: 64, 65: 128, 128: 128, 129: 256}
    assert conv_int8.kernel_tile_n(1, 512, 512, 32, 132) == 32
    assert conv_int8.kernel_tile_n(1, 64, 64, 64, 132) == 64
    assert conv_int8.WG_TILE_ROWS == {256: 1, 128: 1, 64: 2, 32: 4, 8: 1}
    # K = 5 at 256 columns: K4's bf16 budget, the raw x ring (96 loaders x 8
    # items of 16 bf16 channels, or x 4 of f32: 24 KB) and the column tile's
    # table of (scale, bias) pairs (8 bytes a column); all within a block's
    # 227 KB
    raw, table = 96 * 8 * 32, 256 * 8
    assert conv_int8.wgmma_smem_bytes(5, 256) == convlstm_cell.wgmma_smem_bytes(5) + raw + table
    assert conv_int8.wgmma_smem_bytes(5, 256, 4) == (convlstm_cell.wgmma_smem_bytes(5)
                                                     + 96 * 4 * 64 + table)
    assert conv_int8.wgmma_smem_bytes(3, 256) == 98_304 + 67_840 + raw + table + 80
    assert max(conv_int8.wgmma_smem_bytes(k, t, xb) for k in (1, 3, 5)
               for t in (256, 128, 8) for xb in (2, 4)) <= convlstm_cell.SMEM_LIMIT
    # 32 columns, 8 rows, K = 5, chunks of 64: 8 weight stages of 4 planes x 32
    # columns, two x tiles of 4 planes of 12 x 68 pixels (odd: 817 units),
    # the raw ring of 224 loaders x 3 items of 16 bf16 channels, the table of
    # 32 columns
    assert conv_int8.wgmma_smem_bytes(5, 32, 2, 64) == (8 * 4 * 32 * 16 + 2 * 4 * 817 * 16
                                                         + 224 * 3 * 32 + 32 * 8 + 20 * 8)
    # the chunk: the widest compiled for the tile that divides cin rounded up
    # to 32 and fits (128 at 128 and 256 columns); every (K, N tile, x bytes)
    # block of the kernel's chunk fits
    assert {(cin, k, t): conv_int8.kernel_chunk(cin, k, t)
            for cin, k, t in ((192, 5, 32), (32, 5, 32), (384, 5, 64), (64, 5, 64), (32, 1, 8),
                              (1024, 3, 128), (128, 5, 32), (144, 3, 256), (144, 3, 128), (16, 3, 32),
                              (48, 3, 64))} == {
        (192, 5, 32): 64, (32, 5, 32): 32, (384, 5, 64): 128, (64, 5, 64): 64, (32, 1, 8): 32,
        (1024, 3, 128): 128, (128, 5, 32): 64, (144, 3, 256): 128, (144, 3, 128): 128,
        (16, 3, 32): 32,
        (48, 3, 64): 64}
    for k in (1, 3, 5):
        for t in conv_int8.WG_STAGES:
            for xb in (2, 4):
                for cin in (16, 32, 48, 64, 128, 192, 384, 1024):
                    chunk = conv_int8.kernel_chunk(cin, k, t, xb)
                    assert conv_int8.wgmma_smem_bytes(k, t, xb, chunk) <= conv_int8.SMEM_LIMIT


def test_the_published_widths_take_narrow_tiles_at_four_decoder_sites():
    """The benchmark's configuration (LSTM-UNet's published widths): exactly
    ``decoder/0/convs/{0,1}`` and ``decoder/1/convs/{0,1}`` take 32- or
    64-column tiles, each as wide as its cout, and every site's chunk holds
    no padded channel past 32; the port's default net takes none."""
    with open(os.path.join(chip_smoke.HERE, "portbench", "configs", "flagship-int8.json")) as f:
        widths = cell.as_run(json.load(f))
    narrow, chunks = {}, {}
    for site, h, w, k, cin, cout in arith.conv_sites(widths, 512, 512):
        if conv_int8.route(h, w, cin, k, cout) != "wgmma":
            continue
        t = conv_int8.kernel_tile_n(1, h, w, cout, 132)
        chunks[site] = conv_int8.kernel_chunk(cin, k, t)
        assert -(-cin // chunks[site]) * chunks[site] == -(-cin // 32) * 32, site
        if t in conv_int8.WG_NARROW:
            assert t == cout
            narrow[site] = (t, chunks[site])
    assert narrow == {"decoder/1/convs/0": (64, 128), "decoder/1/convs/1": (64, 64),
                      "decoder/0/convs/0": (32, 64), "decoder/0/convs/1": (32, 32)}
    assert chunks["head"] == 32  # the K half alone: 8 columns already
    assert [s for s, c in chunks.items() if c != 128] == [
        "decoder/1/convs/1", "decoder/0/convs/0", "decoder/0/convs/1", "head"]
    for _, h, cin, k, cout in chip_smoke.int8_conv_sites(default_net_kernel_params(), 512):
        if conv_int8.route(h, h, cin, k, cout) == "wgmma":
            assert conv_int8.kernel_tile_n(1, h, h, cout, 132) not in conv_int8.WG_NARROW


def test_the_published_widths_in_the_ports_order_are_the_harness_sites():
    """``chip_smoke.published_net_kernel_params`` (the published file's
    decoder stacks turned shallowest first, the head apart) gives the
    benchmark harness's own 25 sites of the file, in order; its wide shapes
    (``published_wide_shapes``) are those 19 sites on 128- and 256-column
    tiles with full chunks."""
    with open(os.path.join(chip_smoke.HERE, "portbench", "configs", "flagship-int8.json")) as f:
        widths = cell.as_run(json.load(f))
    ours = chip_smoke.int8_conv_sites(chip_smoke.published_net_kernel_params(), 512)
    assert ours == [(site, h, cin, k, cout)
                    for site, h, w, k, cin, cout in arith.conv_sites(widths, 512, 512)]
    wide = chip_smoke.published_wide_shapes()
    assert sum(map(len, wide.values())) == 19 and len(wide) == 14
    for (hw, cin, k, cout), sites in wide.items():
        tile = conv_int8.kernel_tile_n(1, hw, hw, cout, 132)
        assert tile in (128, 256) and conv_int8.kernel_chunk(cin, k, tile) == 128, sites


def test_the_narrow_count_counts_the_narrow_packs():
    """``conv2d_int8_wgmma_narrow`` counts a call whose pack has 32 or 64
    columns (here the plain versions, on the CPU), beside the route's own
    count: the published widths' decoder shapes at 8^2, and a wide one."""
    shapes = [(192, 5, 32), (32, 5, 32), (384, 5, 64), (64, 5, 64), (128, 5, 128), (32, 1, 3)]
    reset_counts()
    for cin, k, cout in shapes:
        weight = quant.QWeight(_kernel(cout, cin, k, cin + cout), None)
        x = torch.from_numpy(np.random.default_rng(cin).normal(0, 1, (1, 8, 8, cin))
                             .astype(np.float32)).to(torch.bfloat16)
        quant.conv2d_q(x, weight, None, torch.bfloat16)
    ran = counts()
    assert ran["conv2d_int8_wgmma"] == {"kernel": 0, "plain": 6}
    assert ran["conv2d_int8_wgmma_narrow"] == {"kernel": 0, "plain": 4}


# ---------------------------------------------------------------- the grid's walk


@pytest.mark.parametrize("b,h,w,cin,k,cout,tile_n,blocks", [
    (1, 8, 256, 128, 5, 512, 256, 8),      # one chunk: a work item takes both column tiles
    (1, 16, 128, 256, 5, 1024, 256, 6),    # two chunks, kept: all four column tiles
    (1, 16, 128, 256, 5, 1024, 256, 132),  # too few spatial tiles for 132 blocks: one
    (3, 7, 100, 384, 5, 128, 128, 4),      # three chunks: a column tile an item, ragged
    (1, 5, 70, 192, 5, 32, 32, 7),         # a narrow tile
    (2, 6, 64, 256, 5, 256, 128, 6),       # two lanes of 3 spatial tiles each
    (1, 130, 64, 256, 3, 256, 128, 10),    # a halo-extended height: 65 spatial tiles
    (1, 64, 64, 512, 5, 2048, 256, 132),   # the published 64^2 h-conv: 4 chunks, 8 column tiles
])
def test_kernel_schedule_covers_each_tile_once(b, h, w, cin, k, cout, tile_n, blocks):
    """``kernel_schedule`` (the kernel's ``tile_at`` and ``group_size``,
    walked as its loops walk them): every (lane, column tile, spatial tile)
    is computed once, each column tile's weight stages come in chunk and tap
    order, and a work item keeps one x tile for ``group_size`` column tiles."""
    chunk = conv_int8.kernel_chunk(cin, k, tile_n)
    sched = conv_int8.kernel_schedule(b, h, w, cin, k, cout, tile_n, chunk, blocks)
    rows = 2 * conv_int8.WG_TILE_ROWS[tile_n]
    nx, ny = -(-w // 64), -(-h // rows)
    ntiles = -(-cout // conv_int8.pack_tile_n(cout)) * conv_int8.pack_tile_n(cout) // tile_n
    nchunks = -(-cin // chunk)
    group = conv_int8.group_size(ntiles, nchunks, nx * ny, b, blocks)
    done = {}
    for items in sched:
        for lane, y0, x0, stages in items:
            cols = sorted({c for c, _, _ in stages})
            assert len(cols) == group and cols[0] % group == 0
            for c in cols:
                assert [(ch, tap) for cc, ch, tap in stages if cc == c] == [
                    (ch, tap) for ch in range(nchunks) for tap in range(k * k)]
            assert y0 % rows == 0 and y0 < h and x0 % 64 == 0 and x0 < w
            for c in cols:
                key = (lane, c, y0, x0)
                done[key] = done.get(key, 0) + 1
    want = {(lane, c, y0, x0) for lane in range(b) for c in range(ntiles)
            for y0 in range(0, ny * rows, rows) for x0 in range(0, nx * 64, 64)}
    assert set(done) == want and set(done.values()) == {1}


def test_kernel_schedule_of_single_blocks_is_the_persistent_grid_walk():
    """The blocks, one an SM, walk the persistent grid: block i takes work items i,
    i + blocks, ..., spatial tiles fastest, then column groups, then lanes;
    three chunks take one column tile an item."""
    b, h, w, cin, k, cout, blocks = 2, 12, 150, 384, 5, 256, 7
    sched = conv_int8.kernel_schedule(b, h, w, cin, k, cout, 128, 128, blocks)
    nx, ny = 3, 6
    for block, items in enumerate(sched):
        want = []
        for t in range(block, nx * ny * 2 * b, blocks):
            x0, y0 = t % nx * 64, t // nx % ny * 2
            nt, lane = t // (nx * ny) % 2, t // (nx * ny * 2)
            want.append((lane, y0, x0, nt))
        assert [(lane, y0, x0, stages[0][0]) for lane, y0, x0, stages in items] == want


def test_group_size_keeps_x_for_the_column_tiles_where_every_block_has_work():
    """At the published widths on 132 SMs (B = 1): one- and two-chunk inputs
    keep their x tile for all the column tiles where that still leaves a
    work item for each block (the 256^2 h-conv's four), fewer where it would
    not (the 128^2 h-conv's 128 spatial tiles: two), one at the 64^2
    x-conv's 32 spatial tiles, and always one beyond two chunks."""
    sms = 132
    with open(os.path.join(chip_smoke.HERE, "portbench", "configs", "flagship-int8.json")) as f:
        widths = cell.as_run(json.load(f))
    got = {}
    for site, h, w, k, cin, cout in arith.conv_sites(widths, 512, 512):
        if conv_int8.route(h, w, cin, k, cout) != "wgmma":
            continue
        t = conv_int8.kernel_tile_n(1, h, w, cout, sms)
        rows = 2 * conv_int8.WG_TILE_ROWS[t]
        ntiles = -(-cout // conv_int8.pack_tile_n(cout)) * conv_int8.pack_tile_n(cout) // t
        got[site] = conv_int8.group_size(ntiles, -(-cin // conv_int8.kernel_chunk(cin, k, t)),
                                         -(-w // 64) * -(-h // rows), 1, sms)
    assert got["encoder/0/lstm/0/h"] == 2 and got["encoder/1/lstm/0/x"] == 4
    assert got["encoder/1/lstm/0/h"] == 4
    assert got["encoder/2/lstm/0/x"] == got["encoder/2/lstm/0/h"] == 2
    assert got["encoder/3/lstm/0/x"] == 1 and got["encoder/3/lstm/0/h"] == 1
    assert got["decoder/3/convs/0"] == 1  # cin 1024: eight chunks
    assert conv_int8.group_size(4, 3, 10_000, 1, 132) == 1
    assert conv_int8.group_size(6, 2, 70, 1, 132) == 3  # 70 x 2 items >= 132 blocks


@pytest.mark.parametrize("tile_n,x_bytes,planes,k", [
    (256, 2, 8, 5), (256, 4, 8, 5), (128, 2, 8, 3), (128, 4, 8, 1), (64, 2, 4, 5),
    (32, 2, 2, 5), (8, 4, 2, 1),
])
def test_loaders_stage_each_item_once_from_their_own_slots(tile_n, x_bytes, planes, k):
    """csrc/conv_int8_wgmma.cuh::stage_x in Python: loader li takes the items
    (pixel li // P + m * loaders // P, channel group li % P): every item of
    the halo'd tile once; its raw ring slots (raw_depth of them, each the
    item's 16-byte pieces) are its own, consecutive loaders 16 bytes apart,
    so a warp's 16-byte reads of one piece cover 512 contiguous bytes, and
    the ring holds loaders x raw_depth items."""
    loaders = 96 if tile_n == 256 else 224
    depth = (16 if loaders == 96 else 6) // x_bytes
    pieces = x_bytes  # 16 channels of x in 16-byte pieces
    rows = 2 * conv_int8.WG_TILE_ROWS[tile_n]
    npix = (rows + k - 1) * (64 + k - 1)
    step = loaders // planes
    seen, slots = {}, set()
    for li in range(loaders):
        first = li // planes
        mine = -(-(npix - first) // step) if first < npix else 0
        for m in range(mine):
            item = (first + m * step, li % planes)
            seen[item] = seen.get(item, 0) + 1
        for m in range(depth):
            for q in range(pieces):
                addr = (((m % depth) * pieces + q) * loaders + li) * 16
                assert addr not in slots
                slots.add(addr)
    assert set(seen) == {(p, g) for p in range(npix) for g in range(planes)}
    assert set(seen.values()) == {1}
    assert max(slots) + 16 == loaders * depth * pieces * 16  # the ring's bytes
    for warp in range(loaders // 32):  # one piece of one slot: a warp's 512 bytes
        got = [li * 16 for li in range(32 * warp, 32 * warp + 32)]
        assert got == list(range(got[0], got[0] + 512, 16))


def test_the_epilogues_quad_exchange_stores_each_row_in_column_order():
    """csrc/conv_int8_wgmma.cuh::epilogue_bf16x8 and quad_transpose in Python:
    lane q of a quad holds column pairs 8j + 2q, + 1 of its pixel; after the
    two xor exchanges of each group of 4 j, lane q stores 16 bytes at column
    32 jb + 8q: together the quad writes every column of the 256-column row
    once, in order."""
    tn = 256
    row = np.arange(tn)  # column ids of one pixel's output row
    held = {q: [(row[8 * j + 2 * q], row[8 * j + 2 * q + 1]) for j in range(tn // 8)]
            for q in range(4)}
    out = np.full(tn, -1)
    for jb in range(tn // 32):
        w = {q: [held[q][4 * jb + kk] for kk in range(4)] for q in range(4)}
        for mask in (1, 2):  # send the words whose index bit differs from the lane's
            sent = {q: [w[q][kk] for kk in range(4) if bool(kk & mask) != bool(q & mask)]
                    for q in range(4)}
            for q in range(4):
                idx = [kk for kk in range(4) if bool(kk & mask) != bool(q & mask)]
                for t, kk in enumerate(idx):
                    w[q][kk] = sent[q ^ mask][t]
        for q in range(4):
            start = 32 * jb + 8 * q
            assert np.all(out[start:start + 8] == -1)
            out[start:start + 8] = np.array(w[q]).reshape(-1)
    assert np.array_equal(out, row)


# ---------------------------------------------------------------- the kernel's arithmetic


def _kernel_quantize(x, s, fallback=True):
    """csrc/conv_int8_wgmma.cuh::quantize16 in torch: q = rint(x * fl(1/s)) of
    the exact product (the kernel's FMA with 1.5 * 2^23), rounded half to even
    and clamped to [-127, 127]; each value whose product lies within 2^-14 of
    a half-integer (every value, with a subnormal 1/s) takes the true
    division instead. The float64 product of two f32 values is exact."""
    xf = x.float()
    r = torch.tensor(1.0, dtype=torch.float32) / s
    prod = xf.double() * r.double()
    q = torch.round(prod)
    if fallback:
        near = (prod - q).abs() >= 0.5 - 2.0 ** -14
        if float(r) < 2.0 ** -126:
            near[...] = True
        q = torch.where(near, torch.round(xf / s).double(), q)
    return q.clamp(-127, 127).to(torch.int8)


def _adversarial(s, n=4096, seed=0):
    """Values next to the exact halves (k + 0.5) * s: within a few f32 ulps."""
    r = np.random.default_rng(seed)
    k = r.integers(-127, 128, n).astype(np.float32) + np.float32(0.5)
    v = (k * np.float32(s)).astype(np.float32)
    for _ in range(3):
        step = r.integers(-1, 2, n)
        v = np.where(step > 0, np.nextafter(v, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(v, np.float32(-np.inf)), v))
    return torch.from_numpy(v.astype(np.float32)).reshape(-1, 16)


@pytest.mark.parametrize("s", [0.0123, 3.0 / 127, 1.0 / 127, 0.1, 7.7e-4])
def test_kernel_quantize_equals_the_division(s):
    s_t = torch.tensor(s, dtype=torch.float32)
    r = np.random.default_rng(2)
    rand = torch.from_numpy(r.normal(0, 60 * s, (8192, 16)).astype(np.float32))
    adv = _adversarial(float(s_t))
    for x in (rand, adv, rand.bfloat16()):
        want, _ = quant.quantize_act(x, s_t)
        assert torch.equal(_kernel_quantize(x, s_t), want)
    # without the division fallback the multiply alone misses some of them
    assert not all(torch.equal(_kernel_quantize(adv, torch.tensor(v, dtype=torch.float32),
                                                fallback=False),
                               quant.quantize_act(adv, torch.tensor(v, dtype=torch.float32))[0])
                   for v in (s, float(s_t) * 1.37, float(s_t) * 0.61))


def _emulate_sums(xq, packed, k, tile_n):
    """The s32 sums [B,H,W,N_pad] as the wgmma kernel forms them: per tile
    (b, column tile, 2 * rows rows, 64 pixels) and chunk of the kernel
    (``kernel_chunk`` channels: that many / 16 planes of the pack's stage of
    8) the halo'd x tile as the chunk's planes of [HP*WP, 16]; per tap and
    per warpgroup's row the 64 pixels from (row + ky)*WP + kx of each plane
    against the chunk's planes of the weight stage, read from the pack's
    flat bytes at the kernel's offsets; K in the order wgmma reads it (plane
    pairs of 16 bytes), only the chunk's own planes."""
    b, h, w, cin = xq.shape
    tiles_p, pchunks, _, _, _, pack_tn, _ = packed.shape
    rows = conv_int8.WG_TILE_ROWS[tile_n]
    chunk = conv_int8.kernel_chunk(cin, k, tile_n)
    planes, nchunks, tr = chunk // 16, -(-cin // chunk), 2 * rows
    npad, rad = tiles_p * pack_tn, k // 2
    hp, wp = tr + k - 1, 64 + k - 1
    ny, nx = -(-h // tr), -(-w // 64)
    x = torch.zeros(b, ny * tr + 2 * rad, nx * 64 + 2 * rad, nchunks * chunk, dtype=torch.int64)
    x[:, rad:rad + h, rad:rad + w, :cin] = xq
    flat = packed.reshape(-1).to(torch.int64)
    out = torch.zeros(b, ny * tr, nx * 64, npad, dtype=torch.int64)
    for bi in range(b):
        for nt in range(npad // tile_n):
            col = nt * tile_n
            for y0 in range(0, ny * tr, tr):
                for x0 in range(0, nx * 64, 64):
                    acc = torch.zeros(2, rows, 64, tile_n, dtype=torch.int64)
                    for ch in range(nchunks):
                        cc = ch * chunk
                        t = x[bi, y0:y0 + hp, x0:x0 + wp, cc:cc + chunk]
                        pl = t.reshape(hp * wp, planes, 16).permute(1, 0, 2)
                        for tap in range(k * k):
                            ky, kx = divmod(tap, k)
                            stage = ((col // pack_tn) * pchunks + cc // 128) * k * k + tap
                            first = stage * 8 + (cc % 128) // 16
                            bmat = torch.cat([
                                flat[(first + p) * pack_tn * 16 + (col % pack_tn) * 16:][
                                    :tile_n * 16].reshape(tile_n, 16) for p in range(planes)], 1)
                            for wg in range(2):
                                for m in range(rows):
                                    r = (wg * rows + m + ky) * wp + kx + torch.arange(64)
                                    amat = torch.cat([pl[p, r] for p in range(planes)], 1)
                                    acc[wg, m] += amat @ bmat.T
                    out[bi, y0:y0 + tr, x0:x0 + 64, col:col + tile_n] = acc.reshape(
                        tr, 64, tile_n)
    return out[:, :h, :w]


@pytest.mark.parametrize("b,h,w,cin,k,cout,tile_n", [
    (1, 5, 70, 144, 3, 300, 256),   # ragged frame, two chunks of 128 (the second partial)
    (1, 5, 70, 144, 3, 300, 128),   # 128-column tiles over a 256-column pack
    (2, 3, 9, 16, 5, 40, 64),       # cin 16, one plane of a chunk of 32; cout 40 in 64 columns
    (1, 4, 66, 128, 1, 3, 8),       # the head: 1x1, N padded to 8
    (1, 5, 70, 192, 5, 32, 32),     # decoder/0/convs/0: 32 columns, 8 rows, chunks of 64
    (1, 4, 66, 32, 5, 32, 32),      # decoder/0/convs/1: one chunk of 32
    (1, 3, 70, 384, 5, 64, 64),     # decoder/1/convs/0: 64 columns, 4 rows, full chunks
    (2, 3, 9, 64, 5, 64, 64),       # decoder/1/convs/1: one chunk of 64
    (1, 4, 66, 32, 1, 3, 8),        # the head at cin 32: one k32 product a tap
    (1, 9, 20, 48, 3, 20, 32),      # cin 48: a chunk of 64, its last plane zero
])
def test_tile_emulation_equals_the_exact_sums(b, h, w, cin, k, cout, tile_n):
    r = np.random.default_rng(cin + cout)
    xq = torch.from_numpy(r.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    kq = torch.from_numpy(r.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
    packed = conv_int8.pack_weight_wgmma(kq)
    got = _emulate_sums(xq, packed, k, tile_n)
    want = conv_int8.conv_acc_plain(xq, kq)
    assert torch.equal(got[..., :cout], want.to(torch.int64))
    assert not got[..., cout:].any()


# ---------------------------------------------------------------- against the reference


def _jdt(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


def _edge_input(edge, shape, r):
    """x (f32 numpy) and a static absmax for each edge case."""
    x = r.normal(0, 1.0, shape).astype(np.float32)
    if edge == "halves":  # max|x| = 127/8: s = 1/8 exactly, x / s = k + 0.5
        x = ((r.integers(-127, 127, shape) + 0.5) / 8).astype(np.float32)
        x.flat[0] = 127 / 8
        return x, 127 / 8
    if edge == "clamp":  # a static scale below max|x|: the clamp engages
        return x * 4, 1.5
    if edge == "zeros":  # max|x| = 0: the 1e-8 floor
        return np.zeros(shape, np.float32), 0.0
    if edge == "negzero":
        x[..., ::3] = -0.0
        return x, 2.0
    return x, 2.5


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("in_dt,out_dt", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("edge", ["random", "halves", "clamp", "zeros", "negzero"])
def test_wgmma_plain_equals_reference_conv2d_q(edge, in_dt, out_dt, scale):
    r = np.random.default_rng(9)
    x, absmax = _edge_input(edge, (1, 6, 9, 32), r)
    kern = r.normal(0, 0.2, (3, 3, 32, 24)).astype(np.float32)
    bias = r.normal(0, 0.5, (24,)).astype(np.float32)
    qk, sk = jq.quantize_weight(jnp.asarray(kern))
    qd = {"kernel_q": qk, "w_scale": sk, "bias": jnp.asarray(bias)}
    static = quant._scale_of({"s": absmax}, "s") if scale == "static" else None
    if static is not None:
        qd["x_scale"] = jq._scale_of({"s": absmax}, "s")
    xj = jnp.asarray(x).astype(_jdt(in_dt))
    want = np.asarray(jq.conv2d_q(xj, qd, out_dtype=_jdt(out_dt)).astype(jnp.float32))
    weight = quant.QWeight(torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1))),
                           torch.from_numpy(bias))
    assert weight.route == "wgmma"  # cin 32
    xt = torch.from_numpy(x).to(in_dt)
    reset_counts()
    got = conv_int8.conv2d_int8_wgmma(xt, static, weight.packed, weight.w_scale, weight.bias,
                                      3, out_dt)
    assert counts()["conv2d_int8_wgmma"] == {"kernel": 0, "plain": 1}
    assert got.dtype == out_dt
    np.testing.assert_array_equal(got.float().numpy(), want)
    # conv2d_q takes the same route and gives the same bits
    assert torch.equal(quant.conv2d_q(xt, weight, static, out_dt), got)
    if edge == "clamp" and scale == "static":
        assert int(quant.quantize_act(xt, static)[0].abs().max()) == 127


def test_wgmma_wrapper_checks():
    kq = torch.randint(-127, 128, (24, 32, 3, 3), dtype=torch.int32).to(torch.int8)
    packed = conv_int8.pack_weight_wgmma(kq)
    x = torch.zeros(1, 4, 4, 32)
    ws = torch.ones(24)
    with pytest.raises(ValueError, match="pack"):
        conv_int8.conv2d_int8_wgmma(x, None, packed[:, :, :1], ws, None, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_int8.conv2d_int8_wgmma(x.to(torch.int8), None, packed, ws, None, 3)
    with pytest.raises(ValueError, match="Cin % 16"):
        conv_int8.conv2d_int8_wgmma(x[..., :24], None, packed, ws, None, 3)
    with pytest.raises(TypeError, match="scale"):
        conv_int8.conv2d_int8_wgmma(x, torch.tensor(1.0).double(), packed, ws, None, 3)
    with pytest.raises(ValueError, match="device"):
        conv_int8.conv2d_int8_wgmma(x.to("meta"), None, packed, ws, None, 3)
    with pytest.raises(ValueError, match="wgmma route"):
        conv_int8.pack_weight_wgmma(kq[:, :24])
