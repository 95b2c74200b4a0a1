"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips where no GPU is present (decided
when the test runs). This file imports neither JAX nor the reference, so it
runs on a machine with only PyTorch; ``tests/conftest.py`` imports JAX, so
skip it there:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: K1 and K2 1e-6 in f32 and one bf16 ulp of output rounding in
bf16; K4 2e-5 in f32 (the reference's fused-vs-XLA bound) and one bf16 ulp;
K4's tensor-core routes (bf16, and f32 as 3xTF32: f32 sums in another
order than cuDNN's) 2e-5 with f32 state and 1e-5 plus one bf16 ulp with bf16 state, up
to K*K*F = 3200 summed products (flagship level 0), scaled linearly with
the summation length above that (a sum's worst-case rounding error grows
with its length: x4 at level 3's 12800); K3 (both routes), the int8 conv (both
routes), the postprocess's loop kernels (round counts too), the 'dist'
split's markers kernel and the postprocess with the instance split equal; the tiny model's grads
with the kernels against the same model with the plain versions 1e-5
relative (deterministic cuDNN, same formulas).
"""

import glob
import os

import numpy as np
import pytest
import torch

from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
from lstm_unet_tpu_torch.config import tiny_net_kernel_params
from lstm_unet_tpu_torch.engine.train import loss_and_grads
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.io.tiff import read_tiff
from lstm_unet_tpu_torch.ops.kernels import ccl, convlstm_cell, counts, lstm_gates, reset_counts

import chip_smoke

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 values (8-bit significand)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain versions' f32 convs must run in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, state_dtype, atol):
    rtol = BF16_ULP if state_dtype == torch.bfloat16 else 0.0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == state_dtype
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("gdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_gate_update_matches_plain(cuda, gdt, sdt, act):
    g = torch.Generator(device=cuda).manual_seed(0)
    gates = (torch.randn(3, 333, 4 * 24, device=cuda, generator=g) * 3).to(gdt)
    c = torch.randn(3, 333, 24, device=cuda, generator=g).to(sdt)
    reset_counts()
    got = lstm_gates.fused_lstm_gate_update(gates, c, act)
    want = lstm_gates.lstm_gate_update_plain(gates, c, act)
    assert counts()["lstm_gate_update"] == {"kernel": 1, "plain": 1}
    _close(got, want, sdt, atol=1e-6)


def test_gate_update_rejects_what_it_cannot_take(cuda):
    gates = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_gates.fused_lstm_gate_update(torch.zeros(16, 8, device=cuda).t(),
                                          torch.zeros(8, 4, device=cuda))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        lstm_gates.fused_lstm_gate_update(gates.half(), torch.zeros(8, 4, device=cuda))


@pytest.mark.parametrize("gdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_gate_bwd_matches_plain(cuda, gdt, sdt, act):
    g = torch.Generator(device=cuda).manual_seed(1)
    gates = torch.randn(3, 333, 4 * 24, device=cuda, generator=g) * 3
    gates[:, :4] = 2.5  # hard_sigmoid's band edges, exactly
    gates[:, 4:8] = -2.5
    gates = gates.to(gdt)
    c, dc_out, dh = (torch.randn(3, 333, 24, device=cuda, generator=g).to(sdt)
                     for _ in range(3))
    reset_counts()
    got = lstm_gates.lstm_gate_update_bwd(gates, c, dc_out, dh, act)
    want = lstm_gates.lstm_gate_update_bwd_plain(gates, c, dc_out, dh, act)
    assert counts()["lstm_gate_update_bwd"] == {"kernel": 1, "plain": 1}
    for a, b, dt in zip(got, want, (gdt, sdt)):
        assert a.dtype == b.dtype == dt
        rtol = BF16_ULP if dt == torch.bfloat16 else 1e-6
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6, rtol=rtol)


def test_grads_on_the_card_equal_the_plain_versions(cuda, monkeypatch):
    """One backward of the tiny model: every parameter gets a nonzero grad
    through K1/K2, equal to the grads with the plain versions patched in."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()),
                       generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    state = [[(torch.rand(h.shape, device=cuda, generator=g) - 0.5,
               torch.randn(c.shape, device=cuda, generator=g)) for (h, c) in lvl]
             for lvl in model.init_state(2, 32, 32)]
    img = torch.rand(2, 3, 32, 32, 1, device=cuda, generator=g)
    seg = torch.randint(0, 3, (2, 3, 32, 32), device=cuda, generator=g)
    ones = torch.ones(2, 3, device=cuda)
    reset_counts()
    loss_k, _, _, grads_k = loss_and_grads(model, state, img, seg, ones, ones,
                                           (0.15, 0.25, 0.6), remat=True)
    ran = counts()
    assert ran["lstm_gate_update"]["kernel"] > 0 and ran["lstm_gate_update_bwd"]["kernel"] > 0
    assert all(v["plain"] == 0 for v in ran.values())
    monkeypatch.setattr(lstm_gates, "fused_lstm_gate_update", lstm_gates.lstm_gate_update_plain)
    monkeypatch.setattr(lstm_gates, "lstm_gate_update_bwd",
                        lstm_gates.lstm_gate_update_bwd_plain)
    loss_p, _, _, grads_p = loss_and_grads(model, state, img, seg, ones, ones,
                                           (0.15, 0.25, 0.6), remat=True)
    assert counts()["lstm_gate_update_bwd"]["plain"] > 0
    torch.testing.assert_close(loss_k, loss_p, atol=0, rtol=1e-6)
    assert sorted(grads_k) == sorted(dict(model.named_parameters()))
    for name, gk in grads_k.items():
        scale = float(grads_p[name].abs().max())
        assert float(gk.abs().max()) > 0, name
        torch.testing.assert_close(gk, grads_p[name], atol=1e-5 * scale, rtol=0, msg=name)


@pytest.mark.parametrize("remat,fwd_per_layer_frame", [(False, 1), ("full", 2),
                                                     ("save_outputs", 2)])
def test_remat_policies_on_the_card(cuda, monkeypatch, remat, fwd_per_layer_frame):
    """Each remat policy's K1/K2 launches (the recompute runs K1 again) and
    grads equal to full remat's on the card (1e-5 of each leaf's largest)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    nkp = tiny_net_kernel_params()
    model = ULSTMnet2D(ModelConfig.make(nkp),
                       generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    state = [[(torch.rand(h.shape, device=cuda, generator=g) - 0.5,
               torch.randn(c.shape, device=cuda, generator=g)) for (h, c) in lvl]
             for lvl in model.init_state(2, 32, 32)]
    img = torch.rand(2, 3, 32, 32, 1, device=cuda, generator=g)
    seg = torch.randint(0, 3, (2, 3, 32, 32), device=cuda, generator=g)
    ones = torch.ones(2, 3, device=cuda)
    cw = (0.15, 0.25, 0.6)
    layer_frames = 3 * sum(len(level) for level in nkp.lstm_kernels)
    reset_counts()
    loss, _, _, grads = loss_and_grads(model, state, img, seg, ones, ones, cw, remat=remat)
    ran = counts()
    assert ran["lstm_gate_update"] == {"kernel": fwd_per_layer_frame * layer_frames,
                                       "plain": 0}
    assert ran["lstm_gate_update_bwd"] == {"kernel": layer_frames, "plain": 0}
    loss_f, _, _, grads_f = loss_and_grads(model, state, img, seg, ones, ones, cw,
                                           remat="full")
    torch.testing.assert_close(loss, loss_f, atol=0, rtol=1e-6)
    for name, gf in grads_f.items():
        scale = float(gf.abs().max())
        torch.testing.assert_close(grads[name], gf, atol=1e-5 * scale, rtol=0, msg=name)


def test_fused_level_refuses_grad_on_the_card(cuda):
    gx, h, c, wh = _level(cuda, 1, 8, 8, 8, 3, torch.float32, torch.float32)
    wh.requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        convlstm_cell.fused_convlstm_level(gx, h, c, wh)


def _level(cuda, b, h, w, feat, k, dt, sdt, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lim = (6.0 / (k * k * 5 * feat)) ** 0.5
    return ((torch.randn(b, h, w, 4 * feat, device=cuda, generator=g) * 0.5).to(dt),
            (torch.rand(b, h, w, feat, device=cuda, generator=g) * 2 - 1).to(sdt),
            torch.randn(b, h, w, feat, device=cuda, generator=g).to(sdt),
            ((torch.rand(k, k, feat, 4 * feat, device=cuda, generator=g) * 2 - 1)
             * lim).to(dt))


@pytest.mark.parametrize("b,h,w,feat,k,dt,sdt", [
    (2, 32, 32, 8, 3, torch.float32, torch.float32),      # tiny level 0
    (1, 16, 16, 16, 3, torch.float32, torch.float32),     # tiny level 1
    (1, 20, 36, 128, 5, torch.float32, torch.float32),    # flagship level 0 width
    (1, 19, 37, 40, 5, torch.float32, torch.float32),     # ragged tiles and slices
    (1, 24, 40, 128, 5, torch.bfloat16, torch.bfloat16),
    (1, 24, 40, 128, 5, torch.bfloat16, torch.float32),   # state_dtype float32
    (3, 8, 8, 8, 1, torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_fused_level_matches_plain(cuda, b, h, w, feat, k, dt, sdt, act):
    """Each case on the route that takes it (F % 64 == 0 at 5x5: tensor
    cores, bf16 or 3xTF32; F % 8 == 0 otherwise: the narrow route), counted
    there."""
    ins = _level(cuda, b, h, w, feat, k, dt, sdt)
    assert convlstm_cell.supported(h, w, feat, k, k, b, dt)
    which = convlstm_cell.route(h, w, feat, k, b, dt)
    name = {"wgmma": "fused_convlstm_level_wgmma", "tf32x3": "fused_convlstm_level_tf32x3",
            "narrow": "fused_convlstm_level_narrow"}[which]
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*ins, act)
    want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
    assert counts()[name] == {"kernel": 1, "plain": 1}
    _close(got, want, sdt, atol=2e-5)


def test_wgmma_level_smem_and_route_match_the_kernel(cuda):
    """The tensor-core kernel's shared memory is the Python formula's and
    fits a block; the route sends it exactly the kernel sizes it builds."""
    from lstm_unet_tpu_torch.ops.kernels import _build

    lib = _build.library()
    for k in convlstm_cell.NARROW_KERNEL_SIZES:
        got = lib.lut_convlstm_level_wgmma_smem(k)
        if k in convlstm_cell.TC_KERNEL_SIZES:
            assert got == convlstm_cell.wgmma_smem_bytes(k) <= convlstm_cell.SMEM_LIMIT
        else:
            assert got == 0
            assert convlstm_cell.route(64, 64, 128, k, 1, torch.bfloat16) != "wgmma"


def _tc_close(got, want, sdt, k, feat):
    scale = max(1.0, k * k * feat / 3200)  # summation length over flagship level 0's
    _close(got, want, sdt, atol=(2e-5 if sdt == torch.float32 else 1e-5) * scale)


@pytest.mark.parametrize("b,h,w,feat,k,sdt", [
    (1, 12, 64, 128, 5, torch.bfloat16),    # flagship level 0 width
    (1, 12, 64, 128, 5, torch.float32),
    (1, 8, 128, 256, 5, torch.bfloat16),    # levels 1-2 width
    (1, 8, 128, 256, 5, torch.float32),
    (1, 8, 64, 512, 5, torch.bfloat16),     # level 3 width
    (1, 8, 64, 512, 5, torch.float32),
    (2, 9, 70, 128, 5, torch.bfloat16),     # ragged rows and columns, B = 2
    (2, 9, 70, 128, 5, torch.float32),
    (3, 5, 3, 192, 3, torch.bfloat16),      # narrower than a tile, 3x3
    (1, 7, 66, 64, 1, torch.float32),       # 1x1
])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_wgmma_level_matches_plain(cuda, b, h, w, feat, k, sdt, act):
    ins = _level(cuda, b, h, w, feat, k, torch.bfloat16, sdt)
    assert convlstm_cell.route(h, w, feat, k, b, torch.bfloat16) == "wgmma"
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*ins, act)
    want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
    ran = counts()
    assert ran["fused_convlstm_level_wgmma"] == {"kernel": 1, "plain": 1}
    _tc_close(got, want, sdt, k, feat)


def test_wgmma_level_takes_the_cells_weight_view(cuda):
    """The cell passes kernel_h as a permuted view; the pack takes it as is."""
    gx, h, c, wh = _level(cuda, 1, 6, 64, 64, 5, torch.bfloat16, torch.bfloat16)
    view = wh.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert not view.is_contiguous()
    got = convlstm_cell.fused_convlstm_level(gx, h, c, view)
    want = convlstm_cell.fused_convlstm_level(gx, h, c, wh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tf32x3_level_smem_and_route_match_the_kernel(cuda):
    """The 3xTF32 kernel's shared memory is the Python formula's and fits a
    block; the route sends it f32 levels of exactly the kernel sizes it
    builds."""
    from lstm_unet_tpu_torch.ops.kernels import _build

    lib = _build.library()
    for k in convlstm_cell.NARROW_KERNEL_SIZES:
        got = lib.lut_convlstm_level_tf32x3_smem(k)
        if k in convlstm_cell.TC_KERNEL_SIZES:
            assert got == convlstm_cell.tf32x3_smem_bytes(k) <= convlstm_cell.SMEM_LIMIT
            assert convlstm_cell.route(64, 64, 128, k, 1, torch.float32) == "tf32x3"
        else:
            assert got == 0
            assert convlstm_cell.route(64, 64, 128, k, 1, torch.float32) != "tf32x3"


@pytest.mark.parametrize("b,h,w,feat,k,sdt", [
    (1, 12, 64, 128, 5, torch.float32),     # flagship level 0 width
    (1, 8, 128, 256, 5, torch.float32),     # levels 1-2 width
    (1, 8, 64, 512, 5, torch.float32),      # level 3 width
    (2, 9, 70, 128, 5, torch.float32),      # ragged rows and columns, B = 2
    (2, 9, 70, 128, 5, torch.bfloat16),     # bf16 state
    (3, 5, 3, 192, 3, torch.float32),       # narrower than a tile, 3x3
    (1, 7, 66, 64, 1, torch.float32),       # 1x1
])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_tf32x3_level_matches_plain(cuda, b, h, w, feat, k, sdt, act):
    """f32 compute on the tensor cores as 3xTF32, within K4's f32 tolerance
    (not TF32's): the kernel launches once, the plain version once (called
    here), no other route."""
    ins = _level(cuda, b, h, w, feat, k, torch.float32, sdt)
    assert convlstm_cell.route(h, w, feat, k, b, torch.float32) == "tf32x3"
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*ins, act)
    assert counts()["fused_convlstm_level_tf32x3"] == {"kernel": 1, "plain": 0}
    want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
    ran = counts()
    assert ran["fused_convlstm_level_tf32x3"] == {"kernel": 1, "plain": 1}
    assert ran["fused_convlstm_level_wgmma"] == {"kernel": 0, "plain": 0}
    _tc_close(got, want, sdt, k, feat)


def test_narrow_level_smem_matches_the_kernel(cuda):
    from lstm_unet_tpu_torch.ops.kernels import _build

    lib = _build.library()
    for k in convlstm_cell.NARROW_KERNEL_SIZES:
        for t in convlstm_cell.NARROW_FEATS:
            for dt in (torch.bfloat16, torch.float32):
                assert (lib.lut_convlstm_level_narrow_smem(k, t, _build.DTYPES[dt])
                        == convlstm_cell.narrow_smem_bytes(k, t, dt) <= convlstm_cell.SMEM_LIMIT)
    assert lib.lut_convlstm_level_narrow_smem(9, 8, 1) == 0


@pytest.mark.parametrize("b,h,w,feat,k", [
    (2, 32, 32, 8, 3),      # tiny level 0: 8-feature tiles, half a bf16 chunk
    (1, 16, 16, 16, 3),     # tiny level 1: 16-feature tiles
    (2, 9, 70, 24, 5),      # 8-feature tiles x 3, a ragged bf16 chunk, ragged frame
    (1, 12, 64, 32, 5),     # 32-feature tiles (setmaxnreg)
    (1, 6, 130, 96, 5),     # 3 column tiles, 6 / 12 chunks
    (1, 10, 66, 64, 7),     # 7x7: a 2-stage ring in 3xTF32
    (3, 5, 3, 16, 1),       # 1x1, narrower than a tile
])
@pytest.mark.parametrize("dt,sdt", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_narrow_level_matches_plain(cuda, b, h, w, feat, k, dt, sdt):
    """The narrow route (bf16, or f32 as 3xTF32) against the plain version,
    to K4's tolerances, both activations; counted there and nowhere else; the
    pack handed in by a caller gives the same bits as the wrapper's own."""
    ins = _level(cuda, b, h, w, feat, k, dt, sdt)
    assert convlstm_cell.route(h, w, feat, k, b, dt) == "narrow"
    for act in ("sigmoid", "hard_sigmoid"):
        reset_counts()
        got = convlstm_cell.fused_convlstm_level(*ins, act)
        want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
        ran = counts()
        assert ran["fused_convlstm_level_narrow"] == {"kernel": 1, "plain": 1}
        assert all(ran[n] == {"kernel": 0, "plain": 0} for n in (
            "fused_convlstm_level_wgmma", "fused_convlstm_level_tf32x3"))
        _tc_close(got, want, sdt, k, feat)
    packed = convlstm_cell.pack_for_route(ins[3], "narrow")
    kept = convlstm_cell.fused_convlstm_level(*ins, "sigmoid", packed)
    for a_, b_ in zip(kept, convlstm_cell.fused_convlstm_level(*ins)):
        assert torch.equal(a_, b_)


def test_tf32x3_level_takes_the_cells_weight_view(cuda):
    gx, h, c, wh = _level(cuda, 1, 6, 64, 64, 5, torch.float32, torch.float32)
    view = wh.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert not view.is_contiguous()
    got = convlstm_cell.fused_convlstm_level(gx, h, c, view)
    want = convlstm_cell.fused_convlstm_level(gx, h, c, wh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_level_rejects_unsupported_shapes(cuda):
    # F % 8 != 0: no route
    ins = _level(cuda, 1, 8, 8, 204, 5, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="supported"):
        convlstm_cell.fused_convlstm_level(*ins)
    ins = _level(cuda, 1, 8, 8, 8, 9, torch.bfloat16, torch.bfloat16)  # 9x9: no route
    with pytest.raises(ValueError, match="supported"):
        convlstm_cell.fused_convlstm_level(*ins)


def _masks():
    r = np.random.default_rng(4)
    isolated = np.zeros((64, 96), bool)
    isolated[::2, ::2] = True
    cell = synthetic.cell_like_probs(256, 256, num_cells=80, seed=2)[0][..., 1] > 0.5
    return [r.random((512, 512)) < 0.5, r.random((333, 517)) < 0.6,
            r.random((1, 100)) < 0.5, r.random((100, 1)) < 0.5,
            np.zeros((40, 40), bool), np.ones((70, 65), bool),
            synthetic.spiral_mask(96), synthetic.dense_components_mask(256, 256),
            isolated, r.random((512, 500)) < 0.5, r.random((5, 7)) < 0.5, cell,
            np.fliplr(np.eye(64, dtype=bool)).copy()]


@pytest.mark.parametrize("which", ["cluster", "grid"])
@pytest.mark.parametrize("case", range(13))
def test_ccl_equals_plain(cuda, case, which):
    """Both K3 routes, each one launch, bit-identical to the plain version."""
    mask = torch.from_numpy(_masks()[case]).to(cuda)
    reset_counts()
    got = ccl.launch(mask, which)
    ran = counts()
    assert ran["ccl" if which == "cluster" else "ccl_grid"] == {"kernel": 1, "plain": 0}
    assert ran["ccl_grid" if which == "cluster" else "ccl"] == {"kernel": 0, "plain": 0}
    assert torch.equal(got, ccl.connected_components_plain(mask))


def test_ccl_routes_by_shape(cuda):
    """The wrapper takes the cluster route where the frame fits a cluster's
    shared memory (the kernel's own formula) and the grid route elsewhere; a
    mask that is no aligned whole words takes the byte-wise read."""
    from lstm_unet_tpu_torch.ops.kernels import _build

    lib = _build.library()
    for hw in ((512, 512), (333, 517), (1, 7), (640, 640), (1024, 1024)):
        assert lib.lut_ccl_cluster_smem(*hw) == ccl.cluster_smem_bytes(*hw)
    r = np.random.default_rng(5)
    for (h, w), name in (((512, 512), "ccl"), ((640, 640), "ccl"), ((672, 672), "ccl_grid"),
                         ((1024, 1024), "ccl_grid")):
        mask = torch.from_numpy(r.random((h, w)) < 0.5).to(cuda)
        reset_counts()
        got = ccl.connected_components(mask)
        assert counts()[name] == {"kernel": 1, "plain": 0}
        assert torch.equal(got, ccl.connected_components_plain(mask))
    with pytest.raises(ValueError, match="cluster"):
        ccl.launch(torch.zeros(1024, 1024, dtype=torch.bool, device=cuda), "cluster")
    buf = torch.from_numpy(r.random(1 + 64 * 64) < 0.5).to(cuda)
    view = buf[1:].view(64, 64)  # contiguous, off the 16-byte alignment
    assert torch.equal(ccl.connected_components(view), ccl.connected_components_plain(view))
    as_bytes = (torch.from_numpy(r.integers(0, 3, (64, 64))).to(cuda) * 100).to(torch.uint8)
    assert torch.equal(ccl.connected_components(as_bytes),
                       ccl.connected_components_plain(as_bytes))


@pytest.mark.parametrize("kw,k3", [
    (dict(), 1),
    (dict(instance_split=True, split_method="dist"), 2),
    (dict(instance_split=True, split_method="prob"), 2),
    (dict(instance_split=True, split_method="prob", split_min_size=300, size_filter="post",
          fov=8), 2),
])
def test_postprocess_with_split_on_the_card_equals_cpu(cuda, kw, k3):
    """postprocess_frame on cell-like probabilities: the card (K3 once, twice
    with the split, the markers kernel once with 'dist', no plain version) and
    the CPU give equal labels."""
    from lstm_unet_tpu_torch.ops.postprocess import postprocess_frame

    probs = torch.from_numpy(synthetic.cell_like_probs(256, 320, num_cells=100, seed=4)[0])
    reset_counts()
    got = postprocess_frame(probs.to(cuda), **kw)
    ran = counts()
    assert ran["ccl"]["kernel"] == k3 and all(v["plain"] == 0 for v in ran.values())
    assert ran["split_markers"]["kernel"] == int(kw.get("split_method") == "dist")
    want = postprocess_frame(probs, **kw)
    assert int(want.max()) > 20 and torch.equal(got.cpu(), want)


def test_golden_masks_on_the_card(cuda, tmp_path):
    """The cross-backend bar: equal instance count, <= 3 px per frame."""
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), num_frames=8,
                                             height=32, width=32, num_cells=3, seed=123)
    out = str(tmp_path / "res")
    reset_counts()
    n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                  "--sequence_path", seq_dir, "--output_path", out,
                  "--pre_sequence_frames", "2", "--min_cell_size", "5",
                  "--dtype", "float32"])
    ran = counts()
    assert all(v["plain"] == 0 for v in ran.values())
    assert ran["ccl"]["kernel"] == 10 and ran["lstm_gate_update"]["kernel"] == 20
    golden = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    assert n == len(golden) == 8
    for p in golden:
        want = read_tiff(p)
        got = read_tiff(os.path.join(out, os.path.basename(p)))
        assert len(np.unique(got)) == len(np.unique(want))
        assert int((got != want).sum()) <= 3


def test_golden_masks_fused_f32_on_the_card(cuda, tmp_path):
    """With --fused_cell in f32 the tiny model's narrow levels (F = 8, 16)
    take K4's narrow route (3xTF32) on every frame, K1 never; the masks hold
    the golden bar."""
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), num_frames=8,
                                             height=32, width=32, num_cells=3, seed=123)
    out = str(tmp_path / "res")
    reset_counts()
    n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                  "--sequence_path", seq_dir, "--output_path", out,
                  "--pre_sequence_frames", "2", "--min_cell_size", "5",
                  "--dtype", "float32", "--fused_cell"])
    ran = counts()
    assert all(v["plain"] == 0 for v in ran.values())
    assert ran["fused_convlstm_level_narrow"]["kernel"] == 20
    assert ran["lstm_gate_update"]["kernel"] == 0
    golden = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    assert n == len(golden) == 8
    for p in golden:
        want = read_tiff(p)
        got = read_tiff(os.path.join(out, os.path.basename(p)))
        assert len(np.unique(got)) == len(np.unique(want))
        assert int((got != want).sum()) <= 3


# ---------------------------------------------------------------- int8 conv


@pytest.mark.parametrize("b,h,w,cin,k,cout", [
    (1, 64, 64, 1, 5, 512),     # level 0 x-conv: cin = 1, the byte gather
    (1, 32, 48, 128, 5, 512),   # an h-conv, 16-byte chunks
    (2, 17, 23, 24, 3, 8),      # ragged frame, cin 24 (tiny decoder), cout 8
    (1, 16, 16, 1024, 3, 512),  # cin 1024 (decoder level 3's first conv)
    (1, 40, 40, 128, 1, 3),     # the 1x1 head: cout 3, odd
])
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_int8_equals_plain(cuda, b, h, w, cin, k, cout, bias):
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    xq = torch.randint(-127, 128, (b, h, w, cin), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    kq = torch.randint(-127, 128, (cout, cin, k, k), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    args = (xq, torch.tensor(0.02, device=cuda), conv_int8.pack_weight(kq),
            torch.rand(cout, device=cuda, generator=g) * 1e-3,
            torch.randn(cout, device=cuda, generator=g) if bias else None, k, k)
    for dt in (torch.float32, torch.bfloat16):
        got = conv_int8.conv2d_int8(*args, dt)
        want = conv_int8.conv2d_int8_plain(*args, dt)
        assert got.dtype == dt and torch.equal(got, want)  # exact sums, same epilogue


@pytest.mark.parametrize("b,h,w,cin,k,cout", [
    (2, 17, 70, 16, 3, 40),      # ragged frame (W > 64, odd H), cin 16, N tile 64
    (1, 32, 48, 128, 5, 512),    # an h-conv: N tile 256
    (1, 16, 16, 1024, 3, 512),   # cin 1024, 8 chunks; 128-column tiles (few tiles)
    (1, 24, 40, 384, 3, 128),    # cout 128: N tile 128, three chunks
    (1, 40, 40, 128, 1, 3),      # the 1x1 head: N padded to 8
    # the published widths' narrow sites at their sizes: decoder/0/convs/0
    # (32 columns, 8 rows, chunks of 64), /1 (a chunk of 32), decoder/1/convs/0
    # (64 columns, 4 rows, full chunks), /1 (a chunk of 64), the head (cin 32)
    (1, 512, 512, 192, 5, 32),
    (1, 512, 512, 32, 5, 32),
    (1, 256, 256, 384, 5, 64),
    (1, 256, 256, 64, 5, 64),
    (1, 512, 512, 32, 1, 3),
    (2, 37, 100, 192, 5, 32),    # ragged: a partial tile of 8 rows and of 64 pixels
    (1, 13, 70, 48, 3, 20),      # cin 48: a chunk of 64 half zero-filled
])
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_int8_wgmma_equals_plain(cuda, b, h, w, cin, k, cout, bias):
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    kq = torch.randint(-127, 128, (cout, cin, k, k), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    packed = conv_int8.pack_weight_wgmma(kq)
    w_scale = torch.rand(cout, device=cuda, generator=g) * 1e-3
    bias_t = torch.randn(cout, device=cuda, generator=g) if bias else None
    x32 = torch.randn(b, h, w, cin, device=cuda, generator=g) * 3
    x32[0, 0, 0, :4] = torch.tensor([0.0, -0.0, 1.5, -2.5])
    for xdt in (torch.bfloat16, torch.float32):
        x = x32.to(xdt)
        for scale in (None, torch.tensor(2.5 / 127, device=cuda)):  # dynamic, static (clamps)
            for dt in (torch.float32, torch.bfloat16):
                args = (x, scale, packed, w_scale, bias_t, k, dt)
                got = conv_int8.conv2d_int8_wgmma(*args)
                want = conv_int8.conv2d_int8_wgmma_plain(*args)
                assert got.dtype == dt and torch.equal(got, want), (xdt, scale, dt)
        if conv_int8.pack_tile_n(cout) == 256:  # both N tiles over the same pack
            for tn in (256, 128):
                got = conv_int8.conv2d_int8_wgmma(x, None, packed, w_scale, bias_t, k,
                                                  torch.bfloat16, tile_n=tn)
                want = conv_int8.conv2d_int8_wgmma_plain(x, None, packed, w_scale, bias_t, k,
                                                         torch.bfloat16)
                assert torch.equal(got, want), tn


def test_conv2d_int8_wgmma_smem_formula_matches_the_kernel(cuda):
    from lstm_unet_tpu_torch.ops.kernels import _build, conv_int8

    lib = _build.library()
    for k in conv_int8.WG_KERNEL_SIZES:
        for tn in conv_int8.WG_TILE_ROWS:
            for xb in (2, 4):
                for chunk in conv_int8.WG_TILE_CHUNKS[tn]:
                    assert (lib.lut_conv2d_int8_wgmma_smem(k, tn, chunk, xb)
                            == conv_int8.wgmma_smem_bytes(k, tn, xb, chunk))
    assert lib.lut_conv2d_int8_wgmma_smem(5, 32, 128, 2) == 0  # not compiled: does not fit


# the published widths' wide int8 sites (N tiles of 256 and 128, chunks of
# 128), by shape: (H = W, cin, K, cout)
PUBLISHED_WIDE = list(chip_smoke.published_wide_shapes())


def _wide_site(cuda, hw, cin, k, cout):
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(cin + cout + hw)
    kq = torch.randint(-127, 128, (cout, cin, k, k), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    w_scale = torch.rand(cout, device=cuda, generator=g) * 1e-3
    bias = torch.randn(cout, device=cuda, generator=g)
    return g, conv_int8.pack_weight_wgmma(kq), w_scale, bias


@pytest.mark.parametrize("hw,cin,k,cout", PUBLISHED_WIDE)
def test_published_wide_sites_equal_plain(cuda, hw, cin, k, cout):
    """Each wide site of the published net at its frame size: the route is
    bit-equal to the plain version at B = 1 (bf16 and f32 x, dynamic and
    static scale, f32 and bf16 out) and at B = 4 (bf16 x dynamic -> bf16,
    f32 x static -> f32), and at 256-column packs both N tiles give the
    same outputs."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g, packed, w_scale, bias = _wide_site(cuda, hw, cin, k, cout)
    for b in (1, 4):
        x32 = torch.randn(b, hw, hw, cin, device=cuda, generator=g) * 2
        static = torch.tensor(2.5 / 127, device=cuda)
        cases = [(xdt, sc, dt) for xdt in (torch.bfloat16, torch.float32)
                 for sc in (None, static) for dt in (torch.float32, torch.bfloat16)]
        if b == 4:
            cases = [(torch.bfloat16, None, torch.bfloat16), (torch.float32, static, torch.float32)]
        for xdt, sc, dt in cases:
            args = (x32.to(xdt), sc, packed, w_scale, bias, k, dt)
            assert torch.equal(conv_int8.conv2d_int8_wgmma(*args),
                               conv_int8.conv2d_int8_wgmma_plain(*args)), (b, xdt, sc, dt)
        args = (x32.to(torch.bfloat16), static, packed, w_scale, bias, k)
        want = conv_int8.conv2d_int8_wgmma(*args, torch.bfloat16)
        if conv_int8.pack_tile_n(cout) == 256:
            for tn in (256, 128):
                assert torch.equal(conv_int8.conv2d_int8_wgmma(*args, torch.bfloat16, tile_n=tn),
                                   want), (b, tn)


@pytest.mark.parametrize("b,h,w,cin,k,cout", [
    (1, 130, 64, 256, 5, 1024),  # 65 spatial tiles
    (1, 66, 64, 512, 5, 2048),   # a halo-extended 64^2 level (33 tiles)
    (2, 6, 64, 256, 5, 256),     # 3 tiles a lane, two column tiles over a 256 pack
    (3, 7, 100, 384, 3, 128),    # ragged, 4 tiles a lane, three chunks, 3x3
    (1, 3, 40, 128, 1, 256),     # one tile: a 1x1 conv
])
def test_routes_at_ragged_wide_shapes_equal_plain(cuda, b, h, w, cin, k, cout):
    """Row and column counts that leave a lane an odd number of spatial
    tiles, and frames narrower than a tile's 64 pixels: the route (each of
    the pack's N tiles, with and without bias, dynamic and static scale,
    f32 and bf16 out) is bit-equal to the plain version."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g, packed, w_scale, bias = _wide_site(cuda, h, cin, k, cout)
    x = (torch.randn(b, h, w, cin, device=cuda, generator=g) * 2).to(torch.bfloat16)
    static = torch.tensor(2.5 / 127, device=cuda)
    for tn in ((256, 128) if conv_int8.pack_tile_n(cout) == 256 else (128,)):
        for bb in (bias, None):
            for sc in (None, static):
                for dt in (torch.float32, torch.bfloat16):
                    args = (x, sc, packed, w_scale, bb, k, dt)
                    assert torch.equal(conv_int8.conv2d_int8_wgmma(*args, tile_n=tn),
                                       conv_int8.conv2d_int8_wgmma_plain(*args)), (tn, sc, dt)


# the unfused int8 cell's h-conv with the gate epilogue: (B, H, W, F, K); the
# flagship's four levels at B = 1 and 4, a halo-extended 64^2 block, widths
# that are not a multiple of 64 (a 3x3 and a 1x1 cell)
GATE_SHAPES = [(b, hw, hw, f, 5) for b in (1, 4) for hw, f in chip_smoke.FLAGSHIP_LEVELS]
GATE_SHAPES += [(1, 36, 64, 512, 5), (2, 21, 100, 64, 3), (1, 9, 40, 128, 1)]


@pytest.mark.parametrize("b,h,w,feat,k", GATE_SHAPES)
def test_conv2d_int8_wgmma_gates_equals_hconv_add_k1(cuda, b, h, w, feat, k):
    """The gate epilogue bit for bit against what it replaces on the card:
    the wgmma kernel on the natural pack (4F gates in the gate dtype), the
    eager add of gx and K1; both N tiles, the four (gate, state) dtype
    pairs, static and dynamic scales, sigmoid and hard_sigmoid, into new
    tensors and into ``out``, with some pre-activations infinite or beyond
    +-87 (the sigmoid's division on its rare path). And against its plain
    version (the exact sums, the add, K1's plain version) within K1's bound
    against its own plain version: 1e-6, plus one bf16 unit in the last
    place for a bf16 state."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    n = 4 * feat
    g = torch.Generator(device=cuda).manual_seed(b * h + feat)
    kq = torch.randint(-127, 128, (n, feat, k, k), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    w_scale = torch.rand(n, device=cuda, generator=g) * 1e-3 * 25 / (k * k)
    order = conv_int8.gate_order(n, cuda)
    natural = conv_int8.pack_weight_wgmma(kq)
    gpack, gscale = conv_int8.pack_weight_wgmma(kq[order]), w_scale[order]
    h32 = torch.rand(b, h, w, feat, device=cuda, generator=g) * 2 - 1
    c32 = torch.randn(b, h, w, feat, device=cuda, generator=g) * 1.5
    gx32 = torch.randn(b, h, w, n, device=cuda, generator=g) * 2
    # pre-activations far out: the sigmoid's rare path (1 + e^-z >= 2^126, inf)
    gx32[0, 0, 0, :8] = torch.tensor([float("inf"), -float("inf"), 100.0, -100.0, 1e4, -1e4,
                                      88.0, -88.0])
    gx32[0, 0, 1, 3 * feat:3 * feat + 2] = torch.tensor([-float("inf"), -95.0])
    static = torch.tensor(0.9 / 127, device=cuda)
    bf, f32 = torch.bfloat16, torch.float32
    for gdt, sdt in ((bf, bf), (bf, f32), (f32, f32), (f32, bf)):
        hh, c, gx = h32.to(sdt), c32.to(sdt), gx32.to(gdt)
        for sc in (None, static):
            for act in ("sigmoid", "hard_sigmoid"):
                r = conv_int8.conv2d_int8_wgmma(hh, sc, natural, w_scale, None, k, gdt)
                want_c, want_h = lstm_gates.fused_lstm_gate_update(gx + r, c, act)
                for tn in (256, 128):
                    out = (torch.empty_like(c), torch.empty_like(c)) if tn == 128 else None
                    got_h, got_c = conv_int8.conv2d_int8_wgmma_gates(
                        hh, sc, gpack, gscale, gx, c, k, act, out=out, tile_n=tn)
                    assert got_h.dtype == got_c.dtype == sdt
                    assert torch.equal(got_h, want_h), (gdt, sdt, sc, act, tn)
                    assert torch.equal(got_c, want_c), (gdt, sdt, sc, act, tn)
                    if out is not None:
                        assert got_h is out[0] and got_c is out[1]
                plain = conv_int8.conv2d_int8_wgmma_gates_plain(hh, sc, gpack, gscale, gx, c, k,
                                                                act)
                rtol = 2.0 ** -7 if sdt == bf else 1e-6
                for got, want in zip((got_h, got_c), plain):
                    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=rtol)


def test_int8_stream_runs_the_gate_epilogue(cuda, graph_models):
    """Frames of the captured int8 stream (the flagship, unfused, calibrated,
    128^2, replays): a frame launches the int8 h-conv with the gate epilogue
    once a ConvLSTM level (4) among its 24 wgmma convs, and K1 never."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.ops.kernels import graph_counts

    engine = StreamingInferenceEngine(graph_models["int8"], InferenceParams(), cuda)
    frames = synthetic.make_cell_sequence(num_frames=5, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                          num_cells=8, seed=3)[0]
    engine.step_batch_async(frames[0][None])
    torch.cuda.synchronize()
    reset_counts()
    for f in frames[1:]:
        engine.step_batch_async(f[None])
    torch.cuda.synchronize()
    ran = counts()
    assert graph_counts()["replays"] == 4
    assert ran["conv2d_int8_wgmma_gates"] == {"kernel": 16, "plain": 0}, ran
    assert ran["conv2d_int8_wgmma"]["kernel"] == 96, ran
    assert ran["lstm_gate_update"] == {"kernel": 0, "plain": 0}, ran


def test_wide_site_replays_in_a_captured_step(cuda):
    """The route inside ``engine/graph.py::CompiledStep``: a step whose body
    adds the carried state to the frame and runs a published 256 -> 256 5x5
    site on it, captured and replayed over 4 frames, equals the same steps
    run eagerly, bit for bit, with one launch a step."""
    from lstm_unet_tpu_torch.engine.graph import CompiledStep, CudaGraphs
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    hw, cin, k, cout = 128, 256, 5, 256
    g, packed, w_scale, bias = _wide_site(cuda, hw, cin, k, cout)
    frames = [(torch.randn(1, hw, hw, cin, device=cuda, generator=g)).to(torch.bfloat16)
              for _ in range(4)]

    def body(x, src, dst):
        y = conv_int8.conv2d_int8_wgmma(x + src, None, packed, w_scale, bias, k, torch.bfloat16)
        dst.copy_(y)
        return (y,)

    outs = {}
    for mode in ("graph", "eager"):
        sets = [torch.zeros(1, hw, hw, cout, dtype=torch.bfloat16, device=cuda)
                for _ in range(2)]
        step = CompiledStep(sets, CudaGraphs(cuda) if mode == "graph" else None)
        reset_counts()
        outs[mode] = []
        for f in frames:
            step.input(f.shape, f.dtype, cuda).copy_(f)
            outs[mode].append(step.step(body)[0])
        torch.cuda.synchronize()
        assert counts()["conv2d_int8_wgmma"]["kernel"] == 4
    for t, (got, want) in enumerate(zip(outs["graph"], outs["eager"])):
        assert torch.equal(got, want), f"frame {t}"


@pytest.mark.parametrize("b,h,w,cin,kh,kw,cout", [
    (1, 64, 64, 1, 5, 5, 512),     # the flagship's level 0 x-conv, B = 1
    (4, 64, 64, 1, 5, 5, 512),     # and B = 4 (TTA 'flip')
    (2, 17, 70, 1, 5, 5, 512),     # ragged: a partial second tile of a row
    (1, 32, 32, 8, 3, 3, 32),      # the tiny model's cin 8 sites
    (2, 16, 16, 24, 3, 3, 8),      # the tiny decoder's cin 24
    (1, 32, 32, 8, 1, 1, 3),       # the tiny head: rows of 6 / 12 bytes
    (1, 9, 33, 28, 3, 3, 600),     # K at the limit (252 -> 256), 150 KB of weights
    (1, 7, 20, 3, 1, 3, 20),       # non-square
])
def test_conv2d_int8_smallk_equals_plain(cuda, b, h, w, cin, kh, kw, cout):
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    kq = torch.randint(-127, 128, (cout, cin, kh, kw), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    assert conv_int8.weight_route(kq) == "smallk"
    packed = conv_int8.pack_weight_smallk(kq)
    w_scale = torch.rand(cout, device=cuda, generator=g) * 1e-3
    x32 = torch.randn(b, h, w, cin, device=cuda, generator=g) * 3
    x32[0, 0, 0, 0] = -0.0
    for bias in (torch.randn(cout, device=cuda, generator=g), None):
        for xdt in (torch.bfloat16, torch.float32):
            x = x32.to(xdt)
            for scale in (None, torch.tensor(2.5 / 127, device=cuda)):  # dynamic, static
                for dt in (torch.float32, torch.bfloat16):
                    args = (x, scale, packed, w_scale, bias, kh, kw, dt)
                    reset_counts()
                    got = conv_int8.conv2d_int8_smallk(*args)
                    want = conv_int8.conv2d_int8_smallk_plain(*args)
                    assert counts()["conv2d_int8_smallk"] == {"kernel": 1, "plain": 1}
                    assert got.dtype == dt and torch.equal(got, want), (xdt, scale, dt)


def test_conv2d_int8_smallk_smem_formula_matches_the_kernel(cuda):
    from lstm_unet_tpu_torch.ops.kernels import _build, conv_int8

    lib = _build.library()
    for kh, kw, cin, cout in ((5, 5, 1, 512), (3, 3, 8, 32), (3, 3, 24, 8), (1, 1, 8, 3),
                              (3, 3, 28, 600), (1, 3, 3, 20)):
        for ob in (2, 4):
            assert (lib.lut_conv2d_int8_smallk_smem(kh, kw, cin, cout, ob)
                    == conv_int8.smallk_smem_bytes(kh, kw, cin, cout, ob)
                    <= conv_int8.SMEM_LIMIT)
    assert lib.lut_conv2d_int8_smallk_smem(3, 3, 29, 64, 2) == 0  # K 261 -> 288


def test_int8_model_on_the_card_equals_cpu(cuda):
    """A tiny int8 model's logits on the card (both int8 kernels, K1, K4)
    against the CPU's (plain versions): the int8 convs agree bit for bit, the
    gate math's f32 sigmoid / tanh by an ulp, which a bf16 rounding can
    carry. cin 1, 8 and 24 take the small-K kernel, cin 16 and 32 wgmma,
    none the mma_sync kernel."""
    from lstm_unet_tpu_torch.models import quantize_model_int8

    for fused in (False, True):
        cfg = ModelConfig.make(tiny_net_kernel_params(), dtype="bfloat16", quant="int8",
                               fused_cell=fused)
        model = ULSTMnet2D(cfg, generator=torch.Generator().manual_seed(0))
        quantize_model_int8(model, float_dtype=torch.bfloat16)
        frame = torch.rand(1, 32, 32, 1, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            _, want = model.step(model.init_state(1, 32, 32), frame)
            model.to(cuda)
            reset_counts()
            _, got = model.step(model.init_state(1, 32, 32), frame.to(cuda))
        ran = counts()
        assert ran["conv2d_int8_smallk"] == {"kernel": 5 if fused else 6, "plain": 0}
        assert ran["conv2d_int8"] == {"kernel": 0, "plain": 0}
        assert ran["conv2d_int8_wgmma"] == {"kernel": 2 if fused else 3, "plain": 0}
        assert float((got.cpu() - want).abs().max() / want.abs().max()) < 2.0 ** -5


def test_conv2d_int8_wgmma_shares_the_dynamic_scale_over_lanes(cuda):
    """B = 4 lanes of unequal ranges at a shape whose N tile widens with the
    batch (64^2 3x3, 512 -> 512: 128 columns at B = 1, 256 at B = 4): bit-equal
    to the plain version with one abs-max over all lanes, and lane 0 alone
    (its own scale) differs."""
    from lstm_unet_tpu_torch.ops import quant
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(4)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert conv_int8.kernel_tile_n(1, 64, 64, 512, sms) == 128
    assert conv_int8.kernel_tile_n(4, 64, 64, 512, sms) == 256
    weight = quant.QWeight(torch.randn(512, 512, 3, 3, device=cuda, generator=g),
                           torch.randn(512, device=cuda, generator=g))
    x = (torch.randn(4, 64, 64, 512, device=cuda, generator=g)
         * torch.tensor([1.5, 0.5, 3.0, 1.0], device=cuda)[:, None, None, None]
         ).to(torch.bfloat16)
    a = (weight.packed, weight.w_scale, weight.bias, 3, torch.bfloat16)
    got = conv_int8.conv2d_int8_wgmma(x, None, *a)
    assert torch.equal(got, conv_int8.conv2d_int8_wgmma_plain(x, None, *a))
    assert not torch.equal(conv_int8.conv2d_int8_wgmma(x[:1].contiguous(), None, *a), got[:1])


def test_narrow_tiles_count_4_a_frame_at_the_published_widths(cuda, graph_models):
    """A stream of the published-width int8 model (seeded weights, dynamic
    scales) at 128^2: the engine's replayed step launches the 32- and
    64-column tiles 4 times a frame (``decoder/0/convs/{0,1}``,
    ``decoder/1/convs/{0,1}``) among its 24 wgmma convs, and the port's
    default net (``graph_models``' int8 flagship) none."""
    import json

    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.models import quantize_model_int8
    from lstm_unet_tpu_torch.ops.kernels import graph_counts
    from portbench.harness import cell, port

    with open(os.path.join(GOLDEN, "..", "..", "portbench", "configs", "flagship-int8.json")) as f:
        cfg = port.model_config(cell.as_run(json.load(f)))
    published = ULSTMnet2D(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    quantize_model_int8(published, float_dtype=cfg.compute_dtype)
    frames = synthetic.make_cell_sequence(num_frames=5, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                          num_cells=8, seed=5)[0]
    for model, narrow in ((published, 4), (graph_models["int8"], 0)):
        engine = StreamingInferenceEngine(model, InferenceParams(), cuda)
        reset_counts()
        for f in frames:
            engine.step_batch_async(f[None])
        torch.cuda.synchronize()
        ran = counts()
        assert graph_counts() == {"captures": 2, "replays": 4}
        assert ran["conv2d_int8_wgmma"] == {"kernel": 24 * 5, "plain": 0}, ran
        assert ran["conv2d_int8_wgmma_narrow"] == {"kernel": narrow * 5, "plain": 0}, ran


def test_int8_scales_on_the_card_equal_the_cpu(cuda):
    """``max|x| / 127`` formed on the card as on the CPU (one rounding, as the
    reference and the kernels form it) at an abs-max of each of the 128 bf16
    significands: the dynamic activation scale of ``quantize_act``, the
    weights' per-column scales and codes, and the wgmma kernel with a
    dynamic scale bit-equal to its plain version. A division by the Python
    scalar 127 on the card is one ulp off at some of these abs-maxes."""
    from lstm_unet_tpu_torch.ops import quant
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    amax = (torch.arange(128, 256) / 128).to(torch.bfloat16)
    want = amax.float() / 127.0  # the CPU divides
    got = torch.stack([conv_int8.quantize_act(a.reshape(1, 1, 1, 1).to(cuda))[1]
                       for a in amax])
    assert torch.equal(got.cpu(), want)

    g = torch.Generator().manual_seed(8)
    k = (torch.rand(128, 16, 3, 3, generator=g) - 0.5) * amax.float()[:, None, None, None]
    k[:, 0, 0, 0] = amax.float()
    q_cpu, s_cpu = quant.quantize_weight(k)
    q_card, s_card = quant.quantize_weight(k.to(cuda))
    assert torch.equal(s_cpu, want) and torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)

    packed = conv_int8.pack_weight_wgmma(q_card[:16].contiguous())
    x = (torch.rand(1, 8, 8, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
         - 0.5).to(torch.bfloat16)
    for a in amax:
        x[0, 0, 0, 0] = a
        args = (x, None, packed, s_card[:16], None, 3, torch.float32)
        assert torch.equal(conv_int8.conv2d_int8_wgmma(*args),
                           conv_int8.conv2d_int8_wgmma_plain(*args)), float(a)


@pytest.mark.parametrize("flags", [["--tta"], ["--tta", "--tta_mode", "d4"],
                                   ["--reset_on_jump", "0.4"]])
def test_tta_and_reset_on_the_card_equal_cpu(cuda, tmp_path, flags):
    """The golden model in f32 with TTA (4 or 8 lanes a step) or scene-cut
    resets: the same masks on the card as on the CPU, one K1 a level and one
    K3 a step on the card."""
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), num_frames=8, height=32,
                                             width=32, num_cells=3, seed=123)
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = str(tmp_path / device)
        reset_counts()
        n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"), "--sequence_path",
                      seq_dir, "--output_path", outs[device], "--device", device,
                      "--pre_sequence_frames", "2", "--min_cell_size", "5",
                      "--dtype", "float32", *flags])
        if device == "cuda":
            ran = counts()
            assert ran["lstm_gate_update"] == {"kernel": 2 * (n + 2), "plain": 0}
            assert ran["ccl"] == {"kernel": n + 2, "plain": 0}
    for p in sorted(glob.glob(os.path.join(outs["cpu"], "mask*.tif"))):
        np.testing.assert_array_equal(read_tiff(os.path.join(outs["cuda"], os.path.basename(p))),
                                      read_tiff(p))


def test_batched_stream_on_the_card_equals_cpu(cuda, tmp_path):
    """Two golden-recipe sequences of 8 and 6 frames as two lanes: equal
    masks on the card and on the CPU; K3 once a lane a step."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference_batched

    seqs = [synthetic.write_ctc_dataset(str(tmp_path / "ctc"), seq=s, num_frames=n,
                                        height=32, width=32, num_cells=3, seed=seed)[0]
            for s, n, seed in (("01", 8, 123), ("02", 6, 7))]
    ip = InferenceParams(model_path=os.path.join(GOLDEN, "torch_ckpt"), min_cell_size=5,
                         pre_sequence_frames=2, dtype="float32")
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = [str(tmp_path / f"{device}{i}") for i in range(2)]
        reset_counts()
        assert run_inference_batched(ip, seqs, outs[device], device=device) == 14
        if device == "cuda":
            assert counts()["ccl"] == {"kernel": 2 * (8 + 2), "plain": 0}
    for got_dir, want_dir in zip(outs["cuda"], outs["cpu"]):
        for p in sorted(glob.glob(os.path.join(want_dir, "mask*.tif"))):
            np.testing.assert_array_equal(
                read_tiff(os.path.join(got_dir, os.path.basename(p))), read_tiff(p))


# ---------------------------------------------------------------- the meshes
#
# Under a 'spatial' mesh each rank runs the kernels on its rows plus the
# halo: blocks of Hs + 2 * (k // 2) rows (260, 132, 68, 36 at the flagship's
# 5x5 levels, 18 and 10 at the tiny model's 3x3 ones), heights no
# single-process path gives them.


@pytest.mark.parametrize("b,h,w,feat,k,dt,sdt", [
    (1, 260, 64, 128, 5, torch.bfloat16, torch.bfloat16),   # flagship level 0 block
    (1, 132, 64, 256, 5, torch.bfloat16, torch.float32),    # level 1
    (1, 36, 64, 512, 5, torch.bfloat16, torch.bfloat16),    # level 3
    (1, 260, 64, 128, 5, torch.float32, torch.float32),     # 3xTF32
    (1, 68, 64, 256, 5, torch.float32, torch.float32),      # level 2
    (2, 18, 32, 8, 3, torch.float32, torch.float32),        # tiny level 0, narrow
    (2, 10, 16, 16, 3, torch.bfloat16, torch.bfloat16),     # tiny level 1, narrow
])
def test_fused_level_at_halo_extended_heights_matches_plain(cuda, b, h, w, feat, k, dt, sdt):
    ins = _level(cuda, b, h, w, feat, k, dt, sdt, seed=h)
    which = convlstm_cell.route(h, w, feat, k, b, dt)
    name = {"wgmma": "fused_convlstm_level_wgmma", "tf32x3": "fused_convlstm_level_tf32x3",
            "narrow": "fused_convlstm_level_narrow"}[which]
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*ins)
    want = convlstm_cell.fused_convlstm_level_plain(*ins)
    assert counts()[name] == {"kernel": 1, "plain": 1}
    _tc_close(got, want, sdt, k, feat)


@pytest.mark.parametrize("b,h,w,cin,k,cout", [
    (1, 260, 64, 128, 5, 512),   # the flagship's level 0 h-conv block: wgmma
    (1, 34, 64, 512, 3, 512),    # a 3x3 decoder conv at level 3: wgmma
    (1, 260, 64, 1, 5, 512),     # the cin = 1 x-conv block: small-K
    (2, 18, 32, 8, 3, 32),       # the tiny model's cin 8 site: small-K
])
def test_conv2d_int8_at_halo_extended_heights_equals_plain(cuda, b, h, w, cin, k, cout):
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(h + cin)
    kq = torch.randint(-127, 128, (cout, cin, k, k), device=cuda, generator=g,
                       dtype=torch.int32).to(torch.int8)
    which, packed, _ = conv_int8.pack_site(kq)
    w_scale = torch.rand(cout, device=cuda, generator=g) * 1e-3
    bias = torch.randn(cout, device=cuda, generator=g)
    x = (torch.randn(b, h, w, cin, device=cuda, generator=g) * 3).to(torch.bfloat16)
    fn, plain, kk = {"wgmma": (conv_int8.conv2d_int8_wgmma, conv_int8.conv2d_int8_wgmma_plain,
                               (k,)),
                     "smallk": (conv_int8.conv2d_int8_smallk,
                                conv_int8.conv2d_int8_smallk_plain, (k, k))}[which]
    for scale in (None, torch.tensor(2.5 / 127, device=cuda)):  # dynamic, static
        args = (x, scale, packed, w_scale, bias, *kk, torch.bfloat16)
        reset_counts()
        got, want = fn(*args), plain(*args)
        assert counts()[f"conv2d_int8_{which}"] == {"kernel": 1, "plain": 1}
        assert torch.equal(got, want), (which, scale)


def _halo_rank(rank, device):
    """One of two ranks on one card over gloo: its rows of a [2, 12, 20, 8]
    frame through ``exchange_halo_h`` (forward and backward) and a 5x5
    ``halo_conv2d``; returns them gathered, as numpy."""
    from lstm_unet_tpu_torch.parallel import halo_conv2d, make_mesh, plan_split
    from lstm_unet_tpu_torch.parallel.halo import exchange_halo_h

    torch.backends.cudnn.allow_tf32 = False  # as the cuda fixture sets it in the test
    split = plan_split(make_mesh({"spatial": 2}), 2, 12, 0)
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.normal(size=(2, 12, 20, 8)).astype(np.float32))
    k = torch.from_numpy(g.uniform(-0.2, 0.2, (16, 8, 5, 5)).astype(np.float32))
    r = torch.from_numpy(g.normal(size=(2, 16, 20, 8)).astype(np.float32))
    rows = split.row_slice(12)
    xl = x[:, rows].to(device).requires_grad_()
    xe = exchange_halo_h(xl, 2, split.spatial)
    assert xe.device == xl.device and xe.shape == (2, 10, 20, 8)
    (xe * r[:, 6 * rank:6 * rank + 10].to(device)).sum().backward()
    y = halo_conv2d(xl.detach(), k.to(device), None, group=split.spatial)
    return (xe.detach().cpu().numpy(), xl.grad.cpu().numpy(),
            split.gather(y, row_dim=1).cpu().numpy())


def test_exchange_halo_h_on_the_card_over_two_gloo_ranks(cuda, tmp_path):
    """CUDA tensors through the halo exchange of two ranks sharing the card
    (gloo sends through host memory): the rows of each neighbour, zeros at
    the frame's edges, the gradient returned to the rows' owner; the halo
    conv equal to the whole frame's conv."""
    from lstm_unet_tpu_torch.ops.conv import conv2d
    from lstm_unet_tpu_torch.parallel import run_ranks

    got = run_ranks(_halo_rank, 2, device="cuda:0", timeout_s=180, work_dir=str(tmp_path))
    g = np.random.default_rng(3)
    x = g.normal(size=(2, 12, 20, 8)).astype(np.float32)
    k = g.uniform(-0.2, 0.2, (16, 8, 5, 5)).astype(np.float32)
    r = g.normal(size=(2, 16, 20, 8)).astype(np.float32)
    padded = np.pad(x, ((0, 0), (2, 2), (0, 0), (0, 0)))  # the frame's zero rows
    grad = np.zeros_like(padded)
    for rank in (0, 1):  # each rank's extended block is rows 6 * rank .. + 10
        grad[:, 6 * rank:6 * rank + 10] += r[:, 6 * rank:6 * rank + 10]
    for rank, (xe, gx, y) in enumerate(got):
        np.testing.assert_array_equal(xe, padded[:, 6 * rank:6 * rank + 10])
        np.testing.assert_allclose(gx, grad[:, 2:14][:, 6 * rank:6 * rank + 6], atol=1e-6)
        want = conv2d(torch.from_numpy(x).to(cuda), torch.from_numpy(k).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(y, want, atol=1e-5)


# ---------------------------------------------------------------- the postprocess loops


def _field(cuda, seed, h, w, frac):
    """A smooth random bool field on the card: blobs of ~``frac`` of it."""
    r = np.random.default_rng(seed)
    f = np.kron(r.random((h // 8 + 2, w // 8 + 2)), np.ones((8, 8)))[:h, :w]
    f += r.random((h, w)) * 0.3
    return torch.from_numpy(f > np.quantile(f, 1 - frac)).to(cuda)


def _loop_inputs(cuda, case):
    """(labels, band, mask) on the card: the growth's labels and band and
    the erosion's mask of one case."""
    from lstm_unet_tpu_torch.ops import postprocess
    from lstm_unet_tpu_torch.ops.ccl import relabel_compact

    if case == "serpentine 256^2":
        lbl, band = (torch.from_numpy(a).to(cuda) for a in synthetic.serpentine_band(256, 256))
        return lbl, band, band
    if case == "blobs 1024^2":
        interior = _field(cuda, 3, 1024, 1024, 0.5)
        seeds = ccl.connected_components(postprocess._erode(interior).contiguous())
        return seeds, interior, interior
    probs = torch.from_numpy(synthetic.cell_like_probs(512, 512, num_cells=300,
                                                       seed=0)[0]).to(cuda)
    interior = (probs[..., 1] > 0.5).contiguous()
    lbl, _ = relabel_compact(ccl.connected_components(interior), min_size=10)
    return lbl, (probs[..., 2] > 0.3) & ~interior, interior


@pytest.mark.parametrize("case", ["cell-like 512^2", "blobs 1024^2", "serpentine 256^2"])
def test_postprocess_loops_equal_plain(cuda, case):
    """Each loop's kernel bit-equal to its plain version on the same CUDA
    tensors, uncapped and at the caps 1-4, with its device round count equal
    to the plain loop's."""
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    lbl, band, mask = _loop_inputs(cuda, case)
    caps = (0,) if case == "serpentine 256^2" else (0, 1, 2, 3, 4)
    for cap in caps:
        loops.clear_rounds()
        reset_counts()
        got = loops.grow_into_band(lbl, band, cap)
        want = loops.grow_into_band_plain(lbl, band, cap)
        assert counts()["grow_into_band"] == {"kernel": 1, "plain": 1}
        assert torch.equal(got, want), f"cap {cap}: {int((got != want).sum())} px"
        assert loops.device_rounds(cuda)["grow"] == loops.ROUNDS["grow"] > 0
        for octagon in (False, True):
            loops.clear_rounds()
            got = loops.erosion_distance(mask, cap, octagon)
            want = loops.erosion_distance_plain(mask, cap, octagon)
            assert torch.equal(got, want), f"cap {cap} octagon {octagon}"
            assert loops.device_rounds(cuda)["erode"] == loops.ROUNDS["erode"] > 0
    if case == "serpentine 256^2":
        assert loops.ROUNDS["erode"] == 1 and loops.device_rounds(cuda)["grow"] == 0
        loops.clear_rounds()
        loops.grow_into_band(lbl, band)
        assert loops.device_rounds(cuda)["grow"] > 30000


# the 'dist' split's marker arguments: (window, min_dist, slack, rel, rel_window)
SPLIT_ARGS = {"defaults": (16, 4, 1, 0.65, 48), "window > rel_window": (24, 3, 1, 0.5, 8),
              "rel = 0": (16, 4, 1, 0.0, 48), "window = 0": (0, 2, 0, 0.65, 12),
              "slack 3, rel 0.9": (8, 2, 3, 0.9, 30)}


def _split_maps(cuda, maps, h, w):
    """(dist, interior) on the card: the octagon distance of a cell-like
    interior, or random distances 0-40 on a random interior."""
    from lstm_unet_tpu_torch.ops.postprocess import octagon_distance

    if maps == "random":
        r = np.random.default_rng(h * w)
        return (torch.from_numpy(r.integers(0, 41, (h, w)).astype(np.int32)).to(cuda),
                torch.from_numpy(r.random((h, w)) < 0.7).to(cuda))
    probs = synthetic.cell_like_probs(h, w, num_cells=max(1, h * w // 900), seed=h + w)[0]
    interior = (torch.from_numpy(probs[..., 1]).to(cuda) > 0.5).contiguous()
    return octagon_distance(interior), interior


@pytest.mark.parametrize("maps", ["random", "cell-like"])
@pytest.mark.parametrize("h,w", [(512, 512), (1024, 1024), (96, 160), (40, 56), (7, 300),
                                 (1, 1)])
def test_split_markers_equal_plain(cuda, h, w, maps):
    """The markers kernel bit-equal to its plain version on the same CUDA
    tensors, at every argument case; 40x56, 7x300 and 1x1 lie below the
    default window (2R+1 = 97)."""
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    dist, interior = _split_maps(cuda, maps, h, w)
    for name, args in SPLIT_ARGS.items():
        reset_counts()
        got = loops.split_markers(dist, interior, *args)
        want = loops.split_markers_plain(dist, interior, *args)
        assert counts()["split_markers"] == {"kernel": 1, "plain": 1}
        assert got.dtype == torch.bool and torch.equal(got, want), \
            f"{name}: {int((got != want).sum())} px differ"


def test_split_markers_replay_in_a_cuda_graph(cuda):
    """A CUDA graph that holds the markers kernel: each replay on new
    distances in the captured input equals the plain version."""
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    maps = [_split_maps(cuda, "cell-like", 512, 512), _split_maps(cuda, "random", 512, 512)]
    dist, interior = (t.clone() for t in maps[0])
    loops.split_markers(dist, interior, *SPLIT_ARGS["defaults"])  # the first launch outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = loops.split_markers(dist, interior, *SPLIT_ARGS["defaults"])
    for d, i in maps * 2:
        dist.copy_(d)
        interior.copy_(i)
        graph.replay()
        assert torch.equal(out, loops.split_markers_plain(d, i, *SPLIT_ARGS["defaults"]))


@pytest.mark.parametrize("dtype,fused", [("bfloat16", True), ("int8", False)])
def test_step_batch_async_never_waits_for_the_card(cuda, dtype, fused):
    """Steady steps of the flagship (seeded weights) at 64^2, B = 1, under
    ``set_sync_debug_mode("error")``: no step synchronizes, and the growth
    kernel and K3 launch once a step with no plain call."""
    from lstm_unet_tpu_torch.config import InferenceParams, default_net_kernel_params
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.models import cast_params_for_inference

    cfg = ModelConfig.make(default_net_kernel_params(), dtype="bfloat16",
                           quant="int8" if dtype == "int8" else "none", fused_cell=fused)
    model = ULSTMnet2D(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    if dtype != "int8":
        model = cast_params_for_inference(model, cfg.compute_dtype)
    engine = StreamingInferenceEngine(model, InferenceParams(min_cell_size=5), cuda)
    frames = synthetic.make_cell_sequence(num_frames=5, height=64, width=64, seed=1)[0]
    for f in frames[:2]:
        engine.step_batch_async(f[None])
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            labels, _ = engine.step_batch_async(f[None])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ran = counts()
    assert ran["grow_into_band"]["kernel"] == ran["ccl"]["kernel"] == 3, ran
    assert all(v["plain"] == 0 for v in ran.values()), ran
    assert labels.shape == (1, 64, 64) and labels.dtype == torch.int32


# ---------------------------------------------------------------- the compiled step

GRAPH_SIZE = 128  # the flagship's frames for the graph tests (a multiple of 2^4)


@pytest.fixture(scope="module")
def graph_models():
    """``chip_smoke.py``'s ``SYNC_FREE`` models, seeded: the flagship in bf16
    with the fused cell, int8 calibrated on 4 frames (unfused), f32 with
    the fused cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    from lstm_unet_tpu_torch.engine.infer import calibrate_act_scales
    from lstm_unet_tpu_torch.models import quantize_model_int8

    int8 = chip_smoke.flagship_int8_model(torch, fused=False)
    imgs = synthetic.make_cell_sequence(num_frames=4, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                        num_cells=8, seed=7)[0]
    scales = calibrate_act_scales(int8, [f.astype(np.float32) for f in imgs])
    quantize_model_int8(int8, scales, float_dtype=int8.cfg.compute_dtype)
    return {"bf16": chip_smoke.flagship_model(torch, "bfloat16", True), "int8": int8,
            "f32": chip_smoke.flagship_model(torch, "float32", True)}


def _sync_free_configs():
    import chip_smoke

    return {name: (model, lanes, kw) for name, model, lanes, kw in chip_smoke.SYNC_FREE}


@pytest.mark.parametrize("name", list(_sync_free_configs()))
def test_replays_equal_the_eager_step(cuda, graph_models, name):
    """Each configuration of ``chip_smoke.py``'s ``SYNC_FREE`` at 128^2: the
    engine's graphs (captured at frame 1) over 9 replayed frames give labels
    and probabilities bit-equal to the same body run eagerly, with the same
    launches of every kernel and no plain call."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.ops.kernels import graph_counts

    model, lanes, kw = _sync_free_configs()[name]
    frames = synthetic.make_cell_sequence(num_frames=10, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                          num_cells=8, seed=0)[0]
    batches = [np.stack([np.roll(f, 16 * i, 0) for i in range(lanes)]) for f in frames]
    outs, ran = {}, {}
    for mode in ("eager", "graph"):
        engine = StreamingInferenceEngine(graph_models[model],
                                          InferenceParams(save_intermediate=True, **kw), cuda)
        engine.capture = mode == "graph"
        reset_counts()
        outs[mode] = [tuple(t.cpu() for t in engine.step_batch_async(b)) for b in batches]
        ran[mode] = counts()
        want = {"captures": 2, "replays": 9} if mode == "graph" else {"captures": 0,
                                                                      "replays": 0}
        assert graph_counts() == want
    assert ran["graph"] == ran["eager"]
    assert all(v["plain"] == 0 for v in ran["graph"].values()), ran["graph"]
    for t, (got, want) in enumerate(zip(outs["graph"], outs["eager"])):
        assert got[0].shape == (lanes, GRAPH_SIZE, GRAPH_SIZE)
        assert torch.equal(got[0], want[0]), f"labels of frame {t}"
        assert torch.equal(got[1], want[1]), f"probs of frame {t}"


def test_the_engine_replays_by_frame_3(cuda, graph_models):
    """Frame 1 warms up and captures, frames 2 and 3 are replays, and the
    outputs of frame 2 are still frame 2's after frame 3."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.ops.kernels import graph_counts

    engine = StreamingInferenceEngine(graph_models["bf16"], InferenceParams(), cuda)
    frames = synthetic.make_cell_sequence(num_frames=3, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                          num_cells=8, seed=2)[0]
    reset_counts()
    kept = []
    for f in frames:
        labels, _ = engine.step_batch_async(f[None])
        kept.append((labels, labels.clone()))
    assert graph_counts() == {"captures": 2, "replays": 2}
    assert engine._step.captured
    for labels, then in kept:
        assert torch.equal(labels, then)


def test_a_synchronizing_step_fails_its_capture(cuda, graph_models):
    """A body with a host read (``.item()``) runs as the warm-up, then its
    capture raises, naming the failure: the step never falls back to eager
    launches, and the failed capture counts nothing."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.ops.kernels import graph_counts

    engine = StreamingInferenceEngine(graph_models["bf16"], InferenceParams(), cuda)
    body = engine._body

    def with_a_host_read(frames, src, dst):
        out = body(frames, src, dst)
        float(out[0].max().item())
        return out

    engine._body = with_a_host_read
    frame = synthetic.make_cell_sequence(num_frames=1, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                         num_cells=8, seed=3)[0][0]
    reset_counts()
    with pytest.raises(RuntimeError, match="CUDA graph capture of the streaming step failed"):
        engine.step_batch_async(frame[None])
    assert graph_counts() == {"captures": 0, "replays": 0}
    assert counts()["ccl"]["kernel"] == 1  # the warm-up's
    assert not engine._step.captured
    torch.cuda.synchronize()  # the card is still usable
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        engine.step_batch_async(frame[None])


# ---------------------------------------------------------------- the tracer


@pytest.fixture
def tracer():
    """``utils/trace.py``, off before and after the test."""
    from lstm_unet_tpu_torch.utils import trace

    trace.stop()
    yield trace
    trace.stop()
    torch.cuda.set_sync_debug_mode(0)


def _ring_index(trace, device) -> int:
    """The card's ring index: the stamps written since the last recording
    began (one synchronize)."""
    trace.prepare(device)
    return int(trace._RINGS[trace._card(device)].index.item())


def _carried(engine):
    return [t.clone() for lvl in engine._state for pair in lvl for t in pair]


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_twin_replays_equal_plain_replays(cuda, graph_models, tracer, name):
    """Frames 3-8 replayed through the traced twins give labels,
    probabilities and carried state bit-equal to the plain graphs' over the
    same frames, with the same launches counted; a plain replay writes no
    stamp; neither path makes a host read (``set_sync_debug_mode('error')``);
    the recording holds one ``step`` a frame and every stamp nested."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.ops.kernels import graph_counts

    frames = synthetic.make_cell_sequence(num_frames=8, height=GRAPH_SIZE, width=GRAPH_SIZE,
                                          num_cells=8, seed=4)[0]
    ip = InferenceParams(save_intermediate=True, instance_split=True, min_cell_size=5)
    runs = {}
    for traced in (False, True):
        engine = StreamingInferenceEngine(graph_models[name], ip, cuda)
        outs = [tuple(t.clone() for t in engine.step_batch_async(f[None])) for f in frames[:2]]
        before = _ring_index(tracer, cuda)
        reset_counts()
        if traced:
            tracer.start()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs += [engine.step_batch_async(f[None]) for f in frames[2:]]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tracer.stop()
        if not traced:
            assert _ring_index(tracer, cuda) == before, "a plain replay wrote a stamp"
        runs[traced] = outs, _carried(engine), counts(), graph_counts()
    (plain, plain_state, plain_n, plain_g), (twin, twin_state, twin_n, twin_g) = \
        runs[False], runs[True]
    assert plain_n == twin_n and plain_g == twin_g == {"captures": 0, "replays": 6}
    for t, (a, b) in enumerate(zip(plain, twin)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), f"frame {t}"
    assert all(torch.equal(a, b) for a, b in zip(plain_state, twin_state))
    summary = tracer.summary()
    assert summary["units"] == 6
    assert summary["spans"]["step"]["count"] == summary["spans"]["model"]["count"] == 6
    assert summary["counters"]["stamp_overflow"] == summary["counters"]["unmatched_stamps"] == 0
    assert summary["spans"]["engine.step"]["count"] == 6


@pytest.mark.parametrize("workload", ["stream-int8-b1", "stream-int8-dist", "train-bf16-b5t7"])
def test_the_stamps_segments_add_up_to_the_step(cuda, tracer, workload):
    """Each benchmark cell at its own size, built by its harness: the
    device ms a unit of the step's children (stream: normalize, variants,
    model, probs, postprocess, outputs; training: forward, loss, backward,
    optimizer, reset) sum to the ``step`` / ``train.step`` stamp's within
    2%."""
    from portbench.harness import cell

    c = cell.load(workload)
    seed = 2 ** 33 + 5
    if c.mode == "stream":
        from portbench.harness import stream as harness

        run = harness.Stream(c, seed, cuda)
        parent = "step"
        children = ("normalize", "variants", "model", "probs", "postprocess", "outputs")
    else:
        from portbench.harness import train as harness

        run = harness.Training(c, seed, cuda)
        parent = "train.step"
        children = ("train.forward", "train.loss", "train.backward", "train.optimizer",
                    "train.reset")
    harness.loop(run, 1.0)
    torch.cuda.synchronize()
    tracer.start()
    harness.loop(run, 2.0)
    torch.cuda.synchronize()
    tracer.stop()
    spans = tracer.summary()["spans"]
    total = sum(spans[k]["device_ms"] for k in children if k in spans)
    assert abs(total - spans[parent]["device_ms"]) <= 0.02 * spans[parent]["device_ms"], \
        (total, {k: v.get("device_ms") for k, v in spans.items()})


def test_program_spans_share_the_profilers_clock(cuda, tracer):
    """A host pause inside a program span shows in the profiler's device
    trace as the device's longest gap, whose midpoint lies inside the span
    to within 50 us."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert tracer.check()
        for _ in range(20):
            x @ x
        with tracer.span("pause"):
            torch.cuda.synchronize()
            time.sleep(0.02)
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    pause = [s for s in tracer.spans() if s["name"] == "pause"][0]
    origin = prof.profiler.kineto_results.trace_start_ns()
    busy = []
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == DeviceType.CUDA):
        if busy and t0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t1)
        else:
            busy.append([t0, t1])
    width, mid = max((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:]))
    lo, hi = (pause["start_ns"] - origin) / 1e3, (pause["end_ns"] - origin) / 1e3
    assert width > 15000, width  # us: the 20 ms pause is the device's longest gap
    assert lo - 50 <= mid <= hi + 50, (lo, mid, hi)
