"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips where no GPU is present (decided
when the test runs). This file imports neither JAX nor the reference, so it
runs on a machine with only PyTorch; ``tests/conftest.py`` imports JAX, so
skip it there:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: K1 1e-6 in f32 and one bf16 ulp of output rounding in bf16; K4
2e-5 in f32 (the reference's fused-vs-XLA bound) and one bf16 ulp; K3 equal.
"""

import glob
import os

import numpy as np
import pytest
import torch

from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff
from lstm_unet_tpu_torch.ops.kernels import ccl, convlstm_cell, counts, lstm_gates, reset_counts

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
    (1, 17, 9, 10, 7, torch.float32, torch.float32),     # ragged Wh chunk
    (3, 8, 8, 8, 1, torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_fused_level_matches_plain(cuda, b, h, w, feat, k, dt, sdt, act):
    ins = _level(cuda, b, h, w, feat, k, dt, sdt)
    assert convlstm_cell.supported(h, w, feat, k, k, b)
    reset_counts()
    got = convlstm_cell.fused_convlstm_level(*ins, act)
    want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
    assert counts()["fused_convlstm_level"] == {"kernel": 1, "plain": 1}
    _close(got, want, sdt, atol=2e-5)


def test_fused_level_smem_formula_matches_the_kernel(cuda):
    from lstm_unet_tpu_torch.ops.kernels import _build

    lib = _build.library()
    for k in convlstm_cell.KERNEL_SIZES:
        for feat in (8, 16, 128, 256):
            assert lib.lut_convlstm_level_smem(k, feat) == convlstm_cell.smem_bytes(k, feat)


def test_fused_level_rejects_unsupported_shapes(cuda):
    ins = _level(cuda, 1, 8, 8, 256, 5, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="supported"):
        convlstm_cell.fused_convlstm_level(*ins)


def _masks():
    r = np.random.default_rng(4)
    return [r.random((512, 512)) < 0.5, r.random((333, 517)) < 0.6,
            r.random((1, 100)) < 0.5, r.random((100, 1)) < 0.5,
            np.zeros((40, 40), bool), np.ones((70, 65), bool),
            synthetic.spiral_mask(96), synthetic.dense_components_mask(256, 256)]


@pytest.mark.parametrize("case", range(8))
def test_ccl_equals_plain(cuda, case):
    mask = torch.from_numpy(_masks()[case]).to(cuda)
    reset_counts()
    got = ccl.connected_components(mask)
    assert counts()["ccl"] == {"kernel": 1, "plain": 0}
    assert torch.equal(got, ccl.connected_components_plain(mask))


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
