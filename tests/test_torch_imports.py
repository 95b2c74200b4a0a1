"""Import isolation and build hygiene of the PyTorch port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = os.path.join(ROOT, "lstm_unet_tpu_torch")

_STEP = """
import sys, torch
import lstm_unet_tpu_torch
from lstm_unet_tpu_torch.cli import (ckpt_avg, ctc_score, ctc_sweep, import_tf, inference2d,
                                     train2d)
from lstm_unet_tpu_torch import checkpoint, metrics
from lstm_unet_tpu_torch.checkpoint import tf_bundle, tf_import
from lstm_unet_tpu_torch.config import InferenceParams
from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine, run_inference_batched
from lstm_unet_tpu_torch.config import tiny_net_kernel_params
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import make_train_step
from lstm_unet_tpu_torch.io.dataset import CTCRAMReaderSequence2D
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops.kernels import conv_int8
from lstm_unet_tpu_torch.models import quantize_model_int8
from lstm_unet_tpu_torch.parallel import comm, distributed, halo, mesh
from lstm_unet_tpu_torch.scripts import carry_drift, postprocess_sweep, select_best
from lstm_unet_tpu_torch import bench
assert bench.conv_flops(tiny_net_kernel_params(), 16, 16) > 0
assert mesh.make_mesh({"data": 1}) is None and distributed.initialize("cpu").type == "cpu"
model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()),
                   generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    state, logits = model.step(model.init_state(1, 16, 16), torch.rand(1, 16, 16, 1))
assert logits.shape == (1, 16, 16, 3)
import numpy as np
engine = StreamingInferenceEngine(model, InferenceParams(tta=True, tta_mode="d4",
                                                         reset_on_jump=0.3), "cpu")
labels, _ = engine.step_batch_async(np.zeros((2, 12, 16), np.uint16))
assert labels.shape == (2, 12, 16) and engine._state[0][0][0].shape[0] == 16
assert tf_bundle.crc32c(b"123456789") == 0xE3069283
qmodel = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), dtype="bfloat16", quant="int8"),
                    generator=torch.Generator().manual_seed(0))
quantize_model_int8(qmodel, float_dtype=torch.bfloat16)
with torch.no_grad():
    state, logits = qmodel.step(qmodel.init_state(1, 16, 16), torch.rand(1, 16, 16, 1))
# 9 int8 convs: cin 1, 8 and 24 on the small-K route, cin 16 and 32 on wgmma
assert logits.shape == (1, 16, 16, 3)
assert (conv_int8.SMALLK_COUNT.plain, conv_int8.WGMMA_COUNT.plain) == (6, 3)
assert conv_int8.COUNT.plain == 0
step = make_train_step(model, ClippedAdam(dict(model.named_parameters()), 1e-3, 5.0), (1, 1, 1),
                       remat=True)
ones = torch.ones(1, 2)
state, m = step(model.init_state(1, 16, 16), torch.rand(1, 2, 16, 16, 1),
                torch.randint(0, 3, (1, 2, 16, 16)), ones, ones, torch.zeros(1))
assert torch.isfinite(m["loss"])
import tempfile
from lstm_unet_tpu_torch.config import CTCParams
from lstm_unet_tpu_torch.engine.train import Trainer
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
with tempfile.TemporaryDirectory() as root:
    write_ctc_dataset(root, num_frames=4, height=16, width=16, num_cells=2, seed=0)
    p = CTCParams(root_data_dir=root, train_sequence_list=[("Synth-N2DH-SIM", "01")],
                  crop_size=(16, 16), batch_size=1, unroll_len=2, dry_run=True,
                  net_kernel_params=tiny_net_kernel_params(), elastic_augmentation=True,
                  data_provider_class="GrainCTCReaderSequence2D", adam_mu_dtype="bfloat16",
                  remat_policy="save_outputs", spike_factor=3.0)
    assert torch.isfinite(torch.tensor(Trainer(p, device="cpu").train(2)["loss"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lstm_unet_tpu", "grain", "cv2"))
print("IMPORTED", bad)
"""


def test_port_runs_without_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", _STEP], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                                                  recursive=True))
                         + [os.path.join(ROOT, "chip_smoke.py")]
                         + sorted(glob.glob(os.path.join(ROOT, "scripts", "profile_torch_*.py"))))
def test_no_module_imports_jax_triton_at_top_or_the_reference(path):
    """Nothing in the port imports jax, lstm_unet_tpu or grain, and nothing
    imports triton (a CUDA-only package) when its module is imported."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "lstm_unet_tpu", "grain"), (path, n)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".")[0] == "triton" for m in mods), path


def test_build_dir_is_ignored_and_named_by_sources():
    from lstm_unet_tpu_torch.ops.kernels import _build

    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert "lstm_unet_tpu_torch/build/" in ignored
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR == os.path.join(PORT, "build")
    assert path == _build.library_path()  # stable for an unchanged tree
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(PORT, "csrc", "*.cu"))) \
        == ["ccl.cu", "conv_int8.cu", "conv_int8_smallk.cu", "conv_int8_wgmma.cu",
            "conv_int8_wgmma_gates.cu", "convlstm_narrow.cu",
            "convlstm_wgmma.cu", "lstm_gates.cu", "postprocess_loops.cu", "trace_stamp.cu"]


def test_chip_smoke_alone_fails_and_prints_nothing(tmp_path):
    """Without the port beside it (or without a GPU) the smoke script exits
    non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
