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
from lstm_unet_tpu_torch.cli import inference2d
from lstm_unet_tpu_torch.config import tiny_net_kernel_params
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()),
                   generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    state, logits = model.step(model.init_state(1, 16, 16), torch.rand(1, 16, 16, 1))
assert logits.shape == (1, 16, 16, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lstm_unet_tpu"))
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
                         + [os.path.join(ROOT, "chip_smoke.py")])
def test_no_module_imports_jax_triton_at_top_or_the_reference(path):
    """Nothing in the port imports jax or lstm_unet_tpu, and nothing imports
    triton (a CUDA-only package) when its module is imported."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "lstm_unet_tpu"), (path, n)
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
        == ["ccl.cu", "convlstm_cell.cu", "lstm_gates.cu"]


def test_chip_smoke_alone_fails_and_prints_nothing(tmp_path):
    """Without the port beside it (or without a GPU) the smoke script exits
    non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
