"""What the benchmark's processes load: no JAX and no JAX package anywhere,
nothing of the port in the reference; and no result without a card or
without the program."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "lstm_unet_tpu")

_RUN = """
import contextlib, io, sys
sys.path.insert(0, {root!r})
import torch
from portbench import run
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    assert run.main(["--workload", {workload!r}, "--seed", "3", "--seconds", "0.2"],
                    device=torch.device("cpu"), root={tiny!r}) == 0
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from portbench.reference import model, postprocess
from portbench.harness import traffic, weights
cfg = dict(lstm_kernels=[[[3, 8]]], down_conv_kernels=[[[3, 8]]], up_conv_kernels=[[[3, 8]]])
w = weights.make_weights(cfg, 1, "cpu")
ref = model.Reference(cfg, w)
_, logits = ref.step(ref.init_state(1, 16, 16, "cpu"), torch.rand(1, 1, 16, 16))
postprocess.postprocess(torch.softmax(logits, 1)[0].permute(1, 2, 0).detach().numpy(),
                        postprocess.DEFAULTS)
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _loaded(code):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(eval(proc.stdout.split("LOADED", 1)[1]))


@pytest.mark.parametrize("workload", ["stream-int8-b1", "train-bf16-b5t7"])
def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root, workload):
    loaded = _loaded(_RUN.format(root=ROOT, workload=workload, tiny=tiny_root))
    assert "lstm_unet_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(_REFERENCE.format(root=ROOT))
    assert not loaded & set(FORBIDDEN + ("lstm_unet_tpu_torch",))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                                                  recursive=True)))
def test_no_source_imports_jax_and_the_reference_imports_no_port(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(FORBIDDEN), (path, tops)
    if os.sep + "reference" + os.sep in path:
        assert "lstm_unet_tpu_torch" not in tops and "portbench" not in tops, path


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "stream-int8-b1",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "stream-int8-b1",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
