"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
cells cut to a tiny size (two-level model, 64x64 frames), which the plain
PyTorch versions of the port's kernels run in seconds."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# in the files' layout: the decoder deepest first, ending in the output conv
TINY = dict(lstm_kernels=[[[3, 8]], [[3, 16]]], down_conv_kernels=[[[3, 8]], [[3, 16]]],
            up_conv_kernels=[[[3, 16]], [[3, 8], [1, 3]]])
# limits of the tiny cells, between their sound runs' readings and their
# controls' at this size (int4 for int8, fp8 for bf16); the flagship's own
# are in portbench/workloads
INT8 = {"prob_gap": 0.09, "label_gap": 0.0}
TINY_LIMITS = {
    "stream-int8-b1": INT8, "stream-int8-dist": INT8,
    "stream-bf16-flip": {"prob_gap": 0.004, "label_gap": 0.0},
    "train-bf16-b5t7": {"grad_gap": 0.012, "change_gap": 0.2, "state_gap": 0.015,
                        "reset_gap": 0.0},
}

# cells that BENCHMARK.json does not hold yet, over traffic that portbench
# keeps for them: run here at the tiny size all the same (TTA and its faults)
LATER = {"stream-bf16-flip": ("flagship-bf16", "stream-flip"),
         "stream-int8-dist": ("flagship-int8", "stream-dist")}



def tiny_copy(dst: str) -> str:
    """The benchmark copied under ``dst``, every cell cut to the tiny size."""
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    bench = os.path.join(dst, "portbench")
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        cfg = json.load(open(path))
        cfg.update(TINY)
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        tr = json.load(open(path))
        tr.update(height=64, width=64, frames=12, cells=4)
        if tr["mode"] == "train":
            tr.update(crop=[32, 32], batch=2, unroll=3)
        json.dump(tr, open(path, "w"))
    for name, limits in TINY_LIMITS.items():
        path = os.path.join(bench, "workloads", name + ".json")
        if os.path.exists(path):
            wl = json.load(open(path))
        else:
            config, traffic = LATER[name]
            wl = {"config": config, "traffic": traffic, "chips": 1, "why": "a tiny test cell"}
        wl["limits"] = limits
        json.dump(wl, open(path, "w"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def cpu_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)
