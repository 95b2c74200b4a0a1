#!/usr/bin/env python3
"""Where K3's time goes on one NVIDIA GPU (``lstm_unet_tpu_torch/csrc/ccl.cu``).

    python3 scripts/profile_torch_ccl.py [--also OTHER_CHECKOUT]

Builds ``ccl.cu`` alone, with ``-DLUT_CCL_PROFILE`` (the cluster kernel then
records each block's clock at the end of each phase), and for 512^2 masks
(random at several densities, cell-like interiors and their marker blobs,
dense small components, the spiral, empty, full, isolated pixels) prints:

- both routes held bit-identical to the plain version;
- ms per call of each route from CUDA events around 50 calls of the C entry
  (with the profiling build's extra barriers), and the cluster kernel's device
  time per launch from a CUDA graph of 20 launches;
- the cluster kernel's cycles by phase, the slowest block's: read + seed,
  unions in the strip, flatten, seams, resolve, write.
Then the wrapper ``ops.kernels.ccl.connected_components`` as the engine
calls it, in a process of its own: ms per call from CUDA events, and from
torch.profiler the device time and the kernel launches per call. With
``--also DIR`` the same for the port in another checkout (the parent commit,
unpacked with ``git archive``), in turns: this, other, other, this.
The last line is the same as JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lstm_unet_tpu_torch.io.synthetic import (cell_like_probs, dense_components_mask,  # noqa: E402
                                              spiral_mask)
from lstm_unet_tpu_torch.ops import postprocess  # noqa: E402
from lstm_unet_tpu_torch.ops.kernels import _build, ccl  # noqa: E402

# run as ``python -c WRAPPER_CODE <checkout> <masks.npz>``: prints one JSON line
WRAPPER_CODE = r"""
import json, sys
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from lstm_unet_tpu_torch.ops.kernels import ccl
out = {}
for name, m in np.load(sys.argv[2]).items():
    mask = torch.from_numpy(m).cuda()
    fn = lambda: ccl.connected_components(mask)
    fn(); torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        fn()
    end.record(); end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out[name] = dict(ms=start.elapsed_time(end) / 50,
                     device_ms=sum(e.device_time_total for e in ev) / 1e3 / 20,
                     launches=sum(e.count for e in ev) / 20)
print(json.dumps(out))
"""

PHASES = ("read_seed", "strip_unions", "flatten", "seams", "resolve", "write")


def build():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libccl_profile.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DLUT_CCL_PROFILE", "-shared", "-o", out,
           os.path.join(_build.CSRC_DIR, "ccl.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    print(done.stderr.strip())
    if done.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lut_ccl_cluster.argtypes = lib.lut_ccl_grid.argtypes = [p, p, i, i, p]
    lib.lut_ccl_clocks.argtypes = [p]
    lib.lut_error_string.argtypes, lib.lut_error_string.restype = [i], ctypes.c_char_p
    return lib


def time_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_wrapper(root, npz):
    done = subprocess.run([sys.executable, "-c", WRAPPER_CODE, root, npz],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"wrapper timing of {root} failed:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> int:
    also = sys.argv[sys.argv.index("--also") + 1] if "--also" in sys.argv else None
    if not torch.cuda.is_available():
        print("profile_torch_ccl: no CUDA GPU", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    def run(entry, mask, out):
        err = getattr(lib, entry)(mask.data_ptr(), out.data_ptr(), *mask.shape,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: {lib.lut_error_string(err).decode()}")

    r = np.random.default_rng(0)
    probs = torch.from_numpy(cell_like_probs(512, 512, num_cells=300, seed=0)[0])
    interior = probs[..., 1] > 0.5
    isolated = np.zeros((512, 512), bool)
    isolated[::2, ::2] = True
    masks = {f"random {p}": r.random((512, 512)) < p for p in (0.1, 0.3, 0.5, 0.7)}
    masks.update({"cell-like": interior.numpy(),
                  "cell-like markers": postprocess._erode(
                      interior & (probs[..., 1] >= 0.8)).numpy(),
                  "dense components": dense_components_mask(512, 512),
                  "spiral": spiral_mask(512), "empty": np.zeros((512, 512), bool),
                  "full": np.ones((512, 512), bool), "isolated pixels": isolated})
    results = {}
    for name, m in masks.items():
        mask = torch.from_numpy(m).to(dev)
        want = ccl.connected_components_plain(mask)
        labels = torch.empty((512, 512), dtype=torch.int32, device=dev)
        scratch = torch.empty((512 * 512 + 512 * 16,), dtype=torch.int32, device=dev)
        run("lut_ccl_cluster", mask, labels)
        run("lut_ccl_grid", mask, scratch)
        torch.cuda.synchronize()
        if not (torch.equal(labels, want)
                and torch.equal(scratch[:512 * 512].view(512, 512), want)):
            raise AssertionError(f"K3 differs from the plain version on the {name} mask")
        clocks = (ctypes.c_longlong * 64)()
        lib.lut_ccl_clocks(ctypes.cast(clocks, ctypes.c_void_p))
        c = np.array(clocks[:]).reshape(8, 8)
        cycles = (c[:, 1:7] - c[:, 0:6]).max(0).tolist()
        side = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            run("lut_ccl_cluster", mask, labels)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(20):
                    run("lut_ccl_cluster", mask, labels)
        results[name] = dict(
            density=float(m.mean()),
            cluster_ms=time_ms(lambda: run("lut_ccl_cluster", mask, labels)),
            cluster_device_ms=time_ms(graph.replay, 10) / 20,
            grid_ms=time_ms(lambda: run("lut_ccl_grid", mask, scratch)),
            cycles=dict(zip(PHASES, cycles)))
        print(f"{name}: density {results[name]['density']:.3f}, both routes bit-identical; "
              f"cluster {results[name]['cluster_ms']:.4f} ms (device "
              f"{results[name]['cluster_device_ms']:.4f}), grid {results[name]['grid_ms']:.4f} ms; "
              f"cluster cycles by phase {results[name]['cycles']}")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    npz = os.path.join(_build.BUILD_DIR, "ccl_profile_masks.npz")
    np.savez(npz, **{k: masks[k] for k in ("random 0.5", "cell-like", "cell-like markers")})
    order = [("this", here)] + ([("other", also), ("other", also), ("this", here)] if also else [])
    wrapper = []
    for who, root in order:
        wrapper.append({"checkout": who, **time_wrapper(root, npz)})
        print(f"wrapper of {who} checkout ({os.path.abspath(root)}):", json.dumps(wrapper[-1]))
    print(json.dumps({"card": smi, "masks": results, "wrapper": wrapper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
