"""Steady-state time per frame and device breakdown of the port's flagship
stream (``lstm_unet_tpu_torch``, 512², B = 1, random weights from a seed) on
one NVIDIA GPU, for f32 and bf16 with the fused cell off and on.

    python scripts/profile_torch_stream.py

Per configuration: 3 warm-up frames, then the median of 8 frames timed on
the host clock around ``StreamingInferenceEngine.process_frame`` (which ends
in a device-to-host copy), then ``torch.profiler`` over 3 more frames: kernel
time per frame by kind, the busy share (kernel time / profiled wall) and the
top kernels. The last line is the same as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lstm_unet_tpu_torch.config import InferenceParams, default_net_kernel_params  # noqa: E402
from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine  # noqa: E402
from lstm_unet_tpu_torch.io.synthetic import make_cell_sequence  # noqa: E402
from lstm_unet_tpu_torch.models import (ModelConfig, ULSTMnet2D,  # noqa: E402
                                        cast_params_for_inference)

WARM, TIMED, PROFILED = 3, 8, 3


def kind(name: str) -> str:
    if "convlstm_level" in name:
        return "K4"
    if "gate_update" in name:
        return "K1"
    if "ccl_" in name:
        return "K3"
    if any(t in name for t in ("fprop", "xmma", "cutlass", "convolve", "implicit_gemm",
                               "winograd", "fft")):
        return "conv"
    if "Nhwc" in name or "Nchw" in name:
        return "layout"
    return "elementwise/other"


def profile_config(frames, dtype: str, fused: bool) -> dict:
    cfg = ModelConfig.make(default_net_kernel_params(), dtype=dtype, fused_cell=fused)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = cast_params_for_inference(ULSTMnet2D(cfg, generator=gen, device="cuda"),
                                      cfg.compute_dtype)
    engine = StreamingInferenceEngine(model, InferenceParams(dtype=dtype), "cuda")
    for f in frames[:WARM]:
        engine.process_frame(f)
    torch.cuda.synchronize()
    times = []
    for f in frames[WARM:WARM + TIMED]:
        t0 = time.perf_counter()
        engine.process_frame(f)
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[WARM + TIMED:]:
            engine.process_frame(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.device_time_total)
    by_kind: dict = {}
    for e in kernels:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.device_time_total / 1e3 / PROFILED
    busy = sum(by_kind.values())
    return dict(ms_median=float(np.median(times)), ms=times, profiled_wall_ms=wall,
                kernel_ms=busy, busy_share=busy / wall, by_kind=by_kind,
                kernels_per_frame=sum(e.count for e in kernels) / PROFILED,
                top=[(e.key[:100], e.device_time_total / 1e3 / PROFILED, e.count // PROFILED)
                     for e in kernels[:8]])


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, "| torch", torch.__version__, flush=True)
    frames, _ = make_cell_sequence(num_frames=WARM + TIMED + PROFILED, height=512,
                                   width=512, num_cells=40, seed=0)
    out = {"card": card}
    for dtype in ("bfloat16", "float32"):
        for fused in (False, True):
            r = profile_config(frames, dtype, fused)
            out[f"{dtype} fused={fused}"] = r
            print(f"== {dtype} fused={fused}: {r['ms_median']:.3f} ms/frame (median of "
                  f"{TIMED}), kernel time {r['kernel_ms']:.3f} ms/frame, busy "
                  f"{100 * r['busy_share']:.1f}%, {r['kernels_per_frame']:.0f} kernels/frame")
            print("   by kind (ms/frame):", {k: round(v, 3) for k, v in
                                             sorted(r["by_kind"].items(), key=lambda t: -t[1])})
            for name, ms, n in r["top"]:
                print(f"   {ms:9.3f} ms/frame  x{n:<4d} {name}")
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
