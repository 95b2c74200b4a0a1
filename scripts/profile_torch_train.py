"""Steady-state training step time and device breakdown of the port's
flagship (``lstm_unet_tpu_torch``, B = 5, T = 7, 256² crops, full remat,
random weights and batches from a seed) on one NVIDIA GPU, f32 and bf16.

    python scripts/profile_torch_train.py [--steps N]

Per dtype: 2 warm-up steps, then N steps timed on the host clock around
``make_train_step``'s step followed by ``torch.cuda.synchronize()`` (the
reader is left out: batches are made on the device up front), then
``torch.profiler`` over 2 more steps: kernel time per step by kind, the busy
share (the union of the kernels' intervals on the device timeline / profiled
wall; the sum of kernel times can exceed the wall where cuDNN runs kernels
concurrently) and the top kernels. The last line is the same as JSON.
"""

from __future__ import annotations

import argparse
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

from lstm_unet_tpu_torch.config import CTCParams, default_net_kernel_params  # noqa: E402
from lstm_unet_tpu_torch.engine.optim import ClippedAdam  # noqa: E402
from lstm_unet_tpu_torch.engine.train import make_train_step  # noqa: E402
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D  # noqa: E402

B, T, HW = 5, 7, 256
WARM, PROFILED = 2, 2


def kind(name: str) -> str:
    if "gate_update_bwd" in name:
        return "K2"
    if "gate_update" in name:
        return "K1"
    if "dgrad" in name:
        return "conv dgrad"
    if "wgrad" in name:
        return "conv wgrad"
    if any(t in name for t in ("fprop", "xmma", "cutlass", "convolve", "implicit_gemm",
                               "winograd", "fft", "conv")):
        return "conv other"
    if "Nhwc" in name or "Nchw" in name or "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout"
    if "reduce" in name.lower():
        return "reduce"
    return "elementwise/other"


def busy_ms(events) -> float:
    """Milliseconds in which at least one kernel ran: the union of their
    intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return (total + (0.0 if cur is None else cur[1] - cur[0])) / 1e3


def profile_dtype(dtype: str, steps: int) -> dict:
    p = CTCParams()
    cfg = ModelConfig.make(default_net_kernel_params(), dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ULSTMnet2D(cfg, generator=gen, device="cuda")
    opt = ClippedAdam(dict(model.named_parameters()), p.learning_rate, p.grad_clip_norm,
                      p.skip_nonfinite_updates)
    step = make_train_step(model, opt, p.class_weights, remat=p.remat)
    n = WARM + steps + PROFILED
    batches = [(torch.rand(B, T, HW, HW, 1, device="cuda", generator=gen),
                torch.randint(0, 3, (B, T, HW, HW), device="cuda", generator=gen),
                torch.ones(B, T, device="cuda"), torch.ones(B, T, device="cuda"),
                (torch.rand(B, device="cuda", generator=gen) < 0.3).float())
               for _ in range(n)]
    state = model.init_state(B, HW, HW, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:WARM]:
        state, m = step(state, *b)
    torch.cuda.synchronize()
    times = []
    for b in batches[WARM:WARM + steps]:
        t0 = time.perf_counter()
        state, m = step(state, *b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[WARM + steps:]:
            state, m = step(state, *b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.device_time_total)
    by_kind: dict = {}
    for e in kernels:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.device_time_total / 1e3 / PROFILED
    kernel_ms = sum(by_kind.values())
    busy = busy_ms(prof.events()) / PROFILED
    ms = float(np.median(times))
    return dict(ms_per_step_median=ms, ms=times, frames_per_s=B * T * 1e3 / ms,
                loss=float(m["loss"]), profiled_wall_ms=wall, kernel_ms=kernel_ms,
                busy_ms=busy, busy_share=busy / wall, by_kind=by_kind,
                kernels_per_step=sum(e.count for e in kernels) / PROFILED,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                top=[(e.key[:100], e.device_time_total / 1e3 / PROFILED,
                      e.count // PROFILED) for e in kernels[:20]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, "| torch", torch.__version__, flush=True)
    out = {"card": card}
    for dtype in args.dtypes.split(","):
        r = profile_dtype(dtype, args.steps)
        out[dtype] = r
        print(f"== {dtype} B{B} T{T} {HW}^2: {r['ms_per_step_median']:.1f} ms/step (median "
              f"of {args.steps}) = {r['frames_per_s']:.3f} frames/s; kernel time "
              f"{r['kernel_ms']:.1f} ms/step, device busy {r['busy_ms']:.1f} ms/step = "
              f"{100 * r['busy_share']:.1f}% of the profiled wall, "
              f"{r['kernels_per_step']:.0f} kernels/step, peak {r['peak_gib']:.2f} GiB",
              flush=True)
        print("   by kind (ms/step):", {k: round(v, 3) for k, v in
                                        sorted(r["by_kind"].items(), key=lambda t: -t[1])})
        for name, ms, n in r["top"]:
            print(f"   {ms:9.3f} ms/step  x{n:<5d} {name}")
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
