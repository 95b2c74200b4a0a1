"""Steady-state time per frame and device breakdown of the port's flagship
stream (``lstm_unet_tpu_torch``, 512², B = 1, random weights from a seed) on
one NVIDIA GPU, for bf16, int8 (dynamic scales: the engine quantizes the
f32 weights) and f32, with the fused cell off and on.

    python scripts/profile_torch_stream.py [--dtypes bfloat16,int8,float32]
                                           [--root OTHER_CHECKOUT]
    python scripts/profile_torch_stream.py --mode async [--root OTHER_CHECKOUT]

Per configuration: 3 warm-up frames, then the median of 8 frames timed on
the host clock around ``StreamingInferenceEngine.process_frame`` (which ends
in a device-to-host copy), then ``torch.profiler`` over 3 more frames: kernel
time per frame by kind, the busy share (kernel time / profiled wall), the top
kernels, and the device time of the kernels each PyTorch op launched itself
(``aten::div_``, ``aten::copy_`` for casts, ...: the elementwise time split
by op; the port's own kernels are launched outside any op and show only by
kind), and beside them the program's own spans and device stamps of the
profiled frames (``lstm_unet_tpu_torch/utils/trace.py::summary``: device ms
a frame by layer, inside the captured step). ``--root DIR`` profiles the
port of another checkout (the parent commit, unpacked) instead of this one.
The last line is the same as JSON.

``--mode async`` streams the way a pipelined caller does, through
``step_batch_async`` with no copy back, for bf16 with the fused cell and
int8 (scales calibrated on 4 frames, unfused): 3 warm-up frames (on a card
the first captures the step's CUDA graphs, ``engine/graph.py``), then 32
frames, each timed on the host clock until ``step_batch_async`` returns,
ending in one synchronize (the steady ms per frame), then ``torch.profiler``
over 8 more frames ending in one synchronize (the busy share); with the
hand kernels' launches a frame (``ops.kernels.counts()``) and the peak
device memory from the engine's creation on.

``--mode memory``: peak device memory of bf16 fused streams at B = 1, TTA
'd4' (8 lanes) and B = 4, 2 + 4 frames each, run eagerly (``engine.capture
= False``) and as graph replays; a tree without the compiled step runs
eagerly either way.
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

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WARM, TIMED, PROFILED = 3, 8, 3


def kind(name: str) -> str:
    if "conv_int8_wgmma" in name:
        return "int8 conv wgmma"
    if "conv_int8_smallk" in name:
        return "int8 conv small-K"
    if "conv_int8" in name:
        return "int8 conv"
    if "convlstm_narrow" in name:
        return "K4 narrow"
    if "Tf32x3" in name:
        return "K4 tf32x3"
    if "convlstm_wgmma" in name:
        return "K4 wgmma"
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


def program_summary():
    """The port's tracer's summary of the last profiled stretch, or None for
    a port without a tracer."""
    try:
        from lstm_unet_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.summary()


def profile_config(frames, dtype: str, fused: bool) -> dict:
    # the port on sys.path (this checkout's or --root's, set by main)
    from lstm_unet_tpu_torch.config import InferenceParams, default_net_kernel_params
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, cast_params_for_inference

    quant = dict(dtype="bfloat16", quant="int8") if dtype == "int8" else dict(dtype=dtype)
    cfg = ModelConfig.make(default_net_kernel_params(), fused_cell=fused, **quant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ULSTMnet2D(cfg, generator=gen, device="cuda")
    if dtype != "int8":  # int8: the engine quantizes the f32 weights
        cast_params_for_inference(model, cfg.compute_dtype)
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
    by_op = {}
    for e in prof.key_averages():
        self_ms = getattr(e, "self_device_time_total", None)
        if self_ms is None:
            self_ms = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == DeviceType.CPU and self_ms > 0:
            by_op[e.key] = (self_ms / 1e3 / PROFILED, e.count // PROFILED)
    return dict(ms_median=float(np.median(times)), ms=times, profiled_wall_ms=wall,
                kernel_ms=busy, busy_share=busy / wall, by_kind=by_kind,
                program=program_summary(),
                by_op=dict(sorted(by_op.items(), key=lambda t: -t[1][0])),
                kernels_per_frame=sum(e.count for e in kernels) / PROFILED,
                top=[(e.key[:100], e.device_time_total / 1e3 / PROFILED, e.count // PROFILED)
                     for e in kernels[:8]])


ASYNC_WARM, ASYNC_STEADY, ASYNC_PROFILED = 3, 32, 8


def async_config(frames, dtype: str, fused: bool) -> dict:
    """``--mode async`` for one configuration (int8: calibrated scales)."""
    from lstm_unet_tpu_torch.config import InferenceParams, default_net_kernel_params
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine, calibrate_act_scales
    from lstm_unet_tpu_torch.models import (ModelConfig, ULSTMnet2D, cast_params_for_inference,
                                            quantize_model_int8)

    quant = dict(dtype="bfloat16", quant="int8") if dtype == "int8" else dict(dtype=dtype)
    cfg = ModelConfig.make(default_net_kernel_params(), fused_cell=fused, **quant)
    model = ULSTMnet2D(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    if dtype == "int8":
        scales = calibrate_act_scales(model, [f.astype(np.float32) for f in frames[:4]])
        quantize_model_int8(model, scales, float_dtype=cfg.compute_dtype)
    else:
        cast_params_for_inference(model, cfg.compute_dtype)
    from lstm_unet_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = StreamingInferenceEngine(model, InferenceParams(dtype=dtype), "cuda")
    for f in frames[:ASYNC_WARM]:
        engine.step_batch_async(f[None])
    torch.cuda.synchronize()
    before = kernels.counts()
    host = []
    t0 = time.perf_counter()
    for f in frames[ASYNC_WARM:ASYNC_WARM + ASYNC_STEADY]:
        t = time.perf_counter()
        engine.step_batch_async(f[None])
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) * 1e3 / ASYNC_STEADY
    hand = sum(v["kernel"] - before[k]["kernel"] for k, v in kernels.counts().items())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[ASYNC_WARM + ASYNC_STEADY:]:
            engine.step_batch_async(f[None])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ASYNC_PROFILED
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / ASYNC_PROFILED
    return dict(host_ms_median=float(np.median(host)), host_ms=host, steady_ms=steady,
                profiled_wall_ms=wall, kernel_ms=busy, busy_share=busy / wall,
                kernels_per_frame=sum(e.count for e in kernels) / ASYNC_PROFILED,
                hand_kernels_per_frame=hand / ASYNC_STEADY,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


MEMORY_CONFIGS = (("B = 1", 1, {}), ("TTA 'd4' (8 lanes)", 1, dict(tta=True, tta_mode="d4")),
                  ("B = 4", 4, {}))


def memory_config(frames, lanes: int, kw: dict, capture: bool) -> dict:
    """``--mode memory``: peak device memory of a bf16 fused stream."""
    from lstm_unet_tpu_torch.config import InferenceParams, default_net_kernel_params
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, cast_params_for_inference

    cfg = ModelConfig.make(default_net_kernel_params(), dtype="bfloat16", fused_cell=True)
    model = ULSTMnet2D(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    cast_params_for_inference(model, cfg.compute_dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = StreamingInferenceEngine(model, InferenceParams(dtype="bfloat16", **kw), "cuda")
    engine.capture = capture
    t0 = time.perf_counter()
    for f in frames[:6]:
        engine.step_batch_async(np.stack([np.roll(f, 64 * i, 0) for i in range(lanes)]))
    torch.cuda.synchronize()
    return dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                weights_gib=weights / 2 ** 30, seconds=time.perf_counter() - t0,
                captured=bool(getattr(getattr(engine, "_step", None), "captured", False)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dtypes", default="bfloat16,int8,float32")
    ap.add_argument("--root", default=HERE, help="profile the port of this checkout")
    ap.add_argument("--mode", choices=("breakdown", "async", "memory"), default="breakdown")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from lstm_unet_tpu_torch.io.synthetic import make_cell_sequence
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, "| torch", torch.__version__, "| port at", root, flush=True)
    out = {"card": card, "root": root}
    if args.mode == "async":
        frames, _ = make_cell_sequence(num_frames=ASYNC_WARM + ASYNC_STEADY + ASYNC_PROFILED,
                                       height=512, width=512, num_cells=40, seed=0)
        for dtype, fused in (("bfloat16", True), ("int8", False)):
            r = out[f"async {dtype} fused={fused}"] = async_config(frames, dtype, fused)
            print(f"== async {dtype} fused={fused}: host ms until step_batch_async returns "
                  f"{r['host_ms_median']:.3f} (median of {ASYNC_STEADY}), steady "
                  f"{r['steady_ms']:.3f} ms/frame over {ASYNC_STEADY} frames ending in one "
                  f"synchronize, busy {100 * r['busy_share']:.1f}% over {ASYNC_PROFILED} "
                  f"({r['kernel_ms']:.3f} of {r['profiled_wall_ms']:.3f} ms/frame), "
                  f"{r['kernels_per_frame']:.0f} kernels/frame ({r['hand_kernels_per_frame']:.0f}"
                  f" hand kernels), peak {r['peak_gib']:.3f} GiB", flush=True)
            torch.cuda.empty_cache()
        print(json.dumps(out))
        return
    if args.mode == "memory":
        frames, _ = make_cell_sequence(num_frames=6, height=512, width=512, num_cells=40,
                                       seed=0)
        for name, lanes, kw in MEMORY_CONFIGS:
            for capture in (False, True):
                r = out[f"memory {name} capture={capture}"] = memory_config(frames, lanes, kw,
                                                                            capture)
                print(f"== memory bf16 fused {name}, capture={capture} (captured: "
                      f"{r['captured']}): peak {r['peak_gib']:.3f} GiB allocated "
                      f"(weights {r['weights_gib']:.3f} GiB), 6 frames in "
                      f"{r['seconds']:.2f} s", flush=True)
                torch.cuda.empty_cache()
        print(json.dumps(out))
        return
    frames, _ = make_cell_sequence(num_frames=WARM + TIMED + PROFILED, height=512,
                                   width=512, num_cells=40, seed=0)
    for dtype in args.dtypes.split(","):
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
            print("   kernels launched by PyTorch ops (ms/frame, calls/frame):",
                  {k: (round(v[0], 3), v[1]) for k, v in list(r["by_op"].items())[:14]})
            if r["program"]:
                print("   program spans (device ms/frame; host ms p50):",
                      {k: (round(v.get("device_ms", 0.0), 3), round(v.get("host_ms_p50", 0.0), 3))
                       for k, v in r["program"]["spans"].items()})
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
