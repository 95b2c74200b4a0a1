"""What the port's tracer (``lstm_unet_tpu_torch/utils/trace.py``) costs when
it is on, and where each kind of kernel time falls among its spans, in the
benchmark's cells, on one NVIDIA GPU.

    python scripts/trace_report.py [--workloads stream-int8-b1,stream-int8-dist,train-bf16-b5t7]
                                   [--seconds 4] [--rounds 2] [--seed 1] [--by_launch SPAN]

Each cell is built as ``portbench/harness`` builds it (the seeded sequence
or batches, the weights, int8 calibration, the engine or the train step,
the first frames or steps), then streamed or trained in windows of
``--seconds``:

- **cost**: tracer off and on in turns (off, on, on, off, ... for
  ``--rounds``), switched by ``trace.start()`` / ``trace.stop()``: units
  (frames or steps) a second of each window, and the traced windows' median
  over the untraced ones';
- **split**: one more window under ``torch.profiler`` (which turns the
  tracer on): every kernel the profiler saw, by ``portbench/harness/
  arith.py::kind``, in the innermost device span holding its midpoint, in
  ms a unit, the spans placed among the kernels by the stamps' own kernels
  (``trace.on_profiler_clock``). Kernels outside every span (the upload,
  the output copies, the batch) fall under ``outside``. With ``--by_launch
  SPAN`` (a regular expression), the spans it matches are split by launch
  as well (``split_by_launch``): each kernel under its place among the
  span's launches, its kind and its name, so two launches of one kernel
  (an x-conv and an h-conv) stay apart;
- **launches**: each kernel's launches a unit in that window
  (``ops.kernels.counts()``, replays included), e.g. the int8 streams'
  ``conv2d_int8_wgmma_gates`` (4 a frame) and ``lstm_gate_update`` (0);
- **busy**: the card's busy ms a unit inside each span
  (``trace.busy_ms``, what the benchmark's readers read), the busy ms a
  unit of the whole window, and the share of it that the cell's three
  readers add up to (``readers_over_busy``).

One JSON line a cell, with the card's name and power limit, and the
recording's ``trace.summary()``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def window(harness, run, seconds: float, traced: bool) -> float:
    """Units a second of one window: frames, or training steps."""
    from lstm_unet_tpu_torch.utils import trace

    torch.cuda.synchronize()
    if traced:
        trace.start()
    t0 = time.perf_counter()
    done = harness.loop(run, seconds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if traced:
        trace.stop()
    return done.get("frames", done.get("steps")) / dt


def split(kernels: List[tuple], units: int, by_launch: str = "") -> Dict:
    """``kernels`` [(name, start us, end us)] of the profile into the
    innermost device span holding each one's midpoint, the spans placed
    among them by ``trace.on_profiler_clock``: {span: {kind: ms a unit}}.
    Kernels outside every span fall under ``outside``. In the spans whose
    name matches the pattern ``by_launch``, each kernel is keyed ``"<n>.
    <kind>: <name>"`` instead, n its place among the launches of one
    instance of the span."""
    from lstm_unet_tpu_torch.utils import trace
    from portbench.harness.arith import kind

    placed = trace.on_profiler_clock(kernels) or []
    out: Dict[str, Dict[str, float]] = {}
    order = sorted(placed, key=lambda s: s[1])
    stack: List[list] = []  # the spans holding the sweep's point, innermost last
    launches: Dict[int, int] = {}  # launches so far in each instance of a by_launch span
    pattern = re.compile(by_launch) if by_launch else None
    i = 0
    for name, t0, t1 in sorted(kernels, key=lambda k: k[1] + k[2]):
        if trace.STAMP_KERNEL in name:
            continue
        mid = (t0 + t1) / 2
        while i < len(order) and order[i][1] <= mid:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        row = out.setdefault(stack[-1][0] if stack else "outside", {})
        key = kind(name)
        if stack and pattern is not None and pattern.fullmatch(stack[-1][0]):
            n = launches[id(stack[-1])] = launches.get(id(stack[-1]), 0) + 1
            key = f"{n}. {key}: {name}"
        row[key] = row.get(key, 0.0) + (t1 - t0) / 1e3 / units
    return out


def busy_a_unit(kernels: List[tuple], units: int) -> float:
    """The card's busy ms a unit over the whole profile: the union of every
    operation's interval but the stamps'."""
    from lstm_unet_tpu_torch.utils import trace

    merged: List[List[float]] = []
    for a, b in sorted(k[1:] for k in kernels if trace.STAMP_KERNEL not in k[0]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e3 / units


def profiled(harness, run, seconds: float, by_launch: str = "") -> Dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lstm_unet_tpu_torch.ops import kernels as launches
    from lstm_unet_tpu_torch.utils import trace

    torch.cuda.synchronize()
    before = launches.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        harness.loop(run, seconds)
        torch.cuda.synchronize()
    after = launches.counts()
    summary = trace.summary()
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    units = summary["units"]
    ran = {k: (after[k]["kernel"] - before[k]["kernel"]) / units for k in after}
    return {"summary": summary, "split": split(kernels, units),
            "launches_a_unit": {k: v for k, v in ran.items() if v},
            "split_by_launch": split(kernels, units, by_launch) if by_launch else None,
            "busy_ms": trace.busy_ms(kernels), "busy_ms_a_unit": busy_a_unit(kernels, units),
            "stamps_seen": sum(trace.STAMP_KERNEL in k[0] for k in kernels)}


def report(name: str, seconds: float, rounds: int, seed: int, by_launch: str = "") -> dict:
    from lstm_unet_tpu_torch.utils import trace
    from portbench.harness import cell

    c = cell.load(name)
    device = torch.device("cuda", 0)
    if c.mode == "stream":
        from portbench.harness import stream as harness

        run = harness.Stream(c, seed, device)
    else:
        from portbench.harness import train as harness

        run = harness.Training(c, seed, device)
    harness.loop(run, 1.0)
    rates = {False: [], True: []}
    for r in range(rounds):
        for traced in ((False, True) if r % 2 == 0 else (True, False)):
            rates[traced].append(window(harness, run, seconds, traced))
    off, on = statistics.median(rates[False]), statistics.median(rates[True])
    out = {"workload": name, "untraced_per_s": rates[False], "traced_per_s": rates[True],
           "traced_over_untraced": on / off}
    if c.mode == "train":
        out["untraced_ms_a_step"] = 1e3 / off
        out["traced_ms_a_step"] = 1e3 / on
    got = profiled(harness, run, seconds, by_launch)
    summary = got["summary"]
    out["summary"] = {
        "units": summary["units"],
        "spans": {k: {a: round(b, 4) for a, b in v.items()} for k, v in summary["spans"].items()},
        "counters": {k: v for k, v in summary["counters"].items() if k != "kernels"}}
    out["split"] = got["split"]
    out["launches_a_unit"] = got["launches_a_unit"]
    if by_launch:
        out["split_by_launch"] = {k: v for k, v in got["split_by_launch"].items()
                                  if re.fullmatch(by_launch, k)}
    out["busy_ms"] = got["busy_ms"]
    out["busy_ms_a_unit"] = got["busy_ms_a_unit"]
    out["stamps_seen"] = got["stamps_seen"]
    phases = (("model", "postprocess", "step") if c.mode == "stream" else
              ("train.forward", "train.backward", "train.optimizer"))
    busy = got["busy_ms"] or {}
    parts = [busy.get(p, 0.0) for p in phases]
    if c.mode == "stream":  # engine_device_ms.stream: step less model and postprocess
        parts[2] -= parts[0] + parts[1]
    out["readers_over_busy"] = sum(parts) / got["busy_ms_a_unit"]
    trace.stop()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default="stream-int8-b1,stream-int8-dist,train-bf16-b5t7")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--by_launch", default="",
                    help="a regular expression of spans to split by launch as well, e.g. "
                         "'encoder/[0-9]+/lstm/[0-9]+'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name in args.workloads.split(","):
        out = report(name, args.seconds, args.rounds, args.seed, args.by_launch)
        out["card"] = card
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
