"""The traced run: spans, the profiler's device trace and what is read from them.

The harness records spans of its own around each call into the program
(``torch.profiler.record_function``, only in the profiled sub-window of a
``--trace 1`` run). :func:`reduce` turns a finished profile into the device
operations (each kernel, copy and fill with its device time and interval),
the busy time (the union of those intervals), the top operations by
:func:`arith.kind` and the longest idle gaps named by the span the host was
in when the device went idle.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import arith

# the longest profiled sub-window of a traced run: long enough for a steady
# busy share, short enough that reading the trace stays well inside a run
PROFILED_S = 4.0


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Trace:
    ops: List[Tuple[str, float, float, float]]  # name, seconds, start us, end us
    busy_s: float
    device_ops: List[List]
    idle_gaps: List[List]


@dataclass
class TracedRun:
    """What a per-layer metric's reader gets (``portbench/metrics/*.py``)."""

    cell: object
    units: int                      # frames or steps in the profiled sub-window
    window_s: float                 # its length, host clock
    trace: Trace
    rate: float                     # frames/s or steps/s of the unprofiled stretch
    lanes: int = 1                  # model lanes a step
    host_issue_s: List[float] = field(default_factory=list)
    postprocess_ms: Optional[float] = None

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds one of
        ``needles``."""
        return sum(s for n, s, _, _ in self.trace.ops if any(k in n for k in needles))


SPANS = ("step_batch_async", "labels_to_host", "wait", "batch_put", "train_step", "loss_read")


def reduce(prof) -> Trace:
    from torch.autograd import DeviceType

    ops, host = [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name in SPANS:  # the harness's own; the profiler shows each on both timelines
            if e.device_type != DeviceType.CUDA:
                host.append((t0, t1, e.name))
        elif e.device_type == DeviceType.CUDA:
            ops.append((e.name, (t1 - t0) / 1e6, t0, t1))
    merged: List[List[float]] = []
    for _, _, t0, t1 in sorted(ops, key=lambda o: o[2]):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) / 1e6
    by_kind: Dict[str, float] = {}
    for name, s, _, _ in ops:
        by_kind[arith.kind(name)] = by_kind.get(arith.kind(name), 0.0) + s
    device_ops = sorted(([k, v] for k, v in by_kind.items()), key=lambda kv: -kv[1])[:10]
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        what = [n for h0, h1, n in host if h0 <= mid <= h1]
        gaps.append([what[-1] if what else "other", (b - a) / 1e6])
    idle_gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    return Trace(ops, busy, device_ops, idle_gaps)
