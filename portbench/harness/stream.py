"""Streaming cells: one client streams one sequence through the engine.

Set-up: the seeded sequence (raw uint16 frames, made on the host), the
weights on the device (made from the traffic's ``model_seed``: one served
model, whatever the run's seed, which picks the sequence; without it from
the run's seed), the model as it serves (int8: calibrated on the
sequence's first frames and quantised), the engine, the sequence's first
``check_frames`` frames one by one (the first captures both CUDA graphs of
the step, the others replay them in turn; their outputs are what the check
reads) and ``WARM_S`` seconds of the window's loop.
The window is a closed loop, as ``engine/infer.py::_stream`` drives the
engine without its TIFF reader and writer: hand frame t to
``step_batch_async``, start its labels' copy to pinned host memory, then
wait for frame t-1's labels; the frames are cycled, the LSTM state carried
across the wrap. A frame's latency runs from its hand-off to the moment its
labels are seen on the host.

A ``--trace 1`` run streams its window unprofiled (the rate and the
host's issue time per frame) but for its last half or its last
``trace.PROFILED_S`` seconds, whichever is shorter, which it profiles, both
stretches starting and ending with nothing in flight, so each holds whole
frames.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, port, trace, traffic
from .weights import FIT_STREAM, HEAD, fit_head, make_weights
from ..reference import model as ref_model
from ..reference import postprocess as ref_post


# set-up ends with this many seconds of the window's own loop: the card's
# clocks and the host's caches reach the state the window holds
WARM_S = 1.0


def settle() -> None:
    """After set-up: one full collection, then every object alive moves to
    the collector's permanent generation, so that a collection in the
    window walks only what the window allocates."""
    gc.collect()
    gc.freeze()


def normalised(raw: np.ndarray, device) -> torch.Tensor:
    """``[B, H, W]`` raw -> ``[B, 1, H, W]`` f32 on ``device``."""
    x = np.stack([traffic.percentile_normalize(f) for f in raw])
    return torch.from_numpy(x).to(device)[:, None]


def model_seed(cell, seed: int) -> int:
    """The seed the served model's weights are made from: the traffic's
    ``model_seed`` where it names one, else the run's."""
    return cell.traffic.get("model_seed", seed)


def serving_weights(cell, seed: int, frames: np.ndarray, device, head=None):
    """The cell's weights with the head fitted on the sequence's first
    frames (``harness/weights.py::fit_head``), or with ``head`` when it was
    fitted already."""
    cfg = cell.config
    weights = make_weights(cfg, model_seed(cell, seed), device)
    if head is None:
        head = fit_head(cfg, weights, [normalised(frames[i:i + 1], device)
                                       for i in range(min(FIT_STREAM, len(frames)))])
    weights.update({k: v.to(device) for k, v in head.items()})
    return weights


class Stream:
    """The engine of a cell, fed the cell's frames in order, cycling."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.frames, _ = traffic.sequence(tr, seed)
        self.lanes = tr.get("lanes", 1)
        weights = serving_weights(cell, seed, self.frames, device)
        self.head = {k: weights[k].clone() for k in HEAD}
        if device.type == "cuda":  # the peak of the program's own set-up and window
            torch.cuda.reset_peak_memory_stats(device)
        model = port.serving_model(cell.config, weights,
                                   list(self.frames[:tr["calibration_frames"]]), device)
        del weights
        self.ip = port.inference_params(cell.config, tr)
        self.engine = port.engine(model, self.ip, device)
        self.t = 0

    def batch(self, t: int) -> np.ndarray:
        n = len(self.frames)
        return np.stack([self.frames[(t + lane * n // self.lanes) % n]
                         for lane in range(self.lanes)])

    def hand_off(self):
        """(labels, probabilities) of the next frame, on the device."""
        out = self.engine.step_batch_async(self.batch(self.t))
        self.t += 1
        return out


class HostLabels:
    """Two pinned host buffers for the labels, used in turn: frame t's copy
    is started while frame t-1's labels are read."""

    def __init__(self):
        self.bufs = [None, None]
        self.turn = 0

    def copy(self, labels: torch.Tensor):
        """Start copying ``labels`` to the host: (host tensor, event or None)."""
        if labels.device.type != "cuda":
            return labels.clone(), None
        buf = self.bufs[self.turn]
        if buf is None or buf.shape != labels.shape:
            buf = self.bufs[self.turn] = torch.empty(labels.shape, dtype=labels.dtype,
                                                     pin_memory=True)
        self.turn = 1 - self.turn
        buf.copy_(labels, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev


def loop(stream: Stream, seconds: float, traced: bool = False) -> Dict:
    """Stream for ``seconds`` (two frames at least), then wait for the last
    labels. Returns the frames completed, the window's length, each frame's
    latency and host issue time, and the last frame's labels and
    probabilities."""
    lat: List[float] = []
    issue: List[float] = []
    pending = None
    host_labels = HostLabels()
    t0 = time.perf_counter()
    stop = t0 + seconds
    while True:
        if time.perf_counter() >= stop and len(issue) >= 2:
            break
        with trace.span("step_batch_async", traced):
            t_hand = time.perf_counter()
            labels, probs = stream.hand_off()
            issue.append(time.perf_counter() - t_hand)
        with trace.span("labels_to_host", traced):
            host, ev = host_labels.copy(labels)
        if pending is not None:
            with trace.span("wait", traced):
                if pending[1] is not None:
                    pending[1].synchronize()
                lat.append(time.perf_counter() - pending[2])
        pending = (host, ev, t_hand, probs)
    with trace.span("wait", traced):
        if pending[1] is not None:
            pending[1].synchronize()
        lat.append(time.perf_counter() - pending[2])
    window = time.perf_counter() - t0
    return dict(frames=len(lat), window_s=window, latency_s=lat, issue_s=issue,
                last_labels=pending[0].numpy().copy(), last_probs=pending[3])


# ------------------------------------------------------------ the reference


def reference_params(cell) -> Dict:
    p = dict(ref_post.DEFAULTS)
    p.update(cell.traffic.get("inference", {}))
    return p


def _variants(x: torch.Tensor, tta: bool) -> torch.Tensor:
    """``[B, H, W]`` -> lanes ``[n_var * B, 1, H, W]``, variant-major."""
    v = [x, x.flip(1), x.flip(2), x.flip(1, 2)] if tta else [x]
    return torch.cat(v)[:, None]


def reference_probs(cell, logits: torch.Tensor) -> torch.Tensor:
    """``[n_var * B, 3, H, W]`` logits -> ``[B, H, W, 3]`` probabilities,
    TTA variants transformed back and their probabilities averaged."""
    p = torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    if not cell.traffic.get("inference", {}).get("tta"):
        return p
    v = p.reshape((4, -1) + p.shape[1:])
    return torch.stack([v[0], v[1].flip(1), v[2].flip(2), v[3].flip(1, 2)]).mean(dim=0)


class ReferenceStream:
    """The plain reference of a streaming cell: the same weights, int8
    scales from its own calibration on the same frames."""

    def __init__(self, cell, seed: int, frames: np.ndarray, device, precision: str = "",
                 head=None):
        ref_model.no_tf32()
        self.cell, self.device = cell, device
        cfg = cell.config
        weights = serving_weights(cell, seed, frames, device, head)
        self.head = {k: weights[k] for k in HEAD}
        self.frames = frames
        quant = cfg["quant"] if cfg["quant"] != "none" else "float"
        precision = precision or quant
        absmax = None
        if precision in ref_model.Q_LEVELS:
            cal = ref_model.Reference(cfg, weights, "float")
            absmax = cal.calibrate([normalised(frames[i:i + 1], device)
                                    for i in range(cell.traffic["calibration_frames"])])
        self.model = ref_model.Reference(cfg, weights, precision, absmax)
        self.tta = bool(cell.traffic.get("inference", {}).get("tta"))
        self.params = reference_params(cell)

    @torch.no_grad()
    def step(self, state: Optional[List], raw: np.ndarray):
        """(new state, logits) of one step of ``raw [B, H, W]`` frames from
        ``state`` (the reference's, NCHW, or None for zeros)."""
        x = _variants(normalised(raw, self.device)[:, 0], self.tta)
        if state is None:
            state = self.model.init_state(x.shape[0], x.shape[2], x.shape[3], self.device)
        return self.model.step(state, x)

    def labels(self, logits: torch.Tensor) -> np.ndarray:
        probs = reference_probs(self.cell, logits).cpu().numpy()
        return np.stack([ref_post.postprocess(p, self.params) for p in probs])


def compare(ref: ReferenceStream, raws: List[np.ndarray], outputs: List) -> Dict[str, float]:
    """The check's numbers: the reference streams ``raws`` from the zero
    state, as the program did, beside the program's ``outputs`` (labels,
    probabilities) of each of those frames."""
    gaps, mismatch, state = [], [], None
    for raw, (labels, probs) in zip(raws, outputs):
        state, logits = ref.step(state, raw)
        gaps.append(check.rel_gap(probs, reference_probs(ref.cell, logits)))
        mine = probs.float().cpu().numpy()
        mismatch += [ref_post.label_mismatch(a, ref_post.postprocess(p, ref.params))
                     for a, p in zip(labels, mine)]
    return {"prob_gap": max(gaps), "label_gap": max(mismatch)}


# ------------------------------------------------------------ a run


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict:
    stream = Stream(cell, seed, device)
    outputs = []
    for _ in range(cell.traffic["check_frames"]):
        labels, probs = stream.hand_off()
        outputs.append((labels.cpu().numpy(), probs.cpu()))
    raws = [stream.batch(t) for t in range(len(outputs))]
    loop(stream, WARM_S)
    setup_s = time.perf_counter() - t_start
    settle()
    with torch.inference_mode():
        port.clear_loop_rounds()
    counted_from = stream.t

    out: Dict = {"setup_s": setup_s}
    if not traced:
        w = loop(stream, seconds)
    else:
        profiled = min(seconds / 2, trace.PROFILED_S)
        w = loop(stream, seconds - profiled)
        out["rate"] = w["frames"] / w["window_s"]
        out["host_issue_s"] = w["issue_s"]
        if device.type == "cuda":
            torch.cuda.synchronize()
        with trace.profiler() as prof:
            t0 = time.perf_counter()
            w = loop(stream, profiled, traced=True)
            if device.type == "cuda":
                torch.cuda.synchronize()
            out["profiled_s"] = time.perf_counter() - t0
        out["trace"] = trace.reduce(prof)
    out.update(frames=w["frames"], window_s=w["window_s"], latency_s=w["latency_s"])
    lat = np.sort(np.asarray(w["latency_s"])) * 1e3
    out["latency_ms"] = {q: float(np.percentile(lat, p)) for q, p in
                         (("p50", 50), ("p90", 90), ("p99", 99), ("max", 100))}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    rounds = port.loop_rounds(device) if device.type == "cuda" else None
    frames_run = stream.t - counted_from
    if traced and device.type == "cuda":
        out["postprocess_ms"] = postprocess_ms(w["last_probs"][0].contiguous(),
                                               port.postprocess_kwargs(stream.ip))
    head, frames = stream.head, stream.frames
    del stream, w["last_probs"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ReferenceStream(cell, seed, frames, device, head=head)
    out["numbers"] = compare(ref, raws, outputs)
    out["instances"] = int(w["last_labels"].max())
    if rounds is not None:
        out["rounds_per_frame"] = {k: v / max(frames_run, 1) for k, v in rounds.items()}
    return out


def postprocess_ms(probs: torch.Tensor, kwargs: Dict, replays: int = 50) -> float:
    """Device ms of ``postprocess_frame`` on ``probs`` with the cell's
    parameters, captured as a CUDA graph and replayed, timed by events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        port.postprocess_frame(probs, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        port.postprocess_frame(probs, **kwargs)
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / replays
