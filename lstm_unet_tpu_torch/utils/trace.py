"""The port's tracer: host spans, device stamps and counters, one recording at a time.

**On and off.** The tracer is on while a ``torch.profiler`` session is
active and between :func:`start` and :func:`stop` (for operators and
tests). The program asks once a unit of work (:func:`check`, at the top of
``StreamingInferenceEngine.step_batch_async`` and of ``make_train_step``'s
step). Off, that check is the whole cost: no span object is made, no list
grows and no kernel launches. Each switch from off to on starts a new
recording, which replaces the last; so a profiled stretch records exactly
itself. A recording that a profiler started ends when that profiler has
exited, which the tracer notices at the next check, collector pause,
count or read-out.

**Host spans** (:func:`span`): a name, start and end on the profiler's
clock (Unix-epoch nanoseconds, as its events' ``start_ns`` and
``trace_start_ns``), the enclosing span and the unit (frame or step) it
belongs to, kept in memory until the recording is read.

**Device stamps** (:func:`stamp`, :func:`segment`): device time inside a
CUDA graph, where no Python runs. While :func:`stamping` is entered, each
stamp's begin and end launch a one-thread kernel (``csrc/trace_stamp.cu``)
that writes ``(span id, begin | end, %globaltimer)`` into a ring on the
device, whose index lives on the device too, so every replay of a graph
that holds stamps writes new slots. The ring (:data:`RING_STAMPS` slots, 1
MiB a card) is made before the first capture that holds stamps and kept;
its overflow is counted and reported. Nothing reads the card while the
tracer is on: the ring is read once, after the recording ends, with one
synchronize, and converted to the host clock by one anchor pair taken then.
On the CPU a stamp is a host clock reading, so the same code runs there.
The engine stamps only while ``engine/graph.py::CompiledStep`` captures a
traced twin of the step, or runs it eagerly with the tracer on; the
training step while the tracer is on. Under autograd, :func:`segment` also
marks the segment's backward with an identity function: its backward
stamps ``<segment>.backward`` when the gradient reaches the segment's
outputs, up to the next marker or the end of the enclosing stamp; a remat
recompute inside the backward is stamped ``recompute``.

**Counters.** A recording counts the collector's pauses (each also a
host span ``gc``), the graph captures made while it ran (a shape changed
inside it), its stamps and their overflow; :func:`summary` gives them
beside the kernels' launch counts and the graph counts
(``ops/kernels/__init__.py``).

**Read-out.** :func:`summary` (elapsed device ms and host ms by span),
:func:`spans` (every span, with its self time), :func:`on_profiler_clock`
and :func:`busy_ms` (the device stamps placed among a profile's kernels by
the stamps' own kernels, and the card's busy time inside each: what the
benchmark's readers read, since a stamp's elapsed time also holds the
card's idle while the host is late) and :func:`export_chrome` (the
program's spans written into a profiler's Chrome trace, as rows of their
own).
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

RING_STAMPS = 1 << 16  # slots of a card's ring: a 4 s window at 120 frames/s makes ~20 k

_IDS: Dict[str, int] = {}   # span name -> id a stamp carries
_NAMES: List[str] = []
STAMP_KERNEL = "trace_stamp_kernel"  # the stamps' kernel, as a profiler names it


def _sid(name: str) -> int:
    sid = _IDS.get(name)
    if sid is None:
        sid = _IDS[name] = len(_NAMES)
        _NAMES.append(name)
    return sid


# ---------------------------------------------------------------- recordings


class _Recording:
    def __init__(self, by_profiler: bool):
        self.by_profiler = by_profiler
        self.live = True
        self.t0, self.t1 = time.time_ns(), 0
        self.units = 0
        self.host: List[list] = []        # [name, start ns, end ns, parent, unit]
        self.stack: List[int] = []        # open host spans
        self.host_stamps: List[tuple] = []  # (tag, ns) of stamps taken on the host clock
        self.stamps: List[tuple] = []     # every stamp (tag, ns) in order, once read out
        self.device: Optional[List[list]] = None  # device spans, once read out
        self.device_at: List[tuple] = []  # each device span's (begin, end) in ``stamps``
        self.counts = {"gc_pauses": 0, "gc_ms": 0.0, "graph_captures": 0, "stamps": 0,
                       "stamp_overflow": 0, "unmatched_stamps": 0}
        self.gc_t0 = 0


_REC: Optional[_Recording] = None
_manual = False     # between start() and stop()
_prof_seen = False  # the profiler's state at the last check
_hooked = False     # _on_gc is in gc.callbacks


def _profiler_on() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


def _live() -> Optional[_Recording]:
    """The live recording; one whose profiler has exited is ended here."""
    rec = _REC
    if rec is None or not rec.live:
        return None
    if rec.by_profiler and not _manual and not _profiler_on():
        _end(rec, unhook=False)  # maybe inside a collector callback: the list stays
        return None
    return rec


def _on_gc(phase: str, info) -> None:
    rec = _live()
    if rec is None:
        return
    now = time.time_ns()
    if phase == "start":
        rec.gc_t0 = now
    elif rec.gc_t0:
        rec.host.append(["gc", rec.gc_t0, now, rec.stack[-1] if rec.stack else -1,
                         rec.units - 1])
        rec.counts["gc_pauses"] += 1
        rec.counts["gc_ms"] += (now - rec.gc_t0) / 1e6
        rec.gc_t0 = 0


def _begin(by_profiler: bool) -> None:
    global _REC, _hooked
    if _REC is not None and _REC.live:
        _end(_REC)
    _REC = _Recording(by_profiler)
    for ring in _RINGS.values():  # queued on the stream; nothing waits
        ring.index.zero_()
    if not _hooked:
        gc.callbacks.append(_on_gc)
        _hooked = True


def _unhook() -> None:
    global _hooked
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _hooked = False


def _end(rec: _Recording, unhook: bool = True) -> None:
    rec.live = False
    rec.t1 = time.time_ns()
    rec.stack.clear()
    if unhook:
        _unhook()


def check() -> bool:
    """Whether the tracer is on for the unit of work that starts now; starts
    a recording at a switch from off to on and ends one whose profiler has
    exited. Called once a unit, at its top."""
    global _prof_seen
    prof = _profiler_on()
    switched_on, _prof_seen = prof and not _prof_seen, prof
    rec = _REC
    live = rec is not None and rec.live
    if live and not (prof or _manual):
        _end(rec)
        live = False
    if prof and (switched_on or not live):
        _begin(by_profiler=True)
    if not (prof or _manual):
        if _hooked:  # a recording a collector pause ended
            _unhook()
        return False
    _REC.units += 1
    return True


def start() -> None:
    """Turn the tracer on: a new recording, which :func:`stop` ends."""
    global _manual, _prof_seen
    _manual = True
    _prof_seen = _profiler_on()
    _begin(by_profiler=False)


def stop() -> None:
    """Turn the tracer off (unless a profiler is active) and end the recording."""
    global _manual
    _manual = False
    if _REC is not None and _REC.live:
        _end(_REC)
    if _hooked:
        _unhook()


def _ended() -> Optional[_Recording]:
    """The last recording, ended first if its profiler has exited; None
    while it still records."""
    rec = _REC
    if rec is None:
        return None
    if rec.live:
        if not (rec.by_profiler and not _profiler_on() and not _manual):
            return None
        _end(rec)
    if _hooked and not (_manual or _profiler_on()):
        _unhook()
    if rec.device is None:
        _read_out(rec)
    return rec


# ---------------------------------------------------------------- host spans


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "i")

    def __init__(self, rec: _Recording, name: str):
        self.rec = rec
        self.i = len(rec.host)
        rec.host.append([name, 0, 0, rec.stack[-1] if rec.stack else -1, rec.units - 1])

    def __enter__(self):
        self.rec.stack.append(self.i)
        self.rec.host[self.i][1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.host[self.i][2] = time.time_ns()
        if rec.stack and rec.stack[-1] == self.i:
            rec.stack.pop()
        return False


def span(name: str):
    """A host span named ``name`` while a recording is live, else a shared
    context that does nothing."""
    rec = _REC
    if rec is None or not rec.live:
        return _NULL
    return _Span(rec, name)


# ---------------------------------------------------------------- device stamps


class _Ring:
    """A card's ring of stamps and its index, made once and kept (graphs
    that hold stamps hold their addresses)."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.inference_mode(False):  # zeroed in place in and out of inference mode
            self.buf = torch.zeros(RING_STAMPS, 2, dtype=torch.int64, device=device)
            self.index = torch.zeros(1, dtype=torch.int64, device=device)
            self.anchor = torch.zeros(1, 2, dtype=torch.int64, device=device)
            self.anchor_index = torch.zeros(1, dtype=torch.int64, device=device)
        self._entry = None

    def stamp(self, tag: int, into: Optional[tuple] = None, capacity: int = RING_STAMPS) -> None:
        """Launch one stamp on the card's current stream, into the ring (or
        ``into``: the pointers of a buffer of ``capacity`` slots and of its
        index). The entry and pointers are bound once, the stream read raw."""
        if self._entry is None:
            from ..ops.kernels import _build

            self._check = _build.check
            self._entry = _build.library().lut_trace_stamp
            self._ptrs = self.buf.data_ptr(), self.index.data_ptr()
            raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
            self._stream = raw or (lambda i: torch.cuda.current_stream(i).cuda_stream)
        card = self.device.index
        with (contextlib.nullcontext() if torch.cuda.current_device() == card
              else torch.cuda.device(card)):
            err = self._entry(*(into or self._ptrs), capacity, tag, self._stream(card))
        self._check(err, "lut_trace_stamp")

    def read(self):
        """(stamps as [(tag, host ns)], stamps made): one synchronize, then the
        anchor pair of the least round trip of five."""
        torch.cuda.synchronize(self.device)
        made = int(self.index.item())
        rows = self.buf[:min(made, RING_STAMPS)].cpu().tolist()
        best = None
        for _ in range(5):
            self.anchor_index.zero_()
            torch.cuda.synchronize(self.device)
            t0 = time.time_ns()
            self.stamp(0, (self.anchor.data_ptr(), self.anchor_index.data_ptr()), 1)
            torch.cuda.synchronize(self.device)
            t1 = time.time_ns()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, (t0 + t1) // 2 - int(self.anchor[0, 1].item()))
        return [(tag, ns + best[1]) for tag, ns in rows], made


class _HostClock:
    """Stamps of the CPU: host clock readings, kept while a recording is live."""

    @staticmethod
    def stamp(tag: int) -> None:
        rec = _REC
        if rec is not None and rec.live:
            rec.host_stamps.append((tag, time.time_ns()))


_RINGS: Dict[torch.device, _Ring] = {}
_SINK = None       # where stamps go: None (not stamping), _HostClock or a _Ring
_OPEN: List[list] = []  # open stamps: [id, is a backward marker]


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def prepare(device) -> None:
    """Make ``device``'s ring if it is a card without one: before a capture
    that holds stamps, so the ring is not a buffer of the graph's pool."""
    device = torch.device(device)
    if device.type == "cuda":
        card = _card(device)
        if card not in _RINGS:
            _RINGS[card] = _Ring(card)


@contextlib.contextmanager
def stamping(device):
    """Stamps inside this context go to ``device``: its ring on a card, the
    host clock on the CPU."""
    global _SINK
    device = torch.device(device)
    prev, depth = _SINK, len(_OPEN)
    if device.type == "cuda":
        prepare(device)
        _SINK = _RINGS[_card(device)]
    else:
        _SINK = _HostClock
    try:
        yield
    finally:
        del _OPEN[depth:]
        _SINK = prev


def _emit(sid: int, end: int) -> None:
    _SINK.stamp(2 * sid + end)


def _close_markers() -> None:
    while _OPEN and _OPEN[-1][1]:
        _emit(_OPEN.pop()[0], 1)


class _Stamp:
    __slots__ = ("sid",)

    def __init__(self, sid: int):
        self.sid = sid

    def __enter__(self):
        _emit(self.sid, 0)
        _OPEN.append([self.sid, False])
        return self

    def __exit__(self, *exc):
        _close_markers()
        if _OPEN:
            _OPEN.pop()
        _emit(self.sid, 1)
        return False


def stamp(name: str):
    """A device stamp around the work launched inside it while stamping,
    else a shared context that does nothing."""
    if _SINK is None:
        return _NULL
    return _Stamp(_sid(name))


def _marker_fired(sid: int) -> None:
    if _SINK is None:
        return
    _close_markers()
    _emit(sid, 0)
    _OPEN.append([sid, True])


class _Marker(torch.autograd.Function):
    """Identity on a segment's outputs; its backward stamps the begin of the
    segment's backward."""

    @staticmethod
    def forward(ctx, sid, *tensors):
        ctx.sid = sid
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        _marker_fired(ctx.sid)
        return (None,) + grads


def _leaves(tree, out: List[torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.requires_grad:
            out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)


def _replace(tree, new: Dict[int, torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        return new.get(id(tree), tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace(t, new) for t in tree)
    return tree


def segment(name: str, fn: Callable, *args):
    """``fn(*args)``, a segment of the model's step, stamped ``name`` while
    stamping (``recompute`` when it runs inside the backward, a remat
    recompute), its backward marked under autograd."""
    if _SINK is None:
        return fn(*args)
    if torch._C._current_graph_task_id() != -1:
        with _Stamp(_sid("recompute")):
            return fn(*args)
    with _Stamp(_sid(name)):
        out = fn(*args)
    if not torch.is_grad_enabled():
        return out
    leaves: List[torch.Tensor] = []
    _leaves(out, leaves)
    if not leaves:
        return out
    marked = _Marker.apply(_sid(name + ".backward"), *leaves)
    return _replace(out, {id(a): b for a, b in zip(leaves, marked)})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the live recording's counter ``name``."""
    rec = _live()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


# ---------------------------------------------------------------- read-out


def _device_spans(stamps, rec: _Recording) -> List[list]:
    """Nest ``[(tag, ns)]`` in order into spans ``[name, start, end, parent,
    unit]``; a unit is counted at each span with no parent. Each kept span's
    (begin, end) positions in ``stamps`` go to ``rec.device_at``."""
    spans: List[list] = []
    at: List[list] = []
    stack: List[int] = []
    roots = 0
    for i, (tag, ns) in enumerate(stamps):
        name = _NAMES[tag >> 1]
        if not tag & 1:
            if not stack:
                roots += 1
            spans.append([name, ns, None, stack[-1] if stack else -1, roots - 1])
            at.append([i, None])
            stack.append(len(spans) - 1)
            continue
        while stack and spans[stack[-1]][0] != name:
            stack.pop()
            rec.counts["unmatched_stamps"] += 1
        if stack:
            k = stack.pop()
            spans[k][2], at[k][1] = ns, i
        else:
            rec.counts["unmatched_stamps"] += 1
    rec.counts["unmatched_stamps"] += len(stack)
    keep = [k for k, s in enumerate(spans) if s[2] is not None]
    where = {k: i for i, k in enumerate(keep)}
    out = [spans[k] for k in keep]
    for s in out:
        s[3] = where.get(s[3], -1) if s[3] >= 0 else -1
    rec.device_at = [tuple(at[k]) for k in keep]
    return out


def _read_out(rec: _Recording) -> None:
    stamps = list(rec.host_stamps)
    rec.counts["stamps"] = len(stamps)
    for ring in _RINGS.values():
        got, made = ring.read()
        stamps += got
        rec.counts["stamps"] += made
        rec.counts["stamp_overflow"] += max(0, made - RING_STAMPS)
    rec.stamps = stamps
    rec.device = _device_spans(stamps, rec)


def spans() -> Optional[List[Dict]]:
    """Every span of the last ended recording: ``name``, ``kind`` ('host' or
    'device'), ``start_ns`` / ``end_ns`` on the profiler's clock,
    ``parent`` (an index into this list, or None), ``unit`` and ``self_ns``
    (its duration less its children's)."""
    rec = _ended()
    if rec is None:
        return None
    out: List[Dict] = []
    for kind, rows in (("host", rec.host), ("device", rec.device)):
        base = len(out)
        for name, t0, t1, parent, unit in rows:
            if not t1:
                continue
            out.append(dict(name=name, kind=kind, start_ns=t0, end_ns=t1,
                            parent=None if parent < 0 else base + parent, unit=unit,
                            self_ns=t1 - t0))
    for s in out:
        if s["parent"] is not None:
            p = out[s["parent"]]
            p["self_ns"] -= s["end_ns"] - s["start_ns"]
    return out


def _pct(values: List[float], q: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def summary() -> Optional[Dict]:
    """The last ended recording: ``units`` (frames or steps), ``seconds``,
    per span name ``count`` and, where the span has them, ``device_ms`` and
    ``device_self_ms`` a unit (elapsed between the stamps),
    ``host_ms_p50`` / ``host_ms_p95`` of an instance and ``host_ms`` a
    unit; ``counters`` (the recording's own, the kernels' launch counts and
    the graph counts). None when nothing was recorded."""
    from ..ops import kernels as launches

    all_spans = spans()
    rec = _REC
    if all_spans is None or rec.units == 0:
        return None
    rows: Dict[str, Dict] = {}
    for s in all_spans:
        r = rows.setdefault(s["name"], {"host": [], "device": [], "device_self": 0})
        r[s["kind"]].append((s["end_ns"] - s["start_ns"]) / 1e6)
        if s["kind"] == "device":
            r["device_self"] += s["self_ns"] / 1e6
    out = {}
    for name, r in rows.items():
        row = {"count": max(len(r["host"]), len(r["device"]))}
        if r["device"]:
            row["device_ms"] = sum(r["device"]) / rec.units
            row["device_self_ms"] = r["device_self"] / rec.units
        if r["host"]:
            row["host_ms_p50"] = statistics.median(r["host"])
            row["host_ms_p95"] = _pct(r["host"], 95)
            row["host_ms"] = sum(r["host"]) / rec.units
        out[name] = row
    return {"units": rec.units, "seconds": (rec.t1 - rec.t0) / 1e9, "spans": out,
            "counters": dict(rec.counts, kernels=launches.counts(),
                             graphs=launches.graph_counts())}


def _match(ticks: List[float], seen: List[float]) -> List[Optional[int]]:
    """For each stamp (``ticks``, its times in order, us from the first)
    the index of its kernel among ``seen`` (the stamp kernels' starts in a
    profile, sorted, us from any origin), or None where the profile lost
    it. Equal counts pair in order. Else the offset most in-order pairs near
    each other agree on (1 us bins) starts a walk in order that pairs a
    stamp with the next kernel within 2 us of it and carries each pair's
    offset on (the two clocks drift apart slowly)."""
    n, m = len(ticks), len(seen)
    if n == m:
        return list(range(n))
    reach = min(abs(n - m), 64) + 2
    votes: Dict[int, int] = {}
    for i in range(0, n, max(1, n // 400)):
        for j in range(max(0, i - reach), min(m, i + reach + 1)):
            b = round(seen[j] - ticks[i])
            votes[b] = votes.get(b, 0) + 1
    best = max(votes, key=votes.get)
    near = [seen[j] - ticks[i] for i in range(0, n, max(1, n // 400))
            for j in range(max(0, i - reach), min(m, i + reach + 1))
            if abs(seen[j] - ticks[i] - best) <= 1.0]
    offset = statistics.median(near)
    out: List[Optional[int]] = [None] * n
    i = j = 0
    while i < n and j < m:
        d = seen[j] - ticks[i] - offset
        if d < -2.0:  # a kernel of no stamp here
            j += 1
        elif d > 2.0 or (i + 1 < n and abs(seen[j] - ticks[i + 1] - offset) < abs(d)):
            i += 1  # the profile lost this stamp
        else:
            out[i], offset = j, seen[j] - ticks[i]
            i, j = i + 1, j + 1
    return out


def on_profiler_clock(kernels) -> Optional[List[list]]:
    """The last ended recording's device spans ``[name, begin, end, parent,
    unit]`` placed among a profile's device operations. ``kernels`` holds
    one item an operation, its name first and its start and end (us, any
    origin) last: ``(name, start, end)``, or the benchmark harness's
    ``Trace.ops``. The profile's own stamp kernels (:data:`STAMP_KERNEL`)
    are matched to the recording's stamps (:func:`_match`); a span begins
    where its begin stamp's kernel ends and ends where its end stamp's
    starts, and a stamp the profile lost is placed by the offset of the
    matched stamp before it (or of the first). None without an ended recording, device stamps
    or a stamp kernel in the profile."""
    rec = _ended()
    if rec is None or not rec.device:
        return None
    seen = sorted((k[-2], k[-1]) for k in kernels if STAMP_KERNEL in k[0])
    if not seen:
        return None
    t0 = rec.stamps[0][1]
    ticks = [(ns - t0) / 1e3 for _, ns in rec.stamps]
    pair = _match(ticks, [a for a, _ in seen])
    place: List[tuple] = []  # each stamp: (its kernel's start, end)
    first = next((i for i, j in enumerate(pair) if j is not None), None)
    if first is None:
        return None
    offset = seen[pair[first]][0] - ticks[first]
    for t, j in zip(ticks, pair):
        if j is None:
            place.append((t + offset, t + offset))
        else:
            offset = seen[j][0] - t
            place.append(seen[j])
    return [[name, place[b][1], place[e][0], parent, unit]
            for (name, _, _, parent, unit), (b, e) in zip(rec.device, rec.device_at)]


_BUSY: list = [None, None]  # (key, value) of the last busy_ms


def busy_ms(kernels) -> Optional[Dict[str, float]]:
    """The card's busy ms a unit (frame or step) inside each device span of
    the last ended recording, by span name: the union of the profile's
    operations (``kernels``, as :func:`on_profiler_clock` takes them; the
    stamp kernels left out) over each instance's stretch, summed over the
    instances, over the recording's units. Unlike a stamp's elapsed time
    this leaves out the card's idle while the host is late. None where
    :func:`on_profiler_clock` places nothing."""
    rec = _REC
    key = (id(rec), id(kernels), len(kernels))
    if _BUSY[0] == key:
        return _BUSY[1]
    placed = on_profiler_clock(kernels)
    if placed is None or rec.units == 0:
        return None
    union: List[List[float]] = []
    for a, b in sorted((k[-2], k[-1]) for k in kernels if STAMP_KERNEL not in k[0]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    ends = [b for _, b in union]
    before = [0.0]
    for a, b in union:
        before.append(before[-1] + b - a)

    def covered(x: float) -> float:  # busy us up to x
        k = bisect.bisect_right(ends, x)
        return before[k] + (max(0.0, x - starts[k]) if k < len(starts) else 0.0)

    out: Dict[str, float] = {}
    for name, b, e, _, _ in placed:
        if e > b:
            out[name] = out.get(name, 0.0) + covered(e) - covered(b)
    got = {name: us / 1e3 / rec.units for name, us in out.items()}
    _BUSY[:] = [key, got]
    return got


HOST_ROW, DEVICE_ROW = 0x7A00_0001, 0x7A00_0002  # tids of the program's rows


def export_chrome(path: str) -> int:
    """Write the last recording's spans into the Chrome trace at ``path``
    (the profiler's ``export_chrome_trace``), as two rows of this process:
    host spans and device stamps, on the file's time base. Returns the
    spans written."""
    all_spans = spans()
    if not all_spans:
        return 0
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid, label in ((HOST_ROW, "lstm_unet_tpu_torch host spans"),
                       (DEVICE_ROW, "lstm_unet_tpu_torch device stamps")):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": label}})
    for s in all_spans:
        parent = None if s["parent"] is None else all_spans[s["parent"]]["name"]
        events.append({"ph": "X", "cat": "program", "name": s["name"], "pid": pid,
                       "tid": HOST_ROW if s["kind"] == "host" else DEVICE_ROW,
                       "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"unit": s["unit"], "parent": parent}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(all_spans)
