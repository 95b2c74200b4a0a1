"""The port's tracer (``lstm_unet_tpu_torch/utils/trace.py``) on the CPU.

On the CPU a device stamp is a host clock reading, so the streaming step
(the golden model at 32^2, eagerly and through ``tests/test_torch_graph.py``'s
stand-in graphs) and the training step (the tiny model, full remat) run the
same tracing code as on a card: what is recorded, how it nests, which unit
each span belongs to, when a recording starts and ends, the counters, the
summary the benchmark's readers read and the readers themselves. The card's
half (the ring, the twins' graphs, the profiler's clock) is in
``tests/test_torch_cuda.py``.
"""

import gc
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lstm_unet_tpu_torch.checkpoint import load_model
from lstm_unet_tpu_torch.config import InferenceParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import make_train_step
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops import kernels
from lstm_unet_tpu_torch.utils import trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden", "torch_ckpt")
STREAM_CHILDREN = ("normalize", "variants", "model", "probs", "postprocess", "outputs")
TRAIN_CHILDREN = ("train.forward", "train.loss", "train.backward", "train.optimizer",
                  "train.reset")
READERS = ("model_ms.stream", "postprocess_step_ms.stream", "engine_device_ms.stream",
           "step_host_ms.stream", "forward_ms.train", "backward_ms.train",
           "optimizer_ms.train")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """The tracer off, with no recording, before and after each test."""
    trace.stop()
    monkeypatch.setattr(trace, "_REC", None)
    yield
    trace.stop()


@pytest.fixture(scope="module")
def frames():
    return synthetic.make_cell_sequence(num_frames=6, height=32, width=32, num_cells=3,
                                        seed=5)[0]


def _engine(**kw):
    return StreamingInferenceEngine(load_model(GOLDEN, "cpu", dtype="float32"),
                                    InferenceParams(min_cell_size=5, **kw), "cpu")


def _trainer(remat=True):
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()),
                       generator=torch.Generator().manual_seed(0))
    opt = ClippedAdam(dict(model.named_parameters()), 1e-3, grad_clip_norm=5.0)
    step = make_train_step(model, opt, (0.15, 0.25, 0.6), remat=remat)
    g = torch.Generator().manual_seed(1)
    b, t, h = 2, 3, 32
    batch = (torch.rand(b, t, h, h, 1, generator=g), torch.randint(0, 3, (b, t, h, h), generator=g),
             torch.ones(b, t), torch.ones(b, t), torch.zeros(b))
    return model, step, model.init_state(b, h, h), batch


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.fixture
def emitted(monkeypatch):
    """A list that every stamp emitted from now on (launched or captured on
    a card, read on the CPU) is appended to."""
    got = []
    emit = trace._emit

    def counted(sid, end):
        got.append((sid, end))
        emit(sid, end)

    monkeypatch.setattr(trace, "_emit", counted)
    return got


def _profile(stamps, kernels, offset_us=5000.0, lose=(), width_us=1.0):
    """A profile's device operations [(name, start us, end us)] for the
    recording's ``stamps`` [(tag, ns)]: each stamp's kernel ``width_us``
    long at its time less the first, plus ``offset_us`` (an origin of the
    profiler's own), but those whose positions are in ``lose``; and
    ``kernels`` [(start, end)] us after the first stamp, shifted the same."""
    t0 = stamps[0][1]
    ops = [(f"void lut::{trace.STAMP_KERNEL}(unsigned long long*)",
            (ns - t0) / 1e3 + offset_us, (ns - t0) / 1e3 + offset_us + width_us)
           for i, (_, ns) in enumerate(stamps) if i not in lose]
    ops += [("gemm", a + offset_us, b + offset_us) for a, b in kernels]
    return sorted(ops, key=lambda k: k[1])


def test_tracing_off_records_and_launches_nothing(frames, emitted):
    """With the tracer off a streaming step and a train step make no
    recording, no span and no stamp."""
    eng = _engine(instance_split=True)
    for f in frames[:2]:
        eng.step_batch_async(f[None])
    _, step, state, batch = _trainer()
    step(state, *batch)
    assert trace._REC is None and not emitted and not trace._OPEN
    assert trace.summary() is None and trace.spans() is None and trace.busy_ms([]) is None
    assert trace._SINK is None and trace.span("x") is trace._NULL
    assert trace.stamp("x") is trace._NULL


def test_a_traced_step_computes_what_an_untraced_one_does(frames):
    """The stamps and backward markers change no output: labels and
    probabilities of a stream, and a train step's state, loss and updated
    parameters, are bit-equal traced and untraced."""
    outs = {}
    for traced in (False, True):
        eng = _engine(instance_split=True, save_intermediate=True)
        if traced:
            trace.start()
        outs[traced] = [eng.step_batch_async(f[None]) for f in frames[:3]]
        model, step, state, batch = _trainer()
        state, m = step(state, *batch)
        trace.stop()
        outs[traced].append((torch.cat([t.reshape(-1) for lvl in state for p in lvl for t in p]),
                             m["loss"].reshape(1)))
        outs[traced].append((torch.cat([p.detach().reshape(-1) for p in model.parameters()]),
                             m["grad_norm"].reshape(1)))
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_stream_spans_nest_with_parents_and_frames(frames):
    """Three traced frames: host spans ``engine.step`` > (``engine.pad``,
    ``engine.upload``) and device stamps ``step`` > (normalize, variants,
    model > the model's segments, probs, postprocess > ccl / split / grow,
    outputs), each with its frame."""
    eng = _engine(instance_split=True)
    eng.step_batch_async(frames[0][None])
    trace.start()
    for f in frames[1:4]:
        eng.step_batch_async(f[None])
    trace.stop()
    spans = trace.spans()
    for kind, root, children in (("host", "engine.step", ("engine.pad", "engine.upload")),
                                 ("device", "step", STREAM_CHILDREN)):
        roots = [s for s in spans if s["name"] == root]
        assert [s["kind"] for s in roots] == [kind] * 3
        assert [s["unit"] for s in roots] == [0, 1, 2] and all(s["parent"] is None for s in roots)
        for s in spans:
            if s["name"] in children:
                assert spans[s["parent"]]["name"] == root and s["kind"] == kind
                assert spans[s["parent"]]["unit"] == s["unit"]
    segments = {s["name"] for s in spans if s["parent"] is not None
                and spans[s["parent"]]["name"] == "model"}
    assert segments == {"encoder/0/lstm/0", "encoder/0/convs", "encoder/1/lstm/0",
                        "encoder/1/convs", "decoder"}
    assert {spans[s["parent"]]["name"] for s in spans
            if s["name"] in ("ccl", "split", "grow")} == {"postprocess"}
    for s in spans:
        p = s["parent"]
        if p is not None:
            assert spans[p]["start_ns"] <= s["start_ns"] <= s["end_ns"] <= spans[p]["end_ns"]


@pytest.mark.parametrize("remat", [True, "save_outputs", False])
def test_train_spans_nest_with_parents_and_steps(remat):
    """Two traced steps: ``train.step`` (a host span and a device stamp) >
    forward (> the segments), loss, backward (> each segment's
    ``.backward``, and remat's ``recompute`` inside them), optimizer (>
    norm, update), reset, each with its step."""
    _, step, state, batch = _trainer(remat)
    trace.start()
    for _ in range(2):
        state, _ = step(state, *batch)
    trace.stop()
    spans = trace.spans()
    device = [s for s in spans if s["kind"] == "device"]
    roots = [s for s in device if s["parent"] is None]
    assert [(s["name"], s["unit"]) for s in roots] == [("train.step", 0), ("train.step", 1)]
    assert [s["unit"] for s in _by_name(spans, "train.step") if s["kind"] == "host"] == [0, 1]
    parent = {s["name"]: spans[s["parent"]]["name"] for s in device if s["parent"] is not None
              and s["name"] != "recompute"}
    assert all(parent[c] == "train.step" for c in TRAIN_CHILDREN)
    assert parent["encoder/0/lstm/0"] == "train.forward"
    assert parent["decoder.backward"] == parent["encoder/0/lstm/0.backward"] == "train.backward"
    assert parent["optimizer.norm"] == parent["optimizer.update"] == "train.optimizer"
    frames = batch[0].shape[1]
    assert len(_by_name(device, "encoder/1/convs.backward")) == 2 * frames
    recomputes = _by_name(device, "recompute")
    if remat:
        assert recomputes and all(spans[s["parent"]]["name"].endswith(".backward")
                                  for s in recomputes)
    else:
        assert not recomputes


def test_self_time_is_the_span_less_its_children(frames):
    eng = _engine()
    trace.start()
    for f in frames[:2]:
        eng.step_batch_async(f[None])
    _, step, state, batch = _trainer()
    step(state, *batch)
    trace.stop()
    spans = trace.spans()
    for i, s in enumerate(spans):
        kids = sum(c["end_ns"] - c["start_ns"] for c in spans if c["parent"] == i)
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - kids
        assert s["self_ns"] >= 0


def test_each_switch_on_starts_a_fresh_recording(frames):
    """``start()`` / ``stop()`` and a profiler session each record only
    their own steps; a profiler's recording ends when it exits (noticed by
    the next step or the read-out)."""
    eng = _engine()
    eng.step_batch_async(frames[0][None])
    for n in (2, 1):
        trace.start()
        for f in frames[:n]:
            eng.step_batch_async(f[None])
        trace.stop()
        eng.step_batch_async(frames[0][None])  # off: not recorded
        s = trace.summary()
        assert s["units"] == n and s["spans"]["engine.step"]["count"] == n
    for n in (3, 2):
        with profile(activities=[ProfilerActivity.CPU]):
            for f in frames[:n]:
                eng.step_batch_async(f[None])
        assert trace._REC.live  # the exit is noticed later
        s = trace.summary()
        assert not trace._REC.live
        assert s["units"] == n and s["spans"]["step"]["count"] == n
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step_batch_async(frames[0][None])
    eng.step_batch_async(frames[1][None])  # the next step ends the recording
    assert not trace._REC.live and trace.summary()["units"] == 1


def test_a_profilers_recording_ends_at_the_first_event_after_it(frames):
    """A collector pause or a count after the profiler has exited ends its
    recording and is not recorded; the next check unhooks the collector's
    callback."""
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step_batch_async(frames[0][None])
    exited = time.time_ns()
    assert trace._REC.live
    gc.collect()
    assert not trace._REC.live and exited <= trace._REC.t1 <= time.time_ns()
    trace.count("graph_captures", 2)
    s = trace.summary()
    assert s["units"] == 1 and s["counters"]["graph_captures"] == 0
    assert all(sp["start_ns"] < exited for sp in trace.spans() if sp["name"] == "gc")
    assert s["counters"]["gc_pauses"] == len(_by_name(trace.spans(), "gc"))
    assert not trace.check() and trace._on_gc not in gc.callbacks


def test_graph_steps_replay_the_twin_only_while_traced(frames, emitted):
    """Through the stand-in graphs: the first step captures the plain
    graphs and their twins; untraced replays write no stamp, traced ones
    stamp every step, and both give bit-equal outputs; a capture inside a
    recording is counted."""
    from test_torch_graph import StandIn

    outs = {}
    for traced in (False, True):
        eng = _engine(save_intermediate=True)
        eng._build(32, 32, 1)
        eng._step.graphs = StandIn(eng._step.sets)
        kernels.reset_counts()
        eng.step_batch_async(frames[0][None])
        assert kernels.GRAPHS.captures == 2 and kernels.GRAPHS.twins == 2
        if traced:
            trace.start()
        before = len(emitted)
        outs[traced] = [eng.step_batch_async(f[None]) for f in frames[1:4]]
        trace.stop()
        if not traced:
            assert len(emitted) == before
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    s = trace.summary()
    assert s["units"] == 3 and s["spans"]["step"]["count"] == 3
    assert s["spans"]["engine.replay"]["count"] == s["spans"]["engine.outputs"]["count"] == 3
    assert s["counters"]["graph_captures"] == 0
    eng = _engine()
    trace.start()
    eng._build(32, 32, 1)
    eng._step.graphs = StandIn(eng._step.sets)
    eng.step_batch_async(frames[0][None])
    trace.stop()
    assert trace.summary()["counters"]["graph_captures"] == 2


def test_the_counter_registry_holds_the_counts(frames):
    """The summary's counters hold the kernels' launch counts and the graph
    counts as ``kernels.counts()`` and ``graph_counts()`` give them."""
    eng = _engine()
    kernels.reset_counts()
    trace.start()
    eng.step_batch_async(frames[0][None])
    trace.stop()
    got = trace.summary()["counters"]
    assert got["kernels"] == kernels.counts() and got["graphs"] == kernels.graph_counts()
    assert got["kernels"]["ccl"]["plain"] == 1


def test_gc_pauses_are_counted_and_spanned(frames):
    eng = _engine()
    trace.start()
    eng.step_batch_async(frames[0][None])
    import gc

    gc.collect()
    trace.stop()
    s = trace.summary()
    assert s["counters"]["gc_pauses"] >= 1 and s["counters"]["gc_ms"] > 0
    assert s["spans"]["gc"]["count"] == s["counters"]["gc_pauses"]
    assert trace._on_gc not in gc.callbacks


def test_the_summary_has_the_shape_the_readers_read(frames):
    eng = _engine(instance_split=True)
    trace.start()
    for f in frames[:3]:
        eng.step_batch_async(f[None])
    trace.stop()
    s = trace.summary()
    assert set(s) == {"units", "seconds", "spans", "counters"} and s["units"] == 3
    for name in ("step", "model", "postprocess") + STREAM_CHILDREN:
        row = s["spans"][name]
        assert row["count"] >= 3 and row["device_ms"] > 0 and row["device_self_ms"] >= 0
    host = s["spans"]["engine.step"]
    assert host["count"] == 3 and 0 < host["host_ms_p50"] <= host["host_ms_p95"]
    assert abs(host["host_ms"] * 3 - sum(sp["end_ns"] - sp["start_ns"] for sp in trace.spans()
                                         if sp["name"] == "engine.step") / 1e6) < 1e-6
    for key in ("gc_pauses", "gc_ms", "graph_captures", "stamps", "stamp_overflow",
                "unmatched_stamps", "kernels", "graphs"):
        assert key in s["counters"]
    assert s["counters"]["stamp_overflow"] == s["counters"]["unmatched_stamps"] == 0
    total = sum(s["spans"][k]["device_ms"] for k in STREAM_CHILDREN)
    assert total <= s["spans"]["step"]["device_ms"]
    json.dumps(s)


def _reader(name):
    from portbench.harness.cell import metric_reader

    return metric_reader(name, ROOT)


def _busy_profile():
    """A profile of the last recording in which the card is busy from each
    stamp to the next, the stamps' kernels of no length: each span's busy
    time is then its elapsed time."""
    stamps = trace._REC.stamps
    t0 = stamps[0][1]
    ticks = [(ns - t0) / 1e3 for _, ns in stamps]
    return SimpleNamespace(trace=SimpleNamespace(
        ops=_profile(stamps, list(zip(ticks, ticks[1:])), width_us=0.0)))


def test_the_readers_read_the_summary(frames):
    """Each new reader returns its number from a recording of its own kind
    of step and a profile of it, and None from a recording of the other
    kind: busy ms inside the stamps, here where the card is never idle the
    stamps' elapsed ms of the summary."""
    eng = _engine(instance_split=True)
    trace.start()
    for f in frames[:2]:
        eng.step_batch_async(f[None])
    trace.stop()
    spans = trace.summary()["spans"]
    run = _busy_profile()
    got = {name: _reader(name)(run) for name in READERS}
    assert got["model_ms.stream"] == pytest.approx(spans["model"]["device_ms"])
    assert got["postprocess_step_ms.stream"] == pytest.approx(
        spans["postprocess"]["device_ms"])
    assert got["engine_device_ms.stream"] == pytest.approx(
        spans["step"]["device_ms"] - spans["model"]["device_ms"]
        - spans["postprocess"]["device_ms"])
    assert got["step_host_ms.stream"] == spans["engine.step"]["host_ms_p50"]
    assert all(got[n] is None for n in READERS if n.endswith(".train"))
    _, step, state, batch = _trainer()
    trace.start()
    step(state, *batch)
    trace.stop()
    spans = trace.summary()["spans"]
    run = _busy_profile()
    for name in ("forward", "backward", "optimizer"):
        assert _reader(f"{name}_ms.train")(run) == pytest.approx(
            spans[f"train.{name}"]["device_ms"]) and spans[f"train.{name}"]["device_ms"] > 0
    assert all(_reader(n)(run) is None for n in READERS if n.endswith(".stream"))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_returns_none_without_a_tracer_or_records(name, monkeypatch):
    read = _reader(name)
    run = SimpleNamespace(trace=SimpleNamespace(ops=[("gemm", 0.0, 1.0)]))
    assert read(run) is None  # no recording
    trace.start()
    trace.stop()
    assert read(run) is None  # a recording of nothing
    import lstm_unet_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "lstm_unet_tpu_torch.utils.trace", None)
    assert read(run) is None  # a program without the tracer


def _recorded(monkeypatch, stamps, units):
    """``stamps`` [(name, begin | end, ns)] read out of a card's ring as the
    last recording, of ``units`` units."""
    rows = [(2 * trace._sid(name) + end, ns) for name, end, ns in stamps]

    class Ring:
        def read(self):
            return rows, len(rows)

    monkeypatch.setattr(trace, "_RINGS", {torch.device("cuda", 0): Ring()})
    rec = trace._Recording(by_profiler=False)
    rec.units = units
    trace._end(rec)
    trace._read_out(rec)
    monkeypatch.setattr(trace, "_REC", rec)


def _two_steps(jitter_ns=0):
    """Two units of ``step`` > (``model``, ``postprocess``), 200 us apart,
    each stamp ``jitter_ns`` later than the one before it would be."""
    out = []
    for u in range(2):
        for k, (name, end, us) in enumerate((("step", 0, 0), ("model", 0, 10), ("model", 1, 60),
                                             ("postprocess", 0, 70), ("postprocess", 1, 90),
                                             ("step", 1, 100))):
            out.append((name, end, 10 ** 12 + (200 * u + us) * 1000 + (6 * u + k) * jitter_ns))
    return out


# work a unit, us after its step begins: normalize 6, the model 37 with a
# 10 us idle gap inside, the postprocess 16, and 30 us outside every span
WORK = [(2, 8), (12, 30), (40, 59), (72, 88), (120, 150)]


@pytest.mark.parametrize("lose", [(), (2,), (8, 9), (0, 11)], ids=["all", "one", "two", "ends"])
def test_busy_ms_is_the_cards_busy_time_inside_each_stamp(monkeypatch, lose):
    """The stamps placed among a profile by their own kernels, at an origin
    of its own, with the clocks drifting apart 0.3 us a stamp and stamps
    the profile lost: busy ms a unit inside each span leaves out idle gaps
    inside it, the stamps' kernels and work outside it."""
    _recorded(monkeypatch, _two_steps(jitter_ns=300), units=2)
    work = [(200 * u + a, 200 * u + b) for u in range(2) for a, b in WORK]
    ops = _profile([(0, ns) for _, _, ns in _two_steps()], work, lose=lose)
    placed = trace.on_profiler_clock(ops)
    assert [p[0] for p in placed] == ["step", "model", "postprocess"] * 2
    got = trace.busy_ms(ops)
    assert got["model"] == pytest.approx(0.037, abs=1e-6)
    assert got["postprocess"] == pytest.approx(0.016, abs=1e-6)
    assert got["step"] == pytest.approx(0.059, abs=1e-6)
    assert trace.busy_ms(ops) is got  # read once for the three readers


def test_match_pairs_stamps_with_their_kernels():
    ticks = [0.0, 1.5, 3.0, 50.0, 51.5, 120.0, 200.0]
    seen = [t + 7000.0 + 0.01 * i for i, t in enumerate(ticks)]
    assert trace._match(ticks, seen) == list(range(7))
    lost = seen[:3] + seen[4:]
    assert trace._match(ticks, lost) == [0, 1, 2, None, 3, 4, 5]
    extra = sorted(seen + [7100.0])
    assert trace._match(ticks, extra) == [0, 1, 2, 3, 4, 6, 7]
    assert trace.on_profiler_clock([("gemm", 0.0, 1.0)]) is None


def test_stamps_nest_and_the_ring_counts_its_overflow(monkeypatch):
    """Stamps nest by order, an end without its begin is counted, and stamps
    past a ring's end are counted, never silent."""
    sid, inner = trace._sid("step"), trace._sid("model")
    stamps = [(2 * sid, 10), (2 * inner, 11), (2 * inner + 1, 15), (2 * sid + 1, 20),
              (2 * sid + 1, 25), (2 * sid, 30)]

    class Ring:
        def read(self):
            return stamps, trace.RING_STAMPS + 7

    monkeypatch.setattr(trace, "_RINGS", {torch.device("cuda", 0): Ring()})
    rec = trace._Recording(by_profiler=False)
    rec.units = 1
    trace._end(rec)
    trace._read_out(rec)
    assert [(s[0], s[2] - s[1], s[3], s[4]) for s in rec.device] == [("step", 10, -1, 0),
                                                                     ("model", 4, 0, 0)]
    assert rec.counts["unmatched_stamps"] == 2  # the stray end and the open begin
    assert rec.counts["stamp_overflow"] == 7
    assert rec.counts["stamps"] == trace.RING_STAMPS + 7


def test_profile_flag_writes_program_rows_into_the_chrome_trace(tmp_path, frames):
    """The program's spans join a profiler's Chrome trace as two rows of
    their own, on the file's time base."""
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step_batch_async(frames[0][None])
        eng.step_batch_async(frames[1][None])
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    n = trace.export_chrome(path)
    doc = json.load(open(path))
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert n == len(mine) > 0
    assert {e["tid"] for e in mine} == {trace.HOST_ROW, trace.DEVICE_ROW}
    base = int(doc.get("baseTimeNanoseconds", 0))
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") != "program"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e.get("dur", 0) for e in ops)
    for e in mine:  # inside the profiled stretch, on its time base
        assert lo - 1e3 <= e["ts"] <= hi + 1e3
    assert base == 0 or lo < 1e15  # relative to baseTimeNanoseconds where the file has one
    steps = [e for e in mine if e["name"] == "engine.step"]
    assert [e["args"]["unit"] for e in steps] == [0, 1]
    assert np.all(np.diff([e["ts"] for e in steps]) > 0)
