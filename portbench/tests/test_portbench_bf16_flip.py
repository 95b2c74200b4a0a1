"""The bf16 fused-cell TTA cell and the ConvLSTM layers' reader: the metrics
``BENCHMARK.json`` reads in the cell, and ``lstm_ms.stream`` read from a
recording of the tiny cells' own steps on the CPU, where a device stamp is a
host clock reading."""

import sys

import pytest
import torch

from portbench.harness import cell, stream, train

CPU = torch.device("cpu")
STREAM_CELLS = ("stream-int8-b1", "stream-int8-dist", "stream-bf16-flip")


def test_the_flip_cell_reports_its_metrics():
    c = cell.load("stream-bf16-flip")
    assert (c.workload["config"], c.workload["traffic"], c.workload["chips"]) == \
        ("flagship-bf16", "stream-flip", 1)
    assert c.config["fused_cell"] and c.config["quant"] == "none"
    assert c.traffic["inference"]["tta"] and c.traffic["lanes"] == 1
    assert set(c.workload["limits"]) == {"prob_gap", "label_gap"}
    assert c.workload["limits"]["label_gap"] == 0.0
    assert {m["name"] for m in c.end_to_end()} == \
        {"setup_s", "stream_fps", "frame_p95_ms", "peak_mem_gib"}
    layers = {m["name"] for m in c.per_layer()}
    assert {"convlstm_roofline", "lstm_ms.stream", "model_ms.stream", "mfu.stream"} <= layers
    assert "int8_conv_roofline" not in layers
    assert not any(m["name"].endswith(".train") for m in c.per_layer())


@pytest.mark.parametrize("workload", STREAM_CELLS)
def test_every_stream_cell_reads_the_lstm_layers(workload):
    assert "lstm_ms.stream" in {m["name"] for m in cell.load(workload).per_layer()}


def _busy_ops():
    """A profile of the last recording in which the card is busy from each
    stamp to the next, the stamps' kernels of no length: each span's busy
    time is then its elapsed time."""
    from lstm_unet_tpu_torch.utils import trace

    stamps = trace._REC.stamps
    t0 = stamps[0][1]
    ticks = [(ns - t0) / 1e3 for _, ns in stamps]
    ops = [(f"void lut::{trace.STAMP_KERNEL}(unsigned long long*)", t, t) for t in ticks]
    ops += [("gemm", a, b) for a, b in zip(ticks, ticks[1:])]
    return sorted(ops, key=lambda k: k[1])


def _run(ops):
    return type("Run", (), {"trace": type("Trace", (), {"ops": ops})})()


@pytest.fixture
def tracer():
    from lstm_unet_tpu_torch.utils import trace

    trace.stop()
    yield trace
    trace.stop()


@pytest.mark.parametrize("workload", ["stream-int8-b1", "stream-bf16-flip"])
def test_the_lstm_reader_sums_the_lstm_segments(tiny_root, cpu_threads, tracer, workload):
    """On a streaming recording: the sum over the ``encoder/*/lstm/*``
    stamps' device ms, above 0 and under the ``model`` stamp's."""
    s = stream.Stream(cell.load(workload, tiny_root), 2 ** 33 + 7, CPU)
    s.hand_off()
    tracer.start()
    for _ in range(2):
        s.hand_off()
    tracer.stop()
    spans = tracer.summary()["spans"]
    lstm = [k for k in spans if k.startswith("encoder/") and "/lstm/" in k]
    assert len(lstm) == len(s.cell.config["lstm_kernels"])
    got = cell.metric_reader("lstm_ms.stream", tiny_root)(_run(_busy_ops()))
    assert got == pytest.approx(sum(spans[k]["device_ms"] for k in lstm))
    assert 0 < got < spans["model"]["device_ms"]


def test_the_lstm_reader_reads_nothing_in_training(tiny_root, cpu_threads, tracer):
    """A training step stamps the same segments inside its forward, and no
    ``model``: nothing to read."""
    t = train.Training(cell.load("train-bf16-b5t7", tiny_root), 2 ** 33 + 7, CPU)
    tracer.start()
    t.step()
    tracer.stop()
    assert any("/lstm/" in k for k in tracer.summary()["spans"])
    assert cell.metric_reader("lstm_ms.stream", tiny_root)(_run(_busy_ops())) is None


def test_the_lstm_reader_returns_none_without_a_tracer_or_records(tiny_root, tracer,
                                                                  monkeypatch):
    read = cell.metric_reader("lstm_ms.stream", tiny_root)
    run = _run([("gemm", 0.0, 1.0)])
    monkeypatch.setattr(tracer, "_REC", None)
    assert read(run) is None  # no recording
    tracer.start()
    tracer.stop()
    assert read(run) is None  # a recording of nothing
    import lstm_unet_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "lstm_unet_tpu_torch.utils.trace", None)
    assert read(run) is None  # a program without the tracer
