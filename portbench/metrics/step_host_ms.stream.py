"""Median host milliseconds of a streaming step inside the program: the
``engine.step`` spans of the program's tracer
(``lstm_unet_tpu_torch/utils/trace.py``, all of
``StreamingInferenceEngine.step_batch_async``), from its recording of the
profiled stretch; the in-program counterpart of ``host_issue_ms.stream``.
Nothing to read from a program without a tracer, or without a
recording."""


def read(run):
    try:
        from lstm_unet_tpu_torch.utils import trace

        return trace.summary()["spans"]["engine.step"]["host_ms_p50"]
    except Exception:  # no tracer, no recording, no such span
        return None
