"""Busy device milliseconds a frame of the streaming step's own work around
the model and the postprocess (normalize, TTA variants, softmax and average,
outputs): the ``step`` stamps less their ``model`` and ``postprocess``
stamps (``engine/infer.py::_body``), from the profiled stretch: the union of
the profiler's device operations (``run.trace.ops``) inside each stamp, the
stamps placed among them by their own kernels
(``lstm_unet_tpu_torch/utils/trace.py::busy_ms``), so the card's idle while
the host is late is left out. Nothing to read from a program without a
tracer, or without a recording."""


def read(run):
    try:
        from lstm_unet_tpu_torch.utils import trace

        busy = trace.busy_ms(run.trace.ops)
        return busy["step"] - busy["model"] - busy.get("postprocess", 0.0)
    except Exception:  # no tracer, no recording, no such stamp
        return None
