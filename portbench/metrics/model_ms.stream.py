"""Busy device milliseconds a frame of the model step inside the captured
streaming step: the ``model`` stamps (``engine/infer.py::_body``), from the
profiled stretch: the union of the profiler's device operations
(``run.trace.ops``) inside each stamp, the stamps placed among them by their
own kernels (``lstm_unet_tpu_torch/utils/trace.py::busy_ms``), so the card's
idle while the host is late is left out. Nothing to read from a program
without a tracer, or without a recording."""


def read(run):
    try:
        from lstm_unet_tpu_torch.utils import trace

        return trace.busy_ms(run.trace.ops)["model"]
    except Exception:  # no tracer, no recording, no such stamp
        return None
