"""Busy device milliseconds a training step of the optimizer
(``ClippedAdam.step``: the norm, the clip and the update): the
``train.optimizer`` stamps (``engine/train.py``), from the profiled stretch:
the union of the profiler's device operations (``run.trace.ops``) inside
each stamp, the stamps placed among them by their own kernels
(``lstm_unet_tpu_torch/utils/trace.py::busy_ms``), so the card's idle while
the host is late is left out. Nothing to read from a program without a
tracer, or without a recording."""


def read(run):
    try:
        from lstm_unet_tpu_torch.utils import trace

        return trace.busy_ms(run.trace.ops)["train.optimizer"]
    except Exception:  # no tracer, no recording, no such stamp
        return None
