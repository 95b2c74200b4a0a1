"""Busy device milliseconds a frame of the ConvLSTM layers inside the
captured streaming step: the ``encoder/{l}/lstm/{j}`` stamps
(``models/ulstm_unet.py::ULSTMnet2D.step``; each holds the level's 2x2 pool,
the x-conv, the h-conv or K4, and K1), summed over the levels, from the
profiled stretch: the union of the profiler's device operations
(``run.trace.ops``) inside each stamp, the stamps placed among them by their
own kernels (``lstm_unet_tpu_torch/utils/trace.py::busy_ms``), so the card's
idle while the host is late is left out. Only a streaming step's recording
(one with ``model`` stamps) is read: a training step stamps the same
segments inside its forward. Nothing to read from a program without a
tracer, or without a recording."""

import re

LSTM = re.compile(r"encoder/\d+/lstm/\d+")


def read(run):
    try:
        from lstm_unet_tpu_torch.utils import trace

        busy = trace.busy_ms(run.trace.ops)
        if "model" not in busy:
            return None
        parts = [ms for name, ms in busy.items() if LSTM.fullmatch(name)]
        return sum(parts) if parts else None
    except Exception:  # no tracer, no recording
        return None
