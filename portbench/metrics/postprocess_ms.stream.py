"""Device milliseconds a frame of the postprocess (``ops/postprocess.py``,
``ops/ccl.py`` and the loop kernels) alone: ``postprocess_frame`` on the
cell's own probabilities of its last frame and with its parameters,
captured as a CUDA graph and replayed, timed by CUDA events."""


def read(run):
    return run.postprocess_ms
