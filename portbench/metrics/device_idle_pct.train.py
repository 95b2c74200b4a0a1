"""The device's idle share of the profiled stretch of a training run:
100 x (1 - the union of every device operation's interval over the
stretch's length on the host clock), in %."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
