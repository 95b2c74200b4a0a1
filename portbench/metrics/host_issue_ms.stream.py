"""Median host milliseconds inside ``step_batch_async`` a frame, on the
harness's clock, over the unprofiled stretch of a traced run: what the
engine (``engine/infer.py``, ``engine/graph.py``) costs the host to issue a
frame, one graph replay and its copies."""

import statistics


def read(run):
    if not run.host_issue_s:
        return None
    return statistics.median(run.host_issue_s) * 1e3
