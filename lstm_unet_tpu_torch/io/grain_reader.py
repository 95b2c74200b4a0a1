"""The deterministic training input pipeline (``data_provider_class=
'GrainCTCReaderSequence2D'``).

Counterpart of ``lstm_unet_tpu/io/grain_reader.py``: the batch contract of
:class:`CTCRAMReaderSequence2D` (per-lane traversals, BPTT lane continuity,
``is_last``, optional instance GT), with ``make_batch(step)`` a pure
function of (seed, step). Each lane's traversals are drawn from
``np.random.SeedSequence([seed, lane, traversal_index])``, so the stream can
start at any step without replaying the ones before it: the trainer calls
``set_start_step(global_step)`` when it resumes a run.

The reference prefetches through the ``grain`` package; the port needs no
such package. One producer thread makes the batches of consecutive steps,
in order, into a bounded queue: the batches are the same whoever computes
them (``tests/test_torch_grain.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..config import CTCParams
from ..utils import log_print
from .dataset import CTCRAMReaderSequence2D


class GrainCTCReaderSequence2D(CTCRAMReaderSequence2D):
    """Deterministic, resumable provider; a drop-in for the threaded reader."""

    def __init__(self, params: CTCParams, sequence_list: Optional[Sequence] = None,
                 num_threads: Optional[int] = None, queue_capacity: int = 16,
                 seed: int = 0, return_instances: bool = False):
        super().__init__(params, sequence_list, num_threads=1,
                         queue_capacity=queue_capacity, seed=seed,
                         return_instances=return_instances)
        self._start_step = 0
        self._prefetch = max(2, min(queue_capacity, 16))
        self._queue: Optional[queue.Queue] = None
        # per lane: the traversals drawn so far [(sequence, aug)] and the
        # cumulative count of windows up to the end of each
        self._trav: List[list] = [[] for _ in range(self.batch)]
        self._cum: List[list] = [[] for _ in range(self.batch)]

    # -- the deterministic schedule -------------------------------------------

    def _traversal_at(self, lane: int, t_idx: int):
        cache = self._trav[lane]
        while len(cache) <= t_idx:
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, lane, len(cache)]))
            s, aug = self._new_traversal(rng)
            cache.append((s, aug))
            n_windows = max(1, -(-len(s) // self.unroll))  # ceil
            cum = self._cum[lane]
            cum.append((cum[-1] if cum else 0) + n_windows)
        return cache[t_idx]

    def _lane_window(self, lane: int, step: int):
        """``(sequence, aug, window start)`` of lane ``lane`` at global step
        ``step``."""
        cum = self._cum[lane]
        t_idx = 0
        while True:
            if t_idx >= len(cum):
                self._traversal_at(lane, t_idx)
            if step < cum[t_idx]:
                break
            t_idx += 1
        prev = cum[t_idx - 1] if t_idx else 0
        s, aug = self._trav[lane][t_idx]
        return s, aug, (step - prev) * self.unroll

    def make_batch(self, step: int):
        """The batch of global step ``step``, as ``get_batch`` returns it."""
        items = [self._window(*self._lane_window(lane, step))
                 for lane in range(self.batch)]
        imgs, segs, insts, valids, fulls, lasts = zip(*items)
        batch = (np.stack(imgs)[..., None], np.stack(segs), np.stack(valids),
                 np.stack(fulls), np.asarray(lasts, np.float32))
        if self.return_instances:
            batch = batch + (np.stack(insts),)
        return batch

    # -- the provider API -------------------------------------------------------

    def set_start_step(self, step: int) -> None:
        """Start the stream at global step ``step`` (a resumed run)."""
        self._start_step = int(step)

    def _producer_loop(self, tid: int):
        step, q = self._start_step, self._queue
        while not self._stop.is_set():
            item = self.make_batch(step)
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def start_queues(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self._prefetch)
        th = threading.Thread(target=self._producer, args=(0,), daemon=True,
                              name="grain-reader")
        th.start()
        self._threads.append(th)
        log_print(f"GrainCTCReaderSequence2D: deterministic stream from step "
                  f"{self._start_step} (prefetch {self._prefetch})")

    def get_batch(self):
        while True:
            if self._err is not None:
                raise self._err
            try:
                return self._queue.get(timeout=0.5)
            except queue.Empty:
                continue

    def stop(self) -> None:
        """Stop the producer; a restart begins again at the start step."""
        self._stop.set()
        for th in self._threads:
            th.join(timeout=2.0)
        self._threads.clear()
        self._queue = None
        self._err = None
