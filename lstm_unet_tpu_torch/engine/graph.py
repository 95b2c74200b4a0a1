"""The port's compiled step: a streaming step captured as CUDA graphs.

Counterpart of the reference's one device program per frame
(``lstm_unet_tpu/engine/infer.py:13-14``), ``jax.jit(step,
donate_argnums=(1,))`` at ``:311-312``. A :class:`CompiledStep` holds, for
one (lanes, frame shape, configuration):

- a static input ``x`` (:meth:`CompiledStep.input`), which the caller fills
  before each step: the engine copies each frame into it from pinned memory
  without waiting;
- two sets of carried buffers (the engine's: the LSTM state and
  ``reset_on_jump``'s previous frame). A step reads one set and writes the
  other, the next step the reverse: the kernels that compute the new state
  write it into the other set (``ULSTMnet2D.step(..., out=...)``), so no
  step copies the state and memory stays flat over any stream length, as
  the reference's donated state does;
- on a single-process card (:class:`CudaGraphs`), two CUDA graphs that share
  one memory pool: graph 0 reads set 0 and writes set 1, graph 1 the
  reverse.

``body(x, src, dst)``, given to each :meth:`CompiledStep.step` (so that the
step holds no reference to its caller, which holds the step), is the step
itself, one function: it runs eagerly
where nothing is captured (the CPU, which the caller asked for, and a mesh,
whose gloo halo exchange stages rows through the host:
``parallel/comm.py::exchange``), and it is what the graphs capture. The
first step on a card runs it eagerly on a side stream, the warm-up PyTorch's
graph documentation asks for: it builds the kernels, makes each wrapper's
first attribute calls, lets cuDNN choose its algorithms and fills every lazy
cache (the cells' Wh packs, the int8 slices and dequantized Wh, the loop
kernels' round counter) outside the graphs' pool, so no cache ever holds a
tensor of the pool. Then both graphs are captured, and every later step
replays one. A new input shape or dtype drops the graphs and their pool,
and the next step captures anew, as the reference compiles a new program
per shape.

What the wrappers decide on the host at capture (routes by shape, K3's
vectorised path by pointer alignment, K4's per-call Wh pack, the loop
kernels' flag resets) is frozen into the graphs and replayed: the pool's
buffers are aligned as any of the caching allocator's (512 bytes), so a
replay makes the eager step's choices and computes its results bit for bit.

Capture runs with ``capture_error_mode="thread_local"``: only the capturing
thread is held to the capture's rules, so the engine's prefetch and writer
threads (which make no CUDA call) cannot fail it. A synchronizing call in
the step (a host read, a blocking copy) fails the capture, and the step
raises, naming the failure: on a card it never falls back to eager
launches.

Outputs outlive later steps: a replay writes the graph's own output
buffers, so each step returns copies made on the card right after the
replay, which no later replay writes (the engine emits frame t after it
has dispatched frame t + 1).

Kernel counts stay true (``ops/kernels/__init__.py``): the launches the
wrappers counted while a graph was captured, which ran nothing, are taken
back, and each replay adds them again; ``kernels.GRAPHS`` counts captures
and replays.

Tracing (``utils/trace.py``): beside each plain graph the first capture
also captures a traced twin, the same body with device stamps (``step``
around it), in the same pool over the same carried sets, which copies its
outputs into the plain graph's own output buffers after ``step`` closes,
so the twins add no memory but the tracer's ring. A step the caller marks ``traced`` replays
the twin (or runs the body eagerly with stamps, where nothing is
captured); any other step replays the plain graph, which holds no stamp.
A twin's replay counts the same launches as the plain graph's: a stamp is
not a kernel of ``kernels.counts()``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..ops import kernels
from ..utils import trace

Outputs = Tuple[Optional[torch.Tensor], ...]
Body = Callable[[torch.Tensor, Any, Any], Outputs]
Captured = Tuple[Any, Outputs, kernels.Launches]


class CudaGraphs:
    """How a :class:`CompiledStep` warms up and captures on a card: a side
    stream and one memory pool for its two graphs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = None

    def warm_up(self, fn: Callable[[], Outputs]) -> Outputs:
        """``fn()`` eagerly on the side stream, after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def new_pool(self) -> None:
        """A fresh memory pool for the next pair of captures."""
        self.pool = torch.cuda.graph_pool_handle()

    def capture(self, fn: Callable[[], Outputs]):
        """(the CUDA graph of ``fn``, its output tensors)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out


class CompiledStep:
    """A step over a static input and two sets of carried buffers, read and
    written in turn; captured and replayed through ``graphs``
    (:class:`CudaGraphs`), or run eagerly when ``graphs`` is None."""

    def __init__(self, sets: List[Any], graphs: Optional[CudaGraphs] = None):
        if len(sets) != 2:
            raise ValueError(f"need two sets of carried buffers, got {len(sets)}")
        self.sets = sets
        self.graphs = graphs
        self.x: Optional[torch.Tensor] = None
        self.turn = 0  # the set the next step reads
        # per turn: (plain, traced twin), each (graph, its output tensors, the
        # launches a replay makes)
        self._captured: Optional[List[Tuple[Captured, Captured]]] = None

    @property
    def state(self) -> Any:
        """The set the next step reads: what the last step wrote."""
        return self.sets[self.turn]

    @property
    def captured(self) -> bool:
        return self._captured is not None

    def input(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        """The static input for frames of ``shape`` and ``dtype``, which the
        caller fills before :meth:`step`; another shape or dtype makes it
        anew and drops the graphs."""
        shape = tuple(shape)
        if self.x is None or tuple(self.x.shape) != shape or self.x.dtype != dtype:
            self._captured = None
            self.x = torch.empty(shape, dtype=dtype, device=device)
        return self.x

    def step(self, body: Body, traced: bool = False) -> Outputs:
        """One step of ``body`` on the input as it stands: eagerly, or the
        first time on a card warm-up and capture, then a replay (which runs
        no Python: ``body`` must be the one captured). ``traced``: with the
        tracer's device stamps (the twin's replay)."""
        if self.x is None:
            raise RuntimeError("fill CompiledStep.input(...) before the first step")
        src, dst = self.sets[self.turn], self.sets[1 - self.turn]
        if self.graphs is None:
            out = self._run(body, traced, self.x, src, dst)
        elif self._captured is None:
            trace.prepare(self.x.device)
            out = self.graphs.warm_up(functools.partial(self._run, body, traced, self.x,
                                                        src, dst))
            self._capture(body)
        else:
            graph, outputs, held = self._captured[self.turn][int(traced)]
            with trace.span("engine.replay"):
                graph.replay()
            kernels.record_replay(held)
            with trace.span("engine.outputs"):
                out = tuple(None if t is None else t.clone() for t in outputs)
        self.turn = 1 - self.turn
        return out

    @staticmethod
    def _run(body: Body, traced: bool, x: torch.Tensor, src, dst,
             into: Optional[Outputs] = None) -> Outputs:
        """``body(x, src, dst)``; ``traced``: with device stamps, ``step``
        around it, and its outputs copied ``into`` another graph's when
        given (a twin's)."""
        if not traced:
            return body(x, src, dst)
        with trace.stamping(x.device), trace.stamp("step"):
            out = body(x, src, dst)
        if into is None:
            return out
        for mine, theirs in zip(out, into):  # the twin's own work, outside ``step``
            if theirs is not None:
                theirs.copy_(mine)
        return into

    def _capture(self, body: Body) -> None:
        """Both graphs of ``body`` and their traced twins, the pair the next
        step replays first."""
        self.graphs.new_pool()
        captured: List[Any] = [None, None]
        before, counted = kernels.snapshot(), (kernels.GRAPHS.captures, kernels.GRAPHS.twins)
        try:
            for turn in (1 - self.turn, self.turn):
                src, dst = self.sets[turn], self.sets[1 - turn]
                plain = self._capture_one(functools.partial(self._run, body, False, self.x,
                                                            src, dst), twin=False)
                twin = self._capture_one(functools.partial(self._run, body, True, self.x, src,
                                                           dst, plain[1]), twin=True)
                captured[turn] = (plain, twin)
        except RuntimeError as e:  # re-raised: a card never runs the step eagerly
            kernels.restore(before)
            kernels.GRAPHS.captures, kernels.GRAPHS.twins = counted
            raise RuntimeError(f"CUDA graph capture of the streaming step failed: "
                               f"{type(e).__name__}: {e}") from e
        trace.count("graph_captures", 2)
        self._captured = captured

    def _capture_one(self, fn: Callable[[], Outputs], twin: bool) -> Captured:
        before = kernels.snapshot()
        graph, outputs = self.graphs.capture(fn)
        return graph, tuple(outputs), kernels.record_capture(before, twin=twin)
