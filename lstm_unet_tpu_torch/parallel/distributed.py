"""Process-group set-up for a run of several processes ("ranks").

Counterpart of ``lstm_unet_tpu/parallel/distributed.py``. The reference
joins TPU hosts through ``jax.distributed`` and detects a pod from its
environment; the pod detection is not ported, only its contract: a run of
one process needs no set-up and :func:`initialize` does nothing.

A run of N processes joins one ``torch.distributed`` group. Under
``torchrun`` the rank, the world size and the rendezvous come from
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; a caller that starts the processes itself passes them
(:func:`run_ranks` does, with a ``file://`` rendezvous). The backend
follows from the device the caller names, never from what is installed:

- ``cuda`` (no index): each rank takes its own card, ``cuda:LOCAL_RANK``,
  and the ranks talk over ``nccl``;
- ``cuda:N`` (an index): the ranks may share that card, and ``nccl`` does
  not take two ranks on one card, so they talk over ``gloo``
  (``parallel/comm.py`` stages through host memory what gloo does not take
  on the card);
- ``cpu``: ``gloo``.

``init_process_group`` gets a finite timeout, so a lost peer fails the
run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils import log_print, resolve_device

DEFAULT_TIMEOUT_S = 600.0  # covers a rank that builds the kernels while its peers wait


def backend_for(device: torch.device) -> str:
    """The backend of ranks on ``device``: ``nccl`` for ``cuda`` without an
    index (a card per rank), ``gloo`` for a named card (ranks may share it)
    and for the CPU."""
    return "nccl" if device.type == "cuda" and device.index is None else "gloo"


def initialize(device="cuda", *, init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of this run and return this rank's device.

    One process (no ``WORLD_SIZE`` above 1 and no ``world_size`` argument
    above 1) is a no-op: the device as :func:`resolve_device` gives it. So
    is a second call in a process that has joined. The backend is
    :func:`backend_for` the device; ``nccl`` without a GPU raises, as
    ``--device cuda`` does.
    """
    dev = torch.device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return _rank_device(dev, dist.get_backend(), dist.get_rank())
    if world_size <= 1:
        return resolve_device(dev)
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = backend_for(dev)
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} means backend 'nccl', a CUDA GPU per rank, "
                           f"and there is no GPU")
    dev = _rank_device(dev, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log_print(f"distributed: rank {rank}/{world_size} on {dev} over {backend}")
    return dev


def _rank_device(dev: torch.device, backend: str, rank: int) -> torch.device:
    """``cuda`` under nccl is this rank's card, ``cuda:LOCAL_RANK`` (the rank
    when ``LOCAL_RANK`` is unset: one host)."""
    if dev.type == "cuda" and dev.index is None and backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return resolve_device(dev)


def rank() -> int:
    """This process's rank; 0 for a run of one process."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 only."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (pickled; small objects only)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _rank_main(fn, r: int, n: int, init_file: str, device: str, timeout_s: float,
               args: Sequence, results) -> None:
    try:
        dev = initialize(device, init_method=f"file://{init_file}", rank=r, world_size=n,
                         timeout_s=timeout_s)
        out = fn(r, dev, *args)
        results.put((r, True, out))
    except BaseException:  # reported to the launching process, which raises
        results.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], n: int, args: Sequence = (), *, device: str,
              timeout_s: float = 120.0, work_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``n`` new processes joined over
    ``initialize(device)`` with a ``file://`` rendezvous under ``work_dir``
    (what ``torchrun`` does, for tests and for ranks that share one card).
    ``device`` has no default: ``"cuda:0"`` puts every rank on that card,
    ``"cpu"`` on the CPU. Returns each rank's result, in rank order.
    ``fn``, ``args`` and the results must be picklable (``fn`` a
    module-level function; results as numpy arrays, not tensors, which would
    be shared with a process that exits). A rank that raises (its peers get
    10 s more), or a run that outlasts ``timeout_s``, raises here; every
    process is stopped before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init_file, device, timeout_s, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, failed = {}, {}
        try:
            deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
            while len(got) + len(failed) < n:
                try:
                    r, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    lost = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in got and r not in failed]
                    if lost:  # a rank that died in native code posts nothing
                        try:
                            r, ok, out = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"rank {lost[0]} exited with code {procs[lost[0]].exitcode} "
                                f"and no result") from None
                    elif datetime.datetime.now() > deadline:
                        if failed:  # its peers wait in a collective for it
                            break
                        raise TimeoutError(f"ranks {sorted(set(range(n)) - set(got))} gave "
                                           f"no result within {timeout_s} s") from None
                    else:
                        continue
                if ok:
                    got[r] = out
                else:
                    failed[r] = out
                    deadline = min(deadline, datetime.datetime.now()
                                   + datetime.timedelta(seconds=10))
        finally:
            for p in procs:
                p.join(timeout=10.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    if failed:
        raise RuntimeError("a rank failed:\n" + "\n".join(f"rank {r}:\n{tb}" for r, tb in
                                                        sorted(failed.items())))
    return [got[r] for r in range(n)]
