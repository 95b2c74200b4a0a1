"""The few collectives the mesh needs: sums, maxima, gathers along an axis
and the exchange of boundary rows with the neighbours of a 'spatial' line.

This is the transport only: every tensor a caller passes lives where its
math runs (on the card for a CUDA run) and comes back there. Under
``nccl`` everything stays on the card. Under ``gloo``, which ranks that
share one card use, PyTorch's gloo takes CUDA tensors for all-reduce,
all-gather and broadcast but not for point-to-point sends (on torch 2.11 a
CUDA ``send`` ends the process: gloo's TCP transport is handed the device
pointer); :func:`exchange` stages those through host memory, and only
those.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def group_ranks(group: Group) -> List[int]:
    """The global ranks of ``group`` in group-rank order."""
    return dist.get_process_group_ranks(group or dist.group.WORLD)


def all_reduce_(t: torch.Tensor, op: str = "sum", group: Group = None) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (``op`` 'sum' or 'max'); returns it."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The blocks of every rank of ``group``, concatenated along ``dim`` in
    group-rank order (each rank's ``t`` has one shape)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _p2p_on_host(t: torch.Tensor, group: Group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def exchange(to_prev: torch.Tensor, to_next: torch.Tensor, prev: Optional[int],
             nxt: Optional[int], group: Group
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Send ``to_prev`` to global rank ``prev`` and ``to_next`` to ``nxt``
    (None: no neighbour on that side) and receive theirs:
    ``(from_prev, from_next)``, each shaped as what this rank sends the other
    way (the blocks of a line are equal), or None where there is no
    neighbour."""
    host = _p2p_on_host(to_prev, group)
    ops, recvs = [], []
    for peer, out in ((prev, to_prev), (nxt, to_next)):
        if peer is None:
            recvs.append(None)
            continue
        out = out.contiguous()
        buf = torch.empty(out.shape, dtype=out.dtype, device="cpu" if host else out.device)
        ops.append(dist.P2POp(dist.isend, out.cpu() if host else out, peer, group))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        recvs.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        recvs = [None if r is None else r.to(to_prev.device) for r in recvs]
    return recvs[0], recvs[1]
