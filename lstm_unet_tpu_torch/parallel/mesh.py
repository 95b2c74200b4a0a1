"""The device mesh of a multi-process run, and how a batch lies over it.

Counterpart of ``lstm_unet_tpu/parallel/mesh.py``. A mesh is
``{'data': N}``, ``{'spatial': M}`` or ``{'data': N, 'spatial': M}`` over
the ranks of ``torch.distributed``, laid out in row-major order as the
reference reshapes its devices (``mesh.py:36``): rank ``r`` sits at
``divmod(r, M)`` of an ``N x M`` grid.

- ``'data'`` takes batch lanes: whole sequences per rank, so the ConvLSTM
  state of a lane never leaves its rank and training all-reduces the
  gradients;
- ``'spatial'`` takes frame rows (H): each conv with a kernel taller than
  one row first exchanges ``k // 2`` boundary rows with its neighbours
  (``halo.py``).

The split rules are the reference's: lanes go over 'data' only when B
divides by its size, rows over 'spatial' only when H % (size * 2^depth) ==
0 (every encoder level, and the pooled bottleneck, then splits evenly, so
max-pool, upsample, LayerNorm and the elementwise ops need no neighbour);
what does not divide is replicated. A :class:`Split` records the outcome
and is the handle the model's conv sites take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .comm import Group, all_gather

AXES = ("data", "spatial")


def mesh_layout(mesh_shape: Dict[str, int], world_size: int) -> np.ndarray:
    """The ranks of a mesh as an array of its shape (row-major). A mesh that
    needs more ranks than ``world_size`` raises ``ValueError``, and so does
    one that leaves ranks out: a rank outside the mesh would have no work."""
    names = tuple(mesh_shape)
    if not names or any(a not in AXES for a in names) or names != tuple(
            a for a in AXES if a in names):
        raise ValueError(f"mesh_shape must be {{'data': N}}, {{'spatial': M}} or "
                         f"{{'data': N, 'spatial': M}}, got {mesh_shape!r}")
    sizes = tuple(int(v) for v in mesh_shape.values())
    if min(sizes) < 1:
        raise ValueError(f"mesh axis sizes must be positive, got {mesh_shape!r}")
    n = int(np.prod(sizes))
    if n > world_size:
        raise ValueError(f"mesh needs {n} ranks, have {world_size}")
    if n < world_size:
        raise ValueError(f"mesh {mesh_shape!r} uses {n} of the {world_size} ranks: "
                         f"run {n} processes")
    return np.arange(n).reshape(sizes)


class Mesh:
    """This rank's view of the mesh: ``axis_names``, ``shape``, its
    ``coords`` and, per axis, the process group of the ranks that differ
    from it only along that axis (``group(axis)``; None for an axis of size
    1 or absent)."""

    def __init__(self, mesh_shape: Dict[str, int]):
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.grid = mesh_layout(mesh_shape, world)
        self.axis_names = tuple(mesh_shape)
        self.shape = self.grid.shape
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        at = np.argwhere(self.grid == self.rank)[0]
        self.coords = {a: int(i) for a, i in zip(self.axis_names, at)}
        self._groups: Dict[str, Group] = {}
        for ax, name in enumerate(self.axis_names):
            if self.shape[ax] == 1:
                continue
            # every rank creates every group, in one order (new_group is
            # collective over the world)
            lines = np.moveaxis(self.grid, ax, -1).reshape(-1, self.shape[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = g

    def axis_size(self, axis: str) -> int:
        return mesh_axis_sizes(self).get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Group:
        return self._groups.get(axis)


def make_mesh(mesh_shape: Optional[Dict[str, int]]) -> Optional[Mesh]:
    """The mesh of ``mesh_shape`` over this run's ranks, or None for ``{}``
    and for a mesh of one rank (``{'data': 1}``, the trainer's default):
    that is a run of one process."""
    if not mesh_shape or int(np.prod(list(mesh_shape.values()))) == 1:
        if mesh_shape:
            mesh_layout(mesh_shape, 1)  # the names must still be valid
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(f"mesh {mesh_shape!r} uses 1 of the {dist.get_world_size()} "
                             "ranks: run 1 process")
        return None
    return Mesh(dict(mesh_shape))


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


@dataclass(frozen=True)
class Split:
    """How one batch ``[B, H, ...]`` lies over a mesh: its lanes over 'data'
    (``lanes``) and its rows over 'spatial' (``rows``), each only when the
    split rules allow. The model carries it (``ULSTMnet2D.split``) and its
    conv sites take it: a halo exchange over the 'spatial' group before
    each conv with ``k > 1`` when ``rows``, an all-reduced int8 scale over
    :attr:`parts` when anything is split."""

    mesh: Mesh
    lanes: bool
    rows: bool

    @property
    def spatial(self) -> Group:
        """The group H is split over (None: H is whole here)."""
        return self.mesh.group("spatial") if self.rows else None

    @property
    def parts(self) -> Group:
        """The group whose blocks make up the whole batch: a reduction over
        the batch (a loss, an int8 scale, the gradients) runs over it."""
        if self.lanes and self.rows:
            return dist.group.WORLD
        return self.mesh.group("data" if self.lanes else "spatial")

    def lane_slice(self, batch: int) -> slice:
        return _block(batch, self.mesh, "data", self.lanes)

    def row_slice(self, height: int) -> slice:
        return _block(height, self.mesh, "spatial", self.rows)

    def block(self, batch: int, height: int):
        """``(lanes, rows)`` of this rank's block of ``batch`` x ``height``."""
        lanes, rows = self.lane_slice(batch), self.row_slice(height)
        return lanes.stop - lanes.start, rows.stop - rows.start

    def take(self, x, lane_dim: int = 0, row_dim: Optional[int] = None):
        """This rank's block of the whole ``x`` (a tensor or array): its
        lanes along ``lane_dim`` and, with ``row_dim``, its rows."""
        idx = [slice(None)] * x.ndim
        idx[lane_dim] = self.lane_slice(x.shape[lane_dim])
        if row_dim is not None:
            idx[row_dim] = self.row_slice(x.shape[row_dim])
        return x[tuple(idx)]

    def gather(self, t: torch.Tensor, lane_dim: Optional[int] = None,
               row_dim: Optional[int] = None) -> torch.Tensor:
        """This rank's block ``t`` gathered on every rank of its groups: its
        rows over 'spatial' along ``row_dim``, then its lanes over 'data'
        along ``lane_dim`` (each given and split)."""
        if row_dim is not None and self.rows:
            t = all_gather(t, row_dim, self.spatial)
        if lane_dim is not None and self.lanes:
            t = all_gather(t, lane_dim, self.mesh.group("data"))
        return t


def _block(n: int, mesh: Mesh, axis: str, split: bool) -> slice:
    if not split:
        return slice(0, n)
    size = n // mesh.axis_size(axis)
    i = mesh.index(axis)
    return slice(i * size, (i + 1) * size)


def plan_split(mesh: Optional[Mesh], batch: int, height: int, depth: int,
               replicate_lanes: bool = False) -> Optional[Split]:
    """The split of a batch of ``batch`` lanes of ``height`` rows for a
    model of ``depth`` levels, by the reference's rules; None when nothing
    is split (no mesh, or nothing divides): the model runs as in one
    process. ``replicate_lanes`` keeps the lanes whole (TTA)."""
    if mesh is None:
        return None
    dn, sn = mesh.axis_size("data"), mesh.axis_size("spatial")
    lanes = dn > 1 and batch % dn == 0 and not replicate_lanes
    rows = sn > 1 and height % (sn * 2 ** depth) == 0
    return Split(mesh, lanes, rows) if lanes or rows else None
