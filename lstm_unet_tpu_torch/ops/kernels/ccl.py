"""K3 — 8-connected connected-component labelling (CUDA kernel + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/ccl.py::connected_components_pallas``;
the plain version mirrors the reference twin ``ops/ccl.py::
connected_components``. A binary ``[H, W]`` mask becomes int32 labels: 0 for
background, and for each component its minimum linear index ``row*W + col``
plus one — not compact (``ops/ccl.py::relabel_compact`` numbers them).

The plain version propagates the 3x3 minimum to a fixed point, four sweeps
per convergence check, bounded by H*W sweeps, as the reference does. The
kernel (``csrc/ccl.cu``) is a union-find over runs of set pixels whose roots
are component minima, so it reaches the same labels with no iteration bound,
in one launch. :func:`route` picks one of two kernels by shape, each with its
own launch count:

- ``"cluster"`` (:data:`COUNT`): frames whose int32 label grid fits the
  shared memory of a thread-block cluster of 8 (:func:`cluster_smem_bytes`;
  512^2 is 8 strips of 64 rows, 128 KB each). The forest never leaves shared
  memory; seams are joined through distributed shared memory. No scratch.
- ``"grid"`` (:data:`GRID_COUNT`): every other shape, one cooperative launch
  with the forest in the label grid itself and the mask's bit words as scratch
  behind it (one allocation).
"""

from __future__ import annotations

import torch

from . import _build

COUNT = _build.LaunchCount()       # the cluster route
GRID_COUNT = _build.LaunchCount()  # the grid route

CLUSTER_BLOCKS = 8    # the portable cluster size
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

INT_MAX = torch.iinfo(torch.int32).max


def pad1(x: torch.Tensor, value: int) -> torch.Tensor:
    """``x [H, W]`` with a one-pixel border of ``value`` (exact for any int)."""
    p = x.new_full((x.shape[0] + 2, x.shape[1] + 2), value)
    p[1:-1, 1:-1] = x
    return p


def _neighbor_min(lbl: torch.Tensor) -> torch.Tensor:
    """Min over the 8-neighbourhood and the pixel itself, edges padded +inf."""
    h, w = lbl.shape
    p = pad1(lbl, INT_MAX)
    out = lbl
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.minimum(out, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def cluster_smem_bytes(h: int, w: int) -> int:
    """Shared memory one block of the cluster route needs: its strip of
    ``ceil(h / 8)`` rows of int32 parents (in whole groups of 32), the bit
    words of the strip and of the row above it, and the strip's root flags."""
    rows, words = -(-h // CLUSTER_BLOCKS), -(-w // 32)
    return 4 * (-(-rows * w // 32) * 32 + (rows + 1) * words + rows * words)


def route(h: int, w: int) -> str:
    """The K3 kernel that takes an ``h`` x ``w`` mask: ``"cluster"`` or
    ``"grid"``."""
    return "cluster" if cluster_smem_bytes(h, w) <= SMEM_LIMIT else "grid"


_COUNTS = {"cluster": COUNT, "grid": GRID_COUNT}


def connected_components_plain(mask: torch.Tensor, max_iters: int = 0
                               ) -> torch.Tensor:
    """Plain PyTorch version: synchronous min-label propagation."""
    h, w = mask.shape
    _COUNTS[route(h, w)].plain += 1
    mask = mask.bool()
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=mask.device).reshape(h, w)
    inf = torch.full_like(idx, INT_MAX)
    lbl = torch.where(mask, idx, inf)
    bound = max_iters or h * w
    it, changed = 0, True
    while changed and it < bound:
        new = lbl
        for _ in range(4):
            new = torch.where(mask, _neighbor_min(new), inf)
        changed = bool((new != lbl).any())
        lbl, it = new, it + 4
    return torch.where(mask, lbl, torch.zeros_like(lbl))


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Labels of a bool (or uint8 0/1) mask ``[H, W]``; see the module doc.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    their :func:`route` (any other device raises, and so does a refused
    launch). The kernel needs a contiguous mask.
    """
    if mask.dim() != 2:
        raise ValueError(f"mask must be [H, W], got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return connected_components_plain(mask)
    return launch(mask, route(*mask.shape))


def launch(mask: torch.Tensor, which: str) -> torch.Tensor:
    """Labels of a CUDA mask by the kernel of route ``which``. The grid
    route takes every shape; the cluster route only those that fit it."""
    if which not in _COUNTS:
        raise ValueError(f"unknown K3 route {which!r}")
    if mask.device.type != "cuda":
        raise ValueError(f"no CCL kernel for device {mask.device}")
    if mask.dim() != 2:
        raise ValueError(f"mask must be [H, W], got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"CCL kernel takes a bool or uint8 mask, got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError("CCL kernel needs a contiguous mask")
    h, w = mask.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError(f"mask {h}x{w} too large for int32 labels")
    if which == "cluster" and route(h, w) != "cluster":
        raise ValueError(f"mask {h}x{w} does not fit the cluster route's shared memory")
    if h * w == 0:
        return torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if which == "cluster":
        labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
        entry, out = "lut_ccl_cluster", labels
    else:  # the bit words follow the labels in one buffer
        out = torch.empty((h * w + h * -(-w // 32),), dtype=torch.int32,
                          device=mask.device)
        entry, labels = "lut_ccl_grid", out[:h * w].view(h, w)
    fn = getattr(_build.library(), entry)
    args = (mask.data_ptr(), out.data_ptr(), h, w, _build.stream_handle(mask))
    if mask.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(mask.device):
            err = fn(*args)
    _build.check(err, entry)
    _COUNTS[which].kernel += 1
    return labels
