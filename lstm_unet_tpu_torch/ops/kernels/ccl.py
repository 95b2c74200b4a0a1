"""K3 — 8-connected connected-component labelling (CUDA kernel + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/ccl.py::connected_components_pallas``;
the plain version mirrors the reference twin ``ops/ccl.py::
connected_components``. A binary ``[H, W]`` mask becomes int32 labels: 0 for
background, and for each component its minimum linear index ``row*W + col``
plus one — not compact (``ops/ccl.py::relabel_compact`` numbers them).

The plain version propagates the 3x3 minimum to a fixed point, four sweeps
per convergence check, bounded by H*W sweeps, as the reference does. The
kernel (``csrc/ccl.cu``) is a union-find whose roots are component minima,
so it reaches the same labels with no iteration bound at all.
"""

from __future__ import annotations

import torch

from . import _build

COUNT = _build.LaunchCount()

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


def connected_components_plain(mask: torch.Tensor, max_iters: int = 0
                               ) -> torch.Tensor:
    """Plain PyTorch version: synchronous min-label propagation."""
    COUNT.plain += 1
    h, w = mask.shape
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

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). The kernel needs a contiguous mask.
    """
    if mask.dim() != 2:
        raise ValueError(f"mask must be [H, W], got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return connected_components_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"no CCL kernel for device {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"CCL kernel takes a bool or uint8 mask, got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError("CCL kernel needs a contiguous mask")
    h, w = mask.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError(f"mask {h}x{w} too large for int32 labels")
    labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if h * w == 0:
        return labels
    parent = torch.empty((h * w,), dtype=torch.int32, device=mask.device)
    lib = _build.library()
    with torch.cuda.device(mask.device):
        err = lib.lut_ccl(mask.data_ptr(), parent.data_ptr(), labels.data_ptr(),
                          h, w, _build.stream_handle(mask))
    _build.check(err, "lut_ccl")
    COUNT.kernel += 1
    return labels
