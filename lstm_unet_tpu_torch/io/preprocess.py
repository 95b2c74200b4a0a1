"""Percentile normalization, instance -> 3-class GT and padding.

Counterpart of ``lstm_unet_tpu/io/preprocess.py``. The streaming engine
normalizes each frame on its device with the 1st/99th percentiles of the
unpadded frame: exactly, from a 65536-bin histogram, for integer frames
(:func:`integer_percentile_bounds`), and with ``jnp.percentile``'s linear
interpolation for float frames (:func:`float_percentile_bounds`). Both
finish in the same f32 arithmetic as the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.ccl import bincount


def _positions(q: float, n: int):
    """f32 (k, frac) of the q-th percentile of n sorted values, computed as
    the reference does: pos = f32(q / 100) * (n - 1)."""
    pos = np.float32(q / 100.0) * np.float32(n - 1)
    k = int(np.floor(pos))
    return k, np.float32(pos - np.float32(k))


def integer_percentile_bounds(x: torch.Tensor, low: float = 1.0,
                              high: float = 99.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (low, high) percentiles of integer values in [0, 65535]:
    histogram, cumulative sum, search of the order statistics, then the
    linear interpolation in f32. Returns two f32 scalars on x's device."""
    csum = torch.cumsum(bincount(x.reshape(-1).long(), 65536), 0)
    n = x.numel()

    def pct(q):
        k, frac = _positions(q, n)
        # [k + 1, min(k + 2, n)], made on x's device (no copy from the host)
        targets = torch.arange(k + 1, k + 3, device=x.device, dtype=csum.dtype).clamp_(max=n)
        lo_v, hi_v = torch.searchsorted(csum, targets, side="left").float()
        return lo_v * float(np.float32(1.0) - frac) + hi_v * float(frac)

    return pct(low), pct(high)


def float_percentile_bounds(x: torch.Tensor, low: float = 1.0,
                            high: float = 99.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) percentiles of float values with linear interpolation
    between order statistics, in f32, as ``jnp.percentile``."""
    s = torch.sort(x.reshape(-1).float()).values
    n = s.numel()
    # positions and weights in f32 on the host, applied as Python numbers
    # (exact f32 values), so nothing is copied to x's device
    q = torch.tensor([low, high], dtype=torch.float32) / 100
    pos = q * np.float32(n - 1)
    lo_i, hi_i = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo_i
    lw = 1 - hw
    return tuple(s[int(lo_i[i])] * float(lw[i]) + s[int(hi_i[i])] * float(hw[i])
                 for i in range(2))


def normalize_frame(frame: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``(frame - lo) / max(hi - lo, 1e-6)`` in f32 for a padded ``[H, W]``
    frame, with (lo, hi) the 1st/99th percentiles of its ``[:oh, :ow]``."""
    crop = frame[:oh, :ow]
    if frame.dtype.is_floating_point:
        lo, hi = float_percentile_bounds(crop)
    else:
        lo, hi = integer_percentile_bounds(crop)
    return (frame.float() - lo) / torch.clamp(hi - lo, min=1e-6)


def normalize_frames(frames: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """:func:`normalize_frame` of each lane of a padded ``[B, H, W]`` stack,
    each with the stats of its own ``[:oh, :ow]`` crop (the reference's
    ``jax.vmap`` of the per-frame normalization)."""
    return torch.stack([normalize_frame(f, oh, ow) for f in frames])


def percentile_normalize_np(img: np.ndarray, low: float = 1.0,
                            high: float = 99.0) -> np.ndarray:
    """NumPy normalization of a whole frame (host-side twin)."""
    x = img.astype(np.float32)
    lo = np.percentile(x, low)
    hi = np.percentile(x, high)
    return (x - lo) / max(hi - lo, 1e-6)


def instance_to_three_class(labels: np.ndarray, boundary_width: int = 1) -> np.ndarray:
    """Instance mask -> uint8 {0: background, 1: interior, 2: boundary}.

    A labelled pixel is boundary when any pixel of its (2w+1)^2 neighbourhood
    (edge-replicated at the frame border) carries another label, background
    included: the reference's per-label 3x3 erosion for w = 1, in one pass.
    """
    lab = labels.astype(np.int32)
    fg = lab > 0
    boundary = np.zeros_like(fg)
    h, w = lab.shape
    bw = boundary_width
    padded = np.pad(lab, bw, mode="edge")
    for dy in range(-bw, bw + 1):
        for dx in range(-bw, bw + 1):
            if dy or dx:
                neigh = padded[bw + dy:bw + dy + h, bw + dx:bw + dx + w]
                boundary |= fg & (neigh != lab)
    out = np.zeros(lab.shape, dtype=np.uint8)
    out[fg] = 1
    out[boundary] = 2
    return out


def pad_to_multiple(img: np.ndarray, multiple: int
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad the last two axes up to a multiple of ``multiple``;
    returns (padded, (pad_h, pad_w))."""
    h, w = img.shape[-2], img.shape[-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (0, 0)
    pad = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(img, pad, mode="reflect"), (ph, pw)
