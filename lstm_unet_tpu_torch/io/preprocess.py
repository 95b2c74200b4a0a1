"""Percentile normalization and padding.

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
        targets = torch.tensor([k + 1, min(k + 2, n)], device=x.device,
                               dtype=csum.dtype)
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
    q = torch.tensor([low, high], dtype=torch.float32) / 100
    pos = q * np.float32(n - 1)
    lo_i, hi_i = torch.floor(pos), torch.ceil(pos)
    hw = (pos - lo_i).to(x.device)
    lw = 1 - hw
    vals = s[lo_i.long().to(x.device)] * lw + s[hi_i.long().to(x.device)] * hw
    return vals[0], vals[1]


def normalize_frame(frame: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``(frame - lo) / max(hi - lo, 1e-6)`` in f32 for a padded ``[H, W]``
    frame, with (lo, hi) the 1st/99th percentiles of its ``[:oh, :ow]``."""
    crop = frame[:oh, :ow]
    if frame.dtype.is_floating_point:
        lo, hi = float_percentile_bounds(crop)
    else:
        lo, hi = integer_percentile_bounds(crop)
    return (frame.float() - lo) / torch.clamp(hi - lo, min=1e-6)


def percentile_normalize_np(img: np.ndarray, low: float = 1.0,
                            high: float = 99.0) -> np.ndarray:
    """NumPy normalization of a whole frame (host-side twin)."""
    x = img.astype(np.float32)
    lo = np.percentile(x, low)
    hi = np.percentile(x, high)
    return (x - lo) / max(hi - lo, 1e-6)


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
