"""The postprocess's data-dependent loops and the 'dist' split's markers
(CUDA kernels + plain versions).

Replace the XLA ``lax.while_loop``s of ``lstm_unet_tpu/ops/postprocess.py``
(no ``pallas_call``): :func:`grow_into_band` (the reference's ``:53-79``) and
:func:`erosion_distance` (its ``_erosion_distance``, ``:115-137``).

The plain versions run one round a step and read a flag on the host after
each round to decide whether to go on. The kernels (``csrc/
postprocess_loops.cu``) run every round of a call in one cooperative launch
and decide on the card, so a step that calls them never waits for it; each
is bit-identical to its plain version, round count included.

:func:`split_markers` computes the markers of the distance-ridge split (the
reference's plain XLA loop of ``_neighbor_max`` rounds, ``:189-197``): two
window maxima and a predicate, in two launches of a separable kernel on the
card in place of one launch a shifted view a round.

Rounds are counted two ways. The plain versions add theirs to
:data:`ROUNDS` on the host. The kernels add theirs to a counter on their
device that nothing on the step's path reads; :func:`device_rounds` reads it
(one synchronize). :func:`clear_rounds` zeroes both. The counter is made at
a device's first launch and kept: a CUDA graph's replays add to it too.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .ccl import INT_MAX, pad1

GROW_COUNT = _build.LaunchCount()
ERODE_COUNT = _build.LaunchCount()
SPLIT_COUNT = _build.LaunchCount()

# rounds run by the plain loops since the last clear_rounds()
ROUNDS = {"grow": 0, "erode": 0}
# per CUDA device: int64 [2], the kernels' rounds of "grow" and "erode"
_DEVICE_ROUNDS: Dict[torch.device, torch.Tensor] = {}


def clear_rounds() -> None:
    """Zero :data:`ROUNDS` and every device's round counter. A counter is
    zeroed in place, never replaced: a CUDA graph that holds a loop kernel
    holds the counter's address."""
    ROUNDS.update(grow=0, erode=0)
    for counter in _DEVICE_ROUNDS.values():
        counter.zero_()


def device_rounds(device) -> Dict[str, int]:
    """``{"grow": n, "erode": n}``: the rounds the kernels ran on ``device``
    since the last :func:`clear_rounds`, as host ints (one synchronize)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    counter = _DEVICE_ROUNDS.get(device)
    grow, erode = (0, 0) if counter is None else counter.tolist()
    return {"grow": grow, "erode": erode}


def _round_counter(device: torch.device) -> torch.Tensor:
    counter = _DEVICE_ROUNDS.get(device)
    if counter is None:
        counter = _DEVICE_ROUNDS[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return counter


# ---------------------------------------------------------------- plain versions


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's weakly typed scalars are
    when they meet a float32 array."""
    return torch.tensor(x, dtype=torch.float32).item()


def _neighbor_max(lbl: torch.Tensor) -> torch.Tensor:
    """Max over the 8-neighbourhood and the pixel itself, edges padded 0."""
    h, w = lbl.shape
    p = pad1(lbl, 0)
    out = lbl
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.maximum(out, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def _neighbor_min_nonzero(lbl: torch.Tensor) -> torch.Tensor:
    """Min nonzero label over the 8-neighbourhood (INT_MAX where none)."""
    h, w = lbl.shape
    masked = torch.where(lbl > 0, lbl, torch.full_like(lbl, INT_MAX))
    p = pad1(masked, INT_MAX)
    out = torch.full_like(lbl, INT_MAX)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.minimum(out, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def grow_into_band_plain(lbl: torch.Tensor, band: torch.Tensor, max_rounds: int = 0
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`grow_into_band`: a round a step, a
    host read of the "changed" flag after each."""
    GROW_COUNT.plain += 1
    h, w = lbl.shape
    bound = max_rounds if max_rounds > 0 else h * w
    it, changed = 0, True
    while changed and it < bound:
        nb = _neighbor_min_nonzero(lbl)
        new = torch.where((lbl == 0) & band & (nb != INT_MAX), nb, lbl)
        changed = bool((new != lbl).any())
        lbl, it = new, it + 1
    ROUNDS["grow"] += it
    return lbl


def erode(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Binary erosion (8- or 4-neighbourhood); the image border counts as
    background, so cells clipped by the frame edge erode from the edge too."""
    h, w = mask.shape
    p = pad1(mask, False)
    out = mask
    shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if connectivity == 8:
        shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    for dy, dx in shifts:
        out = out & p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return out


def erosion_distance_plain(mask: torch.Tensor, max_iters: int = 0, octagon: bool = False
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`erosion_distance`: a round a step, a
    host read of "not empty" before each."""
    ERODE_COUNT.plain += 1
    h, w = mask.shape
    m = mask.bool()
    dist = m.int()
    bound = max_iters or max(h, w)
    it = 0
    while it < bound and bool(m.any()):
        m = erode(m, 4 if octagon and it % 2 else 8)
        dist = dist + m
        it += 1
    ROUNDS["erode"] += it
    return dist


def split_markers_plain(dist: torch.Tensor, interior: torch.Tensor, window: int,
                        min_dist: int, slack: int, rel: float, rel_window: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`split_markers`: both window maxima as
    rounds of a 3x3 maximum, one launch a shifted view a round."""
    SPLIT_COUNT.plain += 1
    wmax = wide = dist
    for i in range(max(window, rel_window if rel > 0 else 0)):
        wide = _neighbor_max(wide)
        if i + 1 == window:
            wmax = wide
    markers = interior & (dist >= wmax - slack) & (dist >= min_dist)
    if rel > 0:
        markers &= dist.float() >= _f32(rel) * wide.float()
    return markers


# ---------------------------------------------------------------- wrappers


def _check(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if len(shape) != 2:
        raise ValueError(f"{name}: inputs must be [H, W], got {tuple(shape)}")
    if any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: inputs of different shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {device}")


def _launch(entry: str, tensor: torch.Tensor, args) -> None:
    fn = getattr(_build.library(), entry)
    if tensor.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(tensor.device):
            err = fn(*args)
    _build.check(err, entry)


def _cuda_ok(name: str, mask_like: torch.Tensor, *rest: torch.Tensor) -> None:
    if mask_like.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} kernel takes a bool or uint8 mask, got {mask_like.dtype}")
    if not all(t.is_contiguous() for t in (mask_like, *rest)):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    h, w = mask_like.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {h}x{w} too large for int32 indices")


def grow_into_band(lbl: torch.Tensor, band: torch.Tensor, max_rounds: int = 0
                   ) -> torch.Tensor:
    """Simultaneous-BFS growth of int32 labels ``[H, W]`` (0 = none) into
    ``band`` pixels: every round each unlabelled band pixel next to a label
    takes the smallest neighbouring label, so each band pixel goes to its
    geodesically nearest marker and ties go to the smaller label. Stops when
    a round changes nothing, after ``max_rounds`` rounds when > 0, and after
    H*W rounds. Returns new labels; ``lbl`` is not written.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises, and so does a refused launch)."""
    _check("grow_into_band", lbl, band)
    if lbl.device.type == "cpu":
        return grow_into_band_plain(lbl, band, max_rounds)
    if lbl.dtype != torch.int32:
        raise TypeError(f"grow_into_band kernel takes int32 labels, got {lbl.dtype}")
    _cuda_ok("grow_into_band", band, lbl)
    h, w = lbl.shape
    out = torch.empty_like(lbl)
    if h * w == 0:
        return out
    scratch = torch.empty(h * w + 3, dtype=torch.int32, device=lbl.device)
    bound = max_rounds if max_rounds > 0 else h * w
    _launch("lut_grow_into_band", lbl,
            (lbl.data_ptr(), band.data_ptr(), out.data_ptr(), scratch.data_ptr(), h, w,
             bound, _round_counter(lbl.device).data_ptr(), _build.stream_handle(lbl)))
    GROW_COUNT.kernel += 1
    return out


def erosion_distance(mask: torch.Tensor, max_iters: int = 0, octagon: bool = False
                     ) -> torch.Tensor:
    """int32 distance of each pixel of a bool ``mask [H, W]`` to the
    background by iterated erosion: ``dist = mask``, then while the mask is
    not empty and fewer than ``max_iters or max(H, W)`` rounds ran, erode it
    and add it to ``dist``. Erosion by the 8-neighbourhood (Chebyshev), or
    under ``octagon`` by the 8- and the 4-neighbourhood in turn, 8 first; the
    border counts as background.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises, and so does a refused launch)."""
    _check("erosion_distance", mask)
    if mask.device.type == "cpu":
        return erosion_distance_plain(mask, max_iters, octagon)
    _cuda_ok("erosion_distance", mask)
    h, w = mask.shape
    dist = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if h * w == 0:
        return dist
    flag_at = -(-2 * h * w // 4)  # the two uint8 buffers, in int32 words
    scratch = torch.empty(flag_at + 3, dtype=torch.int32, device=mask.device)
    _launch("lut_erosion_distance", mask,
            (mask.data_ptr(), dist.data_ptr(), scratch.data_ptr(), flag_at, h, w,
             max_iters or max(h, w), int(octagon),
             _round_counter(mask.device).data_ptr() + 8, _build.stream_handle(mask)))
    ERODE_COUNT.kernel += 1
    return dist


def split_markers(dist: torch.Tensor, interior: torch.Tensor, window: int, min_dist: int,
                  slack: int, rel: float, rel_window: int) -> torch.Tensor:
    """Markers of the distance-ridge split, bool ``[H, W]``: ``interior &
    (dist >= wmax - slack) & (dist >= min_dist)`` in int32, and with ``rel``
    > 0 also ``float(dist) >= f32(rel) * float(wide)`` (one float32
    multiply). ``wmax`` is the maximum of ``dist`` over the ``(2*window+1)``
    square around each pixel, clipped to the frame (``dist`` itself when
    ``window`` <= 0); ``wide`` the same over the radius ``max(window,
    rel_window)``. The reference takes these as rounds of a 3x3 maximum with
    the border padded 0, which equals the clipped window only because
    ``dist >= 0``: an int32 distance map, ``>= 0`` everywhere, is the
    precondition.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises, and so does a refused launch)."""
    _check("split_markers", dist, interior)
    if dist.device.type == "cpu":
        return split_markers_plain(dist, interior, window, min_dist, slack, rel, rel_window)
    if dist.dtype != torch.int32:
        raise TypeError(f"split_markers kernel takes an int32 distance map, got {dist.dtype}")
    _cuda_ok("split_markers", interior, dist)
    h, w = dist.shape
    markers = torch.empty((h, w), dtype=torch.bool, device=dist.device)
    if h * w == 0:
        return markers
    # radii past the frame's extent change nothing, and keep int32 in the kernel
    window = min(max(window, 0), max(h, w))
    radius = min(max(window, rel_window if rel > 0 else 0), max(h, w))
    scratch = torch.empty((2 if radius > window else 1) * h * w, dtype=torch.int32,
                          device=dist.device)
    # slack and min_dist go as their low 32 bits, as torch takes a Python int
    # against an int32 tensor
    _launch("lut_split_markers", dist,
            (dist.data_ptr(), interior.data_ptr(), markers.data_ptr(), scratch.data_ptr(),
             h, w, window, radius, slack, min_dist, int(rel > 0), _f32(rel) if rel > 0 else 0.0,
             _build.stream_handle(dist)))
    SPLIT_COUNT.kernel += 1
    return markers
