"""CTC sequence readers: the training batch provider and the streaming
inference frame reader.

Counterpart of ``lstm_unet_tpu/io/dataset.py`` (``load_ctc_sequence``,
``CTCRAMReaderSequence2D``, ``CTCInferenceReader``). CTC layout::

    <root>/<dataset>/<seq>/t*.tif
    <root>/<dataset>/<seq>_GT/SEG/man_seg*.tif   (possibly sparse)
    <root>/<dataset>/<seq>_ST/SEG/man_seg*.tif   (silver truth, optional)

For the same params and seed the training batches are bit-identical to the
reference reader's, for any thread count (``tests/test_torch_reader.py``).
With ``elastic_augmentation`` the images agree to ~1e-4 and the labels to a
few pixels a frame: the port's affine warp is numpy where the reference
calls ``cv2.warpAffine`` (``tests/test_torch_elastic.py``).
"""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import CTCParams
from ..utils import log_print
from .preprocess import instance_to_three_class, percentile_normalize_np
from .tiff import read_tiff

_FRAME_RE = re.compile(r"t(\d+)\.tif$")
_SEG_RE = re.compile(r"man_seg(\d+)\.tif$")


def _frame_index(path: str, pattern: re.Pattern = _FRAME_RE) -> Optional[int]:
    m = pattern.search(os.path.basename(path))
    return int(m.group(1)) if m else None


class SequenceData:
    """One CTC sequence in RAM: ``images [T,H,W]`` f32 (percentile-normalized),
    ``seg [T,H,W]`` uint8 {0,1,2}, ``valid [T]`` (frame annotated),
    ``full_seg [T]`` (annotation covers every cell) and, when kept, the raw
    instance GT ``inst [T,H,W]`` int32."""

    def __init__(self, images, seg, valid, full_seg, name, inst=None):
        self.images = images
        self.seg = seg
        self.valid = valid
        self.full_seg = full_seg
        self.inst = inst
        self.name = name

    def __len__(self) -> int:
        return self.images.shape[0]


def load_ctc_sequence(root: str, dataset: str, seq: str,
                      gt_is_full_seg: Optional[bool] = None,
                      keep_instances: bool = False) -> SequenceData:
    """Load one sequence and its SEG annotations. Gold truth (``_GT``) wins
    over silver truth (``_ST``) for a frame. Silver truth and simulated
    datasets (name containing "SIM") are fully annotated; gold truth of real
    datasets may label only some cells (``gt_is_full_seg`` overrides)."""
    seq_dir = os.path.join(root, dataset, seq)
    frames = sorted(glob.glob(os.path.join(seq_dir, "t*.tif")))
    if not frames:
        raise FileNotFoundError(f"no t*.tif frames under {seq_dir}")
    imgs = np.stack([percentile_normalize_np(read_tiff(p)) for p in frames])
    t, h, w = imgs.shape
    seg = np.zeros((t, h, w), dtype=np.uint8)
    inst = np.zeros((t, h, w), dtype=np.int32) if keep_instances else None
    valid = np.zeros((t,), dtype=bool)
    full = np.zeros((t,), dtype=bool)
    gt_full = gt_is_full_seg if gt_is_full_seg is not None else ("SIM" in dataset)
    for gt_kind, kind_full in (("_GT", gt_full), ("_ST", True)):
        seg_dir = os.path.join(root, dataset, seq + gt_kind, "SEG")
        for p in sorted(glob.glob(os.path.join(seg_dir, "man_seg*.tif"))):
            idx = _frame_index(p, _SEG_RE)
            if idx is None or idx >= t or valid[idx]:
                continue
            raw = read_tiff(p)
            seg[idx] = instance_to_three_class(raw)
            if inst is not None:
                inst[idx] = raw.astype(np.int32)
            valid[idx] = True
            full[idx] = kind_full
    return SequenceData(imgs, seg, valid, full, f"{dataset}/{seq}", inst)


class CTCRAMReaderSequence2D:
    """Threaded batches of unrolled windows for truncated-BPTT training.

    Each of the ``batch_size`` lanes walks a randomly chosen sequence in
    ``unroll_len`` windows, with one crop, flip, rot90, gain/bias and (with
    ``elastic_augmentation``) affine warp drawn per traversal so the LSTM
    state stays coherent across windows.
    ``get_batch()`` returns::

        image [B,T,H,W,1] float32, seg [B,T,H,W] int32 {0,1,2},
        valid [B,T] float32, full_seg [B,T] float32, is_last [B] float32

    plus ``inst [B,T,H,W]`` int32 with ``return_instances``. A short tail
    window repeats its last frame, marked invalid; ``is_last`` marks a
    window that ends its sequence (the trainer resets that lane's state).

    The trainer carries the state of lane i from one batch into the next, so
    each lane has its own FIFO queue and its own RNG stream,
    ``default_rng(seed + 9973 * i)``; ``num_threads`` producers share the
    lanes round-robin. The stream is therefore the same for any thread
    count. A producer's exception is raised by ``get_batch``; ``stop()``
    drains the queues, so a restart begins fresh traversals.
    """

    def __init__(self, params: CTCParams, sequence_list: Optional[Sequence] = None,
                 num_threads: Optional[int] = None, queue_capacity: int = 16,
                 seed: int = 0, return_instances: bool = False):
        self.params = params
        self.crop = tuple(params.crop_size)
        self.unroll = params.unroll_len
        self.batch = params.batch_size
        self.return_instances = return_instances
        seq_list = (sequence_list if sequence_list is not None
                    else params.train_sequence_list)
        self.sequences = [
            load_ctc_sequence(params.root_data_dir, ds, sq, params.gt_is_full_seg,
                              keep_instances=return_instances)
            for ds, sq in seq_list]
        requested = num_threads if num_threads is not None else params.num_prefetch_threads
        self.num_threads = max(1, min(requested, self.batch))
        cap = max(2, queue_capacity // self.batch)
        self._lane_qs: List[queue.Queue] = [queue.Queue(maxsize=cap)
                                            for _ in range(self.batch)]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._seed = seed
        self._err: Optional[BaseException] = None
        self.randomize = params.randomize
        self.elastic = params.elastic_augmentation

    def _new_traversal(self, rng: np.random.Generator):
        """A sequence and its augmentation for one traversal; the draws are
        the reference's, in its order."""
        rnd = self.randomize
        s = self.sequences[rng.integers(len(self.sequences))] if rnd else self.sequences[0]
        t, h, w = s.images.shape
        ch, cw = min(self.crop[0], h), min(self.crop[1], w)
        aug = {
            "y0": int(rng.integers(0, h - ch + 1)) if rnd else 0,
            "x0": int(rng.integers(0, w - cw + 1)) if rnd else 0,
            "flip_y": bool(rng.integers(2)) and rnd,
            "flip_x": bool(rng.integers(2)) and rnd,
            "rot90": int(rng.integers(4)) if (rnd and ch == cw) else 0,
            "gain": float(rng.uniform(0.9, 1.1)) if rnd else 1.0,
            "bias": float(rng.uniform(-0.05, 0.05)) if rnd else 0.0,
            "start": 0,
            "affine": None,
        }
        if self.elastic and rnd:
            # a small rotation, scale and shear, fixed for the traversal so
            # the LSTM state stays geometrically coherent
            ang = rng.uniform(-10, 10)
            scale = rng.uniform(0.9, 1.1)
            shear = rng.uniform(-0.05, 0.05)
            a = np.deg2rad(ang)
            aug["affine"] = np.array([[np.cos(a) * scale, -np.sin(a) + shear, 0.0],
                                      [np.sin(a) + shear, np.cos(a) * scale, 0.0]],
                                     np.float32)
        return s, aug

    @staticmethod
    def _apply_affine(img: np.ndarray, seg: np.ndarray, m: np.ndarray,
                      inst: Optional[np.ndarray] = None):
        """Warp a ``[T,H,W]`` window by the 2x3 affine ``m`` about the crop
        centre, as ``cv2.warpAffine`` with ``BORDER_REFLECT``
        (``fedcba|abcdef``): the image bilinear, ``seg`` and ``inst``
        nearest. Each output pixel samples the input at the inverse map of
        its coordinates, in float64."""
        h, w = img.shape[1:]
        mm = m.copy()
        c = np.array([w / 2, h / 2], np.float32)
        mm[:, 2] = c - mm[:, :2] @ c
        a = mm.astype(np.float64)
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        inv = np.array([[a[1, 1], -a[0, 1]], [-a[1, 0], a[0, 0]]]) / det
        off = -inv @ a[:, 2]
        y, x = np.mgrid[0:h, 0:w].astype(np.float64)
        sx = inv[0, 0] * x + inv[0, 1] * y + off[0]
        sy = inv[1, 0] * x + inv[1, 1] * y + off[1]

        def reflect(i, n):
            i = np.mod(i, 2 * n)
            return np.where(i >= n, 2 * n - 1 - i, i)

        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = (sx - x0)[None], (sy - y0)[None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        xa, xb = reflect(x0, w), reflect(x0 + 1, w)
        ya, yb = reflect(y0, h), reflect(y0 + 1, h)
        f = img.astype(np.float64)
        img = ((1 - fy) * ((1 - fx) * f[:, ya, xa] + fx * f[:, ya, xb])
               + fy * ((1 - fx) * f[:, yb, xa] + fx * f[:, yb, xb])).astype(np.float32)
        ny = reflect(np.rint(sy).astype(np.int64), h)
        nx = reflect(np.rint(sx).astype(np.int64), w)
        seg = seg[:, ny, nx].astype(np.int32)
        if inst is not None:
            inst = inst[:, ny, nx].astype(np.int32)
        return img, seg, inst

    def _window(self, s: SequenceData, aug: Dict, start: int):
        ch = min(self.crop[0], s.images.shape[1])
        cw = min(self.crop[1], s.images.shape[2])
        sl_t = slice(start, start + self.unroll)
        sl_y = slice(aug["y0"], aug["y0"] + ch)
        sl_x = slice(aug["x0"], aug["x0"] + cw)
        img = s.images[sl_t, sl_y, sl_x].copy()
        seg = s.seg[sl_t, sl_y, sl_x].astype(np.int32)
        inst = s.inst[sl_t, sl_y, sl_x].copy() if self.return_instances else None
        valid = s.valid[sl_t].astype(np.float32)
        full_seg = s.full_seg[sl_t].astype(np.float32)
        n = img.shape[0]
        if n < self.unroll:  # tail: repeat the last frame, marked invalid
            rep = self.unroll - n
            img = np.concatenate([img, np.repeat(img[-1:], rep, 0)], 0)
            seg = np.concatenate([seg, np.repeat(seg[-1:], rep, 0)], 0)
            if inst is not None:
                inst = np.concatenate([inst, np.repeat(inst[-1:], rep, 0)], 0)
            valid = np.concatenate([valid, np.zeros(rep, np.float32)], 0)
            full_seg = np.concatenate([full_seg, np.zeros(rep, np.float32)], 0)
        labs = [seg] if inst is None else [seg, inst]
        if aug["flip_y"]:
            img = img[:, ::-1]
            labs = [lab[:, ::-1] for lab in labs]
        if aug["flip_x"]:
            img = img[:, :, ::-1]
            labs = [lab[:, :, ::-1] for lab in labs]
        if aug["rot90"]:
            img = np.rot90(img, aug["rot90"], axes=(1, 2))
            labs = [np.rot90(lab, aug["rot90"], axes=(1, 2)) for lab in labs]
        seg = labs[0]
        inst = labs[1] if inst is not None else None
        if aug["affine"] is not None:
            img, seg, inst = self._apply_affine(img, seg, aug["affine"], inst)
        img = img * aug["gain"] + aug["bias"]  # photometric jitter
        is_last = float(start + self.unroll >= len(s))
        return img.astype(np.float32), seg, inst, valid, full_seg, is_last

    def _producer(self, tid: int):
        try:
            self._producer_loop(tid)
        except BaseException as e:  # raised by get_batch
            if self._err is None:
                self._err = e

    def _producer_loop(self, tid: int):
        my_lanes = [i for i in range(self.batch) if i % self.num_threads == tid]
        rngs = {i: np.random.default_rng(self._seed + 9973 * i) for i in my_lanes}
        lanes = {i: self._new_traversal(rngs[i]) for i in my_lanes}
        while not self._stop.is_set():
            for i in my_lanes:
                s, aug = lanes[i]
                item = self._window(s, aug, aug["start"])
                if item[-1]:  # is_last
                    lanes[i] = self._new_traversal(rngs[i])
                else:
                    aug["start"] += self.unroll
                while not self._stop.is_set():
                    try:
                        self._lane_qs[i].put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

    def start_queues(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for tid in range(self.num_threads):
            th = threading.Thread(target=self._producer, args=(tid,), daemon=True)
            th.start()
            self._threads.append(th)
        log_print(f"CTCRAMReaderSequence2D: {self.num_threads} producer thread(s) started")

    def get_batch(self):
        items = []
        for q in self._lane_qs:
            while True:
                if self._err is not None:
                    raise self._err
                try:
                    items.append(q.get(timeout=0.5))
                    break
                except queue.Empty:
                    continue
        imgs, segs, insts, valids, fulls, lasts = zip(*items)
        batch = (np.stack(imgs)[..., None], np.stack(segs), np.stack(valids),
                 np.stack(fulls), np.asarray(lasts, np.float32))
        if self.return_instances:
            batch = batch + (np.stack(insts),)
        return batch

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=2.0)
        self._threads.clear()
        for q in self._lane_qs:  # a restart must not pair fresh state with old windows
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        self._err = None


class CTCInferenceReader:
    """Yields ``(frame_index or None, frame [H, W])`` for a sequence dir.

    The first ``pre_sequence_frames`` frames are yielded first, in reverse
    order and with index None: warm-up frames whose output is discarded but
    whose LSTM state is kept. With ``normalize=False`` frames come raw in
    their stored dtype (the engine normalizes them on the device).
    """

    def __init__(self, sequence_path: str, filename_format: str = "t*.tif",
                 pre_sequence_frames: int = 0, normalize: bool = True):
        self.paths = sorted(glob.glob(os.path.join(sequence_path, filename_format)))
        if not self.paths:
            raise FileNotFoundError(
                f"no frames matching {filename_format} under {sequence_path}")
        self.pre = min(pre_sequence_frames, len(self.paths))
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.paths)

    def frame_indices(self) -> List[int]:
        out = []
        for p in self.paths:
            idx = _frame_index(p)
            out.append(idx if idx is not None else len(out))
        return out

    def _load(self, path: str) -> np.ndarray:
        img = read_tiff(path)
        return percentile_normalize_np(img) if self.normalize else img

    def __iter__(self):
        for p in reversed(self.paths[:self.pre]):
            yield None, self._load(p)
        for p, idx in zip(self.paths, self.frame_indices()):
            yield idx, self._load(p)
