"""Streaming inference engine.

Counterpart of ``lstm_unet_tpu/engine/infer.py`` (single sequence, no TTA,
scene-cut reset or mesh). Per frame, on the model's device::

    raw frame -> reflect-pad to a multiple of 2^depth (host)
    -> percentile normalization with the stats of the unpadded frame
    -> ULSTMnet2D.step with the (h, c) state carried across the sequence
    -> softmax on the unpadded crop -> postprocess_frame -> int32 labels

and the labels go to a uint16 ``mask###.tif`` on a writer thread. Frames are
decoded on a prefetch thread; the labels of frame t-1 are written after
frame t has been dispatched. The state is rebound to the step's output every
frame and the old tensors are released, so the caching allocator hands their
memory to the next step: memory stays flat over any sequence length (the
reference donates the state buffers for the same effect).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..checkpoint.convert import load_model
from ..config import InferenceParams
from ..io.dataset import CTCInferenceReader
from ..io.preprocess import normalize_frame
from ..io.tiff import write_tiff
from ..models import ULSTMnet2D
from ..ops.postprocess import UINT16_MAX, postprocess_frame
from ..utils import StallWatchdog, log_print


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass --device cpu to run the plain PyTorch path")
    return dev


class StreamingInferenceEngine:
    """Stateful streaming over a sequence of frames of one size."""

    def __init__(self, model: ULSTMnet2D, ip: InferenceParams, device):
        self.model = model
        self.ip = ip
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN runs f32 convs in TF32 by default, which keeps ~3 decimal
            # digits and would break every f32 tolerance against the
            # reference; bf16 math does not use TF32 either way
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.depth_multiple = 2 ** model.cfg.nkp.depth
        self._state = None
        self._shape: Optional[Tuple[int, int]] = None

    def _padded_hw(self, oh: int, ow: int) -> Tuple[int, int]:
        return oh + (-oh) % self.depth_multiple, ow + (-ow) % self.depth_multiple

    def _pad_frame(self, frame: np.ndarray) -> np.ndarray:
        """Reflect-pad ``[..., H, W]`` up to ``_padded_hw``, in chunks (one
        reflect covers at most size-1 pixels)."""
        oh, ow = frame.shape[-2], frame.shape[-1]
        th, tw = self._padded_hw(oh, ow)
        ph, pw = th - oh, tw - ow
        while ph > 0 or pw > 0:
            dh = min(ph, frame.shape[-2] - 1)
            dw = min(pw, frame.shape[-1] - 1)
            pad = [(0, 0)] * (frame.ndim - 2) + [(0, dh), (0, dw)]
            frame = np.pad(frame, pad, mode="reflect")
            ph -= dh
            pw -= dw
        return frame

    def _build(self, oh: int, ow: int) -> None:
        h, w = self._padded_hw(oh, ow)
        self._state = self.model.init_state(1, h, w, device=self.device)
        self._shape = (oh, ow)

    @torch.inference_mode()
    def step_async(self, frame: np.ndarray):
        """Enqueue one raw frame ``[H, W]``; returns the device tensors
        (labels ``[1, H, W]`` int32, probs ``[1, H, W, 3]`` or None) without
        waiting for them."""
        oh, ow = frame.shape
        if self._shape != (oh, ow):
            self._build(oh, ow)
        padded = self._pad_frame(frame)
        if np.issubdtype(padded.dtype, np.integer):
            if padded.dtype not in (np.uint8, np.uint16):
                raise ValueError(f"integer frames must be uint8/uint16, got "
                                 f"{padded.dtype}")
            x = torch.from_numpy(padded.astype(np.int32))
        else:
            x = torch.from_numpy(padded.astype(np.float32))
        x = normalize_frame(x.to(self.device), oh, ow)
        self._state, logits = self.model.step(self._state, x[None, ..., None])
        probs = torch.softmax(logits[:, :oh, :ow], dim=-1)
        ip = self.ip
        labels = torch.stack([
            postprocess_frame(p, cell_thresh=ip.cell_thresh,
                              edge_thresh=ip.edge_thresh,
                              min_cell_size=ip.min_cell_size,
                              max_cell_size=ip.max_cell_size,
                              size_filter=ip.size_filter, fov=ip.FOV,
                              boundary_growth=ip.boundary_growth,
                              grow_iters=ip.grow_iters)
            for p in probs])
        return labels, (probs if ip.save_intermediate else None)

    def process_frame(self, frame: np.ndarray):
        """One frame -> (labels ``[H, W]`` int32, probs ``[H, W, 3]`` or None)
        on the host; waits for the device."""
        labels, probs = self.step_async(frame)
        return (labels[0].cpu().numpy(),
                None if probs is None else probs[0].cpu().numpy())


def _to_host_async(t: torch.Tensor):
    """Start copying ``t`` to the host; returns (host tensor, event to wait
    on, or None when t is already on the host)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


class _Prefetcher:
    """Decode frames on a thread, overlapped with the device. A reader
    exception is re-raised to the consumer instead of ending the stream."""

    _END = object()

    def __init__(self, iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, args=(iterable,), daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _loop(self, iterable):
        try:
            for item in iterable:
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            self._put(self._END)

    def close(self):
        self._stop.set()
        self._t.join(timeout=2.0)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            yield item


class _AsyncWriter:
    """TIFF writes on a thread. Fail-fast: the first write error is raised
    on the next ``put()``, or on ``close()`` if no put came after it."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._err: Optional[Exception] = None
        self._raised = False
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # an error is pending: drain without writing
            path, arr = item
            try:
                write_tiff(path, arr)
            except Exception as e:
                self._err = e

    def put(self, path: str, arr: np.ndarray):
        if self._err is not None:
            self._raised = True
            raise self._err
        self._q.put((path, arr))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None and not self._raised:
            self._raised = True
            raise self._err


def _arm_watchdog(ip: InferenceParams, label: str) -> Optional[StallWatchdog]:
    """A StallWatchdog fed per frame when ``ip.watchdog_secs`` > 0, with 3x
    grace before the first frame (kernel build and first-frame set-up)."""
    secs = float(ip.watchdog_secs or 0.0)
    if secs <= 0:
        return None
    return StallWatchdog(timeout_s=secs, label=label,
                         first_timeout_s=3.0 * secs).start()


def run_inference(ip: InferenceParams, device="cuda",
                  model: Optional[ULSTMnet2D] = None) -> int:
    """Stream ``ip.sequence_path`` through the model and write one uint16
    ``mask###.tif`` per frame to ``ip.output_path`` (and ``probs###.npy``
    with ``save_intermediate``); returns the number of masks written.
    ``model`` replaces loading ``ip.model_path``."""
    device = resolve_device(device)
    if ip.ckpt_step:
        raise NotImplementedError(
            "ckpt_step: a port model dir holds one params.npz; export the step "
            "you want with scripts/export_params_npz.py --step")
    if model is None:
        model = load_model(ip.model_path, device, dtype=ip.dtype,
                           state_dtype=ip.state_dtype, fused_cell=ip.fused_cell)
    engine = StreamingInferenceEngine(model, ip, device)
    reader = CTCInferenceReader(ip.sequence_path, ip.filename_format,
                                ip.pre_sequence_frames, normalize=False)
    writer = _AsyncWriter()
    prefetcher = _Prefetcher(reader)
    fmt = "mask%04d.tif" if ip.digit_4 else "mask%03d.tif"
    n = 0

    def emit(idx, labels_host, event, probs_dev):
        if event is not None:
            event.synchronize()
        labels = labels_host[0].numpy()
        if labels.max(initial=0) > UINT16_MAX:
            raise ValueError("instance count exceeds uint16")
        writer.put(os.path.join(ip.output_path, fmt % idx),
                   labels.astype(np.uint16))
        if probs_dev is not None:
            inter_dir = ip.save_intermediate_path or os.path.join(
                ip.output_path, "intermediate")
            os.makedirs(inter_dir, exist_ok=True)
            np.save(os.path.join(inter_dir, f"probs{idx:03d}.npy"),
                    probs_dev[0].cpu().numpy())

    # dispatch frame t, then wait for and write frame t-1: the label copy and
    # the TIFF encode overlap frame t on the device
    pending = None
    wd = _arm_watchdog(ip, "infer")
    try:
        for idx, frame in prefetcher:
            if wd is not None:
                wd.feed()
            labels_dev, probs_dev = engine.step_async(frame)
            if pending is not None:
                emit(*pending)
                n += 1
            # warm-up frames (idx None): state kept, output discarded
            pending = ((idx, *_to_host_async(labels_dev), probs_dev)
                       if idx is not None else None)
        if pending is not None:
            emit(*pending)
            n += 1
    finally:
        if wd is not None:
            wd.stop()
        writer.close()
        prefetcher.close()
    log_print(f"inference: wrote {n} masks to {ip.output_path}")
    return n
