"""Streaming inference engine.

Counterpart of ``lstm_unet_tpu/engine/infer.py``. Per step, on
the model's device, for B lanes (one sequence each; B = 1 for
:func:`run_inference`, up to ``--max_batch`` for
:func:`run_inference_batched`)::

    raw frames -> reflect-pad to a multiple of 2^depth (host; square under
    TTA 'd4') -> percentile normalization of each lane with the stats of its
    unpadded frame -> [reset_on_jump: zero the state of lanes whose clipped
    mean |frame delta| exceeds the threshold] -> [TTA: the flipped (and
    transposed) variants stacked variant-major as extra lanes, each with its
    own state] -> ULSTMnet2D.step with the (h, c) state carried across the
    sequence -> [TTA: each variant's logits transformed back] -> softmax on
    the unpadded crop [TTA: probabilities averaged over the variants] ->
    postprocess_frame per lane -> int32 labels

and the labels go to a uint16 ``mask###.tif`` on a writer thread. Frames are
decoded on prefetch threads; the labels of step t-1 are written after step
t has been dispatched.

The step is one function, :meth:`StreamingInferenceEngine._body`, run by
``engine/graph.py::CompiledStep`` over a static input and two sets of
carried buffers (the state, and ``reset_on_jump``'s previous frame) that the
steps read and write in turn, so memory stays flat over any sequence length
(the reference donates the state buffers for the same effect). On a
single-process card the body is captured as two CUDA graphs per frame shape
at the first frame and each later frame replays one: the counterpart of the
reference's one jitted program per frame. It runs eagerly on the CPU, and
under a mesh (below), whose gloo halo exchange stages rows through the host
(``parallel/comm.py::exchange``), which a graph cannot hold.

``dtype='int8'``: the engine quantizes the model when it is built
(``models/ulstm_unet.py::quantize_model_int8``, from the weights as
restored), with the static activation scales of ``act_scales.json`` in the model dir when
its provenance stamp matches the checkpoint (:func:`load_act_scales`), else
dynamic scales, one per conv call over all of its lanes, as the reference
takes them. :func:`calibrate_model_dir` writes that file.

``ip.mesh_shape`` (``{'data': N}``, ``{'data': N, 'spatial': M}``) runs the
stream over the ranks of a multi-process run (``parallel/``), by the
reference's rules (``lstm_unet_tpu/engine/infer.py:411-435``): lanes over
'data' when B divides (never under TTA), rows over 'spatial' when H %
(M * 2^depth) == 0, else replicated, with its log lines. Every rank reads,
pads and normalizes the whole frame, builds the TTA variants and takes
``reset_on_jump``'s decision from it, then steps the model on its block
(halo convs, ``parallel/halo.py``). The logits are gathered over 'spatial'
(the softmax is per pixel, so gathering them is gathering the
probabilities), the inverse TTA transforms and ``postprocess_frame`` run
once per lane on one rank, and the label maps are gathered over 'data' to
rank 0, whose writer alone writes masks and intermediates.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.ckpt import MODEL_PARAMS_FILE, resolve_model_dir
from ..checkpoint.convert import load_model
from ..config import InferenceParams
from ..io.dataset import CTCInferenceReader
from ..io.preprocess import normalize_frames, pad_to_multiple, percentile_normalize_np
from ..io.tiff import write_tiff
from ..models import ULSTMnet2D
from ..models.ulstm_unet import QConv, quantize_model_int8
from ..ops.convlstm import QConvLSTMCell
from ..ops.postprocess import UINT16_MAX, postprocess_frame
from ..parallel.distributed import is_writer
from ..parallel.mesh import make_mesh, mesh_axis_sizes, plan_split
from ..utils import StallWatchdog, log_print, resolve_device, trace
from .graph import CompiledStep, CudaGraphs


def _no_tf32(device: torch.device) -> None:
    """cuDNN runs f32 convs in TF32 by default, which keeps ~3 decimal digits
    and would break every f32 tolerance against the reference; bf16 math does
    not use TF32 either way."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------------------------ int8 scales

ACT_SCALES_FILE = "act_scales.json"


def is_quantized(model: ULSTMnet2D) -> bool:
    """Whether some site of ``model`` is int8 (``quantize_model_int8`` ran)."""
    return any(isinstance(m, (QConv, QConvLSTMCell)) for m in model.modules())


@torch.inference_mode()
def calibrate_act_scales(model: ULSTMnet2D, frames: List[np.ndarray]) -> Dict[str, float]:
    """Each conv site's input abs-max over ``frames`` (raw ``[H, W]``,
    percentile-normalized and reflect-padded on the host as the reference's
    calibration does), streamed statefully through the float ``model`` (as
    :func:`load_model` restores it: the checkpoint's own dtype, not
    quantized) on its device: the static int8 scales that replace the
    per-call abs-max."""
    if is_quantized(model):
        raise ValueError("calibrate the float model, not a quantized one")
    device = next(iter(model.parameters())).device
    _no_tf32(device)
    mult = 2 ** model.cfg.nkp.depth
    h, w = frames[0].shape
    state = model.init_state(1, h + (-h) % mult, w + (-w) % mult, device=device)
    running: Dict[str, torch.Tensor] = {}
    for f in frames:
        x, _ = pad_to_multiple(percentile_normalize_np(f), mult)
        collected: Dict[str, torch.Tensor] = {}
        state, _ = model.step(state, torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.float32)).to(device)[None, ..., None], collect_scales=collected)
        for k, v in collected.items():
            running[k] = v if k not in running else torch.maximum(running[k], v)
    return {k: float(v) for k, v in running.items()}


def _scales_provenance(model_path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """What ``act_scales.json`` was calibrated against: the sha256 of the
    architecture file and the checkpoint step (``step``, else the latest
    numbered subdir), as the reference stamps it."""
    prov: Dict[str, Any] = {}
    arch_path = os.path.join(model_path, MODEL_PARAMS_FILE)
    if os.path.exists(arch_path):
        with open(arch_path, "rb") as f:
            prov["arch_sha256"] = hashlib.sha256(f.read()).hexdigest()
    if step is not None:
        prov["ckpt_step"] = step
        return prov
    steps = [int(d) for d in os.listdir(model_path)
             if d.isdigit() and os.path.isdir(os.path.join(model_path, d))]
    if steps:
        prov["ckpt_step"] = max(steps)
    return prov


def save_act_scales(model_path: str, scales: Dict[str, float],
                    step: Optional[int] = None) -> str:
    """Write ``act_scales.json`` (with its ``__provenance__`` stamp) into the
    model dir; returns its path."""
    model_path = resolve_model_dir(model_path)
    path = os.path.join(model_path, ACT_SCALES_FILE)
    out = dict(scales)
    out["__provenance__"] = _scales_provenance(model_path, step)
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    return path


def load_act_scales(model_path: str, step: Optional[int] = None
                    ) -> Optional[Dict[str, float]]:
    """The calibrated scales of a model dir, or None. A file whose stamp does
    not match the model dir now (the checkpoint advanced, the architecture
    changed, or another ``step`` is restored) is stale: a warning, and None
    (dynamic scales). A file without a stamp loads with a warning."""
    model_path = resolve_model_dir(model_path)
    path = os.path.join(model_path, ACT_SCALES_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        scales = json.load(f)
    stamped = scales.pop("__provenance__", None)
    if stamped is None:
        log_print(f"WARNING: {path} has no provenance stamp; cannot verify the "
                  "scales match the checkpoint: re-calibrate to silence this")
        return scales
    current = _scales_provenance(model_path, step)
    if stamped != current:
        log_print(f"WARNING: {path} is STALE (calibrated at {stamped}, model dir now "
                  f"{current}): ignoring the static scales, int8 runs on dynamic "
                  "scales; re-run calibration")
        return None
    return scales


def calibrate_model_dir(model_path: str, sequence_path: str, n_frames: int = 8,
                        filename_format: str = "t*.tif", step: Optional[int] = None,
                        device="cuda") -> str:
    """Calibrate on the first ``n_frames`` of a sequence, with the model in
    its checkpoint's own dtype on ``device``, and write ``act_scales.json``
    into the model dir (every later int8 run of that dir picks it up)."""
    model = load_model(model_path, resolve_device(device), step=step)
    reader = CTCInferenceReader(sequence_path, filename_format, pre_sequence_frames=0,
                                normalize=False)
    frames = []
    for _, frame in reader:
        frames.append(frame)
        if len(frames) >= n_frames:
            break
    scales = calibrate_act_scales(model, frames)
    path = save_act_scales(model_path, scales, step=step)
    log_print(f"calibrated {len(scales)} activation sites over {len(frames)} frames "
              f"-> {path}")
    return path


# ------------------------------------------------------------ the engine


class StreamingInferenceEngine:
    """Stateful streaming over B sequences of frames of one size. An int8
    model (``cfg.quant='int8'``) not yet quantized is quantized here, with
    the calibrated scales of ``ip.model_path`` when they are current.

    ``ip.tta`` streams the variants of each frame (``ip.tta_mode`` 'flip':
    the frame and its three axis flips; 'd4': those and their transposes)
    as extra lanes, ``n_var * B`` in all, and averages their probabilities
    after the inverse transforms. ``ip.reset_on_jump`` > 0 zeroes a lane's
    state (all of its variants) before a frame whose normalized, [0, 1]
    clipped mean absolute difference from the lane's previous frame exceeds
    it; the first frame never resets. ``ip.mesh_shape`` splits the stream
    over this run's ranks (module docstring); then :meth:`step_batch_async`
    returns the outputs on rank 0 only, and None on the others.

    ``capture`` (True on a single-process card, False on the CPU and under a
    mesh) is whether the step is captured as CUDA graphs
    (``engine/graph.py``); set it False before the first step to run the
    same body eagerly on a card, as ``chip_smoke.py`` and the card tests do
    to compare the two."""

    def __init__(self, model: ULSTMnet2D, ip: InferenceParams, device):
        self.model = model
        self.ip = ip
        self.device = resolve_device(device)
        _no_tf32(self.device)
        if model.cfg.quant == "int8" and not is_quantized(model):
            scales = (load_act_scales(ip.model_path, step=ip.ckpt_step or None)
                      if ip.model_path else None)
            quantize_model_int8(model, scales, keep_float=ip.int8_keep_float,
                                float_dtype=model.cfg.compute_dtype)
        tta_mode = ip.tta_mode or "flip"
        if tta_mode not in ("flip", "d4"):
            raise ValueError(f"unknown tta_mode {tta_mode!r} (flip | d4)")
        self.n_var = (8 if tta_mode == "d4" else 4) if ip.tta else 1
        self.jump_thresh = float(ip.reset_on_jump or 0.0)
        self.depth_multiple = 2 ** model.cfg.nkp.depth
        self._step: Optional[CompiledStep] = None
        self._shape: Optional[Tuple[int, int, int]] = None  # (B, oh, ow)
        self.mesh = make_mesh(ip.mesh_shape)
        self._split = None  # this rank's block of the lanes and rows
        self.capture = self.device.type == "cuda" and self.mesh is None

    @property
    def _state(self):
        """The state the next step reads (what the last step wrote)."""
        return None if self._step is None else self._step.state[0]

    @property
    def _prev(self) -> Optional[torch.Tensor]:
        """``reset_on_jump``: the normalized frames of the last step."""
        return None if self._step is None else self._step.state[1]

    def _padded_hw(self, oh: int, ow: int) -> Tuple[int, int]:
        """The model's frame size for an original (oh, ow): multiples of
        2^depth, square under 'd4' (the transposed variants share the lanes'
        shape)."""
        h, w = oh + (-oh) % self.depth_multiple, ow + (-ow) % self.depth_multiple
        if self.n_var == 8:
            h = w = max(h, w)
        return h, w

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

    def _plan(self, batch: int, h: int):
        """The split of ``batch`` lanes of ``h`` rows over the mesh, with the
        reference's log lines for what replicates."""
        if self.mesh is None:
            return None
        sizes = mesh_axis_sizes(self.mesh)
        data_n, spatial_n = sizes.get("data", 0), sizes.get("spatial", 0)
        depth = self.model.cfg.nkp.depth
        if self.n_var > 1 and data_n > 1 and batch % data_n == 0:
            log_print("mesh: tta active — replicating the batch dim")
        split = plan_split(self.mesh, batch, h, depth, replicate_lanes=self.n_var > 1)
        if data_n > 1 and not (split and split.lanes):
            log_print(f"mesh: batch={batch} not divisible by data={data_n}"
                      " — replicating the batch dim")
        if spatial_n > 1 and not (split and split.rows):
            log_print(f"mesh: H={h} not divisible by spatial={spatial_n}"
                      f"*2^{depth} — replicating the H dim")
        return split

    def _build(self, oh: int, ow: int, batch: int = 1) -> None:
        """The step of ``batch`` lanes of ``oh`` x ``ow`` frames: two sets of
        carried buffers and, when :attr:`capture`, CUDA graphs (captured at
        the first step). The old step, its buffers and graphs go first."""
        self._step = None
        h, w = self._padded_hw(oh, ow)
        split = self.model.split = self._split = self._plan(batch, h)
        lanes = batch * self.n_var
        if split is not None:
            lanes, h = split.block(lanes, h)

        def carried():  # (state, previous frames)
            prev = (torch.full((batch,) + self._padded_hw(oh, ow), float("nan"),
                               device=self.device)
                    if self.jump_thresh > 0 else None)
            return self.model.init_state(lanes, h, w, device=self.device), prev

        self._shape = (batch, oh, ow)
        self._step = CompiledStep([carried(), carried()],
                                  CudaGraphs(self.device) if self.capture else None)

    def _upload(self, padded: np.ndarray) -> None:
        """The frames into the step's static input, as int32 (integer frames)
        or f32. To a card they go from a pinned block of PyTorch's caching
        host allocator, which keeps the block until the copy has run, without
        waiting."""
        if np.issubdtype(padded.dtype, np.integer):
            if padded.dtype not in (np.uint8, np.uint16):
                raise ValueError(f"integer frames must be uint8/uint16, got "
                                 f"{padded.dtype}")
            host = torch.from_numpy(padded.astype(np.int32))
        else:
            host = torch.from_numpy(padded.astype(np.float32))
        x = self._step.input(host.shape, host.dtype, self.device)
        if self.device.type == "cuda":
            x.copy_(host.pin_memory(), non_blocking=True)
        else:
            x.copy_(host)

    def _variants(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W]`` -> the model's lanes ``[n_var * B, H, W]``,
        variant-major (a new contiguous tensor under TTA)."""
        if self.n_var == 1:
            return x
        v = [x, x.flip(1), x.flip(2), x.flip(1, 2)]
        if self.n_var == 8:
            t = x.transpose(1, 2)
            v += [t, t.flip(1), t.flip(2), t.flip(1, 2)]
        return torch.cat(v)

    def _probs(self, logits: torch.Tensor, b: int, oh: int, ow: int) -> torch.Tensor:
        """Softmax on the ``[:oh, :ow]`` crop; under TTA each variant's logits
        transformed back (undo the flip, then the transpose) first and the
        probabilities averaged over the variants."""
        if self.n_var == 1:
            return torch.softmax(logits[:, :oh, :ow], dim=-1)
        lv = logits.reshape((self.n_var, b) + logits.shape[1:])
        aligned = [lv[0], lv[1].flip(1), lv[2].flip(2), lv[3].flip(1, 2)]
        if self.n_var == 8:
            aligned += [v.transpose(1, 2)
                        for v in (lv[4], lv[5].flip(1), lv[6].flip(2), lv[7].flip(1, 2))]
        return torch.softmax(torch.stack(aligned)[:, :, :oh, :ow], dim=-1).mean(dim=0)

    def _postprocesses(self) -> bool:
        """Whether this rank postprocesses its lanes: each lane on one rank,
        spatial index 0 of the ranks that hold it."""
        split, mesh = self._split, self.mesh
        if mesh is None:
            return True
        return mesh.index("spatial") == 0 and (
            (split is not None and split.lanes) or mesh.index("data") == 0)

    @torch.inference_mode()
    def step_batch_async(self, frames: np.ndarray):
        """Enqueue one raw frame per lane, ``[B, H, W]``; returns the device
        tensors (labels ``[B, H, W]`` int32, probs ``[B, H, W, 3]`` or None)
        without waiting for them; under a mesh, (None, None) on every rank but
        rank 0. The tensors are the step's own, which no later step writes:
        on a card, copies made on the card right after the step's replay
        (``engine/graph.py``), eagerly the body's own outputs.

        On a card, once a frame shape's state exists, the step never waits
        for the device: the upload is asynchronous from pinned memory, and
        the step is a replay of a CUDA graph (``engine/graph.py``), which
        holds no host read (``chip_smoke.py`` phase p also holds it to
        ``torch.cuda.set_sync_debug_mode("error")``). A mesh is exempt: it
        runs eagerly, and its collectives stage through the host."""
        if not trace.check():
            return self._step_batch(frames, False)
        with trace.span("engine.step"):
            return self._step_batch(frames, True)

    def _step_batch(self, frames: np.ndarray, traced: bool):
        """:meth:`step_batch_async`; ``traced``: with the tracer's spans
        (``engine.pad``, ``engine.upload``, and ``engine/graph.py``'s
        ``engine.replay`` and ``engine.outputs``) and device stamps."""
        b, oh, ow = frames.shape
        with trace.span("engine.pad"):
            if self._shape != (b, oh, ow):
                self._build(oh, ow, b)
            padded = self._pad_frame(frames)
        with trace.span("engine.upload"):
            self._upload(padded)
        return self._step.step(self._body, traced)

    def _body(self, frames: torch.Tensor, src, dst):
        """The step on the device: padded raw ``frames [B, H, W]`` (int32 or
        f32) and the carried buffers ``src`` (state, previous frames) -> the
        new ones written into ``dst``; returns (labels, probs or None), or
        (None, None) on a rank that does not write. What the CUDA graphs
        capture, and what runs eagerly where they do not."""
        _, oh, ow = self._shape
        (state, prev), (state_out, prev_out) = src, dst
        split = self._split
        with trace.stamp("normalize"):
            x = normalize_frames(frames, oh, ow)
            if self.jump_thresh > 0:
                jumps = (x.clamp(0.0, 1.0) - prev.clamp(0.0, 1.0)).abs().mean(dim=(1, 2))
                cut = (jumps > self.jump_thresh).float().repeat(self.n_var)
                state = ULSTMnet2D.reset_lanes(state, cut if split is None else split.take(cut))
                prev_out.copy_(x)
        with trace.stamp("variants"):
            lanes = self._variants(x)[..., None]
            if split is not None:
                lanes = split.take(lanes, 0, 1).contiguous()
        with trace.stamp("model"):
            _, logits = self.model.step(state, lanes, out=state_out)
            if split is not None:
                logits = split.gather(logits, row_dim=1)
        if not self._postprocesses():
            return None, None
        with trace.stamp("probs"):
            probs = self._probs(logits, logits.shape[0] // self.n_var, oh, ow)
        ip = self.ip
        lane_labels = []
        for p in probs:
            with trace.stamp("postprocess"):
                lane_labels.append(postprocess_frame(
                    p, cell_thresh=ip.cell_thresh, edge_thresh=ip.edge_thresh,
                    min_cell_size=ip.min_cell_size, max_cell_size=ip.max_cell_size,
                    size_filter=ip.size_filter, fov=ip.FOV,
                    boundary_growth=ip.boundary_growth, grow_iters=ip.grow_iters,
                    instance_split=ip.instance_split, split_method=ip.split_method,
                    split_window=ip.split_window, split_min_dist=ip.split_min_dist,
                    split_slack=ip.split_slack, split_rel=ip.split_rel,
                    split_rel_window=ip.split_rel_window, split_min_size=ip.split_min_size,
                    split_hi_thresh=ip.split_hi_thresh, split_erode=ip.split_erode))
        with trace.stamp("outputs"):
            labels = torch.stack(lane_labels)
            probs = probs if ip.save_intermediate else None
            if split is not None and split.lanes:
                labels = split.gather(labels, lane_dim=0)
                probs = None if probs is None else split.gather(probs, lane_dim=0)
        if not is_writer():
            return None, None
        return labels, probs

    def step_async(self, frame: np.ndarray):
        """:meth:`step_batch_async` of one raw frame ``[H, W]`` (B = 1)."""
        return self.step_batch_async(frame[None])

    def process_frame(self, frame: np.ndarray):
        """One frame -> (labels ``[H, W]`` int32, probs ``[H, W, 3]`` or None)
        on the host; waits for the device. (None, None) on a rank that does
        not write."""
        labels, probs = self.step_async(frame)
        if labels is None:
            return None, None
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
    under ``ip.save_intermediate_path``, default ``<output>/intermediate``,
    with ``save_intermediate``); returns the number of masks written.
    ``model`` replaces loading ``ip.model_path``. It is
    :func:`run_inference_batched` with one lane, save that a frame of a new
    shape rebuilds the state instead of raising."""
    return _stream(ip, [ip.sequence_path], [ip.output_path], device, model,
                   fixed_shape=False)


def run_inference_batched(ip: InferenceParams, sequence_paths: List[str],
                          output_paths: List[str], device="cuda",
                          model: Optional[ULSTMnet2D] = None) -> int:
    """Stream several sequences at once, one lane each, and write each one's
    masks to its own entry of ``output_paths``; returns the number of masks
    written. ``ip.sequence_path`` and ``ip.output_path`` are not used.

    All sequences must share one frame shape (``cli/ctc_sweep.py`` groups
    them by shape), else ``ValueError``; so must every frame of a sequence.
    A lane whose sequence has ended keeps stepping on its last frame (the
    lane count stays fixed) and its outputs are discarded; warm-up frames
    write nothing. The uint16 overflow check runs on the lanes written only.
    ``save_intermediate`` writes each lane's probabilities under its own
    ``<output>/intermediate`` (one lane: ``ip.save_intermediate_path`` when
    set). Frame t is dispatched before the labels of frame t-1 are waited
    for and written, so the label copy and the TIFF encode overlap the
    device. ``model`` replaces loading ``ip.model_path``. Under
    ``ip.mesh_shape`` every rank of the run calls this with the same
    arguments, and rank 0 writes (the others return 0).
    """
    return _stream(ip, sequence_paths, output_paths, device, model, fixed_shape=True)


def _stream(ip: InferenceParams, sequence_paths: List[str], output_paths: List[str],
            device, model: Optional[ULSTMnet2D], fixed_shape: bool) -> int:
    device = resolve_device(device)
    if model is None:
        model = load_model(ip.model_path, device, dtype=ip.dtype,
                           state_dtype=ip.state_dtype, fused_cell=ip.fused_cell,
                           step=ip.ckpt_step or None)
    engine = StreamingInferenceEngine(model, ip, device)
    readers = [CTCInferenceReader(sp, ip.filename_format, ip.pre_sequence_frames,
                                  normalize=False) for sp in sequence_paths]
    prefetchers = [_Prefetcher(r) for r in readers]
    iters = [iter(p) for p in prefetchers]
    fmt = "mask%04d.tif" if ip.digit_4 else "mask%03d.tif"
    b = len(readers)
    n = 0
    writer = None

    def emit(writes, labels_host, event, probs_dev):
        nonlocal n
        if event is not None:
            event.synchronize()
        labels = labels_host.numpy()
        probs = None if probs_dev is None else probs_dev.cpu().numpy()
        for lane, idx in writes:
            if labels[lane].max(initial=0) > UINT16_MAX:
                raise ValueError(f"instance count exceeds uint16 (lane {lane})")
            writer.put(os.path.join(output_paths[lane], fmt % idx),
                       labels[lane].astype(np.uint16))
            if probs is not None:
                inter_dir = ((b == 1 and ip.save_intermediate_path)
                             or os.path.join(output_paths[lane], "intermediate"))
                os.makedirs(inter_dir, exist_ok=True)
                np.save(os.path.join(inter_dir, f"probs{idx:03d}.npy"), probs[lane])
            n += 1

    wd = _arm_watchdog(ip, "infer")
    try:
        cur = [next(it) for it in iters]  # (idx, frame) per lane
        shapes = [f.shape for _, f in cur]
        if len(set(shapes)) != 1:
            raise ValueError(f"batched inference requires equal frame shapes, got {shapes}")
        writer = _AsyncWriter() if is_writer() else None
        done = [False] * b
        pending = None
        while not all(done):
            if wd is not None:
                wd.feed()
            for lane, (_, f) in enumerate(cur):
                if fixed_shape and f.shape != shapes[lane]:
                    raise ValueError(f"lane {lane} frame shape changed mid-sequence: "
                                     f"{shapes[lane]} -> {f.shape}")
            labels_dev, probs_dev = engine.step_batch_async(np.stack([f for _, f in cur]))
            writes = [(lane, cur[lane][0]) for lane in range(b)
                      if cur[lane][0] is not None and not done[lane]]
            if pending is not None:
                emit(*pending)
            # under a mesh only rank 0 gets labels, and only it writes
            pending = (None if labels_dev is None
                       else (writes, *_to_host_async(labels_dev), probs_dev))
            for lane in range(b):
                if not done[lane]:
                    try:
                        cur[lane] = next(iters[lane])
                    except StopIteration:
                        done[lane] = True
        if pending is not None:
            emit(*pending)
    finally:
        if wd is not None:
            wd.stop()
        if writer is not None:
            writer.close()
        for p in prefetchers:
            p.close()
    log_print(f"inference: wrote {n} masks across {b} sequence(s) to "
              f"{', '.join(output_paths)}")
    return n
