"""Benchmark: streaming frames/sec/chip at 512x512 and training frames/sec.

Counterpart of the repo's ``bench.py``, on the port and its hand kernels::

    python -m lstm_unet_tpu_torch.bench                 # int8, calibrated, B = 1
    python -m lstm_unet_tpu_torch.bench --mode train    # B8 T7 256^2 bf16, full remat
    python -m lstm_unet_tpu_torch.bench --device cpu --tiny --size 32

The timed region is the reference's: the full streaming pipeline per frame
on the device, with the LSTM state carried from frame to frame, on a card
one replay of the step's CUDA graph a frame (the reference times its one
jitted step)::

    raw uint16 frames (made once, on the device before timing) -> per-lane
    1/99 percentile normalize (integer frames: the exact 65536-bin quantile)
    -> ULSTMnet2D.step (flagship, random weights from seed 0) -> softmax ->
    postprocess_frame(cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10,
    grow_iters=3): K3's labels, growth, compaction

Two warm-up steps and a sync, then ``--frames`` steps ended by one sync
(a host read of the last labels, which depend on every step through the
state). frames/s = frames x batch / seconds. Weights are cast (float) or
quantized (``--dtype int8``, the reference's default: static activation
scales calibrated on 4 synthetic frames, ``--no-calibrated`` for dynamic
ones) once, before timing. At ``--batch`` > 1 the lanes step together
through the model and are postprocessed one by one, as the port's engine
does (the reference ``vmap``s the postprocess): that is where the port's
batching stands.

Training: the flagship (bf16 when the stream is int8), plain Adam at 1e-4
(``ClippedAdam`` with no clipping and no skipping of non-finite steps: the
update of ``optax.adam``), class weights (0.15, 0.25, 0.6), an image of
0.5 and a segmentation of 0 everywhere; one warm step, ``steps`` timed, one
sync on the loss. The default line folds ``train_*`` keys into the
streaming line: ``--train_batch`` (8) x ``--train_unroll`` (7) and, when
the batch is not 5, the B5 parity line.

Deviations from the reference, on purpose:

- A failed training pass fails the run. The reference catches it into
  ``train_error`` and exits 0, which would hide a broken K2 or build.
- ``--device cuda`` (the default) on a host without CUDA prints one line
  with ``"value": 0.0`` and an ``"error"``, and exits 1; it never carries on
  on the CPU. ``--device cpu`` runs every kernel's plain version.
- Not ported (TPU, XLA or tunnel mechanisms, ``ROADMAP.md`` "Do not port"):
  ``--ccl scan`` (``--ccl`` keeps its one choice, ``sweep``), ``--int8_conv``,
  ``--conv_method``, ``--entry_layouts`` and the chip lease.
- The flop count. The reference counts the compiled step's flops with XLA's
  ``cost_analysis`` (remat recompute included) against a TPU peak. Here
  :func:`conv_flops` and :func:`train_flops` count model flops from the net
  config alone, 2·H·W·K²·cin·cout over every conv, so the count is the same
  whichever kernel computes a conv (cuDNN, K4's h-conv, the int8 routes) and
  under every remat policy: a remat change moves the time, not the yardstick.
  A training step counts the forward, every weight grad and the input grad
  of every conv whose input needs one (not the conv reading the frame, nor
  the h-convs of a window's first frame, whose state is detached).
  ``--mfu`` adds ``flops_per_frame`` and ``mfu`` to the streaming line and
  ``train_flops_per_step`` and ``train_mfu`` for the training config, against
  :data:`PEAK_FLOPS`.

Every line carries ``device`` (the card's name, or ``cpu``) and
``power_limit`` (``nvidia-smi``'s, or null), so each number stands beside
the hardware it was taken on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import NetKernelParams, default_net_kernel_params, tiny_net_kernel_params
from .engine.graph import CompiledStep, CudaGraphs
from .engine.infer import _no_tf32, calibrate_act_scales
from .engine.optim import ClippedAdam
from .engine.train import make_train_step
from .io.preprocess import normalize_frames
from .io.synthetic import make_cell_sequence
from .models import ModelConfig, ULSTMnet2D, cast_params_for_inference, quantize_model_int8
from .ops.postprocess import postprocess_frame
from .utils import resolve_device

# The reference stack's first JAX-CPU run of this workload (512^2, flagship,
# bf16, full pipeline: 3 frames in 100.84 s on a 1-vCPU host, the repo's
# bench.py). Not a TPU number and not a target: the denominator of
# vs_baseline, kept so the two benches' lines read alike.
CPU_BASELINE_FPS = 0.0297

# H100 SXM dense peaks (NVIDIA data sheet) of the fastest tensor-core format
# that carries each dtype's math, so no implementation of the same work reads
# above 1: int8 on int8 tensor cores, bf16 on bf16 ones, f32 against TF32
# (the port's f32 runs cuDNN with TF32 off and K4 as 3xTF32, both below it).
PEAK_FLOPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 495e12}

CLASS_WEIGHTS = (0.15, 0.25, 0.6)
POSTPROCESS = dict(cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10, grow_iters=3)
CALIBRATION_FRAMES = 4


def _apply_probe(nkp: NetKernelParams, probe: str) -> NetKernelParams:
    """Config-only roofline probes: the flagship with one region narrowed,
    benched with untrained weights — a throughput probe locating where the
    time of a level lives, never a quality claim.

    - half_enc0: encoder level 0 (ConvLSTM + down convs) channels halved —
      the full-resolution encoder level, the biggest working set
    - half_dec0: decoder level 0 conv stack halved — the full-resolution
      decoder level
    - half_l0:   both of the above
    """
    def halve(levels, i):
        levels[i] = [(k, f // 2) for k, f in levels[i]]

    if probe in ("half_enc0", "half_l0"):
        halve(nkp.lstm_kernels, 0)
        halve(nkp.down_conv_kernels, 0)
    if probe in ("half_dec0", "half_l0"):
        halve(nkp.up_conv_kernels, 0)
    if probe and probe not in ("half_enc0", "half_dec0", "half_l0"):
        raise ValueError(f"unknown probe {probe!r}")
    return nkp


def net_params(tiny: bool, probe: str = "") -> NetKernelParams:
    nkp = tiny_net_kernel_params() if tiny else default_net_kernel_params()
    return _apply_probe(nkp, probe) if probe else nkp


# ------------------------------------------------------------ flop count


def conv_sites(nkp: NetKernelParams, height: int, width: int
               ) -> List[Tuple[str, int, int, int, int, int]]:
    """Every conv of one forward frame of ``ULSTMnet2D`` (one input channel,
    three classes: ``ModelConfig``'s defaults) at ``height x width``, in the
    order the model runs them: ``(site, H, W, K, cin, cout)``. A ConvLSTM
    layer is two sites, ``.../x`` (cin -> 4F) and ``.../h`` (F -> 4F); a
    decoder level's first conv reads the upsampled input and the skip,
    concatenated."""
    sites = []
    cin, skips = 1, []
    for lvl in range(nkp.depth):
        h, w = height >> lvl, width >> lvl
        for j, (k, f) in enumerate(nkp.lstm_kernels[lvl]):
            sites.append((f"encoder/{lvl}/lstm/{j}/x", h, w, k, cin, 4 * f))
            sites.append((f"encoder/{lvl}/lstm/{j}/h", h, w, k, f, 4 * f))
            cin = f
        for j, (k, f) in enumerate(nkp.down_conv_kernels[lvl]):
            sites.append((f"encoder/{lvl}/convs/{j}", h, w, k, cin, f))
            cin = f
        skips.append(cin)
    for lvl in reversed(range(nkp.depth)):
        h, w = height >> lvl, width >> lvl
        c = cin + skips[lvl]
        for j, (k, f) in enumerate(nkp.up_conv_kernels[lvl]):
            sites.append((f"decoder/{lvl}/convs/{j}", h, w, k, c, f))
            c = f
        cin = c
    sites.append(("head", height, width, 1, cin, 3))
    return sites


def _flops(site) -> int:
    _, h, w, k, cin, cout = site
    return 2 * h * w * k * k * cin * cout


def conv_flops(nkp: NetKernelParams, height: int, width: int) -> int:
    """Model flops of one forward frame of one lane: 2·H·W·K²·cin·cout summed
    over every conv, whichever kernel computes it (the flagship at 512²:
    3.969e12)."""
    return sum(_flops(s) for s in conv_sites(nkp, height, width))


def train_flops(nkp: NetKernelParams, height: int, width: int, batch: int,
                unroll: int) -> int:
    """Model flops of one truncated-BPTT step over ``batch`` lanes of
    ``unroll`` frames, what autograd must compute with remat off: per frame
    the forward and every conv's weight grad, plus the input grad of every
    conv whose input needs one. The first conv reads the frame, which needs
    none; the h-convs of the window's first frame read the carried state,
    detached at the step's end, which needs none either. Remat recompute is
    not counted, so every remat policy has this count."""
    sites = conv_sites(nkp, height, width)
    fwd = sum(_flops(s) for s in sites)
    first_h = sum(_flops(s) for s in sites if s[0].endswith("/h"))
    per_lane = unroll * (3 * fwd - _flops(sites[0])) - first_h
    return batch * per_lane


def _mfu(flops_per_s: float, dtype: str) -> float:
    """``flops_per_s`` as a share of the dtype's peak, 4 significant digits."""
    return float(f"{flops_per_s / PEAK_FLOPS[dtype]:.4g}")


# ------------------------------------------------------------ the device


def device_info(device: torch.device) -> Tuple[str, Optional[str]]:
    """(the card's name, its power limit as ``nvidia-smi`` prints it, or
    None when it cannot be read); ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return name, None
    fields = out.strip().splitlines()[0].rsplit(",", 1) if out.strip() else []
    return name, (fields[1].strip() if len(fields) == 2 else None)


# ------------------------------------------------------------ streaming


def make_model(dtype: str, tiny: bool, fused_cell: bool = False, probe: str = "",
               device="cpu") -> ULSTMnet2D:
    """The bench's model, float and not yet quantized: ``dtype='int8'`` is a
    bf16 model with ``quant='int8'`` (the reference's mapping), weights drawn
    from seed 0 on ``device``."""
    quant = "int8" if dtype == "int8" else "none"
    cfg = ModelConfig.make(net_params(tiny, probe),
                           dtype="bfloat16" if dtype == "int8" else dtype,
                           quant=quant, fused_cell=fused_cell)
    device = torch.device(device)
    return ULSTMnet2D(cfg, generator=torch.Generator(device=device).manual_seed(0),
                      device=device)


def calibrate(model: ULSTMnet2D, size: int) -> Dict[str, float]:
    """Static int8 activation scales of the float ``model``: the abs-max of
    every conv site over 4 synthetic frames of the bench's distribution,
    streamed in the model's dtype (the reference's calibration)."""
    imgs, _ = make_cell_sequence(num_frames=CALIBRATION_FRAMES, height=size, width=size,
                                 num_cells=40, seed=7)
    return calibrate_act_scales(model, [f.astype(np.float32) for f in imgs])


def build_pipeline(model: ULSTMnet2D, size: int, calibrated: bool = False,
                   batch: int = 1, int8_keep_float: str = ""):
    """Cast the float ``model`` to its compute dtype, or quantize it (int8:
    calibrated static scales, else dynamic), once; returns ``(step,
    state)``: ``step(state, frames [B, H, W] int32) -> (state, labels [B,
    H, W] int32)``, the whole streaming pipeline on the model's device. The
    state is a handle (``engine/graph.py::CompiledStep``: the LSTM state in
    two sets of buffers, read and written in turn); on a card the step is
    captured as CUDA graphs at its first call and replayed at every later
    one, as the reference's bench times one jitted step. The labels are the
    step's own (no later step writes them)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    _no_tf32(device)
    if cfg.quant == "int8":
        scales = calibrate(model, size) if calibrated else None
        quantize_model_int8(model, scales, keep_float=int8_keep_float,
                            float_dtype=cfg.compute_dtype)
    else:
        cast_params_for_inference(model, cfg.compute_dtype)

    def body(frames, state, state_out):
        x = normalize_frames(frames, size, size)
        _, logits = model.step(state, x[..., None], out=state_out)
        probs = torch.softmax(logits, dim=-1)
        return (torch.stack([postprocess_frame(p, **POSTPROCESS) for p in probs]),)

    sets = [model.init_state(batch, size, size, device=device) for _ in range(2)]
    compiled = CompiledStep(sets, CudaGraphs(device) if device.type == "cuda" else None)

    @torch.inference_mode()
    def step(state: CompiledStep, frames):
        state.input(frames.shape, frames.dtype, frames.device).copy_(frames)
        labels, = state.step(body)
        return state, labels

    return step, compiled


def make_frames(n: int, size: int, batch: int = 1) -> np.ndarray:
    """Raw uint16 frames ``[n, batch, H, W, 1]``, what a stream uploads; the
    lanes of ``batch`` > 1 decorrelated by rolling each one down H."""
    imgs, _ = make_cell_sequence(num_frames=n, height=size, width=size, num_cells=40,
                                 seed=7)
    frames = np.stack(imgs)[..., None, :, :, None]  # [n,1,H,W,1]
    if batch > 1:
        frames = np.concatenate([np.roll(frames, (size // batch) * b, axis=2)
                                 for b in range(batch)], axis=1)
    return frames


def upload(frames: np.ndarray, device) -> List[torch.Tensor]:
    """``make_frames``' output as one int32 ``[B, H, W]`` tensor a frame on
    ``device`` (the engine's upload of integer frames)."""
    return [torch.from_numpy(f[..., 0].astype(np.int32)).to(device) for f in frames]


# ------------------------------------------------------------ training


def bench_train(size: int, dtype: str, tiny: bool, steps: int = 10, emit: bool = True,
                remat: str = "full", B: int = 5, T: int = 7,
                adam_mu_dtype: str = "float32", mfu: bool = False,
                device="cuda") -> Tuple[dict, str]:
    """Training-step throughput: ``(line, config tag)``; the line is printed
    with ``emit``. ``remat``: 'full', 'save_outputs' or 'none'."""
    device = torch.device(device)
    _no_tf32(device)
    nkp = net_params(tiny)
    model = ULSTMnet2D(ModelConfig.make(nkp, dtype=dtype),
                       generator=torch.Generator(device=device).manual_seed(0), device=device)
    opt = ClippedAdam(dict(model.named_parameters()), 1e-4, grad_clip_norm=0.0,
                      skip_nonfinite_updates=False,
                      mu_dtype=torch.bfloat16 if adam_mu_dtype == "bfloat16" else torch.float32)
    step = make_train_step(model, opt, CLASS_WEIGHTS,
                           remat={"full": True, "none": False}.get(remat, remat))
    state = model.init_state(B, size, size, device=device)
    img = torch.full((B, T, size, size, 1), 0.5, device=device)
    seg = torch.zeros((B, T, size, size), dtype=torch.int32, device=device)
    ones = torch.ones((B, T), device=device)
    last = torch.zeros((B,), device=device)
    state, m = step(state, img, seg, ones, ones, last)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, img, seg, ones, ones, last)
    float(m["loss"])
    dt = time.perf_counter() - t0
    fps = steps * B * T / dt
    out = {
        "metric": f"training frames/sec/chip @ {size}x{size} B{B} T{T} "
                  f"(flagship ULSTMnet2D, {dtype}, remat={remat} BPTT"
                  + (f", mu={adam_mu_dtype}" if adam_mu_dtype != "float32" else "") + ")",
        "value": round(fps, 3),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / CPU_BASELINE_FPS, 3),
    }
    if mfu:
        flops = train_flops(nkp, size, size, B, T)
        out["train_flops_per_step"] = flops
        out["train_mfu"] = _mfu(flops * steps / dt, dtype)
    if emit:
        name, limit = device_info(device)
        out.update(device=name, power_limit=limit)
        print(json.dumps(out), flush=True)
    return out, f"{size}x{size} B{B} T{T} {dtype} remat"


# ------------------------------------------------------------ the CLI


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--dtype", type=str, default="int8",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--fused_cell", action="store_true")
    ap.add_argument("--calibrated", action="store_true", default=True,
                    help="int8 with precalibrated static activation scales")
    ap.add_argument("--no-calibrated", dest="calibrated", action="store_false")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", choices=["infer", "train"], default="infer")
    ap.add_argument("--train_too", action="store_true", default=True,
                    help="append train_* keys to the streaming JSON line")
    ap.add_argument("--no-train_too", dest="train_too", action="store_false")
    ap.add_argument("--remat_policy", type=str, default="full",
                    choices=["full", "save_outputs", "none"])
    ap.add_argument("--train_batch", type=int, default=8,
                    help="training bench batch B (the reference's parity config is B5)")
    ap.add_argument("--train_unroll", type=int, default=7,
                    help="training bench BPTT unroll T (the reference's is T7)")
    ap.add_argument("--adam_mu_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"],
                    help="Adam first-moment storage dtype (--mode train)")
    ap.add_argument("--mfu", action="store_true",
                    help="add the analytic model flops and their share of the "
                         "dtype's H100 peak (PEAK_FLOPS)")
    ap.add_argument("--ccl", type=str, default="sweep", choices=["sweep"],
                    help="connected components: K3 (the reference's 'scan' "
                         "variant is not ported)")
    ap.add_argument("--int8_keep_float", type=str, default="",
                    help="mixed-precision int8: comma-separated site prefixes "
                         "kept bf16 (e.g. 'encoder/0')")
    ap.add_argument("--batch", type=int, default=1,
                    help="concurrent independent streams; value = aggregate frames/sec")
    ap.add_argument("--probe", type=str, default="",
                    choices=["", "half_enc0", "half_dec0", "half_l0"],
                    help="bench a config-only clone with the named full-res "
                         "region's channels halved (throughput attribution only)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (hand-written kernels) or 'cpu' (plain "
                         "PyTorch); 'cuda' without a GPU exits 1")
    return ap


def run_bench(args) -> dict:
    """Run the bench of ``args``; prints and returns its JSON line."""
    device = resolve_device(args.device)
    train_size = 256 if args.size == 512 else args.size
    train_dtype = "bfloat16" if args.dtype == "int8" else args.dtype
    if args.mode == "train":
        return bench_train(train_size, train_dtype, args.tiny, remat=args.remat_policy,
                           B=args.train_batch, T=args.train_unroll,
                           adam_mu_dtype=args.adam_mu_dtype, mfu=args.mfu,
                           device=device)[0]

    model = make_model(args.dtype, args.tiny, args.fused_cell, args.probe, device)
    step, state = build_pipeline(model, args.size, args.calibrated, args.batch,
                                 args.int8_keep_float)
    frames = upload(make_frames(min(args.frames, 16), args.size, args.batch), device)

    state, labels = step(state, frames[0])
    state, labels = step(state, frames[1 % len(frames)])
    int(labels.max())
    t0 = time.perf_counter()
    for i in range(args.frames):
        state, labels = step(state, frames[i % len(frames)])
    # the last labels depend on every step through the state: one host read
    # syncs the whole timed region
    int(labels.max())
    dt = time.perf_counter() - t0

    fps = args.frames * args.batch / dt
    lanes = f", {args.batch} concurrent streams aggregate" if args.batch > 1 else ""
    probe_tag = f", PROBE {args.probe}" if args.probe else ""
    out = {
        "metric": f"streaming inference frames/sec/chip @ {args.size}x{args.size} "
                  f"(flagship ULSTMnet2D, {args.dtype}, on-device postprocess"
                  f"{lanes}{probe_tag})",
        "value": round(fps, 3),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / CPU_BASELINE_FPS, 3),
    }
    if args.mfu:
        flops = conv_flops(model.cfg.nkp, args.size, args.size)
        out["flops_per_frame"] = flops
        out["mfu"] = _mfu(flops * fps, args.dtype)
    if args.train_too:
        train, tcfg = bench_train(train_size, train_dtype, args.tiny, steps=6, emit=False,
                                  remat=args.remat_policy, B=args.train_batch,
                                  T=args.train_unroll, mfu=args.mfu, device=device)
        out["train_value"] = train["value"]
        out["train_unit"] = "frames/sec/chip"
        out["train_config"] = tcfg
        for k in ("train_flops_per_step", "train_mfu"):
            if k in train:
                out[k] = train[k]
        if args.train_batch != 5:
            # the B5 reference-parity config beside the throughput config
            parity, pcfg = bench_train(train_size, train_dtype, args.tiny, steps=6,
                                       emit=False, remat=args.remat_policy, B=5,
                                       T=args.train_unroll, device=device)
            out["train_parity_value"] = parity["value"]
            out["train_parity_config"] = pcfg
    name, limit = device_info(device)
    out.update(device=name, power_limit=limit)
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv`` and run the bench; returns its JSON line. Without a
    GPU, ``--device cuda`` prints an error line and exits 1."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        what = "training" if args.mode == "train" else "streaming inference"
        print(json.dumps({
            "metric": f"{what} frames/sec/chip @ {args.size}x{args.size}",
            "value": 0.0,
            "unit": "frames/sec/chip",
            "vs_baseline": 0.0,
            "error": f"device {args.device!r} requested but torch.cuda.is_available() "
                     "is False; --device cpu runs the plain PyTorch path",
        }), flush=True)
        raise SystemExit(1)
    return run_bench(args)


if __name__ == "__main__":
    main()
