#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lstm_unet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit != 0) when it fails:
  a. device: the GPU's name and power limit;
  b. build: the CUDA kernels from ``lstm_unet_tpu_torch/csrc``;
  c. each kernel against its plain PyTorch version, at the flagship model's
     shapes, with its tolerance; times from CUDA events;
  d. the golden sequence through the inference CLI against
     ``tests/golden/masks`` (equal instance count, <= 3 px per frame);
  e. the flagship model (512^2, random weights from a seed) through
     ``run_inference`` in float32 and bfloat16, fused cell off and on, with
     each kernel's launch count over (d) + (e).
The last two lines are a JSON kernel summary and the device JSON.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
# the frozen recipe of tests/golden/make_golden.py
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=10):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol):
    import torch

    for g, w in zip(got, want):
        bad = (g.float() - w.float()).abs() > atol + rtol * w.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                                 f"atol={atol} rtol={rtol}, max err {max_err(g, w)}")
    return max(max_err(g, w) for g, w in zip(got, want))


def phase_kernels(torch):
    """(c): every kernel vs its plain version; returns {name: summary}."""
    from lstm_unet_tpu_torch.io.synthetic import dense_components_mask, spiral_mask
    from lstm_unet_tpu_torch.ops.kernels import _build, ccl, convlstm_cell, lstm_gates

    # the plain versions' f32 convs must not run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K1 at the flagship's four ConvLSTM levels (rows = H*W, F); gates and
    # state dtypes as dtype / state_dtype combine on the path
    tol = {torch.float32: (1e-6, 1e-6),        # ulp-level: same f32 formulas
           torch.bfloat16: (1e-6, 2.0 ** -7)}  # one bf16 ulp of output rounding
    errs, timing = [], None
    for rows, feat in ((512 * 512, 128), (256 * 256, 256), (128 * 128, 256),
                       (64 * 64, 512)):
        for gdt, sdt in ((torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            gates = (torch.randn(rows, 4 * feat, device=dev, generator=g) * 2).to(gdt)
            c = torch.randn(rows, feat, device=dev, generator=g).to(sdt)
            for act in ("sigmoid", "hard_sigmoid"):
                got = lstm_gates.fused_lstm_gate_update(gates, c, act)
                want = lstm_gates.lstm_gate_update_plain(gates, c, act)
                e = check_close(f"K1 rows={rows} F={feat} {gdt}/{sdt} {act}", got,
                                want, *tol[sdt])
                errs.append(e)
                log(f"K1 lstm_gate_update rows={rows} F={feat} gates "
                    f"{str(gdt)[6:]} state {str(sdt)[6:]} {act}: max_abs_err={e:.3g}")
            if timing is None:  # level 0, f32: the largest shape on the path
                timing = (time_ms(lambda: lstm_gates.fused_lstm_gate_update(gates, c)),
                          time_ms(lambda: lstm_gates.lstm_gate_update_plain(gates, c)))
                log(f"K1 time @512^2 F=128 float32: kernel {timing[0]:.4f} ms, "
                    f"plain {timing[1]:.4f} ms")
    out["lstm_gate_update"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1])

    # K4 at flagship level 0 (f32, bf16) and the tiny model's 3x3 levels
    lib = _build.library()
    for k, feat in ((5, 128), (3, 8), (3, 16)):
        c_smem = lib.lut_convlstm_level_smem(k, feat)
        if c_smem != convlstm_cell.smem_bytes(k, feat):
            raise AssertionError(f"K4 smem formula differs: C {c_smem} vs "
                                 f"python {convlstm_cell.smem_bytes(k, feat)}")
    tol4 = {torch.float32: (2e-5, 0.0),         # the reference's fused-vs-XLA bound
            torch.bfloat16: (1e-5, 2.0 ** -7)}  # one bf16 ulp of output rounding
    errs, timing = [], {}
    cases = [(1, 512, 128, 5, torch.float32, torch.float32),
             (1, 512, 128, 5, torch.bfloat16, torch.bfloat16),
             (1, 64, 128, 5, torch.bfloat16, torch.float32),  # state_dtype float32
             (1, 32, 8, 3, torch.float32, torch.float32),
             (2, 16, 16, 3, torch.float32, torch.float32)]
    for (b, hw, feat, k, dt, sdt) in cases:
        lim = (6.0 / (k * k * feat + k * k * 4 * feat)) ** 0.5
        gx = (torch.randn(b, hw, hw, 4 * feat, device=dev, generator=g) * 0.5).to(dt)
        h = (torch.rand(b, hw, hw, feat, device=dev, generator=g) * 2 - 1).to(sdt)
        c = torch.randn(b, hw, hw, feat, device=dev, generator=g).to(sdt)
        wh = ((torch.rand(k, k, feat, 4 * feat, device=dev, generator=g) * 2 - 1)
              * lim).to(dt)
        got = convlstm_cell.fused_convlstm_level(gx, h, c, wh)
        want = convlstm_cell.fused_convlstm_level_plain(gx, h, c, wh)
        e = check_close(f"K4 {hw}^2 F={feat} {k}x{k} {dt}/{sdt}", got, want,
                        *tol4[sdt])
        errs.append(e)
        log(f"K4 fused_convlstm_level B={b} {hw}^2 F={feat} {k}x{k} compute "
            f"{str(dt)[6:]} state {str(sdt)[6:]}: max_abs_err={e:.3g}")
        if hw == 512:
            ms = time_ms(lambda: convlstm_cell.fused_convlstm_level(gx, h, c, wh), 5)
            plain = time_ms(lambda: convlstm_cell.fused_convlstm_level_plain(
                gx, h, c, wh), 5)
            # what the unfused path runs instead: the h-conv in the compute
            # dtype (cuDNN) + the K1 kernel
            w_oihw = wh.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            h_nchw = h.permute(0, 3, 1, 2)

            def unfused():
                z = torch.nn.functional.conv2d(h_nchw, w_oihw, padding=k // 2)
                gates = z.permute(0, 2, 3, 1).contiguous() + gx
                return lstm_gates.fused_lstm_gate_update(gates, c)

            alt = time_ms(unfused, 5)
            timing[dt] = (ms, plain)
            tflops = 2 * hw * hw * k * k * feat * 4 * feat / (ms * 1e-3) / 1e12
            log(f"K4 time @512^2 F=128 5x5 {str(dt)[6:]}: kernel {ms:.3f} ms "
                f"({tflops:.1f} TFLOP/s), plain f32 conv + gates {plain:.3f} ms, "
                f"cuDNN h-conv + K1 {alt:.3f} ms")
    out["fused_convlstm_level"] = dict(max_abs_err=max(errs),
                                       ms=timing[torch.float32][0],
                                       plain_ms=timing[torch.float32][1])

    # K3: random masks of several densities, a dense small-component frame and
    # the spiral, each bit-identical
    masks = [torch.rand(512, 512, device=dev, generator=g) < p for p in (0.3, 0.5, 0.6, 0.7)]
    masks.append(torch.rand(333, 517, device=dev, generator=g) < 0.55)  # ragged tiles
    masks.append(torch.from_numpy(dense_components_mask(512, 512)).to(dev))
    masks.append(torch.from_numpy(spiral_mask(128)).to(dev))
    for m in masks:
        got = ccl.connected_components(m)
        want = ccl.connected_components_plain(m)
        n_comp = int(torch.unique(want).numel()) - int(bool((want == 0).any()))
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs on a {tuple(m.shape)} mask: "
                                 f"{int((got != want).sum())} px")
        log(f"K3 ccl {tuple(m.shape)} density={float(m.float().mean()):.3f} "
            f"components={n_comp}: bit-identical")
    m = masks[1]
    out["ccl"] = dict(max_abs_err=0.0, ms=time_ms(lambda: ccl.connected_components(m)),
                      plain_ms=time_ms(lambda: ccl.connected_components_plain(m), 3))
    log(f"K3 time @512^2 density 0.5: kernel {out['ccl']['ms']:.4f} ms, plain "
        f"{out['ccl']['plain_ms']:.3f} ms")
    return out


def flagship_model(torch, dtype, fused):
    from lstm_unet_tpu_torch.config import default_net_kernel_params
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, cast_params_for_inference

    cfg = ModelConfig.make(default_net_kernel_params(), dtype=dtype, fused_cell=fused)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ULSTMnet2D(cfg, generator=gen, device="cuda")
    return cast_params_for_inference(model, cfg.compute_dtype)


def phase_fused_vs_unfused(torch):
    """One f32 flagship step with the fused cell on and off, same inputs."""
    model = flagship_model(torch, "float32", False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        state = [[(torch.rand(h.shape, device="cuda", generator=gen) - 0.5,
                   torch.randn(c.shape, device="cuda", generator=gen) * 0.5)
                  for (h, c) in lvl] for lvl in model.init_state(1, 512, 512)]
        frame = torch.rand(1, 512, 512, 1, device="cuda", generator=gen)
        s0, l0 = model.step(state, frame)
        model.cfg = dataclasses.replace(model.cfg, fused_cell=True)
        s1, l1 = model.step(state, frame)
    ds = max(max_err(a, b) for la, lb in zip(s0, s1) for ta, tb in zip(la, lb)
             for a, b in zip(ta, tb))
    dl = max_err(l0, l1)
    log(f"flagship f32 step fused vs unfused: state max diff {ds:.3g}, logits "
        f"max diff {dl:.3g}")
    # two f32 summation orders of the 3200-term level-0 h-conv, carried
    # through the network
    if ds > 1e-4 or dl > 1e-3:
        raise AssertionError("fused and unfused f32 steps disagree")


def phase_golden(torch, work):
    from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.io.tiff import read_tiff
    import numpy as np

    root = os.path.join(work, "golden")
    write_ctc_dataset(root, **GOLDEN_DATA)
    out = os.path.join(work, "golden_res")
    n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                  "--sequence_path", os.path.join(root, "Synth-N2DH-SIM", "01"),
                  "--output_path", out, "--device", "cuda",
                  "--pre_sequence_frames", "2", "--min_cell_size", "5",
                  "--dtype", "float32"])
    want_paths = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    if n != len(want_paths) or n == 0:
        raise AssertionError(f"golden: wrote {n} masks, expected {len(want_paths)}")
    diffs = []
    for p in want_paths:
        want = read_tiff(p)
        got = read_tiff(os.path.join(out, os.path.basename(p)))
        d = int((got != want).sum())
        diffs.append(d)
        if len(np.unique(got)) != len(np.unique(want)) or d > 3:
            raise AssertionError(f"golden {os.path.basename(p)}: {d} px differ, "
                                 f"instances {len(np.unique(got)) - 1} vs "
                                 f"{len(np.unique(want)) - 1}")
    log(f"golden masks on the card: differing px per frame {diffs} (bar: equal "
        "instance count, <= 3 px)")


def phase_flagship(torch, work, card):
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "flagship")
    seq_dir, _ = write_ctc_dataset(root, num_frames=8, height=512, width=512,
                                   num_cells=40, seed=0)
    for dtype in ("float32", "bfloat16"):
        for fused in (False, True):
            out = os.path.join(work, f"flagship_{dtype}_{int(fused)}")
            ip = InferenceParams(sequence_path=seq_dir, output_path=out,
                                 pre_sequence_frames=2, dtype=dtype, fused_cell=fused)
            model = flagship_model(torch, dtype, fused)
            before = kernels.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = run_inference(ip, device="cuda", model=model)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = kernels.counts()
            d = {k: {s: after[k][s] - before[k][s] for s in ("kernel", "plain")}
                 for k in after}
            written = len(glob.glob(os.path.join(out, "mask*.tif")))
            if n != 8 or written != 8:
                raise AssertionError(f"flagship {dtype} fused={fused}: {n} masks "
                                     f"reported, {written} written")
            if any(v["plain"] for v in d.values()):
                raise AssertionError(f"plain versions ran on the card: {d}")
            if (d["ccl"]["kernel"] == 0 or d["lstm_gate_update"]["kernel"] == 0
                    or (d["fused_convlstm_level"]["kernel"] > 0) != fused):
                raise AssertionError(f"unexpected kernel launches: {d}")
            log(f"flagship 512^2 {dtype} fused_cell={fused}: {n + 2} frames "
                f"(2 warm-up) in {secs:.3f} s = {(n + 2) / secs:.3f} frames/s "
                f"incl. first-frame set-up [{card}]; launches "
                f"{ {k: v['kernel'] for k, v in d.items()} }")
            del model


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from lstm_unet_tpu_torch.ops import kernels
        from lstm_unet_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1

    # (a) device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # (b) build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s; "
        f"{os.path.relpath(_build.library_path(), HERE)})")
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # (c) kernels vs plain versions
    summary = phase_kernels(torch)
    phase_fused_vs_unfused(torch)

    # (d) + (e): the main path, counted
    with tempfile.TemporaryDirectory() as work:
        kernels.reset_counts()
        phase_golden(torch, work)
        phase_flagship(torch, work, smi)
        launched = kernels.counts()
    for k, v in launched.items():
        if v["kernel"] == 0 or v["plain"] != 0:
            raise AssertionError(f"main path: {k} launched {v['kernel']} times, "
                                 f"plain version {v['plain']} times")

    sources = {"lstm_gate_update": ("lstm_unet_tpu_torch/csrc/lstm_gates.cu",
                                    "lstm_unet_tpu/ops/pallas/lstm_gates.py:77"),
               "ccl": ("lstm_unet_tpu_torch/csrc/ccl.cu",
                       "lstm_unet_tpu/ops/pallas/ccl.py:79"),
               "fused_convlstm_level": ("lstm_unet_tpu_torch/csrc/convlstm_cell.cu",
                                        "lstm_unet_tpu/ops/pallas/convlstm_cell.py:125")}
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launched[k]["kernel"], **summary[k]} for k in sources]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
