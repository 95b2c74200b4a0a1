#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lstm_unet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit != 0) when it fails:
  a. device: the GPU's name and power limit;
  b. build: the CUDA kernels from ``lstm_unet_tpu_torch/csrc``;
  c. each kernel against its plain PyTorch version, at the flagship model's
     shapes (K1 also at its training levels at B = 5 and 8), with its
     tolerance; times from CUDA events; K1's library call (PyTorch's fused
     LSTM cell, ``aten::_thnn_fused_lstm_cell``, which the port never calls)
     held to K1 and timed beside it. K4 has three routes: the bf16
     tensor-core kernel and the f32 one (3xTF32), each at all four flagship
     levels; the narrow kernel (bf16 and 3xTF32) at 512^2 F = 32 and 96 5x5
     and F = 64 7x7 and at the tiny model's levels (32^2 F = 8, 16^2 F = 16,
     3x3, B = 1 and 2); each with cuDNN's h-conv + add + K1 in the same dtype
     timed beside it as the yardstick the port does not call, and its bound; then
     one flagship step with the fused cell against the
     unfused one, in f32 and in bf16. K3 has two routes (the cluster kernel,
     which takes the flagship's 512^2 frame, and the grid kernel for frames
     too large for it), each held bit-identical to the plain version on
     random, ragged, degenerate and cell-like masks and timed two ways: CUDA
     events around the calls, and the kernel's own device time from
     torch.profiler (one launch per call);
  c3. the int8 conv's routes at every distinct int8 conv shape of the
     flagship at 512^2 (5x5 x- and h-convs, 3x3 encoder and decoder convs up
     to cin = 1024, the 1x1 head): the wgmma kernel (``conv2d_int8_wgmma``,
     float x quantized as it is staged) bit-equal to its plain version at its
     15 shapes from bf16 x (and f32 x at the h-conv shapes), dynamic and
     static scales; the small-K kernel (``conv2d_int8_smallk``, the same
     fold, full output rows) likewise at the cin = 1 x-conv, B = 1 and 4, and
     at the tiny model's small-K sites; the route the model takes bit-equal
     to the plain quantize + conv at all 16; the mma_sync kernel
     (``conv2d_int8``, int8 x, now on no main path) bit-equal to its plain
     version at all 16 (exact s32 sums, the same f32 epilogue); per shape
     the kernel's time, the mma_sync route (eager quantize + mma_sync) and its
     kernel alone, cuDNN's bf16 conv, the bound and its share; then the
     published net's wide sites (N tiles of 256 and 128) at 512^2, B = 1 and
     4: bit-equal to the plain version, timed, the bound and its share; the
     published int8 net's launches a frame (alone, with where the kernel's
     cycles go by role: ``python3 -c 'import chip_smoke as s;
     s.conv_int8_wide_alone()'``); the unfused int8 cell's h-conv with the
     gate epilogue (``conv2d_int8_wgmma_gates``) at the four flagship levels,
     B = 1 and 4: bit-equal to the h-conv + add + K1 it replaces, both timed
     (alone: ``s.conv_int8_gates_alone()``);
  c2. ``postprocess_frame`` on cell-like 512^2 probabilities (made from a
     seed, no model) with the instance split off, 'dist' and 'prob': equal to
     the same call on the CPU, 1, 2 and 2 K3 launches a frame (and 1, 2, 2
     of the growth kernel, 0, 1, 0 of the erosion kernel and of the 'dist'
     split's markers kernel), ms per frame and
     the rounds of the growth and erosion loops, read from the card's
     counter and equal to the CPU's;
  p. the postprocess's loop kernels (``csrc/postprocess_loops.cu``), then
     the compiled step (``engine/graph.py``): each kernel bit-equal to
     its plain version, with equal round counts, on the inputs
     ``postprocess_frame`` gives it at 512^2 (split off, 'dist', 'prob',
     ``grow_iters=3``) and 1024^2 ('dist'), and on a 128^2 serpentine band,
     each timed beside its plain version; ``postprocess_frame`` with the
     kernels beside the plain loops; the 'dist' split's markers kernel
     (``split_markers``, window 16, rel window 48) at 512^2 and 1024^2,
     bit-equal to its plain version and timed beside it, its bound and a
     yardstick of separable ``max_pool2d`` (timed only); then (counted from
     0) 8 steady steps of
     ``StreamingInferenceEngine.step_batch_async`` on the flagship at 512^2
     (bf16 fused, int8 calibrated unfused, f32 fused, TTA 'flip', B = 4,
     the 'dist' and 'prob' splits) and of the bench's ``build_pipeline``
     step, each run eagerly and as replays of its CUDA graphs (captured at
     the first frame), all under ``torch.cuda.set_sync_debug_mode("error")``:
     a step that synchronizes fails, and so do replays whose labels (and
     probabilities) differ from the eager steps' by a bit or whose launches
     differ from theirs, a step that launches the loop kernels, the markers
     kernel or K3 other than expected or runs a plain version, and an engine whose buffers or
     graph pool stay allocated after it is dropped; host ms until each step
     returns, eager against graph. Its wall time is printed beside a budget
     of 40 s;
  d. the golden sequence through the inference CLI (each stream captured
     once and replayed at every later frame) against
     ``tests/golden/masks`` (f32: 0 px per frame), with
     the fused cell off and on (f32: the tiny levels take K4's narrow
     route, 3xTF32),
     then a 1024^2 sequence, whose frames take K3's grid route, against the
     same run on the CPU;
  e. the flagship model (512^2, random weights from a seed) through
     ``run_inference`` in float32 and bfloat16, fused cell off and on, and
     once more in bfloat16 with ``instance_split`` ('prob': 2 K3 launches a
     frame), with each kernel's launch count over (d) + (e): with the fused
     cell, K4's tensor-core route of the dtype runs at all 4 levels of every
     frame;
  d2. int8 (a path of its own, counted from 0): the golden sequence through
     the inference CLI with ``--dtype int8`` (captured and replayed), fused
     cell off and on, dynamic
     scales, then ``--calibrate 4`` into a copy of the model dir, each against
     the same run on the CPU (equal instance count, <= 3 px per frame), each
     launching both int8 routes it takes (6 small-K + 3 wgmma a frame, fused
     5 + 2 and 2 K4 narrow) and no mma_sync;
  e2. the flagship at 512^2 through ``run_inference`` with ``dtype='int8'``,
     fused cell off and on: per frame 24 wgmma + 1 small-K int8 convs and no
     mma_sync, 4 of the wgmma convs with the gate epilogue and no K1, 1 K3
     (unfused) or 20 + 1 int8 convs, 4 K4 bf16
     tensor-core launches, 1 K3 (fused), no plain call; frames/s; one int8
     frame's logits within 0.15 of the bf16 frame's largest |logit|;
  f. K2 (the gate backward) against its plain version at the flagship
     training shapes (B = 5 and 8, 256^2 crops), with K2's time and its
     library call's (``aten::_thnn_fused_lstm_cell_backward_impl``, held to
     K2);
  g. the flagship trained through ``cli/train2d.main`` (B = 5, T = 7, 256^2
     crops of a synthetic 512^2 sequence) in float32 and bfloat16: a few
     steps, one validation, the final checkpoint (bf16: also one at step 4,
     out of the timed steps), then the port's ``inference2d``
     from the trained run dir; K1, K2 and K3 must launch and no plain version
     run, and every parameter must get a nonzero gradient;
  l. the rest of training on the flagship (B5 T7 256² bf16, phase g's data,
     each run counted: K1, K2 and K3 launched, no plain version): l1 resume,
     8 steps with the deterministic provider, elastic augmentation (through
     a recipe), bf16 Adam moments and the save_outputs remat policy, a
     relaunch with ``--continue_run`` to 12 and 12 steps uninterrupted: step
     8 restored bit for bit, the batches of steps 9-12 bit-equal, the
     target file, the losses; l2 a loss 100x on step 8 (a save step)
     rolled back before the save, then ``spike_max_rollbacks + 1`` spikes
     raise and skip the final save; l3 + l4 a fine-tune seeded from phase
     g's bf16 run, 16 steps with ``--profile``: its steps and target, a
     trace naming K1 and K2; l5 steady frames/s, peak memory and K1/K2
     launches per step with remat off, full and save_outputs;
  h. one f32 flagship training step (loss and grads) with the kernels
     against the same step with the plain versions patched in;
  j (kernels). the kernels at the lane counts of TTA and batched streams:
     K4's bf16 route at B = 4 and 8 and its 3xTF32 route at B = 8 at the
     four flagship levels, the
     int8 conv at B = 4 at every flagship int8 shape (the wgmma route with
     the N tile it picks at B = 4, a static scale and the dynamic scale
     shared by the lanes; the mma_sync kernel at the cin = 1 site), each against
     its plain version, timed, with its bound;
  i. (a path counted from 0 with j) the golden model through the inference
     CLI with ``--tta``, ``--tta --tta_mode d4`` and ``--reset_on_jump 0.4``
     (on the golden sequence with an inverted frame spliced in) in f32
     against the same run on the CPU (0 px per frame), and int8 ``--tta``
     with the fused cell off and on (<= 3 px, equal instance counts);
  j. the flagship at 512^2: steady ms/frame of B = 1, TTA 'flip' (4 lanes)
     and 'd4' (8 lanes) in bf16 fused and int8 unfused; ``run_inference``
     with 'd4' in bf16 fused (4 K4 wgmma launches a step at 8 lanes) and
     'flip' in int8 unfused (24 wgmma + 1 small-K int8 convs, 4 of them
     with the gate epilogue and no K1, a step at 4 lanes), counted, no plain
     call;
  k. (counted from 0) ``ctc_sweep`` in bf16 at ``--max_batch 4`` over four
     512^2 sequences (one chunk of 4 lanes) and a 384 x 512 one (a group of
     its own), with SEG and DET; each lane within 3 px per frame of its
     sequence streamed alone; the steady ms per step of a bf16 stream of 1,
     2 and 4 lanes; ``ctc_score`` on the output; ``ckpt_avg`` over
     the bf16 run of (g) (steps 4, 5) and ``inference2d`` from the soup;
     ``import_tf`` of phase e's flagship weights exported as a TF bundle,
     bit-equal.
  m. (counted from 0 on the ranks) the meshes: two ranks on the one card
     over gloo (``parallel.run_ranks``, the kernels built here first), each
     part held to the same card's single-process run: m1 the golden
     sequence through ``inference2d`` with a {"spatial": 2} recipe, f32 fused
     and int8, 0 px; m2 the flagship at 512^2, B = 1, {"spatial": 2}, bf16
     fused (K4 wgmma on blocks of 256 + 4 .. 32 + 4 rows) and int8 unfused
     (dynamic scales all-reduced): one frame's logits (bf16 within K4's
     tolerance, int8 equal), the heights each kernel ran at, the launches
     by route and the steady ms/frame beside the single process (2 ranks on
     one card: not a scaling figure); m3 4 int8 lanes through
     ``run_inference_batched`` under {"data": 2}, 0 px, rank 0 alone writing;
     m4 flagship training B4 T7 256^2 f32, 3 steps, under {"data": 2} and
     {"spatial": 2}: losses within rtol 2e-4, K1 and K2 launched, rank 1
     writing nothing.
  n. (counted from 0, after k) the workflow scripts of
     ``lstm_unet_tpu_torch/scripts`` on the card: n1 held-out data from
     ``heldout_protocol``'s tables (train 03, eval 01-02 at 512^2, cut to 6
     frames); n2 ``select_best --prune`` on phase g's bf16 run, its
     ``ctc_sweep`` children (ranking, soup, eval and int8 confirms) on the
     card, ``act_scales.json`` in ``best/``, ``inference2d`` from it; n3
     ``ctc_sweep --save_intermediate`` of ``best/`` and ``calibrate_recipe``
     on the dumps (``--baseline_check`` bit for bit); n4 ``postprocess_sweep``
     (2x2 grid, 'prob' split) with rows equal to the CPU's, ms per (config,
     frame) beside the CPU's; n5 ``oracle_ceiling`` with and without the
     split, equal to the CPU's; n6 ``mask_agreement`` of phase d's golden
     masks (1.0000 over 8 frames), ``seg_error_decomposition`` and
     ``split_sweep`` on n3's masks; n7 ``carry_drift`` at 512^2, 300 frames,
     on phase g's flagship (K1, K3) and on the golden model with
     ``fused_cell`` (K4's narrow route, K3), its rows and ms/frame. Its wall
     time is printed beside a budget of 240 s.
  o. (counted from 0, after n) the port's bench, ``lstm_unet_tpu_torch.bench
     .main`` in this process on the flagship at full width and depth: o1 the
     default line with ``--mfu`` (int8 calibrated unfused 512^2, B = 1, 32
     frames, with training B8 T7 and the B5 parity line, bf16, full remat),
     o2 bf16 fused, o3 bf16 fused at 4 lanes, o4 f32 fused (8 frames), o5
     ``--mode train --remat_policy none --train_batch 5``; each one JSON line
     (printed after the card's name and power limit) with ``value`` > 0 and
     every ``mfu`` in (0, 1], launching its kernels (o1: both int8 routes,
     K1, K3, K2; o2, o3: K4 wgmma; o4: K4 3xTF32; o5: K1, K2) and no plain
     version. Its wall time is printed beside a budget of 120 s.
The last two lines are a JSON kernel summary (the loop kernels
``grow_into_band`` and ``erosion_distance`` at 512^2, every row of phase p
beside; ``split_markers`` at 512^2, its 1024^2 row beside; K3's two routes as ``ccl`` and
``ccl_grid``; ``conv2d_int8_wgmma`` summed over the 24 convs of one unfused
int8 frame it takes, with each shape beside; ``conv2d_int8_smallk`` at the
cin = 1 site, its B = 4 and tiny rows beside; ``conv2d_int8``, which no
main path launches, at the shapes it served, launches 0; K4's narrow route
at 512^2 F = 32 bf16, every timed shape beside; K4's tensor-core routes and
the int8 routes with their rows at B > 1 under ``batched``) and the device
JSON. The build fails
if ptxas reports spills for a tensor-core kernel (K4's bf16, 3xTF32 and
narrow entries, the int8 conv's wgmma and small-K entries).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
# the frozen recipe of tests/golden/make_golden.py
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 and TF32
# FLOP/s on the tensor cores
HBM_BPS, BF16_FLOPS, TF32_FLOPS = 3.35e12, 989e12, 495e12
INT8_OPS = 1979e12
# flagship ConvLSTM levels: (H = W, F), 5x5
FLAGSHIP_LEVELS = ((512, 128), (256, 256), (128, 256), (64, 512))


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


def device_ms(fn, kernel_name, iters=20, attempts=3):
    """Mean device milliseconds per call of ``fn`` spent in the kernel whose
    name holds ``kernel_name``, from torch.profiler; ``fn`` must launch it
    exactly once, and more launches than calls raise. The profiler has been
    seen to drop kernel records (6 of 20 once): a trace that lacks some is
    taken again, and after ``attempts`` such traces the time is reported as
    not measured (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel_name in e.key]
        launches = sum(e.count for e in events)
        if launches > iters:
            raise AssertionError(f"{kernel_name}: {launches} launches in {iters} calls")
        if launches == iters:
            return sum(e.device_time_total for e in events) / 1e3 / iters
        log(f"torch.profiler saw {launches} {kernel_name} launches in {iters} calls")
    log(f"{kernel_name}: device time not measured (the profiler dropped launches)")
    return None


def fmt(v, spec=".4f"):
    return "not measured" if v is None else format(v, spec)


def bound(nbytes, flops=0.0, peak=BF16_FLOPS):
    """(least ms the card could take, what bounds it): bytes over the HBM
    rate against operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def summary(ms, plain_ms, max_abs_err, bound_ms_by):
    """A kernel's entry of the summary line, with no library time: K1 and K2
    add theirs (``library_k1``, ``library_k2``); no single PyTorch call
    computes any other kernel's function."""
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1], library_ms=None)


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


def compare_dirs(name, got_dir, want_dir, max_px):
    """Masks of ``got_dir`` against ``want_dir``, frame by frame: equal
    instance counts and at most ``max_px`` differing pixels; returns the
    differing pixels per frame."""
    from lstm_unet_tpu_torch.io.tiff import read_tiff

    paths = sorted(glob.glob(os.path.join(want_dir, "mask*.tif")))
    if not paths:
        raise AssertionError(f"{name}: no masks in {want_dir}")
    diffs = []
    for p in paths:
        want = read_tiff(p)
        got = read_tiff(os.path.join(got_dir, os.path.basename(p)))
        diffs.append(int((got != want).sum()))
        if len(np.unique(got)) != len(np.unique(want)) or diffs[-1] > max_px:
            raise AssertionError(f"{name} {os.path.basename(p)}: {diffs[-1]} px differ, "
                                 f"instances {len(np.unique(got)) - 1} vs "
                                 f"{len(np.unique(want)) - 1}")
    return diffs


def phase_kernels(torch):
    """(c): every kernel vs its plain version; returns {name: summary}."""
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    # the plain versions' f32 convs must not run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K1 at the flagship's four ConvLSTM levels (rows = H*W, F), then at its
    # training levels (256^2 crops) at B = 5 and 8, the bench's two training
    # batches (rows = B*H*W); gates and state dtypes as dtype / state_dtype
    # combine on the path
    tol = {torch.float32: (1e-6, 1e-6),        # ulp-level: same f32 formulas
           torch.bfloat16: (1e-6, 2.0 ** -7)}  # one bf16 ulp of output rounding
    errs, timing = [], None
    shapes = [(hw * hw, feat) for hw, feat in FLAGSHIP_LEVELS]
    shapes += [(b * (hw // 2) ** 2, feat) for b in (5, 8) for hw, feat in FLAGSHIP_LEVELS]
    for rows, feat in shapes:
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
                          time_ms(lambda: lstm_gates.lstm_gate_update_plain(gates, c)),
                          library_k1(torch, gates, c))
                log(f"K1 time @512^2 F=128 float32: kernel {timing[0]:.4f} ms, "
                    f"plain {timing[1]:.4f} ms, library {timing[2]:.4f} ms")
    # reads 4F gates + F state, writes 2F, f32, per row
    out["lstm_gate_update"] = dict(summary(timing[0], timing[1], max(errs),
                                           bound(512 * 512 * 128 * 7 * 4)),
                                   library_ms=timing[2])

    out.update(phase_k4(torch, g))

    out.update(phase_k3(torch, g))
    return out


def cell_like_masks(torch):
    """(probabilities [512, 512, 3], interior mask, marker mask of the 'prob'
    splitter) of 300 synthetic cells, 40% of them touching another, on the
    card."""
    from lstm_unet_tpu_torch.io.synthetic import cell_like_probs
    from lstm_unet_tpu_torch.ops import postprocess

    probs = torch.from_numpy(cell_like_probs(512, 512, num_cells=300, seed=0)[0]).cuda()
    interior = (probs[..., 1] > 0.5).contiguous()
    markers = postprocess._erode(interior & (probs[..., 1] >= 0.8)).contiguous()
    return probs, interior, markers


def phase_k3(torch, g):
    """(c), K3: both routes bit-identical to the plain version, then their
    times; returns their summaries."""
    from lstm_unet_tpu_torch.io.synthetic import dense_components_mask, spiral_mask
    from lstm_unet_tpu_torch.ops.kernels import ccl

    dev = torch.device("cuda")
    rand = lambda h, w, p: torch.rand(h, w, device=dev, generator=g) < p
    masks = {f"random {p}": rand(512, 512, p) for p in (0.3, 0.5, 0.6, 0.7)}
    masks["ragged"] = rand(333, 517, 0.55)
    masks["dense components"] = torch.from_numpy(dense_components_mask(512, 512)).to(dev)
    masks["spiral"] = torch.from_numpy(spiral_mask(128)).to(dev)
    masks["empty"] = torch.zeros(512, 512, dtype=torch.bool, device=dev)
    masks["full"] = torch.ones(512, 512, dtype=torch.bool, device=dev)
    masks["isolated pixels"] = torch.zeros(512, 512, dtype=torch.bool, device=dev)
    masks["isolated pixels"][::2, ::2] = True
    masks["one row"] = rand(1, 512, 0.5)
    masks["one column"] = rand(512, 1, 0.5)
    masks["W = 500"] = rand(512, 500, 0.5)
    masks["random 1024^2"] = rand(1024, 1024, 0.5)
    _, masks["cell-like"], masks["cell-like markers"] = cell_like_masks(torch)
    for name, m in masks.items():
        want = ccl.connected_components_plain(m)
        n_comp = int(torch.unique(want).numel()) - int(bool((want == 0).any()))
        routes = ["grid"] if ccl.route(*m.shape) == "grid" else ["cluster", "grid"]
        for which in routes:
            got = ccl.launch(m, which)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K3 {which} differs on the {name} mask "
                                     f"{tuple(m.shape)}: {int((got != want).sum())} px")
        if not torch.equal(ccl.connected_components(m), ccl.launch(m, routes[0])):
            raise AssertionError(f"K3: the wrapper did not take the {routes[0]} route")
        log(f"K3 ccl {name} {tuple(m.shape)} density={float(m.float().mean()):.3f} "
            f"components={n_comp}: {' and '.join(routes)} bit-identical")

    # 512^2: events around the wrapper's calls (host and device together) and
    # the kernel's own device time, for both routes; the plain version once
    times = {}
    for name in ("random 0.5", "cell-like", "cell-like markers"):
        m = masks[name]
        times[name] = dict(
            cluster_ms=time_ms(lambda: ccl.connected_components(m), 50),
            cluster_device_ms=device_ms(lambda: ccl.connected_components(m), "ccl_cluster"),
            grid_ms=time_ms(lambda: ccl.launch(m, "grid"), 50),
            grid_device_ms=device_ms(lambda: ccl.launch(m, "grid"), "ccl_grid"),
            plain_ms=time_ms(lambda: ccl.connected_components_plain(m), 2))
        log(f"K3 time @512^2 {name}: " + ", ".join(f"{k} {fmt(v)}" for k, v in times[name].items()))
    big = masks["random 1024^2"]
    grid = dict(ms=time_ms(lambda: ccl.connected_components(big), 50),
                device_ms=device_ms(lambda: ccl.connected_components(big), "ccl_grid"),
                plain_ms=time_ms(lambda: ccl.connected_components_plain(big), 1))
    log(f"K3 time @1024^2 random 0.5 (grid route): kernel {grid['ms']:.4f} ms (device "
        f"{fmt(grid['device_ms'])}), plain {grid['plain_ms']:.3f} ms")
    # reads the bool mask, writes int32 labels
    t = times["random 0.5"]
    return {"ccl": dict(summary(t["cluster_ms"], t["plain_ms"], 0.0, bound(512 * 512 * 5)),
                        device_ms=t["cluster_device_ms"], masks=times),
            "ccl_grid": dict(summary(grid["ms"], grid["plain_ms"], 0.0,
                                     bound(big.numel() * 5)), device_ms=grid["device_ms"])}


def phase_postprocess(torch):
    """(c2): postprocess_frame on the card against the CPU, split off and on."""
    from lstm_unet_tpu_torch.ops import kernels, postprocess
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    probs = cell_like_masks(torch)[0]
    probs_cpu = probs.cpu()
    counts = {}
    # (split, launches of K3, the growth, erosion and markers kernels)
    for name, need, kw in (("off", (1, 1, 0, 0), {}),
                           ("dist", (2, 2, 1, 1), dict(instance_split=True, split_method="dist")),
                           ("prob", (2, 2, 0, 0), dict(instance_split=True, split_method="prob"))):
        kernels.reset_counts()
        loops.clear_rounds()
        got = postprocess.postprocess_frame(probs, **kw)
        rounds = loops.device_rounds("cuda")
        ran = kernels.counts()
        if (tuple(ran[k]["kernel"] for k in ("ccl", "grow_into_band", "erosion_distance",
                                             "split_markers"))
                != need or any(v["plain"] for v in ran.values())):
            raise AssertionError(f"postprocess split {name}: expected {need} launches of K3, "
                                 f"the loop kernels and the markers kernel, and no plain call "
                                 f"on the card, got {ran}")
        ms = time_ms(lambda: postprocess.postprocess_frame(probs, **kw), 5)
        want = postprocess.postprocess_frame(probs_cpu, **kw)
        if not torch.equal(got.cpu(), want) or rounds != loops.ROUNDS:
            raise AssertionError(f"postprocess split {name}: card and CPU differ in "
                                 f"{int((got.cpu() != want).sum())} px, rounds {rounds} "
                                 f"on the card, {loops.ROUNDS} on the CPU")
        counts[name] = int(got.max())
        log(f"postprocess 512^2 cell-like, split {name}: {counts[name]} instances, equal "
            f"on the card and the CPU; {ms:.3f} ms/frame, launches (K3, growth, erosion, markers) "
            f"{need}, growth rounds {rounds['grow']}, erosion rounds {rounds['erode']} "
            f"(the device's counter, equal to the CPU's)")
    if not counts["dist"] > counts["off"] < counts["prob"]:
        raise AssertionError(f"the split changed nothing: instances {counts}")


# ---------------------------------------------------------------- phase p

PHASE_P_BUDGET_S = 40.0
# steps a configuration runs under set_sync_debug_mode("error"), eagerly and
# as replays of its CUDA graphs, held bit-equal
STEADY_STEPS = 8
# what may stay allocated once a configuration's engines are dropped (the
# library's own workspaces; a step's buffers and its graphs' pool are GBs)
DROPPED_ENGINE_BYTES = 64 << 20
# (configuration, model, lanes, InferenceParams fields): the models are the
# flagship at 512^2 from seed 0, "bf16" with the fused cell, "int8" calibrated
# and unfused, "f32" with the fused cell
SYNC_FREE = (("bf16 fused, B = 1", "bf16", 1, {}),
             ("int8 calibrated, B = 1", "int8", 1, {}),
             ("f32 fused, B = 1", "f32", 1, {}),
             ("bf16 fused, TTA 'flip'", "bf16", 1, dict(tta=True)),
             ("bf16 fused, B = 4", "bf16", 4, {}),
             ("bf16 fused, split 'dist'", "bf16", 1,
              dict(instance_split=True, split_method="dist")),
             ("bf16 fused, split 'prob'", "bf16", 1,
              dict(instance_split=True, split_method="prob")))
# the loops' kernels: (count name, loop, kernel symbol, bytes a pixel read once
# and written once)
LOOP_KERNELS = (("grow_into_band", "grow", "grow_into_band_kernel", 9),
                ("erosion_distance", "erode", "erosion_distance_kernel", 5))


def loop_calls(fn):
    """(``fn()``, [(loop, args)]): the growth and erosion calls that ``fn``
    makes through ``ops.postprocess``, recorded with their inputs."""
    from lstm_unet_tpu_torch.ops import postprocess

    calls = []
    grow, erode = postprocess.grow_into_band, postprocess.erosion_distance

    def rec_grow(lbl, band, max_rounds=0):
        calls.append(("grow", (lbl, band, max_rounds)))
        return grow(lbl, band, max_rounds)

    def rec_erode(mask, max_iters=0, octagon=False):
        calls.append(("erode", (mask, max_iters, octagon)))
        return erode(mask, max_iters, octagon)

    postprocess.grow_into_band, postprocess.erosion_distance = rec_grow, rec_erode
    try:
        out = fn()
    finally:
        postprocess.grow_into_band, postprocess.erosion_distance = grow, erode
    return out, calls


def phase_loop_kernels(torch):
    """(p), kernels: each loop's kernel against its plain version on the
    inputs that ``postprocess_frame`` gives it (512^2 cell-like
    probabilities with the split off, 'dist' and 'prob', and the bench's
    ``grow_iters=3``; 1024^2 with 'dist'), and on a serpentine band:
    bit-equal, with the device round count equal to the plain loop's; their
    times; then ``postprocess_frame`` with the kernels against the same call
    with the plain loops on the card (the port before them). Returns the
    kernels' summaries."""
    from lstm_unet_tpu_torch.io.synthetic import cell_like_probs, serpentine_band
    from lstm_unet_tpu_torch.ops import postprocess
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    plain = {"grow": loops.grow_into_band_plain, "erode": loops.erosion_distance_plain}
    kernel = {"grow": loops.grow_into_band, "erode": loops.erosion_distance}
    probs = cell_like_masks(torch)[0]
    big = torch.from_numpy(cell_like_probs(1024, 1024, num_cells=1200, seed=1)[0]).cuda()
    frames = {"off": (probs, {}),
              "dist": (probs, dict(instance_split=True, split_method="dist")),
              "prob": (probs, dict(instance_split=True, split_method="prob")),
              "grow_iters=3": (probs, dict(grow_iters=3)),
              "1024^2 dist": (big, dict(instance_split=True, split_method="dist"))}
    cases = {}
    for name, (p, kw) in frames.items():
        calls = loop_calls(lambda: postprocess.postprocess_frame(p, **kw))[1]
        cases.update({f"{name} #{i} {loop}": (loop, args)
                      for i, (loop, args) in enumerate(calls)})
    lbl, band = (torch.from_numpy(a).cuda() for a in serpentine_band(128, 128))
    cases["serpentine 128^2 grow"] = ("grow", (lbl, band, 0))
    cases["serpentine 128^2 erode"] = ("erode", (band, 0, True))
    rows = {}
    for name, (loop, args) in cases.items():
        loops.clear_rounds()
        got = kernel[loop](*args)
        want = plain[loop](*args)
        on_card = loops.device_rounds("cuda")[loop]
        if not torch.equal(got, want) or on_card != loops.ROUNDS[loop]:
            raise AssertionError(f"{loop} kernel on {name}: {int((got != want).sum())} px "
                                 f"differ, rounds {on_card} on the card, "
                                 f"{loops.ROUNDS[loop]} plain")
        rows[name] = dict(ms=time_ms(lambda: kernel[loop](*args), 20),
                          plain_ms=time_ms(lambda: plain[loop](*args), 2), rounds=on_card,
                          shape=list(args[0].shape))
        log(f"{loop} kernel {name} {tuple(args[0].shape)}: bit-equal, {on_card} rounds on "
            f"both; kernel {rows[name]['ms']:.4f} ms, plain {rows[name]['plain_ms']:.3f} ms")
    summaries = {}
    for (kname, loop, symbol, per_px), row in zip(LOOP_KERNELS, ("off #0 grow",
                                                                 "dist #0 erode")):
        args = cases[row][1]
        h, w = args[0].shape
        summaries[kname] = dict(
            summary(rows[row]["ms"], rows[row]["plain_ms"], 0.0, bound(h * w * per_px)),
            device_ms=device_ms(lambda: kernel[loop](*args), symbol), shape=row,
            rows={k: v for k, v in rows.items() if cases[k][0] == loop})
    # postprocess_frame with the kernels, then with the plain loops
    for name in ("off", "dist", "prob"):
        p, kw = frames[name]
        ms = time_ms(lambda: postprocess.postprocess_frame(p, **kw), 10)
        postprocess.grow_into_band, postprocess.erosion_distance = plain["grow"], plain["erode"]
        try:
            plain_ms = time_ms(lambda: postprocess.postprocess_frame(p, **kw), 3)
        finally:
            postprocess.grow_into_band, postprocess.erosion_distance = (kernel["grow"],
                                                                        kernel["erode"])
        log(f"postprocess_frame 512^2 cell-like, split {name}: {ms:.3f} ms/frame with the "
            f"loop kernels, {plain_ms:.3f} ms/frame with the plain loops on the card")
    return summaries


# the markers kernel's symbols (a row pass, then a column pass), and the bytes
# a pixel it reads once (dist, interior) and writes once (the markers)
SPLIT_SYMBOLS = ("split_rows_kernel", "split_cols_kernel")
SPLIT_BYTES_PX = 6


def split_yardstick(torch, dist, window, radius):
    """What the markers kernel does of the window maxima, as PyTorch does it
    (timed only; the port never calls it): a float copy, then per radius a
    max_pool2d along the rows and one along the columns (padded -inf, so
    clipped to the frame)."""
    import torch.nn.functional as F

    x = dist.float()[None, None]
    out = []
    for r in (window, radius):
        rows = F.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))
        out.append(F.max_pool2d(rows, (2 * r + 1, 1), stride=1, padding=(r, 0)))
    return out


def phase_split_markers(torch):
    """(p), the markers kernel of the 'dist' split on the distances
    ``postprocess_frame`` gives it (512^2 and 1024^2 cell-like probabilities,
    the default window 16 and rel window 48): bit-equal to its plain version,
    timed beside it, its bound and the yardstick (two separable max pools a
    radius, ``split_yardstick``). Returns its summary."""
    from lstm_unet_tpu_torch.io.synthetic import cell_like_probs
    from lstm_unet_tpu_torch.ops import postprocess
    from lstm_unet_tpu_torch.ops.kernels import postprocess_loops as loops

    window, min_dist, slack, rel, rel_window = 16, 4, 1, 0.65, 48
    args = (window, min_dist, slack, rel, rel_window)
    big = torch.from_numpy(cell_like_probs(1024, 1024, num_cells=1200, seed=1)[0]).cuda()
    rows = {}
    for name, probs in (("512^2 'dist'", cell_like_masks(torch)[0]), ("1024^2 'dist'", big)):
        interior = (probs[..., 1] > 0.5).contiguous()
        dist = postprocess.octagon_distance(interior)
        got = loops.split_markers(dist, interior, *args)
        want = loops.split_markers_plain(dist, interior, *args)
        if not torch.equal(got, want):
            raise AssertionError(f"split_markers kernel on {name}: "
                                 f"{int((got != want).sum())} px differ from the plain version")
        h, w = dist.shape
        passes = [device_ms(lambda: loops.split_markers(dist, interior, *args), sym)
                  for sym in SPLIT_SYMBOLS]
        rows[name] = dict(
            summary(time_ms(lambda: loops.split_markers(dist, interior, *args), 50),
                    time_ms(lambda: loops.split_markers_plain(dist, interior, *args), 5), 0.0,
                    bound(h * w * SPLIT_BYTES_PX)),
            device_ms=None if None in passes else sum(passes), pass_ms=passes,
            library_ms=time_ms(lambda: split_yardstick(torch, dist, window, rel_window), 20),
            markers=int(got.sum()), shape=[h, w])
        r = rows[name]
        log(f"split_markers kernel {name}: bit-equal ({r['markers']} markers); kernel "
            f"{r['ms']:.4f} ms (device {fmt(r['device_ms'])}: rows {fmt(passes[0])}, columns "
            f"{fmt(passes[1])}), plain {r['plain_ms']:.3f} ms, yardstick (max_pool2d) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return dict(rows["512^2 'dist'"], rows=rows)


def sync_free_models(torch):
    """The flagship at 512^2 from seed 0, by name: bf16 fused, int8 (f32
    weights quantized with scales calibrated on 4 synthetic frames,
    unfused), f32 fused."""
    from lstm_unet_tpu_torch.engine.infer import calibrate_act_scales
    from lstm_unet_tpu_torch.io.synthetic import make_cell_sequence
    from lstm_unet_tpu_torch.models import quantize_model_int8

    int8 = flagship_int8_model(torch, fused=False)
    imgs = make_cell_sequence(num_frames=4, height=512, width=512, num_cells=40, seed=7)[0]
    scales = calibrate_act_scales(int8, [f.astype(np.float32) for f in imgs])
    quantize_model_int8(int8, scales, float_dtype=int8.cfg.compute_dtype)
    return {"bf16": flagship_model(torch, "bfloat16", True), "int8": int8,
            "f32": flagship_model(torch, "float32", True)}


def sync_debug(torch, fn, *args):
    """``fn(*args)`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    call that synchronizes with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def steady_steps(torch, step, inputs):
    """``step(x)`` of each input after the first two (the warm-up: on a card
    the first frame captures the graphs), under
    ``set_sync_debug_mode("error")``, the count of launches and graph
    replays from 0; returns (outputs on the host, {kernel: (launches, plain
    calls)}, graph counts, median host ms until each step returned)."""
    from lstm_unet_tpu_torch.ops import kernels

    for x in inputs[:2]:
        step(x)
    torch.cuda.synchronize()
    before, graphs = kernels.snapshot(), kernels.graph_counts()
    outs, host = [], []

    def steady():
        for x in inputs[2:]:
            t0 = time.perf_counter()
            outs.append(step(x))
            host.append((time.perf_counter() - t0) * 1e3)

    sync_debug(torch, steady)
    torch.cuda.synchronize()
    ran = {k: (n - before[k][0], p - before[k][1]) for k, (n, p) in kernels.snapshot().items()}
    graphs = {k: v - graphs[k] for k, v in kernels.graph_counts().items()}
    outs = [tuple(None if t is None else t.cpu() for t in out) for out in outs]
    return outs, ran, graphs, float(np.median(host))


def graph_against_eager(torch, name, runs):
    """Hold the graph run of ``runs`` ({"eager": .., "graph": ..}, each
    ``steady_steps``' tuple) to the eager one: STEADY_STEPS replays and no
    capture, the eager run none; every output bit-equal; the same launches
    of every kernel, and no plain call. Returns the launches of the steps."""
    (eager, ran_e, graphs_e, ms_e), (graph, ran_g, graphs_g, ms_g) = runs["eager"], runs["graph"]
    if graphs_g != {"captures": 0, "replays": STEADY_STEPS} or any(graphs_e.values()):
        raise AssertionError(f"{name}: graph counts {graphs_g} (eager {graphs_e}), expected "
                             f"{STEADY_STEPS} replays and no capture")
    for t, (a, b) in enumerate(zip(graph, eager)):
        for i, (x, y) in enumerate(zip(a, b)):
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"{name}: output {i} of frame {t} replayed differs from "
                                     f"the eager step's")
    if ran_g != ran_e or any(p for _, p in ran_g.values()):
        raise AssertionError(f"{name}: replays launched {ran_g}, the eager steps {ran_e}")
    probs = len(graph[0]) > 1 and graph[0][1] is not None
    log(f"  {name}: {STEADY_STEPS} replays bit-equal to the eager steps (labels"
        f"{' and probs' if probs else ''}), the same launches; host ms until return, eager "
        f"{ms_e:.3f} / graph {ms_g:.3f}")
    return {k: n for k, (n, _) in ran_g.items()}


def phase_sync_free(torch):
    """(p), the step: steady steps of ``StreamingInferenceEngine
    .step_batch_async`` on the flagship at 512^2 in each configuration of
    ``SYNC_FREE``, then of the bench's ``build_pipeline`` step (int8
    calibrated), each run eagerly and as replays of its CUDA graphs (the
    engine's default on a card), each under ``set_sync_debug_mode("error")``:
    no step may wait for the card, the replays must equal the eager steps
    bit for bit and launch what they launch, and each configuration must
    launch the loop kernels it needs and K3. A dropped engine must give
    its buffers and its graphs' pool back. The caller counts from 0."""
    import gc

    from lstm_unet_tpu_torch import bench
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu_torch.io.synthetic import make_cell_sequence

    models = sync_free_models(torch)
    frames = make_cell_sequence(num_frames=2 + STEADY_STEPS, height=512, width=512,
                                num_cells=40, seed=0)[0]
    for name, model, lanes, kw in SYNC_FREE:
        batches = [np.stack([np.roll(f, 64 * i, 0) for i in range(lanes)]) for f in frames]
        held = torch.cuda.memory_allocated()
        runs = {}
        for mode in ("eager", "graph"):
            engine = StreamingInferenceEngine(models[model],
                                              InferenceParams(save_intermediate=True, **kw),
                                              "cuda")
            engine.capture = mode == "graph"
            runs[mode] = steady_steps(torch, engine.step_batch_async, batches)
            del engine
        gc.collect()
        left = torch.cuda.memory_allocated() - held
        if left > DROPPED_ENGINE_BYTES:
            raise AssertionError(f"sync-free step {name}: {left} bytes stay allocated after "
                                 f"its engines are dropped")
        ran = graph_against_eager(torch, name, runs)
        frames_pp = STEADY_STEPS * lanes  # postprocessed frames (TTA: the averaged one)
        need = {"grow_into_band": frames_pp * (2 if "split" in name else 1),
                "erosion_distance": frames_pp if "'dist'" in name else 0,
                "split_markers": frames_pp if "'dist'" in name else 0}
        if any(ran[k] != n for k, n in need.items()) or ran["ccl"] == 0:
            raise AssertionError(f"sync-free step {name}: launches {ran}, expected {need}")
        labels = [out[0] for out in runs["graph"][0]]
        if any(tuple(t.shape) != (lanes, 512, 512) for t in labels):
            raise AssertionError(f"sync-free step {name}: labels {[t.shape for t in labels]}")
        log(f"sync-free step {name}: {STEADY_STEPS} steps, no sync; launches grow "
            f"{ran['grow_into_band']}, erosion {ran['erosion_distance']}, markers "
            f"{ran['split_markers']}, K3 {ran['ccl']}")
    uploaded = bench.upload(bench.make_frames(2 + STEADY_STEPS, 512), "cuda")
    runs = {}
    for mode in ("eager", "graph"):
        step, state = bench.build_pipeline(bench.make_model("int8", tiny=False, device="cuda"),
                                           512, calibrated=True)
        if mode == "eager":
            state.graphs = None
        runs[mode] = steady_steps(torch, lambda f: step(state, f)[1:], uploaded)
        del step, state
    ran = graph_against_eager(torch, "bench build_pipeline (int8 calibrated, grow_iters=3)",
                              runs)
    if ran["grow_into_band"] != STEADY_STEPS or ran["ccl"] != STEADY_STEPS:
        raise AssertionError(f"sync-free bench step: launches {ran}")
    if any(tuple(out[0].shape) != (1, 512, 512) for out in runs["graph"][0]):
        raise AssertionError("sync-free bench step: labels of another shape")
    log(f"sync-free step bench build_pipeline (int8 calibrated, grow_iters=3): "
        f"{STEADY_STEPS} steps, no sync")


def phase_p(torch):
    """(p): the loop kernels and the markers kernel against their plain
    versions, not counted; then the sync-free steps counted from 0. Returns
    (the kernels' summaries, the launches of the steps); fails past
    ``PHASE_P_BUDGET_S``."""
    from lstm_unet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    summaries = phase_loop_kernels(torch)
    summaries["split_markers"] = phase_split_markers(torch)
    kernels.reset_counts()
    phase_sync_free(torch)
    ran = kernels.counts()
    for k in ("grow_into_band", "erosion_distance", "split_markers", "ccl"):
        if ran[k]["kernel"] == 0:
            raise AssertionError(f"phase p: {k} never launched: {ran}")
    if any(v["plain"] for v in ran.values()):
        raise AssertionError(f"phase p: plain versions ran: {ran}")
    secs = time.perf_counter() - t0
    log(f"phase p: {secs:.1f} s (budget {PHASE_P_BUDGET_S:.0f} s); launches "
        f"{ {k: v['kernel'] for k, v in ran.items() if v['kernel']} }")
    if secs > PHASE_P_BUDGET_S:
        raise AssertionError(f"phase p took {secs:.1f} s, past its {PHASE_P_BUDGET_S:.0f} s")
    return summaries, ran


def sync_free_alone():
    """Phases c2 and p on their own, the kernels built first."""
    import torch
    from lstm_unet_tpu_torch.ops.kernels import _build

    _build.library()
    log(card_name(torch))
    phase_postprocess(torch)
    summaries, _ = phase_p(torch)
    log(json.dumps(summaries))


def k4_inputs(torch, g, b, hw, feat, k, dt, sdt):
    """gx, h, c, wh of one level, made on the card from ``g``; ``hw`` is
    (H, W) or one side."""
    h_, w_ = (hw, hw) if isinstance(hw, int) else hw
    lim = (6.0 / (k * k * feat + k * k * 4 * feat)) ** 0.5
    return ((torch.randn(b, h_, w_, 4 * feat, device="cuda", generator=g) * 0.5).to(dt),
            (torch.rand(b, h_, w_, feat, device="cuda", generator=g) * 2 - 1).to(sdt),
            torch.randn(b, h_, w_, feat, device="cuda", generator=g).to(sdt),
            ((torch.rand(k, k, feat, 4 * feat, device="cuda", generator=g) * 2 - 1)
             * lim).to(dt))


def k4_tolerance(torch, k, feat, sdt):
    """(atol, rtol) of K4 against its plain version. Both sum exact products
    in f32, in other orders: 2e-5 with f32 state (the reference's
    fused-vs-XLA bound) and 1e-5 plus one bf16 ulp of output rounding with
    bf16 state, up to flagship level 0's K*K*F = 3200 products; above that
    the atol grows with the summation length, as a sum's worst-case rounding
    error does (x2 at levels 1-2, x4 at level 3)."""
    scale = max(1.0, k * k * feat / 3200)
    if sdt == torch.float32:
        return 2e-5 * scale, 0.0
    return 1e-5 * scale, 2.0 ** -7


def hconv_k1(torch, lstm_gates, gx, h, c, wh):
    """What the unfused cell runs instead of K4 (its yardstick, never called
    by the port's fused path): cuDNN's h-conv in the compute dtype, the add
    of gx, and K1."""
    k = wh.shape[0]
    w_oihw = wh.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    h_nchw = h.to(wh.dtype).permute(0, 3, 1, 2)

    def run():
        z = torch.nn.functional.conv2d(h_nchw, w_oihw, padding=k // 2)
        return lstm_gates.fused_lstm_gate_update(z.permute(0, 2, 3, 1) + gx, c)
    return run


def phase_k4(torch, g):
    """(c), K4: the three routes against the plain version; returns their
    summaries."""
    from lstm_unet_tpu_torch.ops.kernels import _build, convlstm_cell, lstm_gates

    lib = _build.library()
    for k in convlstm_cell.TC_KERNEL_SIZES:
        if lib.lut_convlstm_level_wgmma_smem(k) != convlstm_cell.wgmma_smem_bytes(k):
            raise AssertionError(f"K4 tensor-core smem formula differs at {k}x{k}")
        if lib.lut_convlstm_level_tf32x3_smem(k) != convlstm_cell.tf32x3_smem_bytes(k):
            raise AssertionError(f"K4 3xTF32 smem formula differs at {k}x{k}")
    for k in convlstm_cell.NARROW_KERNEL_SIZES:
        for t in convlstm_cell.NARROW_FEATS:
            for dt in (torch.bfloat16, torch.float32):
                if (lib.lut_convlstm_level_narrow_smem(k, t, _build.DTYPES[dt])
                        != convlstm_cell.narrow_smem_bytes(k, t, dt)):
                    raise AssertionError(f"K4 narrow smem formula differs at {k}x{k} T={t} {dt}")
    out = {}

    out.update(phase_k4_narrow(torch, g))

    # tensor-core route: the four flagship levels, state bf16 and f32, both
    # activations, plus a ragged B = 2 shape (W not a multiple of 64)
    errs, levels = [], []
    cases = [(1, hw, feat, 5) for hw, feat in FLAGSHIP_LEVELS] + [(2, (37, 100), 128, 5)]
    for (b, hw, feat, k) in cases:
        h_, w_ = (hw, hw) if isinstance(hw, int) else hw
        if convlstm_cell.route(h_, w_, feat, k, b, torch.bfloat16) != "wgmma":
            raise AssertionError(f"K4 route of {hw} F={feat} bf16 is not the tensor-core kernel")
        for sdt in (torch.bfloat16, torch.float32):
            ins = k4_inputs(torch, g, b, hw, feat, k, torch.bfloat16, sdt)
            tol = k4_tolerance(torch, k, feat, sdt)
            for act in ("sigmoid", "hard_sigmoid"):
                got = convlstm_cell.fused_convlstm_level(*ins, act)
                want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
                e = check_close(f"K4 wgmma B={b} {hw} F={feat} state {sdt} {act}", got,
                                want, *tol)
                errs.append(e)
                log(f"K4 wgmma B={b} {hw} F={feat} {k}x{k} state {str(sdt)[6:]} {act}: "
                    f"max_abs_err={e:.3g} (atol {tol[0]:.3g}, rtol {tol[1]:.3g})")
            if b == 1 and sdt == torch.bfloat16:
                gx, h, c, wh = ins
                packed = convlstm_cell.pack_wh(wh)
                ms = time_ms(lambda: convlstm_cell.wgmma_level(gx, h, c, packed, k), 10)
                pack_ms = time_ms(lambda: convlstm_cell.pack_wh(wh), 10)
                alt = time_ms(hconv_k1(torch, lstm_gates, *ins), 10)
                plain = time_ms(lambda: convlstm_cell.fused_convlstm_level_plain(*ins), 3)
                flops = 2 * hw * hw * k * k * feat * 4 * feat
                nbytes = 2 * (hw * hw * 8 * feat + k * k * feat * 4 * feat)
                bd = bound(nbytes, flops)
                levels.append(summary(ms, plain, None, bd))
                log(f"K4 wgmma time @{hw}^2 F={feat} 5x5 bf16: kernel {ms:.4f} ms "
                    f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bd[0] / ms:.1f}% of the "
                    f"{bd[0]:.4f} ms bf16 bound), pack {pack_ms:.4f} ms, plain "
                    f"{plain:.3f} ms; cuDNN h-conv + add + K1 {alt:.4f} ms")
    out["fused_convlstm_level_wgmma"] = dict(levels[0], max_abs_err=max(errs))

    # 3xTF32 route: the four flagship levels in f32 (state f32, both
    # activations), plus the ragged B = 2 shape with f32 and bf16 state; held
    # to K4's f32 tolerance, not TF32's; its bound is 3 TF32 products per
    # multiply-add at the TF32 peak
    errs, levels = [], []
    cases = [(1, hw, feat, 5, torch.float32) for hw, feat in FLAGSHIP_LEVELS]
    cases += [(2, (37, 100), 128, 5, sdt) for sdt in (torch.float32, torch.bfloat16)]
    for (b, hw, feat, k, sdt) in cases:
        h_, w_ = (hw, hw) if isinstance(hw, int) else hw
        if convlstm_cell.route(h_, w_, feat, k, b, torch.float32) != "tf32x3":
            raise AssertionError(f"K4 route of {hw} F={feat} f32 is not the 3xTF32 kernel")
        ins = k4_inputs(torch, g, b, hw, feat, k, torch.float32, sdt)
        tol = k4_tolerance(torch, k, feat, sdt)
        for act in ("sigmoid", "hard_sigmoid"):
            got = convlstm_cell.fused_convlstm_level(*ins, act)
            want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
            e = check_close(f"K4 tf32x3 B={b} {hw} F={feat} state {sdt} {act}", got, want,
                            *tol)
            errs.append(e)
            log(f"K4 tf32x3 B={b} {hw} F={feat} {k}x{k} state {str(sdt)[6:]} {act}: "
                f"max_abs_err={e:.3g} (atol {tol[0]:.3g}, rtol {tol[1]:.3g})")
        if b == 1:
            gx, h, c, wh = ins
            packed = convlstm_cell.pack_wh_tf32x3(wh)
            ms = time_ms(lambda: convlstm_cell.tf32x3_level(gx, h, c, packed, k), 10)
            pack_ms = time_ms(lambda: convlstm_cell.pack_wh_tf32x3(wh), 10)
            alt = time_ms(hconv_k1(torch, lstm_gates, *ins), 5)
            plain = time_ms(lambda: convlstm_cell.fused_convlstm_level_plain(*ins), 3)
            flops = 2 * hw * hw * k * k * feat * 4 * feat
            # gx, h, c, h', c' in f32 and the hi/lo packed Wh
            nbytes = 4 * (hw * hw * 8 * feat + 2 * k * k * feat * 4 * feat)
            bd = bound(nbytes, 3 * flops, TF32_FLOPS)
            levels.append(summary(ms, plain, None, bd))
            log(f"K4 tf32x3 time @{hw}^2 F={feat} 5x5 f32: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} f32 TFLOP/s, {100 * bd[0] / ms:.1f}% of the "
                f"{bd[0]:.4f} ms 3xTF32 bound), pack {pack_ms:.4f} ms, plain "
                f"{plain:.3f} ms; cuDNN f32 h-conv + add + K1 (TF32 off) {alt:.4f} ms")
    out["fused_convlstm_level_tf32x3"] = dict(levels[0], max_abs_err=max(errs))
    return out


# K4's narrow route: the 512^2 shapes it was built for, then the tiny model's
# two levels (launch-bound), each at B = 1 and 2: (B, H = W, F, K)
NARROW_SHAPES = ((1, 512, 32, 5), (1, 512, 96, 5), (1, 512, 64, 7))
TINY_LEVELS = ((1, 32, 8, 3), (2, 32, 8, 3), (1, 16, 16, 3), (2, 16, 16, 3))


def phase_k4_narrow(torch, g):
    """(c), K4's narrow route (the levels the 64-feature tensor-core tiles do
    not take): at the three 512^2 shapes and the tiny model's levels, in
    bf16 and in f32 (3xTF32), against the plain version; per shape the
    narrow kernel's time on a kept pack, the unfused cell's cuDNN h-conv +
    add + K1 in the same dtype (the yardstick the port does not call), the
    plain version's, and the bound. Returns the narrow summary."""
    from lstm_unet_tpu_torch.ops.kernels import convlstm_cell, lstm_gates

    rows, errs = [], []
    for b, hw, feat, k in NARROW_SHAPES + TINY_LEVELS:
        flops = 2 * b * hw * hw * k * k * feat * 4 * feat
        for dt in (torch.bfloat16, torch.float32):
            if convlstm_cell.route(hw, hw, feat, k, b, dt) != "narrow":
                raise AssertionError(f"K4 route of B={b} {hw}^2 F={feat} {k}x{k} {dt} is not "
                                     f"the narrow kernel")
            ins = k4_inputs(torch, g, b, hw, feat, k, dt, dt)
            tol = k4_tolerance(torch, k, feat, dt)
            for act in ("sigmoid", "hard_sigmoid"):
                got = convlstm_cell.fused_convlstm_level(*ins, act)
                want = convlstm_cell.fused_convlstm_level_plain(*ins, act)
                errs.append(check_close(f"K4 narrow B={b} {hw}^2 F={feat} {k}x{k} {dt} {act}",
                                        got, want, *tol))
            gx, h, c, wh = ins
            packed = convlstm_cell.pack_for_route(wh, "narrow")
            iters = 10 if hw == 512 else 50
            ms = time_ms(lambda: convlstm_cell.narrow_level(gx, h, c, packed, k), iters)
            alt = time_ms(hconv_k1(torch, lstm_gates, *ins), iters)
            plain = time_ms(lambda: convlstm_cell.fused_convlstm_level_plain(*ins), 2)
            el = 2 if dt == torch.bfloat16 else 4
            # gx, h, c, h', c' and the packed Wh (hi and lo for 3xTF32)
            nbytes = el * (b * hw * hw * 8 * feat + (1 + (el == 4)) * k * k * feat * 4 * feat)
            bd = (bound(nbytes, flops) if dt == torch.bfloat16
                  else bound(nbytes, 3 * flops, TF32_FLOPS))
            row = dict(shape=f"B{b} {hw}^2 F={feat} {k}x{k} {str(dt)[6:]}", max_abs_err=errs[-1],
                       ms=ms, plain_ms=plain, bound_ms=bd[0], bound_by=bd[1],
                       share=bd[0] / ms, unfused_ms=alt)
            rows.append(row)
            log(f"K4 narrow {row['shape']}: max_abs_err={errs[-1]:.3g} (atol {tol[0]:.3g}, rtol "
                f"{tol[1]:.3g}); kernel {ms:.4f} ms ({100 * row['share']:.1f}% of the "
                f"{bd[0]:.4f} ms bound, {bd[1]}), cuDNN h-conv + add + K1 {alt:.4f} ms, plain "
                f"{plain:.3f} ms")
            del ins, gx, h, c, wh, packed, got, want
            torch.cuda.empty_cache()
    narrow = dict(rows[0], max_abs_err=max(errs), shapes=rows, library_ms=None)
    narrow.pop("shape")
    return {"fused_convlstm_level_narrow": narrow}


def library_k1(torch, gates, c):
    """ms of PyTorch's fused LSTM cell (``aten::_thnn_fused_lstm_cell``, gate
    order i, f, g, o, sigmoid: K1's function, fed K1's gates as its input
    gates and zeros as its hidden gates) on K1's inputs, after holding its
    (c', h') to K1's within 1e-5; the port never calls it."""
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    zeros = torch.zeros_like(gates)
    fused = torch.ops.aten._thnn_fused_lstm_cell
    hy, cy, _ = fused(gates, zeros, c)
    e = check_close("aten::_thnn_fused_lstm_cell against K1", (cy, hy),
                    lstm_gates.fused_lstm_gate_update(gates, c), 1e-5, 1e-5)
    ms = time_ms(lambda: fused(gates, zeros, c))
    log(f"K1's library call aten::_thnn_fused_lstm_cell: {ms:.4f} ms, max_abs_err {e:.3g} "
        f"against K1")
    return ms


def library_k2(torch, gates, c, dc_out, dh):
    """ms of ``aten::_thnn_fused_lstm_cell_backward_impl`` (K2's function, on
    the activated gates its forward saves) on K2's inputs, after holding its
    (dgates, dc) to K2's within 1e-5; the port never calls it."""
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    _, cy, workspace = torch.ops.aten._thnn_fused_lstm_cell(gates, torch.zeros_like(gates), c)
    bwd = torch.ops.aten._thnn_fused_lstm_cell_backward_impl
    dgates, dcx, _ = bwd(dh, dc_out, c, cy, workspace, False)
    e = check_close("aten::_thnn_fused_lstm_cell_backward_impl against K2", (dgates, dcx),
                    lstm_gates.lstm_gate_update_bwd(gates, c, dc_out, dh), 1e-5, 1e-5)
    ms = time_ms(lambda: bwd(dh, dc_out, c, cy, workspace, False))
    log(f"K2's library call aten::_thnn_fused_lstm_cell_backward_impl: {ms:.4f} ms, "
        f"max_abs_err {e:.3g} against K2")
    return ms


def phase_k2(torch):
    """(f): K2 against its plain version at the flagship training shapes
    (rows = B x H x W of each level at B = 5 and 8, 256^2 crops: the
    trainer's and the bench's batches); returns its summary."""
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    tol = {torch.float32: (1e-6, 1e-6),        # same f32 formulas, same rounding
           torch.bfloat16: (1e-6, 2.0 ** -7)}  # one bf16 ulp of output rounding
    errs, timing = [], None
    for b, hw, feat in [(b, hw // 2, feat) for b in (5, 8) for hw, feat in FLAGSHIP_LEVELS]:
        rows = b * hw * hw
        for gdt, sdt in ((torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            z = torch.randn(rows, 4 * feat, device=dev, generator=g) * 3
            z[:64] = 2.5  # hard_sigmoid's band edges, exactly
            z[64:128] = -2.5
            gates = z.to(gdt)
            c, dc_out, dh = (torch.randn(rows, feat, device=dev, generator=g).to(sdt)
                             for _ in range(3))
            for act in ("sigmoid", "hard_sigmoid"):
                got = lstm_gates.lstm_gate_update_bwd(gates, c, dc_out, dh, act)
                want = lstm_gates.lstm_gate_update_bwd_plain(gates, c, dc_out, dh, act)
                e = max(check_close(f"K2 rows={rows} F={feat} {gdt}/{sdt} {act} dgates",
                                    got[:1], want[:1], *tol[gdt]),
                        check_close(f"K2 rows={rows} F={feat} {gdt}/{sdt} {act} dc",
                                    got[1:], want[1:], *tol[sdt]))
                if act == "hard_sigmoid" and bool(got[0][:128, :feat].any()):
                    raise AssertionError("K2: hard_sigmoid derivative at z = +-2.5 is not 0")
                errs.append(e)
                log(f"K2 lstm_gate_update_bwd rows={rows} F={feat} gates "
                    f"{str(gdt)[6:]} state {str(sdt)[6:]} {act}: max_abs_err={e:.3g}")
            if timing is None:  # level 0, f32: the largest shape of training
                timing = (time_ms(lambda: lstm_gates.lstm_gate_update_bwd(
                              gates, c, dc_out, dh)),
                          time_ms(lambda: lstm_gates.lstm_gate_update_bwd_plain(
                              gates, c, dc_out, dh)),
                          library_k2(torch, gates, c, dc_out, dh))
                gb = rows * feat * 12 * 4 / 1e9  # reads 7F, writes 5F f32 per row
                log(f"K2 time @B5x256^2 F=128 float32: kernel {timing[0]:.4f} ms "
                    f"({gb / timing[0]:.2f} TB/s), plain {timing[1]:.4f} ms, library "
                    f"{timing[2]:.4f} ms")
    # reads 4F gates + F state + 2F cotangents, writes 4F + F, f32, per row
    return dict(summary(timing[0], timing[1], max(errs), bound(5 * 256 * 256 * 128 * 12 * 4)),
                library_ms=timing[2])


def train_args(root, save_root, dtype, steps, save_every=10 ** 9):
    return ["--device", "cuda", "--root_data_dir", root,
            "--train_sequence_list", "Synth-N2DH-SIM:01",
            "--val_sequence_list", "Synth-N2DH-SIM:01",
            "--crop_size", "256", "256", "--batch_size", "5", "--unroll_len", "7",
            "--dtype", dtype, "--num_iterations", str(steps),
            "--print_to_console_interval", "1", "--validation_interval", str(steps),
            "--save_checkpoint_iteration", str(save_every),
            "--root_save_dir", save_root, "--experiment_name", f"flagship_{dtype}"]


def phase_train(torch, work, card, launched):
    """(g): flagship training through the CLI, then inference from its run
    dir; adds each main-path run's launch counts to ``launched``. The bf16
    run also saves at step 4 (and 5, the final save); returns its run dir
    (phase k averages its steps). The steady frames/s leaves out the first
    step and the step after an interval save, which holds the save."""
    import lstm_unet_tpu_torch.engine.train as engine_train
    from lstm_unet_tpu_torch.cli.inference2d import main as infer_main
    from lstm_unet_tpu_torch.cli.train2d import main as train_main
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "train_data")
    seq_dir, _ = write_ctc_dataset(root, num_frames=16, height=512, width=512,
                                   num_cells=40, seed=0)
    # every parameter must get a nonzero gradient at least once: watch the
    # grads the train step computes (flags stay on the device, no sync)
    seen = {}
    loss_and_grads = engine_train.loss_and_grads

    def watched(*args, **kw):
        out = loss_and_grads(*args, **kw)
        for name, grad in out[3].items():
            nz = (grad != 0).any()
            seen[name] = nz if name not in seen else seen[name] | nz
        return out

    engine_train.loss_and_grads = watched
    try:
        for dtype, steps in (("float32", 3), ("bfloat16", 5)):
            seen.clear()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counts()
            save_every = 4 if dtype == "bfloat16" else 10 ** 9
            trainer = train_main(train_args(root, os.path.join(work, "runs"), dtype, steps,
                                            save_every))
            torch.cuda.synchronize()
            ran = kernels.counts()
            add_counts(launched, ran)
            if any(v["plain"] for v in ran.values()):
                raise AssertionError(f"train {dtype}: plain versions ran on the card: {ran}")
            for k in ("lstm_gate_update", "lstm_gate_update_bwd", "ccl"):
                if ran[k]["kernel"] == 0:
                    raise AssertionError(f"train {dtype}: {k} never launched: {ran}")
            hist = trainer.history
            if len(hist) != steps or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"train {dtype}: losses {[h['loss'] for h in hist]}")
            params = dict(trainer.model.named_parameters())
            missing = sorted(n for n in params if n not in seen or not bool(seen[n]))
            if missing:
                raise AssertionError(f"train {dtype}: no gradient reached {missing}")
            vm = trainer.last_val_metrics
            if not all(np.isfinite(vm[k]) for k in ("loss", "seg", "det")):
                raise AssertionError(f"train {dtype}: validation {vm}")
            save_dir = trainer.p.experiment_save_dir
            saved = sorted(int(d) for d in os.listdir(save_dir) if d.isdigit())
            if saved != ([4, steps] if dtype == "bfloat16" else [steps]):
                raise AssertionError(f"train {dtype}: saved steps {saved} in {save_dir}")
            # a step's seconds run from the previous step's print, so they
            # hold an interval save made after the previous step
            steady = [h for h in hist[1:] if (h["step"] - 1) % save_every]
            fps = sum(h["frames"] for h in steady) / sum(h["seconds"] for h in steady)
            log(f"train flagship B5 T7 256^2 {dtype}: {steps} steps, losses "
                f"{[round(h['loss'], 5) for h in hist]}, gnorm {hist[-1]['grad_norm']:.4g}; "
                f"step 1 {hist[0]['seconds']:.3f} s; steady {fps:.3f} frames/s "
                f"(steps {[h['step'] for h in steady]}) [{card}]; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; val loss "
                f"{vm['loss']:.4f} seg {vm['seg']:.4f} det {vm['det']:.4f}; launches "
                f"{ {k: v['kernel'] for k, v in ran.items()} }")

            out = os.path.join(work, f"trained_{dtype}_res")
            kernels.reset_counts()
            n = infer_main(["--model_path", os.path.dirname(save_dir),
                            "--sequence_path", seq_dir, "--output_path", out,
                            "--device", "cuda", "--pre_sequence_frames", "2"])
            ran = kernels.counts()
            add_counts(launched, ran)
            written = len(glob.glob(os.path.join(out, "mask*.tif")))
            if n != 16 or written != 16 or any(v["plain"] for v in ran.values()):
                raise AssertionError(f"inference from the {dtype} run: {n} masks "
                                     f"reported, {written} written, counts {ran}")
            log(f"inference2d from the trained {dtype} run dir: {n} masks; launches "
                f"{ {k: v['kernel'] for k, v in ran.items()} }")
            del trainer
            torch.cuda.empty_cache()
    finally:
        engine_train.loss_and_grads = loss_and_grads
    return os.path.dirname(save_dir)


def check_run(name, ran, launched):
    """After a training run: K1, K2 and K3 launched, no plain version ran;
    adds the run's counts to ``launched``."""
    add_counts(launched, ran)
    if any(v["plain"] for v in ran.values()):
        raise AssertionError(f"{name}: plain versions ran on the card: {ran}")
    for k in ("lstm_gate_update", "lstm_gate_update_bwd", "ccl"):
        if ran[k]["kernel"] == 0:
            raise AssertionError(f"{name}: {k} never launched: {ran}")


def npz_tensors(torch, path, opt=False):
    """A saved step's params (or, with ``opt``, its moments ``mu``) as the
    port's tensors."""
    from lstm_unet_tpu_torch.checkpoint.convert import opt_state_from_npz, params_from_jax

    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return opt_state_from_npz(flat)["mu"] if opt else params_from_jax(flat)


def bit_equal(torch, got, want):
    """Names of the tensors of ``got`` that differ from ``want`` in a bit."""
    return sorted(k for k, v in got.items()
                  if not torch.equal(v.cpu().view(torch.int16) if v.dtype == torch.bfloat16
                                     else v.cpu(), want[k].view(torch.int16)
                                     if want[k].dtype == torch.bfloat16 else want[k]))


def phase_train_rest(torch, work, card, launched, seed_run):
    """(l): the rest of training on the flagship, B5 T7 256² bf16, through
    ``cli/train2d.main`` on phase g's data. l1 resume: 8 steps with the
    deterministic provider, elastic augmentation (recipe), bf16 moments and
    the save_outputs policy, saving at 4 and 8; a relaunch with
    ``--continue_run --num_iterations 12``; 12 steps uninterrupted. l2 spike:
    a loss 100x on step 8, a save step, rolled back before the save; then
    ``spike_max_rollbacks + 1`` spikes raise. l3 + l4: a fine-tune seeded
    from phase g's bf16 run, 16 steps with ``--profile``. l5: steady
    frames/s, peak memory and K1/K2 launches per step with remat off, full
    and save_outputs. Each run launches K1, K2 and K3 and no plain version."""
    import lstm_unet_tpu_torch.engine.train as engine_train
    from lstm_unet_tpu_torch.checkpoint import CheckpointManager
    from lstm_unet_tpu_torch.cli.train2d import main as train_main
    from lstm_unet_tpu_torch.io.grain_reader import GrainCTCReaderSequence2D
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "train_data")  # phase g's 16-frame 512^2 sequence
    runs = os.path.join(work, "runs_l")
    recipes = {}
    for name, knobs in (("elastic", {"elastic_augmentation": True}),
                        ("guard", {"spike_warmup": 2}), ("no_remat", {"remat": False})):
        recipes[name] = os.path.join(work, f"recipe_{name}.json")
        with open(recipes[name], "w") as f:
            json.dump(knobs, f)

    def run(name, steps, *extra, expect_error=None):
        kernels.reset_counts()
        args = train_args(root, runs, "bfloat16", steps, 10 ** 9) + [
            "--experiment_name", name, *extra]
        if expect_error is None:
            trainer = train_main(args)
        else:
            try:
                train_main(args)
            except expect_error as e:
                trainer = e
            else:
                raise AssertionError(f"{name}: {expect_error.__name__} not raised")
        torch.cuda.synchronize()
        check_run(name, kernels.counts(), launched)
        return trainer

    # (l1) resume
    knobs = ["--recipe", recipes["elastic"], "--data_provider_class", "GrainCTCReaderSequence2D",
             "--adam_mu_dtype", "bfloat16", "--remat", "--remat_policy", "save_outputs",
             "--save_checkpoint_iteration", "4"]
    t0 = time.perf_counter()
    cut = run("resume", 8, *knobs)
    if cut.global_step != 8 or CheckpointManager(cut.p.experiment_save_dir).all_steps() != [4, 8]:
        raise AssertionError(f"l1: first launch ended at {cut.global_step}")
    seen, restored = [], {}
    get_batch, restore = GrainCTCReaderSequence2D.get_batch, engine_train.Trainer._restore

    def recording(self):
        batch = get_batch(self)
        if self.return_instances is False:  # the training reader, not validation's
            seen.append(batch)
        return batch

    def snapshot(self, path):
        restore(self, path)
        restored.update(step=self.global_step, params={
            k: v.detach().clone() for k, v in self.model.state_dict().items()},
            mu={k: v.clone() for k, v in self.optimizer.mu.items()},
            nu={k: v.clone() for k, v in self.optimizer.nu.items()})

    GrainCTCReaderSequence2D.get_batch, engine_train.Trainer._restore = recording, snapshot
    try:
        resumed = run("resume", 12, *knobs, "--continue_run", "--validation_interval", "4")
    finally:
        GrainCTCReaderSequence2D.get_batch, engine_train.Trainer._restore = get_batch, restore
    whole = run("whole", 12, *knobs)
    step8 = os.path.join(cut.p.experiment_save_dir, "8")
    bad = (bit_equal(torch, restored["params"], npz_tensors(torch, os.path.join(
        step8, "params.npz")))
        + bit_equal(torch, restored["mu"], npz_tensors(torch, os.path.join(
            step8, "opt_state.npz"), opt=True)))
    if restored.get("step") != 8 or bad or resumed.global_step != 12:
        raise AssertionError(f"l1: restored step {restored.get('step')}, ended at "
                             f"{resumed.global_step}; tensors not bit-equal: {bad[:4]}")
    if any(m.dtype != torch.bfloat16 for m in restored["mu"].values()):
        raise AssertionError("l1: the restored moments are not bf16")
    if len(seen) != 4:
        raise AssertionError(f"l1: the resumed run read {len(seen)} batches")
    for step, batch in zip(range(8, 12), seen):
        if not all(np.array_equal(a, b) for a, b in zip(batch, whole.reader.make_batch(step))):
            raise AssertionError(f"l1: the resumed batch of step {step + 1} differs from "
                                 f"the uninterrupted run's")
    with open(os.path.join(cut.p.experiment_save_dir, "target_step.json")) as f:
        target = json.load(f)
    if target != {"target_step": 12, "initial_step": 0}:
        raise AssertionError(f"l1: target_step.json {target}")
    got = [h["loss"] for h in resumed.history]
    want = [h["loss"] for h in whole.history[8:]]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    # step 9 runs from a fresh LSTM state after the relaunch and from the
    # state of steps 7-8 in the uninterrupted run; steps 10-12 begin new
    # traversals in both (16 frames: windows of 7 end at steps 3, 6, 9, 12)
    if max(gaps[1:]) > 1e-2:
        raise AssertionError(f"l1: resumed losses {got} vs uninterrupted {want}")
    log(f"l1 resume (B5 T7 256^2 bf16, grain provider, elastic, bf16 mu, save_outputs): "
        f"step 8 restored bit-equal ({len(restored['params'])} params, "
        f"{len(restored['mu'])} bf16 moments), batches of steps 9-12 bit-equal, target "
        f"{target}; losses of steps 9-12 resumed {[round(x, 6) for x in got]} vs "
        f"uninterrupted {[round(x, 6) for x in want]}, relative gap "
        f"{[f'{g:.2e}' for g in gaps]} (step 9: fresh LSTM state after the relaunch); "
        f"{time.perf_counter() - t0:.1f} s for 3 runs [{card}]")

    # (l2) a loss 100x the EMA on step 8, right before the save at 8
    spikes, calls = set(), [0]
    loss_and_grads = engine_train.loss_and_grads

    def spiking(*args, **kw):
        calls[0] += 1
        loss, acc, state, grads = loss_and_grads(*args, **kw)
        return (loss * 100 if calls[0] in spikes else loss), acc, state, grads

    rolled = {}
    rollback = engine_train.Trainer._rollback

    def rollback_snapshot(self, step):
        rollback(self, step)
        rolled[step] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    engine_train.loss_and_grads, engine_train.Trainer._rollback = spiking, rollback_snapshot
    guard = ["--spike_factor", "5", "--spike_cooldown", "1", "--save_checkpoint_iteration", "4"]
    try:
        t0 = time.perf_counter()
        spikes.update({8})
        spiked = run("spike", 10, "--recipe", recipes["guard"], *guard)
        d = spiked.p.experiment_save_dir
        at4 = npz_tensors(torch, os.path.join(d, "4", "params.npz"))
        at8 = npz_tensors(torch, os.path.join(d, "8", "params.npz"))
        if (spiked.spike_guard.rollback_steps != [8] or bit_equal(torch, rolled[8], at4)
                or bit_equal(torch, at8, at4)):
            raise AssertionError(f"l2: rollbacks {spiked.spike_guard.rollback_steps}; the "
                                 f"rolled-back params or step 8's save differ from step 4's")
        log(f"l2 spike: loss x100 on step 8 (a save step) rolled back before the save: "
            f"params after the rollback and the step-8 save bit-equal to step 4's; "
            f"EMA {spiked.spike_guard.ema:.6f}; {time.perf_counter() - t0:.1f} s [{card}]")
        calls[0] = 0
        spikes.clear()
        spikes.update({4, 6})
        err = run("spike_abort", 8, "--recipe", recipes["guard"], "--spike_factor", "5",
                  "--spike_cooldown", "1", "--spike_max_rollbacks", "1",
                  "--save_checkpoint_iteration", "3", "--validation_interval", "3",
                  expect_error=RuntimeError)
        saved = CheckpointManager(os.path.join(runs, sorted(
            d for d in os.listdir(runs) if d.startswith("spike_abort_"))[-1], "ckpt")).all_steps()
        if "spike guard" not in str(err) or saved != [3]:
            raise AssertionError(f"l2: {err!r}; saved steps {saved}")
        log(f"l2 spike_max_rollbacks 1, spikes on steps 4 and 6: {err}; saved steps "
            f"{saved} (no final save)")
    finally:
        engine_train.loss_and_grads, engine_train.Trainer._rollback = loss_and_grads, rollback

    # (l3 + l4) a fine-tune seeded from phase g's bf16 run, profiled
    seed_step = CheckpointManager(os.path.join(seed_run, "ckpt")).latest_step()
    t0 = time.perf_counter()
    ft = run("finetune", 16, "--load_checkpoint", "--load_checkpoint_path", seed_run,
             "--profile")
    if (ft.initial_step, ft.target_step, ft.global_step, ft.history[0]["step"]) != (
            seed_step, seed_step + 16, seed_step + 16, seed_step + 1):
        raise AssertionError(f"l3: initial {ft.initial_step}, target {ft.target_step}, "
                             f"ended at {ft.global_step}, seed step {seed_step}")
    with open(ft.profile_path) as f:
        trace = f.read()
    k1, k2 = trace.count("gate_update_kernel<"), trace.count("gate_update_bwd_kernel<")
    if not (k1 and k2):
        raise AssertionError(f"l4: the trace {ft.profile_path} names no K1 ({k1}) or "
                             f"K2 ({k2}) kernel")
    log(f"l3 fine-tune from phase g's bf16 run (step {seed_step}): steps "
        f"{seed_step + 1}-{ft.global_step}, target {ft.target_step}; l4 trace "
        f"{os.path.basename(ft.profile_path)} ({len(trace) / 2 ** 20:.1f} MiB) names K1 "
        f"{k1} and K2 {k2} times; {time.perf_counter() - t0:.1f} s [{card}]")

    # (l5) remat policies: steady frames/s (steps 3-6), peak memory, launches
    figures = {}
    for label, flags in (("off", ["--recipe", recipes["no_remat"]]), ("full", ["--remat"]),
                         ("save_outputs", ["--remat", "--remat_policy", "save_outputs"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = run(f"remat_{label}", 6, "--dry_run", "--validation_interval", "6", *flags)
        ran = kernels.counts()
        steady = t.history[2:]
        fps = sum(h["frames"] for h in steady) / sum(h["seconds"] for h in steady)
        # a ConvLSTM layer runs K1 once a frame, twice under remat (the
        # recompute), and K2 once; one validation window ran K1 once
        layer_frames = t.p.unroll_len * sum(len(lvl) for lvl in t.cfg.nkp.lstm_kernels)
        per_step = ((ran["lstm_gate_update"]["kernel"] - layer_frames) / 6,
                    ran["lstm_gate_update_bwd"]["kernel"] / 6)
        want = ((2 if label != "off" else 1) * layer_frames, layer_frames)
        if per_step != want:
            raise AssertionError(f"l5 {label}: K1/K2 per step {per_step}, expected {want}")
        figures[label] = (fps, torch.cuda.max_memory_allocated() / 2 ** 30, per_step)
        del t
    log("l5 remat policies, flagship B5 T7 256^2 bf16 (steady steps 3-6): " + "; ".join(
        f"{k} {v[0]:.3f} frames/s, peak {v[1]:.2f} GiB, K1/K2 per step {v[2][0]:.0f}/"
        f"{v[2][1]:.0f}" for k, v in figures.items()) + f" [{card}]")
    return figures


def phase_train_vs_plain(torch):
    """(h): one f32 flagship step's loss and grads with the kernels against
    the plain versions patched in, same weights, state and batch."""
    from lstm_unet_tpu_torch.config import default_net_kernel_params
    from lstm_unet_tpu_torch.engine.optim import global_norm
    from lstm_unet_tpu_torch.engine.train import loss_and_grads
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
    from lstm_unet_tpu_torch.ops import kernels
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = ULSTMnet2D(ModelConfig.make(default_net_kernel_params()), generator=gen,
                       device="cuda")
    state = [[(torch.rand(h.shape, device="cuda", generator=gen) - 0.5,
               torch.randn(c.shape, device="cuda", generator=gen) * 0.5) for (h, c) in lvl]
             for lvl in model.init_state(5, 256, 256)]
    img = torch.rand(5, 7, 256, 256, 1, device="cuda", generator=gen)
    seg = torch.randint(0, 3, (5, 7, 256, 256), device="cuda", generator=gen)
    valid = torch.ones(5, 7, device="cuda")
    cw = (0.15, 0.25, 0.6)

    def run():
        loss, acc, _, grads = loss_and_grads(model, state, img, seg, valid, valid, cw,
                                             remat=True)
        return float(loss.detach()), float(global_norm(grads.values())), grads

    kernels.reset_counts()
    loss_k, gn_k, grads_k = run()
    used = kernels.counts()
    fwd, bwd = lstm_gates.fused_lstm_gate_update, lstm_gates.lstm_gate_update_bwd
    lstm_gates.fused_lstm_gate_update = lstm_gates.lstm_gate_update_plain
    lstm_gates.lstm_gate_update_bwd = lstm_gates.lstm_gate_update_bwd_plain
    try:
        loss_p, gn_p, grads_p = run()
    finally:
        lstm_gates.fused_lstm_gate_update, lstm_gates.lstm_gate_update_bwd = fwd, bwd
    if used["lstm_gate_update_bwd"]["kernel"] == 0 or used["lstm_gate_update"]["plain"]:
        raise AssertionError(f"kernel step did not run the kernels: {used}")
    worst = max(float((grads_k[n] - grads_p[n]).abs().max() / grads_p[n].abs().max())
                for n in grads_p)
    log(f"flagship f32 step, kernels vs plain: loss {loss_k:.8g} vs {loss_p:.8g}, "
        f"grad_norm {gn_k:.8g} vs {gn_p:.8g}, worst per-parameter grad diff "
        f"{worst:.3g} of the parameter's largest grad")
    # the same gate formulas on both sides; cuDNN's f32 backward convs may
    # sum in a run-dependent order, carried through 7 frames and 4 levels
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or abs(gn_k - gn_p) > 1e-4 * gn_p \
            or worst > 1e-3:
        raise AssertionError("flagship step with kernels differs from the plain step")


def add_counts(total, ran):
    for k, v in ran.items():
        total.setdefault(k, {"kernel": 0, "plain": 0})
        total[k]["kernel"] += v["kernel"]
        total[k]["plain"] += v["plain"]


def flagship_model(torch, dtype, fused):
    from lstm_unet_tpu_torch.config import default_net_kernel_params
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, cast_params_for_inference

    cfg = ModelConfig.make(default_net_kernel_params(), dtype=dtype, fused_cell=fused)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ULSTMnet2D(cfg, generator=gen, device="cuda")
    return cast_params_for_inference(model, cfg.compute_dtype)


def phase_fused_vs_unfused(torch, dtype):
    """One flagship step with the fused cell on and off, same inputs, in
    ``dtype``; the fused step must run K4's tensor-core route for that dtype
    at all four levels (f32: 3xTF32; bf16: bf16) and no other route."""
    from lstm_unet_tpu_torch.ops import kernels

    model = flagship_model(torch, dtype, False)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        state = [[((torch.rand(h.shape, device="cuda", generator=gen) - 0.5).to(dt),
                   (torch.randn(c.shape, device="cuda", generator=gen) * 0.5).to(dt))
                  for (h, c) in lvl] for lvl in model.init_state(1, 512, 512)]
        frame = torch.rand(1, 512, 512, 1, device="cuda", generator=gen)
        s0, l0 = model.step(state, frame)
        model.cfg = dataclasses.replace(model.cfg, fused_cell=True)
        kernels.reset_counts()
        s1, l1 = model.step(state, frame)
        ran = kernels.counts()
    tc = "fused_convlstm_level_tf32x3" if dtype == "float32" else "fused_convlstm_level_wgmma"
    want = {k: 4 if k == tc else 0 for k in ("fused_convlstm_level_wgmma",
                                              "fused_convlstm_level_tf32x3",
                                              "fused_convlstm_level_narrow")}
    if any(ran[k]["kernel"] != n for k, n in want.items()):
        raise AssertionError(f"fused {dtype} step: K4 launches {ran}, expected {want}")
    ds = max(max_err(a, b) for la, lb in zip(s0, s1) for ta, tb in zip(la, lb)
             for a, b in zip(ta, tb))
    dl = max_err(l0, l1)
    scale = float(l0.float().abs().max())
    log(f"flagship {dtype} step fused vs unfused: state max diff {ds:.3g}, logits "
        f"max diff {dl:.3g} (largest |logit| {scale:.3g})")
    if dtype == "float32":
        # the h-convs' f32 sums in two orders (3xTF32 chunks against cuDNN's
        # f32 conv) at all four levels, carried through the network
        bad = ds > 1e-4 or dl > 1e-3
    else:
        # the unfused cell rounds its 4F gate pre-activations to bf16 (2^-9
        # relative) before K1, the fused one keeps them in f32: h' and c'
        # (|c| up to a few units) move by a few bf16 ulps, 2^-4 at most;
        # the decoder's bf16 convs carry that to the logits, 2^-3 of their
        # largest magnitude at most
        bad = ds > 2.0 ** -4 or dl > 2.0 ** -3 * max(scale, 1.0)
    if bad:
        raise AssertionError(f"fused and unfused {dtype} steps disagree")


def int8_conv_sites(nkp, hw):
    """The int8 conv sites of one unfused frame of a model of ``nkp`` at
    ``hw`` x ``hw``, in the model's order: ``[(site, H = W, cin, K, cout)]``
    with the reference's site names (a ConvLSTM cell's x- and h-convs as
    ``<cell>/x`` and ``<cell>/h``); fused, the h-convs run in K4 instead."""
    sites, cin, skips = [], 1, []
    for lvl in range(nkp.depth):
        for j, (k, f) in enumerate(nkp.lstm_kernels[lvl]):
            sites.append((f"encoder/{lvl}/lstm/{j}/x", hw, cin, k, 4 * f))
            sites.append((f"encoder/{lvl}/lstm/{j}/h", hw, f, k, 4 * f))
            cin = f
        for j, (k, f) in enumerate(nkp.down_conv_kernels[lvl]):
            sites.append((f"encoder/{lvl}/convs/{j}", hw, cin, k, f))
            cin = f
        skips.append((hw, cin))
        hw //= 2
    for lvl in reversed(range(nkp.depth)):
        hw, skip = skips[lvl]
        for j, (k, f) in enumerate(nkp.up_conv_kernels[lvl]):
            sites.append((f"decoder/{lvl}/convs/{j}", hw, cin + skip, k, f))
            cin, skip = f, 0
    sites.append(("head", hw, cin, 1, 3))
    return sites


def flagship_int8_convs():
    """The int8 convs of one unfused flagship frame at 512^2, by shape:
    ``{(H = W, cin, K, cout): sites}``."""
    from lstm_unet_tpu_torch.config import default_net_kernel_params

    shapes = {}
    for _, *key in int8_conv_sites(default_net_kernel_params(), 512):
        shapes[tuple(key)] = shapes.get(tuple(key), 0) + 1
    return shapes


H_CONV_SHAPES = {(512, 128, 5, 512), (256, 256, 5, 1024), (128, 256, 5, 1024),
                 (64, 512, 5, 2048)}  # the flagship's h-convs: (H = W, cin, K, cout)


def conv_bound(m, cin, k, cout, x_bytes):
    """(ms, by) of an int8 conv: 2*M*N*K operations at the int8 peak against
    x read once (``x_bytes`` a value), the int8 weights, bf16 y and the
    per-column scale and bias."""
    ops = 2.0 * m * cout * k * k * cin
    nbytes = m * cin * x_bytes + cout * k * k * cin + 2 * m * cout + 8 * cout
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_conv_int8(torch):
    """(c3): the int8 conv routes at every flagship shape. The wgmma route
    (float x, quantize folded in) bit-equal to its plain version from bf16 x
    (dynamic and static scale, bf16 and f32 out) at its 15 shapes, from f32 x
    at the h-conv shapes too; the small-K route likewise at the cin = 1
    x-conv (B = 1 and 4) and at the tiny model's small-K sites; the route the
    model takes bit-equal to the plain quantize + conv at all 16; the
    mma_sync kernel bit-equal to its plain version at all 16 (int8 x). Times
    per shape: the wgmma or small-K kernel (static scale), the op as the
    stream runs it (dynamic: abs-max + kernel), the mma_sync route (eager
    quantize_act + mma_sync, what the stream ran before), the mma_sync kernel
    alone, cuDNN's bf16 conv, the bound for the bytes each route reads and
    its share; at the shapes that take 128-column tiles, the 256-column tile
    beside them. Returns the three routes' summaries."""
    from lstm_unet_tpu_torch.config import tiny_net_kernel_params
    from lstm_unet_tpu_torch.ops import quant
    from lstm_unet_tpu_torch.ops.kernels import _build, conv_int8

    lib = _build.library()
    for k in conv_int8.WG_KERNEL_SIZES:
        for tn in conv_int8.WG_TILE_ROWS:
            for xb in (2, 4):
                for chunk in conv_int8.WG_TILE_CHUNKS[tn]:
                    if (lib.lut_conv2d_int8_wgmma_smem(k, tn, chunk, xb)
                            != conv_int8.wgmma_smem_bytes(k, tn, xb, chunk)):
                        raise AssertionError(f"int8 wgmma smem formula differs at {k}x{k} N "
                                             f"{tn} chunk {chunk} x {xb} bytes")
    for kh, kw, cin, cout in ((5, 5, 1, 512), (3, 3, 8, 32), (3, 3, 24, 8), (1, 1, 8, 3)):
        for ob in (2, 4):
            if (lib.lut_conv2d_int8_smallk_smem(kh, kw, cin, cout, ob)
                    != conv_int8.smallk_smem_bytes(kh, kw, cin, cout, ob)):
                raise AssertionError(f"int8 small-K smem formula differs at {kh}x{kw} "
                                     f"{cin}->{cout}, {ob}-byte out")
    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = flagship_int8_convs()
    if sum(shapes.values()) != 25:
        raise AssertionError(f"expected 25 int8 convs a flagship frame, got {shapes}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("wgmma_ms", "wgmma_dyn_ms", "pr6_ms", "pr6_kernel_ms", "plain_ms", "cudnn_ms",
            "bound_ms", "pr6_bound_ms")
    rows, frame, smallk_rows = [], {k: 0.0 for k in keys}, []
    wg_sum = {k: 0.0 for k in ("ms", "plain_ms", "ops_ms", "bytes_ms", "cudnn_ms")}
    mma = None
    for (hw, cin, k, cout), sites in shapes.items():
        rt = conv_int8.route(hw, hw, cin, k, cout)
        kq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        kq[:, 0, 0, 0] = 127  # each row's max |k| is 127: quantize_weight keeps kq as it is
        w_scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        bias = torch.randn(cout, device="cuda", generator=g)
        static = torch.tensor(3.0 / 127, device="cuda")
        x = (torch.randn(1, hw, hw, cin, device="cuda", generator=g) * 1.5).to(torch.bfloat16)
        m = hw * hw
        row = dict(shape=f"{hw}^2 {cin}->{cout} {k}x{k}", sites=sites, route=rt)

        # PR 6's kernel on int8 x, bit-equal (as before), and its route
        packed6 = conv_int8.pack_weight(kq)
        xq = torch.randint(-127, 128, (1, hw, hw, cin), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        args6 = (xq, static, packed6, w_scale, bias, k, k)
        for dt in (torch.bfloat16, torch.float32):
            got = conv_int8.conv2d_int8(*args6, dt)
            want = conv_int8.conv2d_int8_plain(*args6, dt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"conv2d_int8 {row['shape']} {dt}: "
                                     f"{int((got != want).sum())} outputs differ")

        def pr6_route():
            qx, s_x = quant.quantize_act(x)
            return conv_int8.conv2d_int8(qx, s_x, packed6, w_scale, bias, k, k, torch.bfloat16)

        row["pr6_kernel_ms"] = time_ms(lambda: conv_int8.conv2d_int8(*args6, torch.bfloat16), 20)
        row["pr6_ms"] = time_ms(pr6_route, 20)
        row["pr6_bound_ms"] = conv_bound(m, cin, k, cout, 1)[0]

        # the route the model takes, from bf16 x, against the plain quantize + conv
        weight = quant.QWeight(kq.float(), bias)
        weight.w_scale.copy_(w_scale)
        if not torch.equal(weight.kernel_q, kq) or weight.route != rt:
            raise AssertionError(f"int8 site {row['shape']}: the weights or route changed")
        got = quant.conv2d_q(x, weight, None, torch.bfloat16)
        qx, s_x = quant.quantize_act(x)
        want = conv_int8.conv2d_int8_plain(qx, s_x, packed6, w_scale, bias, k, k, torch.bfloat16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"conv2d_q {row['shape']} ({rt} route): "
                                 f"{int((got != want).sum())} outputs differ from the plain "
                                 f"quantize + conv")

        xb = x.permute(0, 3, 1, 2)  # cuDNN's bf16 conv, NHWC, with the bias
        wb = kq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        row["cudnn_ms"] = time_ms(lambda: torch.nn.functional.conv2d(xb, wb, bb, padding=k // 2),
                                  20)
        if rt == "wgmma":
            packed = weight.packed
            # bit-equal to the plain version: bf16 x dynamic and static, bf16
            # and f32 out; f32 x at the h-conv shapes
            cases = [(x, sc, dt) for sc in (None, static) for dt in (torch.bfloat16, torch.float32)]
            if (hw, cin, k, cout) in H_CONV_SHAPES:
                cases += [(x.float(), sc, torch.bfloat16) for sc in (None, static)]
            for xx, sc, dt in cases:
                a = (xx, sc, packed, w_scale, bias, k, dt)
                got = conv_int8.conv2d_int8_wgmma(*a)
                want = conv_int8.conv2d_int8_wgmma_plain(*a)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"conv2d_int8_wgmma {row['shape']} x {xx.dtype} "
                        f"{'dynamic' if sc is None else 'static'} -> {dt}: "
                        f"{int((got != want).sum())} outputs differ, max {max_err(got, want)}")
            # timed with a static scale as calibration makes one (an absmax
            # seen on other frames, / 127); 3 / 127 above has few significant
            # bits, so it sends more values to the division
            calib = torch.tensor(float(x.abs().max()) * 1.0137 / 127, device="cuda")
            kern = (x, calib, packed, w_scale, bias, k, torch.bfloat16)
            row["tile_n"] = conv_int8.kernel_tile_n(1, hw, hw, cout, sms)
            row["wgmma_ms"] = time_ms(lambda: conv_int8.conv2d_int8_wgmma(*kern), 20)
            row["wgmma_dyn_ms"] = time_ms(
                lambda: conv_int8.conv2d_int8_wgmma(x, None, *kern[2:]), 20)
            row["plain_ms"] = time_ms(lambda: conv_int8.conv2d_int8_wgmma_plain(*kern), 2)
            if row["tile_n"] != conv_int8.pack_tile_n(cout):
                row["wgmma_ms_tile256"] = time_ms(
                    lambda: conv_int8.conv2d_int8_wgmma(*kern, tile_n=256), 20)
            if (hw, cin, k, cout) in H_CONV_SHAPES:
                kern32 = (x.float(),) + kern[1:]
                row["wgmma_f32x_ms"] = time_ms(lambda: conv_int8.conv2d_int8_wgmma(*kern32), 20)
                row["f32x_bound_ms"] = conv_bound(m, cin, k, cout, 4)[0]
            row["bound_ms"], row["bound_by"] = conv_bound(m, cin, k, cout, 2)
            row["share"] = row["bound_ms"] / row["wgmma_ms"]
            ops = 2.0 * m * cout * k * k * cin
            for key, v in (("ms", row["wgmma_ms"]), ("plain_ms", row["plain_ms"]),
                           ("ops_ms", ops / INT8_OPS * 1e3),
                           ("bytes_ms", (m * cin * 2 + cout * k * k * cin + 2 * m * cout
                                         + 8 * cout) / HBM_BPS * 1e3),
                           ("cudnn_ms", row["cudnn_ms"])):
                wg_sum[key] += sites * v
            frame_ms, frame_dyn = row["wgmma_ms"], row["wgmma_dyn_ms"]
            extra = (f"; tile 256: {row['wgmma_ms_tile256']:.4f} ms"
                     if "wgmma_ms_tile256" in row else "")
            if "wgmma_f32x_ms" in row:
                extra += (f"; f32 x {row['wgmma_f32x_ms']:.4f} ms "
                          f"({100 * row['f32x_bound_ms'] / row['wgmma_f32x_ms']:.1f}% of "
                          f"{row['f32x_bound_ms']:.4f})")
            log(f"conv2d_int8_wgmma {row['shape']} (x{sites} a frame, tile N {row['tile_n']}): "
                f"bit-equal to the plain version ({len(cases)} cases); kernel "
                f"{row['wgmma_ms']:.4f} ms ({ops / row['wgmma_ms'] / 1e9:.1f} TOP/s, "
                f"{100 * row['share']:.1f}% of the {row['bound_ms']:.4f} ms bound, "
                f"{row['bound_by']}), with the abs-max {row['wgmma_dyn_ms']:.4f} ms; PR 6's "
                f"route {row['pr6_ms']:.4f} ms (kernel {row['pr6_kernel_ms']:.4f}); cuDNN bf16 "
                f"{row['cudnn_ms']:.4f} ms; plain {row['plain_ms']:.3f} ms{extra}")
        else:
            # the small-K route takes the cin = 1 x-conv; the mma_sync
            # kernel, which it replaces there, keeps its summary as the record
            row["pr6_plain_ms"] = time_ms(
                lambda: conv_int8.conv2d_int8_plain(*args6, torch.bfloat16), 2)
            pr6_bound = conv_bound(m, cin, k, cout, 1)
            mma = summary(row["pr6_kernel_ms"], row["pr6_plain_ms"], 0.0, pr6_bound)
            mma.update(shape=row["shape"], route_ms=row["pr6_ms"], cudnn_bf16_ms=row["cudnn_ms"])
            log(f"conv2d_int8 (mma_sync) {row['shape']}: bit-equal to the plain version; "
                f"kernel {row['pr6_kernel_ms']:.4f} ms "
                f"({100 * pr6_bound[0] / row['pr6_kernel_ms']:.1f}% of the {pr6_bound[0]:.4f} ms "
                f"bound for int8 x), with quantize_act {row['pr6_ms']:.4f} ms")
            smallk_rows = [smallk_site(torch, g, 1, hw, cin, k, cout, row)]
            frame_ms, frame_dyn = row["smallk_ms"], row["smallk_dyn_ms"]
            row["plain_ms"], row["bound_ms"] = row["smallk_plain_ms"], row["smallk_bound_ms"]
            smallk_rows.append(smallk_site(torch, g, 4, hw, cin, k, cout))
        rows.append(row)
        for key, v in (("wgmma_ms", frame_ms), ("wgmma_dyn_ms", frame_dyn),
                       ("pr6_ms", row["pr6_ms"]), ("pr6_kernel_ms", row["pr6_kernel_ms"]),
                       ("plain_ms", row["plain_ms"]), ("cudnn_ms", row["cudnn_ms"]),
                       ("bound_ms", row["bound_ms"]), ("pr6_bound_ms", row["pr6_bound_ms"])):
            frame[key] += sites * v
        del kq, packed6, xq, x, xb, wb, weight
        torch.cuda.empty_cache()
    log(f"int8 convs over one unfused flagship frame (25: 24 wgmma + 1 small-K), bf16 x: "
        f"kernels {frame['wgmma_ms']:.4f} ms, as the stream runs them (dynamic scales) "
        f"{frame['wgmma_dyn_ms']:.4f} ms; PR 6's route {frame['pr6_ms']:.4f} ms (its kernels "
        f"{frame['pr6_kernel_ms']:.4f} ms); cuDNN bf16 {frame['cudnn_ms']:.4f} ms; bound "
        f"{frame['bound_ms']:.4f} ms (PR 6's int8-x bound {frame['pr6_bound_ms']:.4f} ms); "
        f"plain {frame['plain_ms']:.3f} ms")
    wg_bound = max(wg_sum["ops_ms"], wg_sum["bytes_ms"])
    wgmma = dict(max_abs_err=0.0, ms=wg_sum["ms"], plain_ms=wg_sum["plain_ms"],
                 bound_ms=wg_bound,
                 bound_by="operations" if wg_sum["ops_ms"] > wg_sum["bytes_ms"] else "bytes",
                 library_ms=None, yardstick_cudnn_bf16_ms=wg_sum["cudnn_ms"], frame=frame,
                 shapes=rows, narrow=phase_conv_int8_narrow(torch),
                 gates=phase_conv_int8_gates(torch))
    # the tiny model's small-K sites (32^2 frames), B = 1
    tiny = {}
    for _, hw, cin, k, cout in int8_conv_sites(tiny_net_kernel_params(), 32):
        if conv_int8.route(hw, hw, cin, k, cout) == "smallk":
            tiny[(hw, cin, k, cout)] = tiny.get((hw, cin, k, cout), 0) + 1
    for (hw, cin, k, cout), n in tiny.items():
        smallk_rows.append(dict(smallk_site(torch, g, 1, hw, cin, k, cout), sites=n,
                                model="tiny"))
    head = smallk_rows[0]
    smallk = dict(max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
                  bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
                  shapes=smallk_rows)
    return {"conv2d_int8_wgmma": wgmma, "conv2d_int8": mma, "conv2d_int8_smallk": smallk}


def phase_conv_int8_gates(torch):
    """(c3) The unfused int8 cell's h-conv with the gate epilogue
    (``conv2d_int8_wgmma_gates``) at the flagship's four ConvLSTM levels at
    512^2 (5x5), B = 1 and 4, against what it replaces: the wgmma kernel on
    the natural pack (4F gates in the gate dtype), the eager add of gx and
    K1. Bit-equal in the four (gate, state) dtype pairs K1 takes, static and
    dynamic scale, into new tensors and into ``out`` at B = 1, and in bf16 /
    bf16 (the flagship int8 stream's) at B = 4; at B = 1 also against its
    plain version (``conv2d_int8_wgmma_gates_plain``: the exact sums, the
    add, K1's plain version) within K1's bound against its plain version;
    then both timed in bf16 / bf16 with a calibrated static scale, into
    state buffers as the captured step runs them, each part of the old route
    beside. Returns the rows."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8, lstm_gates

    g = torch.Generator(device="cuda").manual_seed(22)
    bf, f32 = torch.bfloat16, torch.float32
    tol = {f32: (1e-6, 1e-6), bf: (1e-6, 2.0 ** -7)}  # K1's against its plain version
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, frame = [], {}
    for b in (1, 4):
        for hw, feat in FLAGSHIP_LEVELS:
            n, k = 4 * feat, 5
            kq = torch.randint(-127, 128, (n, feat, k, k), device="cuda", generator=g,
                               dtype=torch.int32).to(torch.int8)
            w_scale = torch.rand(n, device="cuda", generator=g) * 1e-3
            order = conv_int8.gate_order(n, "cuda")
            natural = conv_int8.pack_weight_wgmma(kq)
            gpack, gscale = conv_int8.pack_weight_wgmma(kq[order]), w_scale[order]
            h32 = torch.rand(b, hw, hw, feat, device="cuda", generator=g) * 2 - 1
            c32 = torch.randn(b, hw, hw, feat, device="cuda", generator=g) * 1.5
            gx32 = torch.randn(b, hw, hw, n, device="cuda", generator=g) * 2
            static = torch.tensor(0.9 / 127, device="cuda")
            shape = f"B{b} {hw}^2 F={feat}"
            pairs = ((bf, bf), (bf, f32), (f32, f32), (f32, bf)) if b == 1 else ((bf, bf),)
            cases, plain_err = 0, 0.0
            for gdt, sdt in pairs:
                h, c, gx = h32.to(sdt), c32.to(sdt), gx32.to(gdt)
                for sc in ((None, static) if b == 1 else (static,)):
                    r = conv_int8.conv2d_int8_wgmma(h, sc, natural, w_scale, None, k, gdt)
                    want_c, want_h = lstm_gates.fused_lstm_gate_update(gx + r, c)
                    outs = [None, (torch.empty_like(h), torch.empty_like(c))]
                    for out in (outs if b == 1 else outs[:1]):
                        got_h, got_c = conv_int8.conv2d_int8_wgmma_gates(h, sc, gpack, gscale, gx,
                                                                         c, k, out=out)
                        torch.cuda.synchronize()
                        for what, got, want in (("h'", got_h, want_h), ("c'", got_c, want_c)):
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"gate epilogue {shape} {gdt}/{sdt} "
                                    f"{'dynamic' if sc is None else 'static'}: {what} differs "
                                    f"at {int((got != want).sum())} of {got.numel()}, max "
                                    f"{max_err(got, want)}")
                        cases += 1
                    if b == 1:
                        want = conv_int8.conv2d_int8_wgmma_gates_plain(h, sc, gpack, gscale, gx,
                                                                       c, k)
                        plain_err = max(plain_err, check_close(
                            f"gate epilogue {shape} {gdt}/{sdt} "
                            f"{'dynamic' if sc is None else 'static'} against plain",
                            (got_h, got_c), want, *tol[sdt]))
            h, c, gx = h32.to(bf), c32.to(bf), gx32.to(bf)
            calib = torch.tensor(float(h.abs().max()) * 1.0137 / 127, device="cuda")
            state = (torch.empty_like(h), torch.empty_like(c))
            r = conv_int8.conv2d_int8_wgmma(h, calib, natural, w_scale, None, k, bf)
            z = gx + r

            def unfused():
                y = conv_int8.conv2d_int8_wgmma(h, calib, natural, w_scale, None, k, bf)
                return lstm_gates.fused_lstm_gate_update(gx + y, c, out=state[::-1])

            row = dict(shape=shape, cases=cases, plain_max_abs_err=plain_err if b == 1 else None,
                       tile_n=conv_int8.kernel_tile_n(b, hw, hw, n, sms),
                       gates_ms=time_ms(lambda: conv_int8.conv2d_int8_wgmma_gates(
                           h, calib, gpack, gscale, gx, c, k, out=state), 20),
                       unfused_ms=time_ms(unfused, 20),
                       hconv_ms=time_ms(lambda: conv_int8.conv2d_int8_wgmma(
                           h, calib, natural, w_scale, None, k, bf), 20),
                       add_ms=time_ms(lambda: gx + r, 20),
                       k1_ms=time_ms(lambda: lstm_gates.fused_lstm_gate_update(
                           z, c, out=state[::-1]), 20))
            row["saved_ms"] = row["unfused_ms"] - row["gates_ms"]
            # bf16 bytes of the 4F gates no longer written, added and read again
            row["saved_gb"] = 16 * feat * b * hw * hw * 2 / 1e9
            rows.append(row)
            for key in ("gates_ms", "unfused_ms", "hconv_ms", "add_ms", "k1_ms"):
                frame[(b, key)] = frame.get((b, key), 0.0) + row[key]
            log(f"int8 gate epilogue {shape} (tile N {row['tile_n']}): bit-equal to h-conv + "
                f"add + K1 ({cases} cases)"
                + (f", plain within K1's bound (max_abs_err={plain_err:.3g})" if b == 1 else "")
                + f"; {row['gates_ms']:.4f} ms against "
                f"{row['unfused_ms']:.4f} ms (h-conv {row['hconv_ms']:.4f}, add "
                f"{row['add_ms']:.4f}, K1 {row['k1_ms']:.4f}): {row['saved_ms']:.4f} ms saved, "
                f"{row['saved_gb']:.3f} GB of 4F gates not moved")
            del kq, natural, gpack, h32, c32, gx32, h, c, gx, r, z, state
            torch.cuda.empty_cache()
    for b in (1, 4):
        log(f"int8 gate epilogue over the four levels, B{b}: {frame[(b, 'gates_ms')]:.4f} ms "
            f"against h-conv + add + K1 {frame[(b, 'unfused_ms')]:.4f} ms (h-conv "
            f"{frame[(b, 'hconv_ms')]:.4f}, add {frame[(b, 'add_ms')]:.4f}, K1 "
            f"{frame[(b, 'k1_ms')]:.4f})")
    return rows


def conv_int8_gates_alone():
    """Phase c3's gate epilogue on its own, the kernels built first."""
    import torch
    from lstm_unet_tpu_torch.ops.kernels import _build

    sys.path.insert(0, HERE)
    _build.library()
    log(card_name(torch))
    return phase_conv_int8_gates(torch)


# the published widths' (portbench/configs/flagship-int8.json) sites whose
# tile the wgmma route fits to them: (H = W, cin, K, cout, site)
NARROW_SITES = ((512, 192, 5, 32, "decoder/0/convs/0"), (512, 32, 5, 32, "decoder/0/convs/1"),
                (256, 384, 5, 64, "decoder/1/convs/0"), (256, 64, 5, 64, "decoder/1/convs/1"),
                (512, 32, 1, 3, "head"))


def phase_conv_int8_narrow(torch):
    """(c3, narrow): the wgmma route at the published widths' four narrow
    decoder sites and their cin = 32 head, B = 1, each bit-equal to its
    plain version (bf16 and f32 x, dynamic and static scale, bf16 and f32
    out, with and without bias), then timed with a calibrated static scale
    beside the same site forced to the 128-column tile and 128-channel
    chunks it took before (the "before"), with the bound and its share.
    Returns the rows."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    g = torch.Generator(device="cuda").manual_seed(19)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for hw, cin, k, cout, site in NARROW_SITES:
        kq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        packed = conv_int8.pack_weight_wgmma(kq)
        w_scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        bias = torch.randn(cout, device="cuda", generator=g)
        x = (torch.randn(1, hw, hw, cin, device="cuda", generator=g) * 1.5).to(torch.bfloat16)
        shape = f"{hw}^2 {cin}->{cout} {k}x{k}"
        tile = conv_int8.kernel_tile_n(1, hw, hw, cout, sms)
        chunk = conv_int8.kernel_chunk(cin, k, tile)
        cases = 0
        for xx in (x, x.float()):
            for sc in (None, torch.tensor(2.5 / 127, device="cuda")):
                for dt in (torch.bfloat16, torch.float32):
                    for bb in (bias, None):
                        a = (xx, sc, packed, w_scale, bb, k, dt)
                        got = conv_int8.conv2d_int8_wgmma(*a)
                        want = conv_int8.conv2d_int8_wgmma_plain(*a)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"conv2d_int8_wgmma {site} {shape} x {xx.dtype} "
                                f"{'dynamic' if sc is None else 'static'} -> {dt}: "
                                f"{int((got != want).sum())} outputs differ")
                        cases += 1
        calib = torch.tensor(float(x.abs().max()) * 1.0137 / 127, device="cuda")
        kern = (x, calib, packed, w_scale, bias, k, torch.bfloat16)
        old_tile = 128 if tile in conv_int8.WG_NARROW else tile
        before_pack = conv_int8.pack_weight_wgmma(kq, tile_n=old_tile)
        before = (x, calib, before_pack, w_scale, bias, k, torch.bfloat16)
        want = conv_int8.conv2d_int8_wgmma(*kern)
        if not torch.equal(conv_int8.conv2d_int8_wgmma(*before, tile_n=old_tile, chunk=128),
                           want):
            raise AssertionError(f"conv2d_int8_wgmma {site}: the {old_tile}-column tile differs")
        ms = time_ms(lambda: conv_int8.conv2d_int8_wgmma(*kern), 50)
        before_ms = time_ms(lambda: conv_int8.conv2d_int8_wgmma(
            *before, tile_n=old_tile, chunk=128), 50)
        bd = conv_bound(hw * hw, cin, k, cout, 2)
        row = dict(site=site, shape=shape, tile_n=tile, rows=2 * conv_int8.WG_TILE_ROWS[tile],
                   chunk=chunk, cases=cases, ms=ms, before_ms=before_ms, bound_ms=bd[0],
                   bound_by=bd[1], share=bd[0] / ms, before_share=bd[0] / before_ms)
        out.append(row)
        log(f"conv2d_int8_wgmma {site} {shape} (tile N {tile}, {row['rows']} rows, chunks of "
            f"{chunk}): bit-equal to the plain version ({cases} cases); kernel {ms:.4f} ms "
            f"({100 * row['share']:.1f}% of the {bd[0]:.4f} ms bound, {bd[1]}); the "
            f"{old_tile}-column tile and 128-channel chunks {before_ms:.4f} ms "
            f"({100 * row['before_share']:.1f}%)")
        del kq, packed, before_pack, x, got, want
        torch.cuda.empty_cache()
    log(f"the four narrow decoder sites: {sum(r['ms'] for r in out[:4]):.4f} ms, before "
        f"{sum(r['before_ms'] for r in out[:4]):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in out[:4]):.4f} ms")
    return out


def published_config():
    """The benchmark's published configuration
    (``portbench/configs/flagship-int8.json``: LSTM-UNet's
    ``net_kernel_params``) as a dict."""
    with open(os.path.join(HERE, "portbench", "configs", "flagship-int8.json")) as f:
        return json.load(f)


def published_net_kernel_params():
    """The published widths as the port's ``NetKernelParams``: the file
    lists the decoder's stacks deepest level first, the last ending in the
    1x1 output conv to the classes; the port indexes them shallowest first
    and adds that conv itself (the head)."""
    from lstm_unet_tpu_torch.config import NetKernelParams

    cfg = published_config()
    up = [list(lvl) for lvl in cfg["up_conv_kernels"][::-1]]
    up[0] = up[0][:-1]  # the head
    return NetKernelParams.from_dict(dict(cfg, up_conv_kernels=up))


def published_wide_shapes():
    """The published net's int8 sites at 512^2 that the wgmma route runs on
    its wide tiles (N tiles of 256 and 128: cout > 64; full chunks: cin % 128
    == 0), by shape: ``{(H = W, cin, K, cout): [site]}`` in the model's
    order."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    shapes = {}
    for site, hw, cin, k, cout in int8_conv_sites(published_net_kernel_params(), 512):
        if (conv_int8.route(hw, hw, cin, k, cout) == "wgmma"
                and conv_int8.pack_tile_n(cout) >= 128 and cin % 128 == 0):
            shapes.setdefault((hw, cin, k, cout), []).append(site)
    return shapes


# the int8 wgmma kernel's cycle counters (its kTime build,
# csrc/conv_int8_wgmma.cuh): name, index, the threads that add to it in each
# block
CYCLES = (("consumer_wait_weights", 0, 8), ("consumer_wait_x", 1, 8), ("consumer_epilogue", 2, 8),
          ("consumer_wait_mma", 3, 8), ("consumer_run", 4, 8), ("loader_stage", 5, 1),
          ("loader_wait_buffer", 6, 1), ("loader_run", 7, 1), ("weights_wait_slot", 8, 1),
          ("weights_run", 9, 1))


def probe_cycles(torch, args, tile_n):
    """Where one launch's cycles go: the wgmma kernel built with its cycle
    counters (``csrc/probes/conv_int8_wgmma_probe.cu``, a library of its
    own, built at the first call) at a wide site (``args``: bf16 x, static
    scale, pack, w_scale, bias, K; bf16 out), one block per SM: each counter
    of ``CYCLES`` per thread that counts it, as a share of that role's run."""
    from lstm_unet_tpu_torch.ops.kernels import _build

    x, scale, packed, w_scale, bias, k = args
    b, h, w, cin = x.shape
    n = w_scale.shape[0]
    y = torch.empty(b, h, w, n, dtype=torch.bfloat16, device=x.device)
    prof = torch.zeros(10, dtype=torch.int64, device=x.device)
    _build.check(_build.probe_library("conv_int8_wgmma_probe").lut_conv2d_int8_wgmma_probe(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), b, h, w, cin, k, n, packed.shape[5], tile_n, prof.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "lut_conv2d_int8_wgmma_probe")
    got = prof.tolist()
    runs = {"consumer": got[4] / 8, "loader": got[7], "weights": got[9]}
    return {name: round(got[i] / per / runs[name.split("_")[0]], 4)
            for name, i, per in CYCLES if not name.endswith("_run")}


def phase_conv_int8_wide(torch, cycles=False):
    """(c3, wide): the wgmma route's wide sites of the published net
    (``published_wide_shapes``) at 512^2, B = 1 and 4: bit-equal to the
    plain version at B = 1 (bf16 x dynamic -> bf16, f32 x static -> f32),
    then timed with a calibrated static scale, beside the bound and its
    share; with ``cycles``, also where the kernel's cycles go
    (``probe_cycles``). Then one eager 512^2 step of the published int8 net
    counted: 24 wgmma launches, 4 of them narrow, 1 small-K. Returns the
    rows, one a shape and lane count."""
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, quantize_model_int8
    from lstm_unet_tpu_torch.ops.kernels import conv_int8, counts, reset_counts

    g = torch.Generator(device="cuda").manual_seed(21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (hw, cin, k, cout), sites in published_wide_shapes().items():
        kq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        packed = conv_int8.pack_weight_wgmma(kq)
        w_scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        bias = torch.randn(cout, device="cuda", generator=g)
        for b in (1, 4):
            tile = conv_int8.kernel_tile_n(b, hw, hw, cout, sms)
            x = (torch.randn(b, hw, hw, cin, device="cuda", generator=g) * 1.5
                 ).to(torch.bfloat16)
            calib = torch.tensor(float(x.abs().max()) * 1.0137 / 127, device="cuda")
            kern = (x, calib, packed, w_scale, bias, k, torch.bfloat16)
            cases = [(x, None, torch.bfloat16), (x.float(), calib, torch.float32)]
            for xx, sc, dt in cases if b == 1 else []:
                a = (xx, sc, packed, w_scale, bias, k, dt)
                got = conv_int8.conv2d_int8_wgmma(*a)
                want = conv_int8.conv2d_int8_wgmma_plain(*a)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"conv2d_int8_wgmma {sites[0]} B={b} x {xx.dtype} -> "
                                         f"{dt}: {int((got != want).sum())} outputs differ")
                del got, want
            row = dict(sites=sites, b=b, shape=f"{hw}^2 {cin}->{cout} {k}x{k}", tile_n=tile)
            row["ms"] = time_ms(lambda: conv_int8.conv2d_int8_wgmma(*kern), 20)
            row["bound_ms"], row["bound_by"] = conv_bound(b * hw * hw, cin, k, cout, 2)
            row["share"] = row["bound_ms"] / row["ms"]
            if cycles:
                row["cycles"] = probe_cycles(torch, kern[:6], tile)
            rows.append(row)
            log(f"conv2d_int8_wgmma {','.join(sites)} B={b} {row['shape']} (tile N {tile}): "
                f"bit-equal to the plain version; {row['ms']:.4f} ms "
                f"({100 * row['share']:.1f}% of {row['bound_ms']:.4f})" +
                (f"; cycles {row['cycles']}" if cycles else ""))
            del x, kern
        del kq, packed
        torch.cuda.empty_cache()
    for b in (1, 4):
        mine = [r for r in rows if r["b"] == b]
        n = sum(len(r["sites"]) for r in mine)
        log(f"the {n} wide sites at B={b}: {sum(r['ms'] * len(r['sites']) for r in mine):.4f} "
            f"ms, bound {sum(r['bound_ms'] * len(r['sites']) for r in mine):.4f} ms")
    # the published net's launches a frame (seeded weights, dynamic scales)
    cfg = published_config()
    mc = ModelConfig.make(published_net_kernel_params(), in_channels=cfg["in_channels"],
                          num_classes=cfg["num_classes"], activation=cfg["activation"],
                          recurrent_activation=cfg["recurrent_activation"],
                          upsample=cfg["upsample"], norm=cfg["norm"], dtype=cfg["dtype"],
                          quant=cfg["quant"], fused_cell=cfg["fused_cell"],
                          state_dtype=cfg["state_dtype"])
    model = ULSTMnet2D(mc, generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    quantize_model_int8(model, float_dtype=mc.compute_dtype)
    want = {"conv2d_int8_wgmma": 24, "conv2d_int8_wgmma_narrow": 4, "conv2d_int8_smallk": 1,
            "conv2d_int8": 0}
    with torch.inference_mode():
        state = model.init_state(1, 512, 512)
        reset_counts()
        model.step(state, torch.rand(1, 512, 512, 1, device="cuda"))
        torch.cuda.synchronize()
    got = {name: counts()[name]["kernel"] for name in want}
    if got != want:
        raise AssertionError(f"the published int8 net's launches a frame: {got}, expected "
                             f"{want}")
    log(f"the published int8 net, one 512^2 frame: launches {got}")
    return dict(sites=rows, launches=got)


def conv_int8_wide_alone():
    """Phase c3's wide sites on their own, with the kernel's cycle counters,
    the kernels built first."""
    import torch
    from lstm_unet_tpu_torch.ops.kernels import _build

    sys.path.insert(0, HERE)
    _build.library()
    log(card_name(torch))
    return phase_conv_int8_wide(torch, cycles=True)

def smallk_site(torch, g, b, hw, cin, k, cout, into=None):
    """(c3) The small-K kernel at one site of B lanes of hw^2: bit-equal to
    its plain version (bf16 and f32 x, dynamic and static scale, bf16 and
    f32 out; at B > 1 lanes of unequal ranges share the dynamic scale), then
    the times of the kernel (a calibrated static scale, bf16 in and out), the
    op as the stream runs it (dynamic: abs-max + kernel), the mma_sync route
    (eager quantize_act + mma_sync), the mma_sync kernel alone, cuDNN's bf16
    conv and the plain version, with the bound (bf16 x read, the weights,
    bf16 y written).
    Returns its row (also written into ``into`` under ``smallk_*`` keys)."""
    from lstm_unet_tpu_torch.ops import quant
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    kq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=g,
                       dtype=torch.int32).to(torch.int8)
    kq[:, 0, 0, 0] = 127
    w_scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
    bias = torch.randn(cout, device="cuda", generator=g)
    ranges = torch.tensor([1.5, 0.5, 3.0, 1.0], device="cuda")[:b, None, None, None]
    x = (torch.randn(b, hw, hw, cin, device="cuda", generator=g) * ranges).to(torch.bfloat16)
    weight = quant.QWeight(kq.float(), bias)
    weight.w_scale.copy_(w_scale)
    if weight.route != "smallk" or not torch.equal(weight.kernel_q, kq):
        raise AssertionError(f"int8 site {cin}->{cout} {k}x{k}: not the small-K pack")
    packed = weight.packed
    shape = f"B{b} {hw}^2 {cin}->{cout} {k}x{k}"
    static = torch.tensor(2.5 / 127, device="cuda")
    cases = 0
    for xx in (x, x.float()):
        for sc in (None, static):
            for dt in (torch.bfloat16, torch.float32):
                a = (xx, sc, packed, w_scale, bias, k, k, dt)
                got = conv_int8.conv2d_int8_smallk(*a)
                want = conv_int8.conv2d_int8_smallk_plain(*a)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"conv2d_int8_smallk {shape} x {xx.dtype} "
                                         f"{'dynamic' if sc is None else 'static'} -> {dt}: "
                                         f"{int((got != want).sum())} outputs differ")
                cases += 1
    # through the model's op: conv2d_q takes the small-K route, bit-equal to
    # the plain quantize + conv
    got = quant.conv2d_q(x, weight, None, torch.bfloat16)
    if not torch.equal(got, conv_int8.conv2d_int8_smallk_plain(x, None, packed, w_scale, bias,
                                                               k, k, torch.bfloat16)):
        raise AssertionError(f"conv2d_q {shape}: differs from the plain quantize + conv")
    calib = torch.tensor(float(x.abs().max()) * 1.0137 / 127, device="cuda")
    kern = (x, calib, packed, w_scale, bias, k, k, torch.bfloat16)
    packed6 = conv_int8.pack_weight(kq)
    xq, s_x = conv_int8.quantize_act(x, calib)
    iters = 20 if hw >= 512 else 50

    def pr6_route():
        q, s = conv_int8.quantize_act(x, calib)
        return conv_int8.conv2d_int8(q, s, packed6, w_scale, bias, k, k, torch.bfloat16)

    if not torch.equal(pr6_route(), conv_int8.conv2d_int8_smallk(*kern)):
        raise AssertionError(f"conv2d_int8_smallk {shape}: differs from the mma_sync route")
    m = b * hw * hw
    bd = conv_bound(m, cin, k, cout, 2)
    row = dict(shape=shape, cases=cases, max_abs_err=0.0,
               ms=time_ms(lambda: conv_int8.conv2d_int8_smallk(*kern), iters),
               dynamic_ms=time_ms(lambda: conv_int8.conv2d_int8_smallk(x, None, *kern[2:]),
                                  iters),
               pr6_route_ms=time_ms(pr6_route, iters),
               pr6_kernel_ms=time_ms(lambda: conv_int8.conv2d_int8(
                   xq, s_x, packed6, w_scale, bias, k, k, torch.bfloat16), iters),
               plain_ms=time_ms(lambda: conv_int8.conv2d_int8_smallk_plain(*kern), 2),
               bound_ms=bd[0], bound_by=bd[1], library_ms=None)
    xb = x.permute(0, 3, 1, 2)
    wb = kq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    row["cudnn_bf16_ms"] = time_ms(lambda: torch.nn.functional.conv2d(
        xb, wb, bias.to(torch.bfloat16), padding=k // 2), iters)
    row["share"] = bd[0] / row["ms"]
    log(f"conv2d_int8_smallk {shape}: bit-equal to the plain version ({cases} cases), to "
        f"conv2d_q and to the mma_sync route; kernel {row['ms']:.4f} ms "
        f"({100 * row['share']:.1f}% of the {bd[0]:.4f} ms bound, {bd[1]}), with the abs-max "
        f"{row['dynamic_ms']:.4f} ms; "
        f"the mma_sync route (quantize_act + mma_sync) {row['pr6_route_ms']:.4f} ms, its kernel "
        f"{row['pr6_kernel_ms']:.4f} ms; cuDNN bf16 {row['cudnn_bf16_ms']:.4f} ms; plain "
        f"{row['plain_ms']:.3f} ms")
    if into is not None:
        into.update(smallk_ms=row["ms"], smallk_dyn_ms=row["dynamic_ms"],
                    smallk_plain_ms=row["plain_ms"], smallk_bound_ms=bd[0], bound_by=bd[1],
                    share=row["share"])
    return row


def replayed(name, before, steps):
    """Check that a stream of ``steps`` frames on the card, since graph
    counts ``before``, captured its step once (two graphs) at its first
    frame and replayed it at every other; returns the replays."""
    from lstm_unet_tpu_torch.ops import kernels

    got = {k: v - before[k] for k, v in kernels.graph_counts().items()}
    if got != {"captures": 2, "replays": steps - 1}:
        raise AssertionError(f"{name}: graph counts {got} over {steps} frames, expected 2 "
                             f"captures and {steps - 1} replays")
    return got["replays"]


def phase_golden(torch, work):
    """(d): the golden sequence in f32, fused cell off, then on (the tiny
    model's levels, F = 8 and 16, take K4's narrow route, 3xTF32: 2 per
    frame)."""
    from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.io.tiff import read_tiff
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "golden")
    write_ctc_dataset(root, **GOLDEN_DATA)
    want_paths = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    for fused in (False, True):
        out = os.path.join(work, f"golden_res_{int(fused)}")
        before, graphs = kernels.counts(), kernels.graph_counts()
        n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                      "--sequence_path", os.path.join(root, "Synth-N2DH-SIM", "01"),
                      "--output_path", out, "--device", "cuda",
                      "--pre_sequence_frames", "2", "--min_cell_size", "5",
                      "--dtype", "float32", *(["--fused_cell"] if fused else [])])
        after = kernels.counts()
        narrow = (after["fused_convlstm_level_narrow"]["kernel"]
                  - before["fused_convlstm_level_narrow"]["kernel"])
        if n != len(want_paths) or n == 0:
            raise AssertionError(f"golden: wrote {n} masks, expected {len(want_paths)}")
        if narrow != (2 * (n + 2) if fused else 0):
            raise AssertionError(f"golden fused_cell={fused}: {narrow} narrow K4 launches")
        replays = replayed(f"golden fused_cell={fused}", graphs, n + 2)
        # f32 is held to the golden masks exactly
        diffs = compare_dirs(f"golden fused_cell={fused}", out, os.path.join(GOLDEN, "masks"), 0)
        log(f"golden masks on the card, f32 fused_cell={fused}: differing px per frame "
            f"{diffs} (bar: 0 px); K4 narrow launches {narrow}; the step "
            f"captured once, replayed {replays} times")

    # frames too large for K3's cluster route: the same model on a 1024^2
    # sequence, on the card (grid route, once a frame) and on the CPU
    seq_dir, _ = write_ctc_dataset(os.path.join(work, "large"), num_frames=3, height=1024,
                                   width=1024, num_cells=40, seed=1)
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = os.path.join(work, f"large_res_{device}")
        before, graphs = kernels.counts(), kernels.graph_counts()
        n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                      "--sequence_path", seq_dir, "--output_path", outs[device],
                      "--device", device, "--pre_sequence_frames", "1",
                      "--min_cell_size", "5", "--dtype", "float32"])
        after = kernels.counts()
        if device == "cuda":
            ran = {k: after[k]["kernel"] - before[k]["kernel"] for k in ("ccl", "ccl_grid")}
            if n != 3 or ran != {"ccl": 0, "ccl_grid": n + 1}:
                raise AssertionError(f"1024^2 sequence: {n} masks, K3 launches {ran}")
            replayed("1024^2 sequence", graphs, n + 1)
        else:  # the plain versions the CPU run calls are no part of the path's count
            for k in after:
                kernels.KERNELS[k].plain = before[k]["plain"]
    # 1024 times the golden frames' pixels: the same bar of equal counts,
    # and 64 px for pixels whose f32 probability sits at a threshold
    diffs = compare_dirs("1024^2 sequence", outs["cuda"], outs["cpu"], 64)
    last = read_tiff(sorted(glob.glob(os.path.join(outs["cuda"], "mask*.tif")))[-1])
    log(f"1024^2 sequence, tiny model f32: K3 grid route {n + 1} launches; differing px per "
        f"frame against the CPU run {diffs} (bar: equal instance count, <= 64 px), "
        f"instances in the last frame {len(np.unique(last)) - 1}")


def phase_flagship(torch, work, card):
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "flagship")
    seq_dir, _ = write_ctc_dataset(root, num_frames=8, height=512, width=512,
                                   num_cells=40, seed=0)
    for dtype, fused, split in (("float32", False, False), ("float32", True, False),
                                ("bfloat16", False, False), ("bfloat16", True, False),
                                ("bfloat16", False, True)):
        out = os.path.join(work, f"flagship_{dtype}_{int(fused)}_{int(split)}")
        ip = InferenceParams(sequence_path=seq_dir, output_path=out,
                             pre_sequence_frames=2, dtype=dtype, fused_cell=fused,
                             instance_split=split, split_method="prob")
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
            raise AssertionError(f"flagship {dtype} fused={fused} split={split}: {n} masks "
                                 f"reported, {written} written")
        if any(v["plain"] for v in d.values()):
            raise AssertionError(f"plain versions ran on the card: {d}")
        # per frame (n + 2 with the warm-up): with the fused cell K4's
        # tensor-core route of the dtype at all four levels (f32: 3xTF32),
        # else K1 at each level; K3's cluster route once, twice with the split
        steps = n + 2
        tc = ("fused_convlstm_level_tf32x3" if dtype == "float32"
              else "fused_convlstm_level_wgmma")
        k4 = {k: 4 * steps if fused and k == tc else 0
              for k in ("fused_convlstm_level_wgmma", "fused_convlstm_level_tf32x3",
                        "fused_convlstm_level_narrow")}
        k1 = 4 * steps - sum(k4.values())
        k3 = (2 if split else 1) * steps
        if (d["ccl"]["kernel"] != k3 or d["ccl_grid"]["kernel"] != 0
                or d["lstm_gate_update"]["kernel"] != k1
                or any(d[k]["kernel"] != v for k, v in k4.items())):
            raise AssertionError(f"unexpected kernel launches: {d}, expected K1 {k1}, "
                                 f"K3 {k3}, K4 {k4}")
        log(f"flagship 512^2 {dtype} fused_cell={fused} instance_split={split}: {n + 2} "
            f"frames (2 warm-up) in {secs:.3f} s = {(n + 2) / secs:.3f} frames/s "
            f"incl. first-frame set-up [{card}]; launches "
            f"{ {k: v['kernel'] for k, v in d.items()} }")
        del model


def phase_golden_int8(torch, work):
    """(d2): the golden sequence through the CLI in int8 on the card, fused
    cell off and on, dynamic scales, then calibrated on 4 frames (in a copy
    of the model dir), each against the same run on the CPU."""
    import shutil

    from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
    from lstm_unet_tpu_torch.ops import kernels

    seq = os.path.join(work, "golden", "Synth-N2DH-SIM", "01")
    for tag, extra in (("dynamic", []), ("dynamic fused", ["--fused_cell"]),
                       ("calibrated", ["--calibrate", "4"])):
        outs = {}
        for device in ("cuda", "cpu"):
            model_dir = os.path.join(work, f"int8_model_{len(extra)}_{device}")
            shutil.copytree(os.path.join(GOLDEN, "torch_ckpt"), model_dir)
            outs[device] = os.path.join(work, f"golden_int8_{tag.replace(' ', '_')}_{device}")
            before, graphs = kernels.counts(), kernels.graph_counts()
            n = cli_main(["--model_path", model_dir, "--sequence_path", seq, "--output_path",
                          outs[device], "--device", device, "--pre_sequence_frames", "2",
                          "--min_cell_size", "5", "--dtype", "int8", *extra])
            after = kernels.counts()
            if device == "cuda":
                # a frame of the tiny model: cin 1, 8 and 24 on the small-K
                # route, cin 16 and 32 on wgmma, none on mma_sync (fused: the
                # h-convs run in K4's narrow route, bf16, 2 a frame)
                ran = {k: after[k]["kernel"] - before[k]["kernel"] for k in after}
                fused = extra == ["--fused_cell"]
                per = (5, 2) if fused else (6, 3)
                want = {"conv2d_int8_smallk": (n + 2) * per[0],
                        "conv2d_int8_wgmma": (n + 2) * per[1], "conv2d_int8": 0,
                        "fused_convlstm_level_narrow": (n + 2) * (2 if fused else 0)}
                got = {k: ran[k] for k in want}
                if n != 8 or got != want:
                    raise AssertionError(f"golden int8 {tag}: {n} masks, int8 conv launches "
                                         f"{got}, expected {want}")
                replayed(f"golden int8 {tag}", graphs, n + 2)
            else:  # the CPU run's plain calls are no part of the path's count
                for k in after:
                    kernels.KERNELS[k].plain = before[k]["plain"]
        diffs = compare_dirs(f"golden int8 {tag}", outs["cuda"], outs["cpu"], 3)
        log(f"golden int8 {tag}: differing px per frame against the CPU run {diffs} (bar: "
            f"equal instance count, <= 3 px)")


def flagship_int8_model(torch, fused):
    """The flagship with f32 weights from seed 0 and ``quant='int8'``: the
    engine quantizes it when it is built."""
    from lstm_unet_tpu_torch.config import default_net_kernel_params
    from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D

    cfg = ModelConfig.make(default_net_kernel_params(), dtype="bfloat16", quant="int8",
                           fused_cell=fused)
    return ULSTMnet2D(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")


def phase_flagship_int8(torch, work, card):
    """(e2): the flagship at 512^2 in int8 through ``run_inference``, fused
    cell off and on, with exact launch counts; then one int8 frame against
    the bf16 frame of the same weights."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference
    from lstm_unet_tpu_torch.models import cast_params_for_inference
    from lstm_unet_tpu_torch.ops import kernels
    from lstm_unet_tpu_torch.models import quantize_model_int8

    seq_dir = os.path.join(work, "flagship", "Synth-N2DH-SIM", "01")
    for fused in (False, True):
        out = os.path.join(work, f"flagship_int8_{int(fused)}")
        ip = InferenceParams(sequence_path=seq_dir, output_path=out, pre_sequence_frames=2,
                             dtype="int8", fused_cell=fused)
        model = flagship_int8_model(torch, fused)
        before = kernels.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run_inference(ip, device="cuda", model=model)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = kernels.counts()
        d = {k: {s: after[k][s] - before[k][s] for s in ("kernel", "plain")} for k in after}
        steps = n + 2
        want = {"conv2d_int8_smallk": steps, "conv2d_int8": 0,
                "conv2d_int8_wgmma": (20 if fused else 24) * steps,
                "conv2d_int8_wgmma_gates": (0 if fused else 4) * steps,
                "fused_convlstm_level_wgmma": (4 if fused else 0) * steps,
                "lstm_gate_update": 0, "ccl": steps, "fused_convlstm_level_tf32x3": 0,
                "fused_convlstm_level_narrow": 0, "ccl_grid": 0}
        got = {k: d[k]["kernel"] for k in want}
        if n != 8 or got != want or any(v["plain"] for v in d.values()):
            raise AssertionError(f"flagship int8 fused={fused}: {n} masks, launches {d}, "
                                 f"expected {want} and no plain call")
        log(f"flagship 512^2 int8 fused_cell={fused}: {steps} frames (2 warm-up) in "
            f"{secs:.3f} s = {steps / secs:.3f} frames/s incl. quantizing the weights and "
            f"first-frame set-up [{card}]; launches per frame "
            f"{ {k: v // steps for k, v in got.items() if v} }")
        del model
    # one frame, int8 against bf16, from the same weights and state
    gen = torch.Generator(device="cuda").manual_seed(2)
    frame = torch.rand(1, 512, 512, 1, device="cuda", generator=gen)
    bf16 = flagship_int8_model(torch, False)
    q8 = flagship_int8_model(torch, False)
    bf16.cfg = dataclasses.replace(bf16.cfg, quant="none")
    cast_params_for_inference(bf16, torch.bfloat16)
    quantize_model_int8(q8, float_dtype=torch.bfloat16)
    with torch.inference_mode():
        _, want = bf16.step(bf16.init_state(1, 512, 512), frame)
        _, got = q8.step(q8.init_state(1, 512, 512), frame)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"flagship 512^2 one frame, int8 against bf16: max |logit diff| / max |logit| = "
        f"{rel:.4g} (bar 0.15, the reference's int8-vs-float bar)")
    if not np.isfinite(rel) or rel >= 0.15:
        raise AssertionError(f"flagship int8 logits differ from bf16 by {rel}")


def phase_batched_kernels(torch):
    """(j, kernels): the kernels at the lane counts of TTA and batched streams,
    against their plain versions. K4's two tensor-core routes at B = 8 (TTA
    'd4') at the four flagship levels: bf16 with bf16 and f32 state, 3xTF32
    with f32 state, to K4's tolerances, and the bf16 route at B = 4 too (TTA
    'flip', the bench's 4 lanes); the int8 conv at B = 4 (TTA 'flip', a
    batched sweep) at every flagship int8 shape: the wgmma route bit-equal
    from bf16 x with a static scale and with the dynamic scale (one abs-max
    over all four lanes) and with the N tile ``kernel_tile_n`` picks for
    B = 4, the mma_sync kernel bit-equal on int8 x at the cin = 1 site
    (the small-K route's B = 4 is in c3). Returns, per kernel, the
    batched rows for the summary line."""
    from lstm_unet_tpu_torch.ops.kernels import conv_int8, convlstm_cell

    g = torch.Generator(device="cuda").manual_seed(21)
    out = {"fused_convlstm_level_wgmma": [], "fused_convlstm_level_tf32x3": [],
           "conv2d_int8_wgmma": [], "conv2d_int8": []}
    for name, b, dt, sdts in (
            ("fused_convlstm_level_wgmma", 4, torch.bfloat16, (torch.float32, torch.bfloat16)),
            ("fused_convlstm_level_wgmma", 8, torch.bfloat16, (torch.float32, torch.bfloat16)),
            ("fused_convlstm_level_tf32x3", 8, torch.float32, (torch.float32,))):
        for hw, feat in FLAGSHIP_LEVELS:
            rt = convlstm_cell.route(hw, hw, feat, 5, b, dt)
            if rt != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
                raise AssertionError(f"K4 route at B={b} {hw}^2 F={feat} {dt}: {rt}")
            errs = []
            for sdt in sdts:
                ins = k4_inputs(torch, g, b, hw, feat, 5, dt, sdt)
                got = convlstm_cell.fused_convlstm_level(*ins)
                want = convlstm_cell.fused_convlstm_level_plain(*ins)
                errs.append(check_close(f"K4 {rt} B={b} {hw}^2 F={feat} state {sdt}", got,
                                        want, *k4_tolerance(torch, 5, feat, sdt)))
            gx, h, c, wh = ins  # state in the compute dtype: the model's
            ms = time_ms(lambda: convlstm_cell.fused_convlstm_level(gx, h, c, wh), 5)
            plain = time_ms(lambda: convlstm_cell.fused_convlstm_level_plain(gx, h, c, wh), 1)
            flops = 2 * b * hw * hw * 25 * feat * 4 * feat
            el = 2 if dt == torch.bfloat16 else 4
            wbytes = el * 25 * feat * 4 * feat * (1 if dt == torch.bfloat16 else 2)
            bd = (bound(el * b * hw * hw * 8 * feat + wbytes, flops) if dt == torch.bfloat16
                  else bound(el * b * hw * hw * 8 * feat + wbytes, 3 * flops, TF32_FLOPS))
            row = dict(shape=f"B{b} {hw}^2 F={feat} 5x5", max_abs_err=max(errs), ms=ms,
                       plain_ms=plain, bound_ms=bd[0], bound_by=bd[1])
            out[name].append(row)
            log(f"K4 {rt} B={b} {hw}^2 F={feat} 5x5 {str(dt)[6:]}: max_abs_err "
                f"{row['max_abs_err']:.3g}; kernel {ms:.4f} ms (with its Wh pack; "
                f"{100 * bd[0] / ms:.1f}% of the {bd[0]:.4f} ms bound, {bd[1]}), plain "
                f"{plain:.3f} ms")
            del ins, gx, h, c, wh, got, want
            torch.cuda.empty_cache()

    from lstm_unet_tpu_torch.ops import quant

    b = 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (hw, cin, k, cout), sites in flagship_int8_convs().items():
        kq = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        kq[:, 0, 0, 0] = 127
        w_scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        bias = torch.randn(cout, device="cuda", generator=g)
        shape = f"B{b} {hw}^2 {cin}->{cout} {k}x{k}"
        m = b * hw * hw
        if conv_int8.route(hw, hw, cin, k, cout) == "wgmma":
            weight = quant.QWeight(kq.float(), bias)
            weight.w_scale.copy_(w_scale)
            # lanes of unequal ranges: a per-lane scale would differ from the shared one
            x = (torch.randn(b, hw, hw, cin, device="cuda", generator=g)
                 * torch.tensor([1.5, 0.5, 3.0, 1.0], device="cuda")[:, None, None, None]
                 ).to(torch.bfloat16)
            calib = torch.tensor(float(x.abs().max()) * 1.0137 / 127, device="cuda")
            tile = conv_int8.kernel_tile_n(b, hw, hw, cout, sms)
            for sc in (calib, None):
                a = (x, sc, weight.packed, w_scale, bias, k, torch.bfloat16)
                got = conv_int8.conv2d_int8_wgmma(*a)
                want = conv_int8.conv2d_int8_wgmma_plain(*a)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"conv2d_int8_wgmma {shape} tile N {tile} "
                                         f"{'dynamic' if sc is None else 'static'}: "
                                         f"{int((got != want).sum())} outputs differ")
            # lane 0 alone takes its own abs-max: its output must differ
            lane0 = conv_int8.conv2d_int8_wgmma(x[:1].contiguous(), None, *a[2:])
            if torch.equal(lane0, got[:1]):
                raise AssertionError(f"conv2d_int8_wgmma {shape}: the dynamic scale is not "
                                     f"shared by the lanes")
            kern = (x, calib) + a[2:]
            ms = time_ms(lambda: conv_int8.conv2d_int8_wgmma(*kern), 10)
            dyn = time_ms(lambda: conv_int8.conv2d_int8_wgmma(x, None, *kern[2:]), 10)
            plain = time_ms(lambda: conv_int8.conv2d_int8_wgmma_plain(*kern), 1)
            bd = conv_bound(m, cin, k, cout, 2)
            out["conv2d_int8_wgmma"].append(dict(shape=shape, sites=sites, tile_n=tile,
                                                 max_abs_err=0.0, ms=ms, dynamic_ms=dyn,
                                                 plain_ms=plain, bound_ms=bd[0],
                                                 bound_by=bd[1]))
            log(f"conv2d_int8_wgmma {shape} (x{sites} a step, tile N {tile}): bit-equal to the "
                f"plain version, static and shared dynamic scale (lane 0 alone "
                f"differs); kernel {ms:.4f} ms "
                f"({100 * bd[0] / ms:.1f}% of the {bd[0]:.4f} ms bound, {bd[1]}), with the "
                f"abs-max {dyn:.4f} ms, plain {plain:.3f} ms")
            del weight, x, got, want, lane0
        else:
            packed = conv_int8.pack_weight(kq)
            xq = torch.randint(-127, 128, (b, hw, hw, cin), device="cuda", generator=g,
                               dtype=torch.int32).to(torch.int8)
            a = (xq, torch.tensor(3.0 / 127, device="cuda"), packed, w_scale, bias, k, k,
                 torch.bfloat16)
            got = conv_int8.conv2d_int8(*a)
            want = conv_int8.conv2d_int8_plain(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"conv2d_int8 {shape}: {int((got != want).sum())} "
                                     f"outputs differ")
            ms = time_ms(lambda: conv_int8.conv2d_int8(*a), 10)
            plain = time_ms(lambda: conv_int8.conv2d_int8_plain(*a), 1)
            bd = conv_bound(m, cin, k, cout, 1)
            out["conv2d_int8"].append(dict(shape=shape, sites=sites, max_abs_err=0.0, ms=ms,
                                           plain_ms=plain, bound_ms=bd[0], bound_by=bd[1]))
            log(f"conv2d_int8 (mma_sync) {shape}: bit-equal to the plain version; kernel "
                f"{ms:.4f} ms ({100 * bd[0] / ms:.1f}% of the {bd[0]:.4f} ms bound), plain "
                f"{plain:.3f} ms")
            del packed, xq, got, want
        torch.cuda.empty_cache()
    rows = out["conv2d_int8_wgmma"]
    log(f"int8 wgmma convs of one B=4 step (24 sites): kernels "
        f"{sum(r['sites'] * r['ms'] for r in rows):.4f} ms, with the abs-max "
        f"{sum(r['sites'] * r['dynamic_ms'] for r in rows):.4f} ms, bound "
        f"{sum(r['sites'] * r['bound_ms'] for r in rows):.4f} ms")
    return out


def splice_cut(src, dst, at):
    """Copy the frames of sequence dir ``src`` to ``dst`` with an
    intensity-inverted copy of frame ``at`` inserted before it (two scene
    cuts), renumbered; returns ``dst``."""
    from lstm_unet_tpu_torch.io.tiff import read_tiff, write_tiff

    frames = [read_tiff(p) for p in sorted(glob.glob(os.path.join(src, "t*.tif")))]
    inverted = (60000 - frames[at].astype(np.int64)).astype(np.uint16)
    os.makedirs(dst, exist_ok=True)
    for t, f in enumerate(frames[:at] + [inverted] + frames[at:]):
        write_tiff(os.path.join(dst, f"t{t:03d}.tif"), f)
    return dst


def phase_golden_surface(torch, work):
    """(i): the golden model through the inference CLI with ``--tta``, ``--tta
    --tta_mode d4`` and ``--reset_on_jump 0.4`` (on the golden sequence with
    an inverted frame spliced in) in f32 on the card against the same run on
    the CPU, 0 px; then int8 ``--tta``, fused cell off and on, <= 3 px and
    equal instance counts. On the card the model runs 4 or 8 lanes a step."""
    from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
    from lstm_unet_tpu_torch.ops import kernels

    golden_seq = os.path.join(work, "golden", "Synth-N2DH-SIM", "01")
    cut_seq = splice_cut(golden_seq, os.path.join(work, "golden_cut", "01"), 4)
    runs = (("tta flip", golden_seq, ["--tta"], "float32", 0, 8),
            ("tta d4", golden_seq, ["--tta", "--tta_mode", "d4"], "float32", 0, 8),
            ("reset_on_jump 0.4", cut_seq, ["--reset_on_jump", "0.4"], "float32", 0, 9),
            ("int8 tta", golden_seq, ["--tta"], "int8", 3, 8),
            ("int8 tta fused", golden_seq, ["--tta", "--fused_cell"], "int8", 3, 8))
    for tag, seq, extra, dtype, max_px, frames in runs:
        outs = {}
        for device in ("cuda", "cpu"):
            outs[device] = os.path.join(work, f"surface_{tag.replace(' ', '_')}_{device}")
            before = kernels.counts()
            n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"), "--sequence_path",
                          seq, "--output_path", outs[device], "--device", device,
                          "--pre_sequence_frames", "2", "--min_cell_size", "5", "--dtype", dtype,
                          *extra])
            after = kernels.counts()
            ran = {k: after[k]["kernel"] - before[k]["kernel"] for k in after}
            steps = n + 2
            if device == "cuda":
                # per step: K1 at both levels (unfused) and K3 once (one lane
                # of averaged probabilities); int8: 6 small-K + 3 wgmma convs
                # (fused: 5 + 2, and K4's narrow route at both levels)
                if dtype == "float32":
                    want = {"lstm_gate_update": 2 * steps, "ccl": steps}
                else:
                    fused = "--fused_cell" in extra
                    per = (5, 2) if fused else (6, 3)
                    want = {"conv2d_int8_smallk": per[0] * steps,
                            "conv2d_int8_wgmma": per[1] * steps, "conv2d_int8": 0,
                            "fused_convlstm_level_narrow": (2 if fused else 0) * steps,
                            "ccl": steps}
                got = {k: ran[k] for k in want}
                if n != frames or got != want:
                    raise AssertionError(f"golden {tag}: {n} masks, launches {got}, "
                                         f"expected {want}")
            else:  # the CPU run's plain calls are no part of the path's count
                for k in after:
                    kernels.KERNELS[k].plain = before[k]["plain"]
        diffs = compare_dirs(f"golden {tag}", outs["cuda"], outs["cpu"], max_px)
        log(f"golden {tag} ({dtype}): differing px per frame against the CPU run {diffs} "
            f"(bar: {max_px} px, equal instance counts)")


def step_ms(torch, model, ip, frames, lanes=1, warm=2, device="cuda"):
    """Median host ms of one engine step (it ends in copying the labels to
    the host; on a rank of a mesh that gets none, in a synchronize) over
    ``lanes`` lanes, each frame of ``frames`` stacked ``lanes`` times, after
    ``warm`` steps."""
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine

    eng = StreamingInferenceEngine(model, ip, device)
    times = []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        labels = eng.step_batch_async(np.stack([f] * lanes))[0]
        if labels is None:
            torch.cuda.synchronize()
        else:
            labels.cpu()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_flagship_tta(torch, work, card):
    """(j): the flagship at 512^2 with TTA. Steady ms/frame of the engine for
    B = 1, 'flip' (4 lanes) and 'd4' (8 lanes) in bf16 fused and int8
    unfused; then ``run_inference`` with 'd4' in bf16 fused (K4 wgmma 4
    launches a step at 8 lanes) and 'flip' in int8 unfused (24 wgmma + 1
    small-K int8 convs, 4 of the wgmma convs with the gate epilogue and no K1
    a step at 4 lanes), counted, no plain call."""
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference
    from lstm_unet_tpu_torch.io.tiff import read_tiff
    from lstm_unet_tpu_torch.ops import kernels

    seq_dir = os.path.join(work, "flagship", "Synth-N2DH-SIM", "01")
    frames = [read_tiff(p) for p in sorted(glob.glob(os.path.join(seq_dir, "t*.tif")))]
    times = {}
    for dtype, fused, make in (("bfloat16", True, lambda: flagship_model(torch, "bfloat16", True)),
                               ("int8", False, lambda: flagship_int8_model(torch, False))):
        model = make()
        for lanes, kw in ((1, {}), (4, dict(tta=True)), (8, dict(tta=True, tta_mode="d4"))):
            ip = InferenceParams(dtype=dtype, fused_cell=fused, **kw)
            times[(dtype, lanes)] = step_ms(torch, model, ip, frames)
        log(f"flagship 512^2 {dtype} fused_cell={fused}, steady ms/frame (median of 6 after "
            f"2) [{card}]: B=1 {times[(dtype, 1)]:.3f}, TTA flip (4 lanes) "
            f"{times[(dtype, 4)]:.3f}, TTA d4 (8 lanes) {times[(dtype, 8)]:.3f}")
        mode, lanes = ("d4", 8) if dtype == "bfloat16" else ("flip", 4)
        out = os.path.join(work, f"flagship_tta_{dtype}")
        ip = InferenceParams(sequence_path=seq_dir, output_path=out, pre_sequence_frames=2,
                             dtype=dtype, fused_cell=fused, tta=True, tta_mode=mode)
        before = kernels.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run_inference(ip, device="cuda", model=model)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = kernels.counts()
        d = {k: {s: after[k][s] - before[k][s] for s in ("kernel", "plain")} for k in after}
        steps = n + 2
        if dtype == "bfloat16":
            want = {"fused_convlstm_level_wgmma": 4 * steps, "lstm_gate_update": 0,
                    "conv2d_int8": 0, "conv2d_int8_wgmma": 0}
        else:
            want = {"conv2d_int8_wgmma": 24 * steps, "conv2d_int8_wgmma_gates": 4 * steps,
                    "conv2d_int8_smallk": steps, "conv2d_int8": 0, "lstm_gate_update": 0,
                    "fused_convlstm_level_wgmma": 0}
        want.update(ccl=steps, ccl_grid=0, fused_convlstm_level_tf32x3=0)
        got = {k: d[k]["kernel"] for k in want}
        if n != 8 or got != want or any(v["plain"] for v in d.values()):
            raise AssertionError(f"flagship TTA {mode} {dtype}: {n} masks, launches {d}, "
                                 f"expected {want} and no plain call")
        log(f"flagship 512^2 {dtype} fused_cell={fused} TTA {mode} ({lanes} lanes) through "
            f"run_inference: {steps} frames in {secs:.3f} s incl. set-up; launches per frame "
            f"{ {k: v // steps for k, v in got.items() if v} }")
        del model
        torch.cuda.empty_cache()
    return times


def save_flagship_dir(torch, path):
    """A port model dir of the flagship with phase e's weights (seed 0, f32);
    returns its param tree (reference layout, numpy)."""
    from lstm_unet_tpu_torch.checkpoint.ckpt import PARAMS_FILE, save_model_params
    from lstm_unet_tpu_torch.checkpoint.convert import flatten_tree, params_to_jax

    model = flagship_model(torch, "float32", False)
    tree = params_to_jax(model.state_dict())
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, PARAMS_FILE), **flatten_tree(tree))
    save_model_params(path, {"model_config": dataclasses.asdict(model.cfg)})
    del model
    return tree


def phase_sweep(torch, work, card, run_dir):
    """(k): ``ctc_sweep`` over four 512^2 sequences (6, 8, 8, 10 frames: one
    chunk of 4 lanes) and a 384 x 512 one (a group of its own) in bf16 with
    the scores, each lane within 3 px per frame of the sequence streamed
    alone, and the steady step time of B = 1, 2 and 4 lanes; ``ctc_score``
    on its output; ``ckpt_avg`` over phase g's bf16 run (steps 4, 5) and
    ``inference2d`` from the soup; ``import_tf`` of the flagship weights
    exported as a TF bundle, bit-equal."""
    from lstm_unet_tpu_torch.checkpoint.tf_import import export_tf_bundle
    from lstm_unet_tpu_torch.cli.ckpt_avg import main as avg_main
    from lstm_unet_tpu_torch.cli.ctc_score import main as score_main
    from lstm_unet_tpu_torch.cli.ctc_sweep import main as sweep_main
    from lstm_unet_tpu_torch.cli.import_tf import main as import_main
    from lstm_unet_tpu_torch.cli.inference2d import main as infer_main
    from lstm_unet_tpu_torch.checkpoint.convert import flatten_tree, load_model
    from lstm_unet_tpu_torch.config import default_net_kernel_params
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import run_inference
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.io.tiff import read_tiff
    from lstm_unet_tpu_torch.ops import kernels

    root = os.path.join(work, "sweep_data")
    seqs = (("01", 6, 512), ("02", 8, 512), ("03", 8, 512), ("04", 10, 512), ("05", 6, 384))
    for seq, n, h in seqs:
        write_ctc_dataset(root, seq=seq, num_frames=n, height=h, width=512, num_cells=40,
                          seed=10 + int(seq))
    model_dir = os.path.join(work, "flagship_model")
    tree = save_flagship_dir(torch, model_dir)
    out_root = os.path.join(work, "sweep_res")
    before = kernels.counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = sweep_main(["--model_path", model_dir, "--root_data_dir", root, "--output_root",
                        out_root, "--device", "cuda", "--dtype", "bfloat16", "--max_batch", "4",
                        "--pre_sequence_frames", "2", "--score_seg", "--score_det"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = kernels.counts()
    d = {k: {s: after[k][s] - before[k][s] for s in ("kernel", "plain")} for k in after}
    steps_512, steps_384 = 10 + 2, 6 + 2  # one chunk of 4 lanes; one lane
    want = {"lstm_gate_update": 4 * (steps_512 + steps_384),
            "ccl": 4 * steps_512 + steps_384, "ccl_grid": 0}
    got = {k: d[k]["kernel"] for k in want}
    if total != 38 or got != want or any(v["plain"] for v in d.values()):
        raise AssertionError(f"ctc_sweep: {total} masks, launches {d}, expected {want}")
    log(f"ctc_sweep bf16 --max_batch 4: {total} masks in {secs:.3f} s incl. loading the model "
        f"and set-up [{card}]; launches {got}")
    model = load_model(model_dir, "cuda", dtype="bfloat16")
    diffs = {}
    for seq, n, h in seqs:
        single = os.path.join(work, f"sweep_single_{seq}")
        ip = InferenceParams(sequence_path=os.path.join(root, "Synth-N2DH-SIM", seq),
                             output_path=single, pre_sequence_frames=2, dtype="bfloat16")
        run_inference(ip, device="cuda", model=model)
        diffs[seq] = compare_dirs(f"ctc_sweep lane {seq}",
                                  os.path.join(out_root, "Synth-N2DH-SIM", f"{seq}_RES"),
                                  single, 3)
    log(f"ctc_sweep lanes against each sequence streamed alone: differing px per frame "
        f"{diffs} (bar: 3 px, equal instance counts)")
    frames = [read_tiff(p) for p in sorted(glob.glob(os.path.join(
        root, "Synth-N2DH-SIM", "04", "t*.tif")))]
    fps = {}
    for lanes in (1, 2, 4):
        ms = step_ms(torch, model, InferenceParams(dtype="bfloat16"), frames, lanes)
        fps[lanes] = (ms, 1e3 / ms, lanes * 1e3 / ms)
    log(f"batched bf16 stream at 512^2, steady (median of 8 steps after 2) [{card}]: "
        + "; ".join(f"B={b}: {ms:.3f} ms/step, {per:.2f} frames/s per lane, {tot:.2f} in all"
                    for b, (ms, per, tot) in fps.items()))
    del model
    torch.cuda.empty_cache()

    scores_path = os.path.join(work, "scores.json")
    scores = score_main(["--pred_root", out_root, "--gt_root", root, "--json", scores_path])
    per_seq = [k for k in scores if not k.startswith("mean_")]
    if len(per_seq) != 5 or not all(0.0 <= scores[f"mean_{m}"] <= 1.0 for m in ("seg", "det")):
        raise AssertionError(f"ctc_score: {scores}")
    log(f"ctc_score: mean SEG {scores['mean_seg']:.4f}, mean DET {scores['mean_det']:.4f} "
        f"over {len(per_seq)} sequences (random weights)")

    soup = os.path.join(work, "soup")
    if avg_main(["--model_path", run_dir, "--output_dir", soup]) != 5:
        raise AssertionError("ckpt_avg: the soup is not at the newest step")
    save_dir = os.path.join(run_dir, "ckpt")
    npz = [np.load(os.path.join(save_dir, str(s), "params.npz")) for s in (4, 5)]
    avg = np.load(os.path.join(soup, "5", "params.npz"))
    for key in avg.files:
        want_v = ((npz[0][key].astype(np.float32) + npz[1][key])
                  * np.float32(1 / 2)).astype(npz[0][key].dtype)
        if not np.array_equal(avg[key], want_v):
            raise AssertionError(f"ckpt_avg: {key} is not the mean of steps 4, 5")
    soup_out = os.path.join(work, "soup_res")
    before = kernels.counts()
    n = infer_main(["--model_path", soup, "--sequence_path",
                    os.path.join(work, "flagship", "Synth-N2DH-SIM", "01"),
                    "--output_path", soup_out, "--device", "cuda", "--pre_sequence_frames", "2"])
    after = kernels.counts()
    if n != 8 or any(after[k]["plain"] != before[k]["plain"] for k in after):
        raise AssertionError(f"inference2d from the soup: {n} masks")
    log(f"ckpt_avg over the bf16 run's steps 4, 5: {len(avg.files)} arrays, each the f32 "
        f"mean; inference2d from the soup: {n} masks")

    prefix = os.path.join(work, "tf_export", "model.ckpt")
    t0 = time.perf_counter()
    export_tf_bundle(prefix, tree)
    export_s = time.perf_counter() - t0
    imported = os.path.join(work, "imported")
    import_main(["--tf_prefix", prefix, "--output_dir", imported, "--net_kernel_params",
                 json.dumps(default_net_kernel_params().to_dict())])
    got = np.load(os.path.join(imported, "params.npz"))
    flat = flatten_tree(tree)
    bad = sorted(k for k in flat if not np.array_equal(got[k], flat[k]))
    if sorted(got.files) != sorted(flat) or bad:
        raise AssertionError(f"import_tf: {len(bad)} flagship tensors differ: {bad[:4]}")
    log(f"import_tf of the flagship weights exported as a TF bundle ({len(flat)} tensors, "
        f"{sum(v.nbytes for v in flat.values()) / 2**20:.1f} MiB, exported in {export_s:.2f} "
        f"s): bit-equal")


# ---------------------------------------------------------------- phase n

HELDOUT_FRAMES = 6  # each held-out sequence of phase n, cut from 40 frames
GT_DUMP_FRAMES = 3  # frames of each sequence dumped from its GT
CARRY_FRAMES, CARRY_SEGMENT, CARRY_EVERY = 300, 40, 100
# phase n took 109.6-165.8 s on an H100, 74-105 s of it in the eight sweep
# children (each a new process that imports torch, starts CUDA and loads the
# model to stream 6-8 frames)
PHASE_N_BUDGET_S = 240.0


def launched_since(kernels, before, name, need):
    """The kernels launched since ``before``; raises unless each of ``need``
    launched and no plain version ran."""
    after = kernels.counts()
    ran = {k: {s: after[k][s] - before[k][s] for s in ("kernel", "plain")} for k in after}
    missing = [k for k in need if ran[k]["kernel"] == 0]
    plain = {k: v["plain"] for k, v in ran.items() if v["plain"]}
    if missing or plain:
        raise AssertionError(f"{name}: {missing} never launched, plain versions ran "
                             f"{plain}: {ran}")
    return {k: v["kernel"] for k, v in ran.items() if v["kernel"]}


def aside(kernels, fn, *args):
    """``fn(*args)`` on the CPU, for comparison: its plain calls are no part
    of the path's count."""
    before = kernels.counts()
    out = fn(*args)
    for k in before:
        kernels.KERNELS[k].plain = before[k]["plain"]
    return out


def captured(fn, *args):
    """(``fn(*args)``, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    sys.stdout.write(text)
    return out, text


def gt_dumps(torch, kernels, gt_root, out_root, dataset):
    """``ctc_sweep --save_intermediate``'s layout for the first
    ``GT_DUMP_FRAMES`` frames of each sequence under ``gt_root``, made from
    the GT: each frame's three classes (the port's
    ``instance_to_three_class``) as logits of 3 plus seeded unit noise,
    softmaxed, and the masks that phase n's production config (0.5, 0.3,
    50) makes of them on the CPU. Returns the instances in
    those masks per sequence."""
    from lstm_unet_tpu_torch.io.preprocess import instance_to_three_class
    from lstm_unet_tpu_torch.io.tiff import read_tiff, write_tiff
    from lstm_unet_tpu_torch.ops.postprocess import postprocess_frame

    rng = np.random.default_rng(0)
    found = {}
    for gt_dir in sorted(glob.glob(os.path.join(gt_root, dataset, "*_GT"))):
        seq = os.path.basename(gt_dir)[:-3]
        pred_dir = os.path.join(out_root, dataset, f"{seq}_RES")
        os.makedirs(os.path.join(pred_dir, "intermediate"))
        found[seq] = 0
        paths = sorted(glob.glob(os.path.join(gt_dir, "SEG", "man_seg*.tif")))
        for path in paths[:GT_DUMP_FRAMES]:
            t = int(os.path.basename(path)[len("man_seg"):-len(".tif")])
            three = instance_to_three_class(read_tiff(path))
            logits = (3 * np.eye(3, dtype=np.float32)[three]
                      + rng.standard_normal(three.shape + (3,), dtype=np.float32))
            probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
            np.save(os.path.join(pred_dir, "intermediate", f"probs{t:03d}.npy"), probs)
            labels = aside(kernels, lambda: postprocess_frame(
                torch.from_numpy(probs), cell_thresh=0.5, edge_thresh=0.3,
                min_cell_size=50).numpy().astype(np.uint16))
            found[seq] += len(np.unique(labels)) - 1
            write_tiff(os.path.join(pred_dir, f"mask{t:03d}.tif"), labels)
    return found


def phase_scripts(torch, work, card, run_dir):
    """(n): the workflow scripts (``lstm_unet_tpu_torch/scripts``) on the
    card, counted from 0 (their children's launches are their own). n1
    held-out data from the protocol's tables (TRAIN row 03, HELDOUT rows
    01-02 at SIZE, cut to ``HELDOUT_FRAMES`` frames); n2 ``select_best`` on
    phase g's bf16 run (steps 4, 5) with ``--prune``, the soup, the eval and
    int8 confirms in ``ctc_sweep`` children on the card, then
    ``inference2d`` from ``best/``; n3 ``ctc_sweep --save_intermediate`` of
    ``best/`` on val and eval, then ``calibrate_recipe`` on dumps that hold
    cells (``gt_dumps``: a 5-step model's masks are empty), its
    ``--baseline_check`` holding the card's masks to the CPU's bit for bit
    in its children; n4 ``postprocess_sweep`` (2x2 grid, 'prob' split) on
    those dumps against the same sweep on the CPU: equal JSON, ms per
    (config, frame); n5 ``oracle_ceiling`` with and without the split
    against the CPU; n6 ``mask_agreement`` of phase d's golden masks,
    ``seg_error_decomposition`` and ``split_sweep`` on n3's eval masks; n7
    ``carry_drift`` on phase g's flagship run and on the golden model with
    ``fused_cell``, at SIZE for ``CARRY_FRAMES`` frames. Raises past
    ``PHASE_N_BUDGET_S``; returns the wall seconds."""
    from lstm_unet_tpu_torch.cli.ctc_sweep import main as sweep_main
    from lstm_unet_tpu_torch.cli.inference2d import main as infer_main
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.ops import kernels
    from lstm_unet_tpu_torch.scripts import (calibrate_recipe, carry_drift, heldout_protocol,
                                             mask_agreement, oracle_ceiling, postprocess_sweep,
                                             seg_error_decomposition, select_best, split_sweep)

    t_phase = time.perf_counter()
    hp = heldout_protocol
    size, dataset = hp.SIZE, hp.DATASET

    # n1: the protocol's own rows, cut in length only
    root = os.path.join(work, "heldout")
    held = (("train", hp.TRAIN[2]), ("eval", hp.HELDOUT[0]), ("eval", hp.HELDOUT[1]))
    for sub, (seq, seed, cells, rs, frames, ov) in held:
        write_ctc_dataset(os.path.join(root, sub), dataset=dataset, seq=seq,
                          num_frames=HELDOUT_FRAMES, height=size, width=size, num_cells=cells,
                          seed=seed, radius_scale=rs, overlap_frac=ov)
    log(f"n1 held-out data: train/{held[0][1][0]} (val), eval/{held[1][1][0]}, "
        f"eval/{held[2][1][0]} from the protocol's tables (seeds "
        f"{[r[1] for _, r in held]}, cells {[r[2] for _, r in held]}, radius scales "
        f"{[r[3] for _, r in held]}) at {size}^2, cut from {[r[4] for _, r in held]} to "
        f"{HELDOUT_FRAMES} frames each")

    # n2: selection, soup, confirms and the durable artifact
    best = os.path.join(work, "best")
    t0 = time.perf_counter()
    summary = select_best.main(["--model_path", run_dir, "--data_root", root, "--val_seqs",
                                "03", "--best_dir", best, "--prune", "--device", "cuda",
                                "--out", os.path.join(work, "select_best.json")])
    secs = time.perf_counter() - t0
    want = ("val_ranking", "artifact_steps", "eval_soup_mean", "eval_soup_int8_mean")
    if (len(summary["val_ranking"]) != 2 or any(k not in summary for k in want)
            or summary["pruned_steps"] != []
            or not os.path.exists(os.path.join(best, "act_scales.json"))):
        raise AssertionError(f"select_best: {summary}")
    log(f"n2 select_best --device cuda on phase g's bf16 run: ranking "
        f"{[(r['step'], r['val_mean']) for r in summary['val_ranking']]}, soup val "
        f"{summary.get('val_soup_mean')}, artifact steps {summary['artifact_steps']}, eval "
        f"{summary['eval_soup_mean']} (int8 {summary['eval_soup_int8_mean']}), pruned "
        f"{summary['pruned_steps']}, best/act_scales.json written; {secs:.1f} s for "
        f"{3 + len(summary['val_ranking'])} ctc_sweep children [{card}]")
    before = kernels.counts()
    eval_seq = os.path.join(root, "eval", dataset, "01")
    n = infer_main(["--model_path", best, "--sequence_path", eval_seq, "--output_path",
                    os.path.join(work, "best_res"), "--device", "cuda",
                    "--pre_sequence_frames", "2"])
    ran = launched_since(kernels, before, "inference2d from best/", ("lstm_gate_update", "ccl"))
    if n != HELDOUT_FRAMES:
        raise AssertionError(f"inference2d from best/: {n} masks")
    log(f"n2 inference2d from best/: {n} masks; launches {ran}")

    # n3: probability dumps of best/ on val and eval, then the calibration
    # on dumps that hold cells
    before = kernels.counts()
    for sub, seqs in (("train", "03"), ("eval", "")):
        sweep_main(["--model_path", best, "--root_data_dir", os.path.join(root, sub),
                    "--output_root", os.path.join(work, f"{sub}_best_dump"), "--device", "cuda",
                    "--save_intermediate", "--min_cell_size", "50", "--pre_sequence_frames",
                    "2", *(["--seqs", seqs] if seqs else [])])
    ran = launched_since(kernels, before, "ctc_sweep --save_intermediate",
                         ("lstm_gate_update", "ccl"))
    n_dumps = sum(len(glob.glob(os.path.join(work, f"{sub}_best_dump", dataset, "*_RES",
                                             "intermediate", "probs*.npy")))
                  for sub in ("train", "eval"))
    if n_dumps != 3 * HELDOUT_FRAMES:
        raise AssertionError(f"ctc_sweep --save_intermediate of best/: {n_dumps} dumps")
    dumps = {sub: os.path.join(work, f"{sub}_dump") for sub in ("train", "eval")}
    found = {sub: gt_dumps(torch, kernels, os.path.join(root, sub), dumps[sub], dataset)
             for sub in dumps}
    if sorted(found["train"]) != ["03"] or sorted(found["eval"]) != ["01", "02"] or not all(
            v > 0 for f in found.values() for v in f.values()):
        raise AssertionError(f"the GT's dumps: instances {found}")
    t0 = time.perf_counter()
    calib = calibrate_recipe.main([
        "--gt_root_val", os.path.join(root, "train"), "--pred_root_val", dumps["train"],
        "--val_seqs", "03", "--gt_root_eval", os.path.join(root, "eval"),
        "--pred_root_eval", dumps["eval"], "--out", os.path.join(work, "calibration.json"),
        "--device", "cuda", "--cell_grid", "0.5,0.6", "--edge_grid", "0.3",
        "--size_filter_grid", "pre,post", "--split_hi_grid", "0.8",
        "--split_min_size_grid", "0,3500"])
    if not (calib["val_baseline"] > 0.5 and calib["eval_baseline"] > 0.5):
        raise AssertionError(f"calibrate_recipe: the baselines hold no cells: {calib}")
    log(f"n3 ctc_sweep --save_intermediate of best/ (val, eval): {n_dumps} dumps, launches "
        f"{ran}; dumps of the GT's first {GT_DUMP_FRAMES} frames (3 classes + noise, masks "
        f"on the CPU: instances {found}); calibrate_recipe --device cuda on them (8 split + "
        f"4 plain configs on val, its --baseline_check bit for bit) in "
        f"{time.perf_counter() - t0:.1f} s: winner {calib['winner']}, val "
        f"{calib['val_best']:.4f} (baseline {calib['val_baseline']:.4f}), eval "
        f"{calib['eval_mean']:.4f} (baseline {calib['eval_baseline']:.4f})")

    # n4: the postprocess sweep in this process, on the card and on the CPU
    times = []
    run_config = postprocess_sweep.run_config

    def timed(probs, cfg):
        t1 = time.perf_counter()
        out = run_config(probs, cfg)  # ends in a copy to the host
        times.append(time.perf_counter() - t1)
        return out

    grid = ["--gt_root", os.path.join(root, "eval"), "--pred_root", dumps["eval"],
            "--min_cell_size", "50", "--baseline_check", "--cell_grid", "0.5,0.6",
            "--edge_grid", "0.3,0.4", "--split_hi_grid", "0.8", "--limit_frames", "2"]
    swept, ms = {}, {}
    postprocess_sweep.run_config = timed
    try:
        for dev in ("cuda", "cpu"):
            times.clear()
            json_out = os.path.join(work, f"ppsweep_{dev}.json")
            before = kernels.counts()
            if dev == "cuda":
                rc, text = captured(postprocess_sweep.main, grid + ["--device", dev,
                                                                     "--json_out", json_out])
                ran = launched_since(kernels, before, "postprocess_sweep", ("ccl",))
            else:
                rc, text = aside(kernels, captured, postprocess_sweep.main,
                                 grid + ["--device", dev, "--json_out", json_out])
            if rc != 0 or "BASELINE MISMATCH" in text:
                raise AssertionError(f"postprocess_sweep --device {dev}: rc {rc}")
            with open(json_out) as f:
                swept[dev] = json.load(f)
            ms[dev] = 1e3 * sum(times) / len(times)
    finally:
        postprocess_sweep.run_config = run_config
    rows = swept["cuda"]["rows"]
    if (swept["cuda"] != swept["cpu"] or len(rows) != 4 or swept["cpu"]["n_frames"] != 4
            or not swept["cpu"]["baseline_mean"] > 0.5 or not all(r["mean"] > 0 for r in rows)):
        raise AssertionError(f"postprocess_sweep: the card's JSON is not the CPU's, or holds "
                             f"no cells: {swept['cuda']} vs {swept['cpu']}")
    log(f"n4 postprocess_sweep (2x2 grid, 'prob' split, 2 frames of each eval sequence, "
        f"--baseline_check): JSON equal on cuda and the CPU (baseline SEG "
        f"{swept['cpu']['baseline_mean']:.4f}, rows {[round(r['mean'], 4) for r in rows]}); "
        f"ms per (config, frame) incl. the copy to the host: cuda {ms['cuda']:.3f}, cpu "
        f"{ms['cpu']:.3f} [{card}]; launches {ran}")

    # n5: the oracle ceiling, split off and on, on the card and on the CPU
    means = {}
    before = kernels.counts()
    for extra in ([], ["--instance_split"]):
        argv = ["--root", os.path.join(root, "eval"), "--max_frames", "2", *extra]
        means[bool(extra)] = (oracle_ceiling.main(argv + ["--device", "cuda"]),
                              aside(kernels, oracle_ceiling.main, argv + ["--device", "cpu"]))
        if means[bool(extra)][0] != means[bool(extra)][1]:
            raise AssertionError(f"oracle_ceiling {extra}: {means[bool(extra)]}")
    ran = launched_since(kernels, before, "oracle_ceiling", ("ccl",))
    log(f"n5 oracle_ceiling (2 frames of each eval sequence): mean SEG split off "
        f"{means[False][0]:.4f}, 'dist' split {means[True][0]:.4f}, each equal on cuda "
        f"and the CPU; launches {ran}")

    # n6: the host-side scorers
    rc, text = captured(mask_agreement.main, [os.path.join(work, "golden_res_0"),
                                              os.path.join(GOLDEN, "masks")])
    if rc != 0 or text.strip() != "agreement=1.0000 frames=8":
        raise AssertionError(f"mask_agreement: rc {rc}, {text!r}")
    t0 = time.perf_counter()
    seg_error_decomposition.main(["--gt_root", os.path.join(root, "eval"),
                                  "--pred_root", dumps["eval"], "--top", "3"])
    split_sweep.main(["--gt_root", os.path.join(root, "eval"), "--pred_root", dumps["eval"],
                      "--seqs", "01", "--method", "prob"])
    log(f"n6 mask_agreement of phase d's golden masks: {text.strip()}; "
        f"seg_error_decomposition and split_sweep on n3's eval masks: "
        f"{time.perf_counter() - t0:.1f} s")

    # n7: carry drift on phase g's flagship, then on the golden model fused
    frames, segment, every = CARRY_FRAMES, CARRY_SEGMENT, CARRY_EVERY
    golden_fused = os.path.join(work, "golden_fused_model")
    shutil.copytree(os.path.join(GOLDEN, "torch_ckpt"), golden_fused)
    arch_path = os.path.join(golden_fused, "model_params.json")
    with open(arch_path) as f:
        arch = json.load(f)
    arch["model_config"]["fused_cell"] = True
    with open(arch_path, "w") as f:
        json.dump(arch, f)
    need = {"flagship": ("lstm_gate_update", "ccl"),
            "golden fused": ("fused_convlstm_level_narrow", "ccl")}
    for name, model_path in (("flagship", run_dir), ("golden fused", golden_fused)):
        before = kernels.counts()
        out = carry_drift.main(["--model_path", model_path, "--frames", str(frames),
                                "--size", str(size), "--segment", str(segment),
                                "--report_every", str(every), "--device", "cuda"])
        ran = launched_since(kernels, before, f"carry_drift {name}", need[name])
        if len(out["rows"]) != frames // every:
            raise AssertionError(f"carry_drift {name}: {out['rows']}")
        log(f"n7 carry_drift {name} at {size}^2, {frames} frames, segment {segment}: "
            f"ms/frame (step + softmax + postprocess) "
            + ", ".join(f"{k} {v:.3f}" for k, v in out["ms_per_frame"].items())
            + f" [{card}]; launches {ran}")
    secs = time.perf_counter() - t_phase
    log(f"phase n: {secs:.1f} s (budget {PHASE_N_BUDGET_S:.0f} s)")
    if secs > PHASE_N_BUDGET_S:
        raise AssertionError(f"phase n took {secs:.1f} s, over its {PHASE_N_BUDGET_S:.0f} s")
    return secs


def card_name(torch):
    """Card 0's name and power limit, as the bench's JSON line holds them."""
    from lstm_unet_tpu_torch.bench import device_info

    name, limit = device_info(torch.device("cuda", 0))
    return f"{name}, {limit}"


def scripts_alone():
    """Phase n on its own, with the phases whose outputs it reads (d: the
    golden masks, g: the trained flagship run); the kernels built first."""
    import torch
    from lstm_unet_tpu_torch.ops.kernels import _build

    _build.library()
    card = card_name(torch)
    log(card)
    with tempfile.TemporaryDirectory() as work:
        phase_golden(torch, work)
        run_dir = phase_train(torch, work, card, {})
        phase_scripts(torch, work, card, run_dir)


def flagship_carry_drift(frames=1200, steps=5):
    """The carry-drift protocol at full length: the flagship trained
    ``steps`` bf16 steps as phase g trains it (B5 T7 256^2 crops of a 512^2
    sequence; its validation SEG logged), then ``carry_drift`` at 512^2, one
    coherent sequence of ``frames`` frames (``--segment`` = ``--frames``,
    ``--velocity_scale 0.2``), reported every 100 frames."""
    import torch
    from lstm_unet_tpu_torch.cli.train2d import main as train_main
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.scripts import carry_drift

    log(card_name(torch))
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "train_data")
        write_ctc_dataset(root, num_frames=16, height=512, width=512, num_cells=40, seed=0)
        trainer = train_main(train_args(root, os.path.join(work, "runs"), "bfloat16", steps))
        run_dir = os.path.dirname(trainer.p.experiment_save_dir)
        vm = trainer.last_val_metrics
        log(f"flagship after {steps} bf16 steps: loss {trainer.history[-1]['loss']:.4f}, "
            f"validation seg {vm['seg']:.4f} det {vm['det']:.4f}")
        del trainer
        torch.cuda.empty_cache()
        carry_drift.main(["--model_path", run_dir, "--frames", str(frames), "--size", "512",
                          "--segment", str(frames), "--velocity_scale", "0.2",
                          "--report_every", "100", "--device", "cuda"])


# ---------------------------------------------------------------- phase o

PHASE_O_BUDGET_S = 120.0
# (run, argv of ``python -m lstm_unet_tpu_torch.bench``, kernels it must launch)
BENCH_RUNS = (
    ("o1", ["--mfu"], ("conv2d_int8_wgmma", "conv2d_int8_smallk", "lstm_gate_update", "ccl",
                       "lstm_gate_update_bwd")),
    ("o2", ["--dtype", "bfloat16", "--fused_cell", "--no-train_too", "--mfu"],
     ("fused_convlstm_level_wgmma", "ccl")),
    ("o3", ["--dtype", "bfloat16", "--fused_cell", "--batch", "4", "--no-train_too"],
     ("fused_convlstm_level_wgmma", "ccl")),
    ("o4", ["--dtype", "float32", "--fused_cell", "--frames", "8", "--no-train_too", "--mfu"],
     ("fused_convlstm_level_tf32x3", "ccl")),
    ("o5", ["--mode", "train", "--remat_policy", "none", "--train_batch", "5", "--mfu"],
     ("lstm_gate_update", "lstm_gate_update_bwd")),
)


def phase_bench(card, launched):
    """(o): the port's bench, ``lstm_unet_tpu_torch.bench.main``, in this
    process at the flagship's full width and depth, each run counted: one
    JSON line with ``value`` > 0, every ``mfu`` in (0, 1], the kernels of
    ``BENCH_RUNS`` launched and no plain version. Adds the launches to
    ``launched``; fails past ``PHASE_O_BUDGET_S``."""
    import contextlib
    import io

    import torch
    from lstm_unet_tpu_torch import bench
    from lstm_unet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_counts()
    log(f"phase o: {torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB reserved at its start")
    for name, argv, need in BENCH_RUNS:
        before = kernels.counts()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = bench.main(argv)
        lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
        if len(lines) != 1 or json.loads(lines[0]) != out:
            raise AssertionError(f"bench {name}: not one JSON line: {buf.getvalue()!r}")
        ran = launched_since(kernels, before, f"bench {name}", need)
        mfus = {k: out[k] for k in ("mfu", "train_mfu") if k in out}
        args = bench.build_parser().parse_args(argv)
        want = set() if not args.mfu else (
            {"train_mfu"} if args.mode == "train"
            else {"mfu", "train_mfu"} if args.train_too else {"mfu"})
        if not out["value"] > 0 or set(mfus) != want or not all(0 < v <= 1 for v in mfus.values()):
            raise AssertionError(f"bench {name}: value or mfu out of range: {out}")
        log(f"bench {name} ({card}): {lines[0]}")
        log(f"  launches: {ran}; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB reserved, "
            f"{torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries} allocator "
            "retries (cached blocks freed to satisfy a request)")
    add_counts(launched, kernels.counts())
    secs = time.perf_counter() - t0
    log(f"phase o: {secs:.1f} s (budget {PHASE_O_BUDGET_S:.0f} s)")
    if secs > PHASE_O_BUDGET_S:
        raise AssertionError(f"phase o took {secs:.1f} s, past its {PHASE_O_BUDGET_S:.0f} s")


def bench_alone():
    """Phase o on its own, the kernels built first."""
    import torch
    from lstm_unet_tpu_torch.ops.kernels import _build

    _build.library()
    card = card_name(torch)
    log(card)
    phase_bench(card, {})


# ---------------------------------------------------------------- phase m

MESH_RANKS = 2
MESH_TIMEOUT_S = 600.0
M2_FRAMES = 8  # frames of the flagship sequence timed in m2 (2 warm-up)


def record_writes(root, into):
    """An audit hook: every file this process opens for writing, and every
    directory it makes or file it renames or removes, under ``root``."""
    root = os.path.realpath(root)
    events = ("os.mkdir", "os.rename", "os.remove", "os.rmdir", "shutil.rmtree")

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
        elif event in events:
            path, writes = args[0], True
        else:
            return
        if writes and isinstance(path, (str, bytes, os.PathLike)) and os.path.realpath(
                os.fsdecode(path)).startswith(root):
            into.append((event, os.fsdecode(path)))

    sys.addaudithook(hook)


def m2_models(torch):
    """m2's two cases: (tag, model, InferenceParams kwargs)."""
    return (("bf16 fused", flagship_model(torch, "bfloat16", True),
             dict(dtype="bfloat16", fused_cell=True)),
            ("int8 unfused", flagship_int8_model(torch, False),
             dict(dtype="int8", fused_cell=False)))


def m2_logits(torch, engine, frame):
    """One step of ``engine``'s model from a zero state on ``frame`` [1, H, W,
    1] (a rank's rows of it under the engine's split), the whole logits."""
    model, split = engine.model, engine.model.split
    b, h, w = 1, frame.shape[1], frame.shape[2]
    with torch.inference_mode():
        if split is None:
            return model.step(model.init_state(b, h, w), frame)[1]
        x = split.take(frame, 0, 1).contiguous()
        _, logits = model.step(model.init_state(*split.block(b, h), w), x)
        return split.gather(logits, lane_dim=0, row_dim=1)


def m4_args(root, save_root, mesh, device):
    return ["--device", device, "--root_data_dir", root,
            "--train_sequence_list", "Synth-N2DH-SIM:01", "--crop_size", "256", "256",
            "--batch_size", "4", "--unroll_len", "7", "--dtype", "float32",
            "--num_iterations", "3", "--print_to_console_interval", "1",
            "--validation_interval", str(10 ** 9), "--save_checkpoint_iteration", str(10 ** 9),
            "--root_save_dir", save_root, "--experiment_name", "mesh",
            *(["--mesh_shape", json.dumps(mesh)] if mesh else [])]


def block_heights(model, height, spatial):
    """The heights of the halo-extended blocks K4 and the 5x5 int8 convs
    see at each encoder level: a rank's rows plus ``k // 2`` rows of each
    neighbour."""
    nkp = model.cfg.nkp
    return sorted({height // spatial // 2 ** lvl + 2 * (k // 2)
                   for lvl, cells in enumerate(nkp.lstm_kernels) for k, _ in cells})


def mesh_rank(rank, device, work, frames_dir, m3_seqs):
    """One of phase m's two ranks on one card (over gloo): m1-m4, each on
    the port's entry points; returns what the parent checks, and this
    rank's kernel launches (counted from 0 here)."""
    import torch

    from lstm_unet_tpu_torch.cli.inference2d import main as infer_main
    from lstm_unet_tpu_torch.cli.train2d import main as train_main
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine, run_inference_batched
    from lstm_unet_tpu_torch.io.dataset import CTCInferenceReader
    from lstm_unet_tpu_torch.ops import convlstm, kernels
    from lstm_unet_tpu_torch.ops.kernels import conv_int8

    kernels.reset_counts()
    out = {}
    # m1: the golden sequence through the CLI with a {"spatial": 2} recipe
    recipe = os.path.join(work, "mesh_spatial.json")
    seq = os.path.join(work, "golden", "Synth-N2DH-SIM", "01")
    for tag, extra in (("f32_fused", ["--dtype", "float32", "--fused_cell"]),
                       ("int8", ["--dtype", "int8"])):
        out[f"m1_{tag}"] = infer_main([
            "--model_path", os.path.join(GOLDEN, "torch_ckpt"), "--sequence_path", seq,
            "--output_path", os.path.join(work, f"m1_{tag}_rank{rank}"), "--device",
            str(device), "--pre_sequence_frames", "2", "--min_cell_size", "5",
            "--recipe", recipe, *extra])

    # m2: the flagship at 512^2, B = 1, {"spatial": 2}: logits of one frame,
    # the heights K4 and the int8 convs ran at, steady ms/frame
    heights = {"k4": set(), "int8": set()}
    wrapped = {}

    def recording(mod, name, key):
        fn = wrapped[(mod, name)] = getattr(mod, name)

        def rec(*args, **kw):
            t = args[1] if key == "k4" else args[0]  # K4's h, the int8 conv's x
            heights[key].add(int(t.shape[1]))
            return fn(*args, **kw)

        setattr(mod, name, rec)

    recording(convlstm, "fused_convlstm_level", "k4")
    recording(conv_int8, "conv2d_int8_wgmma", "int8")
    recording(conv_int8, "conv2d_int8_smallk", "int8")
    frames = [f for _, f in CTCInferenceReader(frames_dir, pre_sequence_frames=0,
                                               normalize=False)][:M2_FRAMES]
    frame = torch.rand(1, 512, 512, 1, device=device,
                       generator=torch.Generator(device=device).manual_seed(2))
    try:
        for tag, model, kw in m2_models(torch):
            ip = InferenceParams(mesh_shape={"spatial": 2}, **kw)
            before = kernels.counts()
            engine = StreamingInferenceEngine(model, ip, device)
            engine.process_frame(frames[0])  # builds the split
            out[f"m2_{tag}_logits"] = m2_logits(torch, engine, frame).float().cpu().numpy()
            out[f"m2_{tag}_ms"] = step_ms(torch, model, ip, frames, device=device)
            after = kernels.counts()
            out[f"m2_{tag}_launches"] = {k: after[k]["kernel"] - before[k]["kernel"]
                                         for k in after if after[k]["kernel"] > before[k]["kernel"]}
            out["m2_want_heights"] = block_heights(model, 512, 2)
            del engine, model
    finally:
        for (mod, name), fn in wrapped.items():
            setattr(mod, name, fn)
    out["m2_heights"] = {k: sorted(v) for k, v in heights.items()}

    # m3: 4 lanes of the int8 flagship, {"data": 2}
    out["m3_n"] = run_inference_batched(
        InferenceParams(dtype="int8", pre_sequence_frames=1, mesh_shape={"data": 2}), m3_seqs,
        [os.path.join(work, f"m3_rank{rank}", str(i)) for i in range(len(m3_seqs))],
        device=device, model=flagship_int8_model(torch, False))
    torch.cuda.empty_cache()

    # m4: flagship training, {"data": 2} then {"spatial": 2}; rank 1's writes
    writes = []
    runs = os.path.join(work, "m4_runs")
    if rank == 1:
        record_writes(runs, writes)
    for tag, mesh in (("data", {"data": 2}), ("spatial", {"spatial": 2})):
        before = kernels.counts()
        trainer = train_main(m4_args(os.path.join(work, "train_data"),
                                     os.path.join(runs, tag), mesh, str(device)))
        torch.cuda.synchronize()
        after = kernels.counts()
        out[f"m4_{tag}_losses"] = [h["loss"] for h in trainer.history]
        out[f"m4_{tag}_split"] = (trainer.model.split.lanes, trainer.model.split.rows)
        out[f"m4_{tag}_k1k2"] = tuple(after[k]["kernel"] - before[k]["kernel"]
                                      for k in ("lstm_gate_update", "lstm_gate_update_bwd"))
        out[f"m4_{tag}_save_dir"] = trainer.p.experiment_save_dir
        del trainer
        torch.cuda.empty_cache()
    out["m4_writes"] = writes
    out["counts"] = kernels.counts()
    return out


def phase_mesh(torch, work, card, launched, device="cuda"):
    """(m): two ranks on the one card over gloo (``parallel.run_ranks``),
    each phase held to the same card's single-process run: m1 the golden
    sequence through ``inference2d`` with a {"spatial": 2} recipe, f32 fused
    and int8, 0 px from phases d and d2's runs; m2 the flagship at 512^2, B
    = 1, {"spatial": 2}, bf16 fused (K4 wgmma on blocks of 256 + 4, 128 + 4,
    64 + 4, 32 + 4 rows) and int8 unfused (dynamic scales all-reduced): the
    logits of one frame (bf16 within K4's tolerance, int8 equal), the heights
    each kernel ran at, steady ms/frame; m3 ``run_inference_batched`` with 4
    int8 lanes under {"data": 2}: masks 0 px from the single-process run,
    written by rank 0 alone; m4 flagship training B4 T7 256^2 f32, 3 steps,
    under {"data": 2} and {"spatial": 2}: losses within rtol 2e-4 of the
    single-process run, K1 and K2 launched, rank 1 writing nothing. Adds the
    ranks' launches to ``launched``."""
    from lstm_unet_tpu_torch.cli.train2d import main as train_main
    from lstm_unet_tpu_torch.config import InferenceParams
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine, run_inference_batched
    from lstm_unet_tpu_torch.io.dataset import CTCInferenceReader
    from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu_torch.parallel import run_ranks

    t_phase = time.perf_counter()
    with open(os.path.join(work, "mesh_spatial.json"), "w") as f:
        json.dump({"mesh_shape": {"spatial": 2}}, f)
    frames_dir = os.path.join(work, "flagship", "Synth-N2DH-SIM", "01")
    m3_seqs = [write_ctc_dataset(os.path.join(work, "m3_data"), seq=f"0{i}", num_frames=4,
                                 height=512, width=512, num_cells=40, seed=30 + i)[0]
               for i in range(1, 5)]
    # the single-process runs on this card (m1's are phases d and d2's)
    single = {}
    frames = [f for _, f in CTCInferenceReader(frames_dir, pre_sequence_frames=0,
                                               normalize=False)][:M2_FRAMES]
    frame = torch.rand(1, 512, 512, 1, device=device,
                       generator=torch.Generator(device=device).manual_seed(2))
    for tag, model, kw in m2_models(torch):
        ip = InferenceParams(**kw)
        engine = StreamingInferenceEngine(model, ip, device)
        engine.process_frame(frames[0])
        single[f"m2_{tag}_logits"] = m2_logits(torch, engine, frame).float().cpu().numpy()
        single[f"m2_{tag}_ms"] = step_ms(torch, model, ip, frames, device=device)
        del engine, model
    single["m3_n"] = run_inference_batched(
        InferenceParams(dtype="int8", pre_sequence_frames=1), m3_seqs,
        [os.path.join(work, "m3_single", str(i)) for i in range(len(m3_seqs))],
        device=device, model=flagship_int8_model(torch, False))
    trainer = train_main(m4_args(os.path.join(work, "train_data"),
                                 os.path.join(work, "m4_single"), None, device))
    single["m4_losses"] = [h["loss"] for h in trainer.history]
    del trainer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_RANKS, (work, frames_dir, m3_seqs),
                      device="cuda:0" if device == "cuda" else device, timeout_s=MESH_TIMEOUT_S,
                      work_dir=work)
    secs = time.perf_counter() - t_ranks
    r0, r1 = ranks

    # m1: 0 px from the single-process runs of phases d and d2
    for tag, want in (("f32_fused", "golden_res_1"), ("int8", "golden_int8_dynamic_cuda")):
        if r0[f"m1_{tag}"] != GOLDEN_DATA["num_frames"] or r1[f"m1_{tag}"] != 0:
            raise AssertionError(f"m1 {tag}: masks written {r0[f'm1_{tag}']}, {r1[f'm1_{tag}']}")
        diffs = compare_dirs(f"m1 {tag}", os.path.join(work, f"m1_{tag}_rank0"),
                             os.path.join(work, want), 0)
        if os.path.exists(os.path.join(work, f"m1_{tag}_rank1")):
            raise AssertionError(f"m1 {tag}: rank 1 wrote its output dir")
        log(f"m1 golden {tag} under {{'spatial': 2}}: differing px per frame against the "
            f"single-process run {diffs} (bar: 0 px)")

    # m2: logits, heights, launches by route, ms/frame
    for tag in ("bf16 fused", "int8 unfused"):
        want = single[f"m2_{tag}_logits"]
        for r in ranks:
            got = r[f"m2_{tag}_logits"]
            if tag.startswith("int8"):
                if not np.array_equal(got, want):
                    raise AssertionError(f"m2 int8: logits differ from the single-process run "
                                         f"by {np.abs(got - want).max()}")
                err = 0.0
            else:
                atol, rtol = k4_tolerance(torch, 5, 512, torch.bfloat16)
                err = float(np.abs(got - want).max())
                bad = np.abs(got - want) > atol + rtol * np.abs(want)
                if bad.any():
                    raise AssertionError(f"m2 bf16: {int(bad.sum())} logits outside atol={atol} "
                                         f"rtol={rtol} of the single-process run, max err {err}")
        log(f"m2 flagship 512^2 {tag} under {{'spatial': 2}}: logits max |diff| {err:.3g} "
            f"against the single-process run; rank 0's launches over {M2_FRAMES + 1} frames "
            f"{r0[f'm2_{tag}_launches']}, rank 1's {r1[f'm2_{tag}_launches']}; steady "
            f"{r0[f'm2_{tag}_ms']:.3f} ms/frame on 2 ranks on one card, not a scaling figure "
            f"(single process {single[f'm2_{tag}_ms']:.3f}) [{card}]")
    want = set(r0["m2_want_heights"])
    for key in ("k4", "int8"):
        got = set(r0["m2_heights"][key])
        if not want <= got:
            raise AssertionError(f"m2: {key} ran at heights {sorted(got)}, not on every "
                                 f"halo-extended block {sorted(want)}")
    log(f"m2 block heights: K4 {r0['m2_heights']['k4']}, int8 convs "
        f"{r0['m2_heights']['int8']} (blocks of 256, 128, 64, 32 rows + 2 * halo)")

    # m3: 0 px, rank 0 alone writes
    if (r0["m3_n"], r1["m3_n"]) != (single["m3_n"], 0) or single["m3_n"] != 16:
        raise AssertionError(f"m3: masks {r0['m3_n']}, {r1['m3_n']}, single {single['m3_n']}")
    if os.path.exists(os.path.join(work, "m3_rank1")):
        raise AssertionError("m3: rank 1 wrote its output dir")
    diffs = [compare_dirs(f"m3 lane {i}", os.path.join(work, "m3_rank0", str(i)),
                          os.path.join(work, "m3_single", str(i)), 0) for i in range(4)]
    log(f"m3 int8 flagship 4 lanes under {{'data': 2}}: differing px per lane and frame "
        f"{diffs} (bar: 0 px); rank 1 wrote nothing")

    # m4: losses, K1 and K2, rank 1's writes
    for tag, split in (("data", (True, False)), ("spatial", (False, True))):
        for r in ranks:
            got = r[f"m4_{tag}_losses"]
            if r[f"m4_{tag}_split"] != split or len(got) != 3 or not np.allclose(
                    got, single["m4_losses"], rtol=2e-4, atol=0):
                raise AssertionError(f"m4 {tag}: split {r[f'm4_{tag}_split']}, losses {got} "
                                     f"against {single['m4_losses']} (rtol 2e-4)")
            if min(r[f"m4_{tag}_k1k2"]) == 0:
                raise AssertionError(f"m4 {tag}: K1, K2 launches {r[f'm4_{tag}_k1k2']}")
        saved = sorted(os.listdir(r0[f"m4_{tag}_save_dir"]))
        if "3" not in saved:
            raise AssertionError(f"m4 {tag}: rank 0 saved {saved}")
        log(f"m4 flagship B4 T7 256^2 f32 under {{'{tag}': 2}}: losses "
            f"{[round(v, 6) for v in r0[f'm4_{tag}_losses']]} against the single-process "
            f"{[round(v, 6) for v in single['m4_losses']]} (rtol 2e-4); K1, K2 per rank "
            f"{[r[f'm4_{tag}_k1k2'] for r in ranks]}; rank 0 saved {saved}")
    if r1["m4_writes"]:
        raise AssertionError(f"m4: rank 1 wrote {r1['m4_writes'][:5]}")

    for r in ranks:
        if any(v["plain"] for v in r["counts"].values()):
            raise AssertionError(f"phase m: plain versions ran on a rank: {r['counts']}")
        add_counts(launched, r["counts"])
    ran = {k: r0["counts"][k]["kernel"] + r1["counts"][k]["kernel"] for k in r0["counts"]}
    for k in ("lstm_gate_update", "lstm_gate_update_bwd", "ccl", "fused_convlstm_level_wgmma",
              "fused_convlstm_level_narrow", "conv2d_int8_wgmma", "conv2d_int8_smallk"):
        if ran[k] == 0:
            raise AssertionError(f"phase m: {k} never launched: {ran}")
    log(f"phase m: 2 ranks on one card over gloo, {secs:.1f} s for the ranks "
        f"({time.perf_counter() - t_phase:.1f} s with the single-process runs); launches "
        f"over both ranks {ran}; rank 1 wrote nothing")


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
        from lstm_unet_tpu_torch.ops.kernels import _build, conv_int8
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
        ptxas = f.read().splitlines()
    entry, tensor_core, int8_wgmma, narrow, smallk = None, set(), set(), set(), set()
    for line in ptxas:
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "registers" in line or "spill" in line:
            if "narrow_kernel" not in (entry or "") or "spill" not in line:
                log("  ptxas:", line.strip())
            if entry and ("wgmma_kernel" in entry or "narrow_kernel" in entry
                          or "smallk_kernel" in entry) and "spill" in line:
                if "convlstm_wgmma_kernel" in entry:
                    tensor_core.add("Tf32x3" if "Tf32x3" in entry else "Bf16")
                elif "conv_int8_wgmma_kernel" in entry:
                    int8_wgmma.add(entry)
                elif "convlstm_narrow_kernel" in entry:
                    narrow.add(entry)
                else:
                    smallk.add(entry)
                if "0 bytes spill stores, 0 bytes spill loads" not in line:
                    raise AssertionError(f"a tensor-core kernel spills: {entry}: "
                                         f"{line.strip()}")
    if tensor_core != {"Bf16", "Tf32x3"}:
        raise AssertionError(f"ptxas reported no spill line for K4's {tensor_core} entries")
    # int8 wgmma: x bf16 / f32, y bf16 / f32, its 9 tile configurations, and the
    # gate epilogue's 4 (state, gate) dtype pairs at 256 and 128 columns; K4 narrow:
    # bf16 / 3xTF32, state bf16 / f32, 32 / 16 / 8 features, K 1 / 3 / 5 / 7;
    # int8 small-K: x and y bf16 / f32, one k step or more
    for what, seen, want in (("int8 wgmma", int8_wgmma,
                              4 * sum(map(len, conv_int8.WG_TILE_CHUNKS.values())) + 4 * 2),
                             ("K4 narrow", narrow, 48),
                             ("int8 small-K", smallk, 8)):
        if len(seen) != want:
            raise AssertionError(f"ptxas reported spill lines for {len(seen)} of the {want} "
                                 f"{what} entries")
    log(f"  ptxas: the {len(narrow)} K4 narrow entries spill nothing")

    # (c) kernels vs plain versions; (f) K2
    kernel_summary = phase_kernels(torch)
    kernel_summary.update(phase_conv_int8(torch))
    kernel_summary["conv2d_int8_wgmma"]["wide"] = phase_conv_int8_wide(torch)
    phase_postprocess(torch)
    # (p): the loop kernels, then the sync-free steps, counted from 0
    loop_summary, sync_free = phase_p(torch)
    kernel_summary.update(loop_summary)
    phase_fused_vs_unfused(torch, "float32")
    phase_fused_vs_unfused(torch, "bfloat16")
    kernel_summary["lstm_gate_update_bwd"] = phase_k2(torch)
    for kname, rows in phase_batched_kernels(torch).items():
        kernel_summary[kname]["batched"] = rows

    # (d) + (e): the inference path, counted; (g): the training path, counted
    launched = {}
    add_counts(launched, sync_free)
    with tempfile.TemporaryDirectory() as work:
        kernels.reset_counts()
        phase_golden(torch, work)
        phase_flagship(torch, work, smi)
        inference = kernels.counts()
        for k in ("lstm_gate_update", "ccl", "ccl_grid", "fused_convlstm_level_narrow",
                  "fused_convlstm_level_wgmma", "fused_convlstm_level_tf32x3"):
            if inference[k]["kernel"] == 0:
                raise AssertionError(f"inference path: {k} never launched: {inference}")
        if any(v["plain"] for v in inference.values()):
            raise AssertionError(f"inference path: plain versions ran: {inference}")
        add_counts(launched, inference)
        # (d2) + (e2): the int8 path, counted from 0 on its own
        kernels.reset_counts()
        phase_golden_int8(torch, work)
        phase_flagship_int8(torch, work, smi)
        int8 = kernels.counts()
        for k in ("conv2d_int8_smallk", "conv2d_int8_wgmma", "conv2d_int8_wgmma_gates",
                  "lstm_gate_update", "ccl", "fused_convlstm_level_wgmma",
                  "fused_convlstm_level_narrow"):
            if int8[k]["kernel"] == 0:
                raise AssertionError(f"int8 path: {k} never launched: {int8}")
        if any(v["plain"] for v in int8.values()):
            raise AssertionError(f"int8 path: plain versions ran: {int8}")
        add_counts(launched, int8)
        run_dir = phase_train(torch, work, smi, launched)
        phase_train_rest(torch, work, smi, launched, run_dir)
        # (i) + (j): TTA and reset_on_jump, 4 and 8 lanes a step, counted from 0
        kernels.reset_counts()
        phase_golden_surface(torch, work)
        tta_ms = phase_flagship_tta(torch, work, smi)
        surface = kernels.counts()
        for k in ("lstm_gate_update", "ccl", "fused_convlstm_level_wgmma", "conv2d_int8_smallk",
                  "conv2d_int8_wgmma"):
            if surface[k]["kernel"] == 0:
                raise AssertionError(f"TTA path: {k} never launched: {surface}")
        if any(v["plain"] for v in surface.values()):
            raise AssertionError(f"TTA path: plain versions ran: {surface}")
        add_counts(launched, surface)
        # (k): the sweep, score, soup and import CLIs, counted from 0
        kernels.reset_counts()
        phase_sweep(torch, work, smi, run_dir)
        sweep = kernels.counts()
        for k in ("lstm_gate_update", "ccl"):
            if sweep[k]["kernel"] == 0:
                raise AssertionError(f"sweep path: {k} never launched: {sweep}")
        if any(v["plain"] for v in sweep.values()):
            raise AssertionError(f"sweep path: plain versions ran: {sweep}")
        add_counts(launched, sweep)
        # (n): the workflow scripts on phase g's run, counted from 0
        kernels.reset_counts()
        phase_scripts(torch, work, smi, run_dir)
        scripts = kernels.counts()
        for k in ("lstm_gate_update", "ccl", "fused_convlstm_level_narrow"):
            if scripts[k]["kernel"] == 0:
                raise AssertionError(f"scripts path: {k} never launched: {scripts}")
        if any(v["plain"] for v in scripts.values()):
            raise AssertionError(f"scripts path: plain versions ran: {scripts}")
        log(f"phase n launches in this process: "
            f"{ {k: v['kernel'] for k, v in scripts.items() if v['kernel']} }")
        add_counts(launched, scripts)
        # (o): the port's bench, five runs, each counted
        phase_bench(smi, launched)
        # (m): the meshes, two ranks sharing the card, counted from 0 on the ranks
        phase_mesh(torch, work, smi, launched)
    phase_train_vs_plain(torch)
    # the kernel the small-K int8 route replaced is held against its plain
    # version and timed in (c3), and no main path launches it; every other
    # kernel runs on one
    retired = ("conv2d_int8",)
    for k, v in launched.items():
        if (v["kernel"] == 0) != (k in retired) or v["plain"] != 0:
            raise AssertionError(f"main paths: {k} launched {v['kernel']} times, "
                                 f"plain version {v['plain']} times")

    # source, and the line of the pl.pallas_call it replaces
    sources = {"lstm_gate_update": ("lstm_unet_tpu_torch/csrc/lstm_gates.cu",
                                    "lstm_unet_tpu/ops/pallas/lstm_gates.py:82"),
               "lstm_gate_update_bwd": ("lstm_unet_tpu_torch/csrc/lstm_gates.cu",
                                        "lstm_unet_tpu/ops/pallas/lstm_gates.py:147"),
               "ccl": ("lstm_unet_tpu_torch/csrc/ccl.cu",
                       "lstm_unet_tpu/ops/pallas/ccl.py:94"),
               "ccl_grid": ("lstm_unet_tpu_torch/csrc/ccl.cu",
                            "lstm_unet_tpu/ops/pallas/ccl.py:94"),
               "fused_convlstm_level_wgmma": ("lstm_unet_tpu_torch/csrc/convlstm_wgmma.cu",
                                              "lstm_unet_tpu/ops/pallas/convlstm_cell.py:140"),
               "fused_convlstm_level_tf32x3": ("lstm_unet_tpu_torch/csrc/convlstm_wgmma.cu",
                                               "lstm_unet_tpu/ops/pallas/convlstm_cell.py:140"),
               "fused_convlstm_level_narrow": ("lstm_unet_tpu_torch/csrc/convlstm_narrow.cu",
                                               "lstm_unet_tpu/ops/pallas/convlstm_cell.py:140"),
               "conv2d_int8": ("lstm_unet_tpu_torch/csrc/conv_int8.cu",
                               "lstm_unet_tpu/ops/quant.py:91 (XLA int8 conv; no pallas_call)"),
               "conv2d_int8_wgmma": ("lstm_unet_tpu_torch/csrc/conv_int8_wgmma.cu",
                                     "lstm_unet_tpu/ops/quant.py:91 (XLA int8 conv; no "
                                     "pallas_call)"),
               "conv2d_int8_smallk": ("lstm_unet_tpu_torch/csrc/conv_int8_smallk.cu",
                                      "lstm_unet_tpu/ops/quant.py:91 (XLA int8 conv; no "
                                      "pallas_call)"),
               "grow_into_band": ("lstm_unet_tpu_torch/csrc/postprocess_loops.cu",
                                  "lstm_unet_tpu/ops/postprocess.py:78 (XLA while_loop; no "
                                  "pallas_call)"),
               "erosion_distance": ("lstm_unet_tpu_torch/csrc/postprocess_loops.cu",
                                    "lstm_unet_tpu/ops/postprocess.py:135 (XLA while_loop; "
                                    "no pallas_call)"),
               "split_markers": ("lstm_unet_tpu_torch/csrc/postprocess_loops.cu",
                                 "lstm_unet_tpu/ops/postprocess.py:189-197 (XLA window "
                                 "maxima; no pallas_call)")}
    log("flagship 512^2 steady ms/frame by dtype and lanes: "
        + ", ".join(f"{d} {n} lanes {v:.3f}" for (d, n), v in tta_ms.items()))
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launched[k]["kernel"], **kernel_summary[k]} for k in sources]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
