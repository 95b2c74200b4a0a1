"""The harness's pieces at a tiny size on the CPU: the frozen traffic and
arithmetic against the port's originals and a flop counter, the weights
against the port's model, the plain reference against the port's plain
path, and a cell, a configuration and a metric added as files."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import arith, cell, traffic, weights
from portbench.reference import model as ref_model
from portbench.reference import postprocess as ref_post

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FILE = json.load(open(os.path.join(ROOT, "portbench", "configs", "flagship-int8.json")))
FLAGSHIP = cell.as_run(FILE)
TINY = dict(FLAGSHIP, lstm_kernels=[[[3, 8]], [[3, 16]]], down_conv_kernels=[[[3, 8]], [[3, 16]]],
            up_conv_kernels=[[[3, 8]], [[3, 16]]])


def _widths(cfg):
    from lstm_unet_tpu_torch.config import NetKernelParams

    return NetKernelParams.from_dict({k: cfg[k] for k in
                                      ("lstm_kernels", "down_conv_kernels", "up_conv_kernels")})


# ------------------------------------------------------------ traffic


def test_the_sequence_is_the_ports_and_made_by_the_seed():
    from lstm_unet_tpu_torch.io import synthetic

    seed = 2 ** 33 + 17
    imgs, labs = traffic.make_cell_sequence(5, 48, 40, 6, seed)
    want = synthetic.make_cell_sequence(num_frames=5, height=48, width=40, num_cells=6, seed=seed)
    assert np.array_equal(imgs, want[0]) and np.array_equal(labs, want[1])
    assert not np.array_equal(imgs, traffic.make_cell_sequence(5, 48, 40, 6, seed + 1)[0])


def test_the_three_class_target_and_normalisation_are_the_ports():
    from lstm_unet_tpu_torch.io import preprocess

    imgs, labs = traffic.make_cell_sequence(2, 48, 48, 6, 3)
    for img, lab in zip(imgs, labs):
        assert np.array_equal(traffic.instance_to_three_class(lab),
                              preprocess.instance_to_three_class(lab))
        assert np.array_equal(traffic.percentile_normalize(img),
                              preprocess.percentile_normalize_np(img))


def test_the_configuration_files_decoder_is_run_by_level():
    """The file's decoder stacks, deepest first and ending in the output
    conv, are run shallowest first with that conv as the head."""
    assert FILE["up_conv_kernels"][-1][-1] == [1, 3]
    assert FLAGSHIP["up_conv_kernels"] == [[[5, 32], [5, 32]], [[5, 64], [5, 64]],
                                           [[5, 128], [5, 128]], [[5, 256], [5, 256]]]
    assert {k: v for k, v in FLAGSHIP.items() if k != "up_conv_kernels"} == \
        {k: v for k, v in FILE.items() if k != "up_conv_kernels"}
    assert arith.conv_sites(FLAGSHIP, 64, 64)[-1] == ("head", 64, 64, 1, 32, 3)
    with pytest.raises(ValueError, match="output conv"):
        cell.as_run(dict(FILE, up_conv_kernels=FILE["up_conv_kernels"][::-1]))


def test_a_stream_serves_one_model_and_its_seed_picks_the_sequence():
    from portbench.harness import stream

    c = cell.load("stream-int8-b1")
    assert stream.model_seed(c, 5) == stream.model_seed(c, 2 ** 40) == c.traffic["model_seed"]
    tr = dict(c.traffic, frames=2, height=64, width=64, cells=4)
    assert not np.array_equal(traffic.sequence(tr, 5)[0], traffic.sequence(tr, 6)[0])
    train = cell.load("train-bf16-b5t7")
    assert stream.model_seed(train, 5) == 5


def test_training_batches_walk_the_sequence_window_by_window():
    tr = dict(frames=12, height=64, width=64, cells=4, batch=3, unroll=4, crop=[32, 32])
    batches = traffic.train_batches(tr, 9)
    got = [next(batches) for _ in range(4)]
    img, seg, valid, full, last = got[0]
    assert img.shape == (3, 4, 32, 32, 1) and img.dtype == np.float32
    assert seg.shape == (3, 4, 32, 32) and seg.dtype == np.int32 and seg.max() <= 2
    assert valid.shape == full.shape == (3, 4) and last.shape == (3,)
    assert [b[4][0] for b in got] == [0.0, 0.0, 1.0, 0.0]  # 3 windows, then the first again
    assert not np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][0], got[3][0])
    assert not np.array_equal(img[0], img[1])  # each lane its own crop
    late = traffic.train_batches(dict(tr, first_window=1), 9)
    assert [next(late)[4][0] for _ in range(3)] == [0.0, 1.0, 0.0]  # crosses the end


# ------------------------------------------------------------ arithmetic


@pytest.mark.parametrize("cfg", [TINY, FLAGSHIP], ids=["tiny", "flagship"])
def test_conv_flops_are_the_ports_and_a_flop_counters(cfg):
    from lstm_unet_tpu_torch import bench

    assert arith.conv_flops(cfg, 32, 48) == bench.conv_flops(_widths(cfg), 32, 48)
    assert [s[0] for s in arith.conv_sites(cfg, 32, 48)] == \
        [s[0] for s in bench.conv_sites(_widths(cfg), 32, 48)]
    w = weights.make_weights(cfg, 1, "cpu")
    ref = ref_model.Reference(cfg, w)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.step(ref.init_state(2, 32, 48, "cpu"), torch.rand(2, 1, 32, 48))
    assert fc.get_total_flops() == 2 * arith.conv_flops(cfg, 32, 48)


def test_train_flops_are_a_flop_counters_of_a_step_without_remat():
    w = {k: v.requires_grad_(True) for k, v in weights.make_weights(TINY, 1, "cpu").items()}
    ref = ref_model.Reference(TINY, w)
    b, t, h, wd = 2, 3, 16, 16
    with FlopCounterMode(display=False) as fc:
        state = ref.init_state(b, h, wd, "cpu")
        loss = 0.0
        for _ in range(t):
            state, logits = ref.step(state, torch.rand(b, 1, h, wd))
            loss = loss + logits.square().mean()
        torch.autograd.grad(loss, list(w.values()))
    assert fc.get_total_flops() == arith.train_flops(TINY, h, wd, b, t)


def test_the_int8_conv_bound_is_the_kernel_tables():
    # PERF.md section 6: one unfused frame of the port's default net (its
    # 3x3 reconstruction of the flagship), 25 sites, 2.1060 ms
    from lstm_unet_tpu_torch.config.params import default_net_kernel_params

    widths = default_net_kernel_params().to_dict()
    assert arith.int8_conv_bound_s(widths, 512, 512, 1, False) * 1e3 == \
        pytest.approx(2.1060, abs=5e-5)


def test_kinds_of_kernels():
    assert arith.kind("void conv_int8_wgmma_kernel<...>") == "int8 conv wgmma"
    assert arith.kind("gate_update_bwd_kernel") == "K2"
    assert arith.kind("gate_update_kernel") == "K1"
    assert arith.kind("ccl_cluster") == "K3"
    assert arith.kind("sm90_xmma_fprop_implicit_gemm") == "conv"
    assert arith.kind("sm90_xmma_wgrad_implicit_gemm") == "conv backward"
    assert arith.kind("vectorized_elementwise_kernel") == "elementwise/other"


# ------------------------------------------------------------ weights


def test_weights_fit_the_ports_model_by_name():
    from portbench.harness import port

    w = weights.make_weights(TINY, 5, "cpu")
    model = port.load_model(TINY, w, "cpu")
    got = dict(model.named_parameters())
    assert set(got) == set(w)
    assert all(torch.equal(got[k], w[k]) for k in w)
    assert all(torch.equal(a, b) for a, b in zip(w.values(),
                                                 weights.make_weights(TINY, 5, "cpu").values()))
    bf16 = weights.make_weights(dict(TINY, weights_dtype="bfloat16"), 5, "cpu")
    assert all(torch.equal(v, v.bfloat16().float()) for v in bf16.values())


def test_the_fitted_head_makes_instances():
    frames, _ = traffic.make_cell_sequence(4, 64, 64, 4, 3)
    x = [torch.from_numpy(traffic.percentile_normalize(f))[None, None] for f in frames]
    w = weights.make_weights(TINY, 3, "cpu")
    head = weights.fit_head(TINY, w, x)
    assert head["head.kernel"].shape == w["head.kernel"].shape
    ref = ref_model.Reference(TINY, dict(w, **head))
    state = ref.init_state(1, 64, 64, "cpu")
    for f in x:
        with torch.no_grad():
            state, logits = ref.step(state, f)
    probs = torch.softmax(logits, 1)[0].permute(1, 2, 0).numpy()
    interior = (probs[..., 1] > 0.5).mean()
    assert 0.05 < interior < 0.4


# ------------------------------------------------------------ the reference


@pytest.mark.parametrize("quant,atol", [("none", 1e-5), ("int8", 2e-3)])
def test_the_reference_is_the_ports_plain_path_in_f32(quant, atol):
    from portbench.harness import port

    cfg = dict(TINY, dtype="float32", quant=quant)
    frames, _ = traffic.make_cell_sequence(4, 32, 32, 3, 2)
    w = weights.make_weights(cfg, 2, "cpu")
    model = port.serving_model(cfg, w, list(frames[:2]), "cpu")
    absmax = None
    if quant == "int8":
        absmax = ref_model.Reference(cfg, w).calibrate(
            [torch.from_numpy(traffic.percentile_normalize(f))[None, None] for f in frames[:2]])
    ref = ref_model.Reference(cfg, w, "int8" if quant == "int8" else "float", absmax)
    state_p, state_r = model.init_state(1, 32, 32), ref.init_state(1, 32, 32, "cpu")
    with torch.no_grad():
        for f in frames:
            x = torch.from_numpy(traffic.percentile_normalize(f))
            state_p, lp = model.step(state_p, x[None, ..., None])
            state_r, lr = ref.step(state_r, x[None, None])
            torch.testing.assert_close(lp.permute(0, 3, 1, 2), lr, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("knobs", [dict(grow_iters=3), dict(grow_iters=0),
                                   dict(grow_iters=3, instance_split=True)])
def test_the_reference_postprocess_is_the_ports(knobs):
    from lstm_unet_tpu_torch.io.synthetic import cell_like_probs
    from lstm_unet_tpu_torch.ops.postprocess import postprocess_frame

    probs, _ = cell_like_probs(128, 112, num_cells=25, seed=4, radius=(3.0, 6.0))
    params = dict(ref_post.DEFAULTS, **knobs)
    want = postprocess_frame(torch.from_numpy(probs), **{
        k: params[k] for k in ("cell_thresh", "edge_thresh", "min_cell_size", "grow_iters",
                               "instance_split", "split_window", "split_min_dist",
                               "split_slack", "split_rel", "split_rel_window")}).numpy()
    got = ref_post.postprocess(probs, params)
    assert want.max() > 5 and np.array_equal(got, want)


def test_label_mismatch():
    a = np.zeros((8, 8), np.int32)
    a[1:4, 1:4], a[5:7, 5:7] = 3, 9
    b = np.where(a == 3, 1, np.where(a == 9, 2, 0))
    assert ref_post.label_mismatch(a, b) == 0.0
    c = b.copy()
    c[5:7, 5:7] = 0
    assert ref_post.label_mismatch(a, c) == pytest.approx(4 / 13)
    assert ref_post.label_mismatch(a, np.zeros_like(a)) == 1.0


# ------------------------------------------------------------ found by name


def test_a_cell_a_configuration_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    snapshot = {p: open(p, "rb").read() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cfg = dict(FILE, dtype="float32")
    (tmp_path / "portbench" / "configs" / "flagship-int8-new.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench" / "traffic" / "stream-new.json").write_text(json.dumps(
        {"mode": "stream", "frames": 8, "height": 256, "width": 256, "cells": 9, "lanes": 1,
         "calibration_frames": 2, "check_frames": 4, "inference": {"save_intermediate": True}}))
    (tmp_path / "portbench" / "workloads" / "stream-new-cell.json").write_text(json.dumps(
        {"config": "flagship-int8-new", "traffic": "stream-new", "chips": 1, "why": "a new one",
         "limits": {"prob_gap": 0.1}}))
    (tmp_path / "portbench" / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench["workloads"].append({"name": "stream-new-cell", "config": "flagship-int8-new",
                               "traffic": "stream-new", "chips": 1, "why": "a new one"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "stream_fps" == m["name"]:
            m["workloads"].append("stream-new-cell")
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "stream_fps",
                               "workloads": ["stream-new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = cell.load("stream-new-cell", str(tmp_path))
    assert found.config["dtype"] == "float32" and found.traffic["height"] == 256
    assert found.workload["limits"] == {"prob_gap": 0.1}
    assert [m["name"] for m in found.per_layer()] == ["frames_seen"]
    assert "stream_fps" in [m["name"] for m in found.end_to_end()]
    assert cell.metric_reader("frames_seen", str(tmp_path))(type("R", (), {"units": 7})) == 7.0
    for path, data in snapshot.items():  # no file that was there changed
        assert open(path, "rb").read() == data


def test_the_benchmark_names_every_file_it_uses():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        wl = json.load(open(os.path.join(ROOT, "portbench", "workloads", w["name"] + ".json")))
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
