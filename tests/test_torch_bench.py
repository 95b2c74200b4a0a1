"""The port's bench (``python -m lstm_unet_tpu_torch.bench``) against the
repo's ``bench.py`` (CPU, tiny model at 32²).

The emission contract of ``tests/test_bench_cli.py``, the metric strings,
the frames and probes, the pipeline's labels from the same weights, and the
analytic flop count against ``torch.utils.flop_counter.FlopCounterMode``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import default_net_kernel_params as jax_flagship
from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu_torch import bench as port
from lstm_unet_tpu_torch.checkpoint.convert import params_from_jax
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import make_train_step
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops.kernels import counts, reset_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as ref  # noqa: E402  (the repo's JAX bench, the reference)

TINY = ["--tiny", "--size", "32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at 32² it is as fast as many, and the test
    workers share the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


# ------------------------------------------------ the emission contract


def test_bench_train_mfu_emits_flops_and_mfu(capsys):
    port.bench_train(32, "float32", tiny=True, steps=1, emit=True, remat="none", B=1, T=1,
                     mfu=True, device="cpu")
    (d,) = _lines(capsys)
    assert d["unit"] == "frames/sec/chip" and d["value"] > 0
    assert d["train_flops_per_step"] > 0 and d["train_mfu"] > 0, d
    assert (d["device"], d["power_limit"]) == ("cpu", None)


def test_bench_train_no_mfu_keys_by_default(capsys):
    port.bench_train(32, "float32", tiny=True, steps=1, emit=True, remat="none", B=1, T=1,
                     device="cpu")
    (d,) = _lines(capsys)
    assert "train_flops_per_step" not in d and "train_mfu" not in d


@pytest.mark.parametrize("mfu", [True, False])
def test_stream_line_mfu_keys(mfu, capsys):
    out = port.main(TINY + ["--dtype", "float32", "--frames", "2", "--no-train_too"]
                    + (["--mfu"] if mfu else []))
    (d,) = _lines(capsys)
    assert d == out and d["value"] > 0
    if mfu:
        assert d["flops_per_frame"] == port.conv_flops(tiny_net_kernel_params(), 32, 32) > 0
        assert d["mfu"] > 0
    else:
        assert "flops_per_frame" not in d and "mfu" not in d


# ------------------------------------------------ the reference's strings


@pytest.mark.parametrize("argv", [
    ["--dtype", "float32", "--frames", "2", "--train_batch", "1", "--train_unroll", "1"],
    ["--dtype", "int8", "--batch", "2", "--probe", "half_enc0", "--frames", "2",
     "--no-train_too"],
    ["--mode", "train", "--dtype", "float32", "--remat_policy", "save_outputs",
     "--adam_mu_dtype", "bfloat16", "--train_batch", "1", "--train_unroll", "1"],
], ids=["f32+train", "int8-batch2-probe", "train-mu-bf16"])
def test_metric_strings_equal_the_reference(argv, monkeypatch, capsys):
    """The same arguments give the reference's metric and config strings and
    its keys, plus ``device`` and ``power_limit``. The reference's strings
    depend on its arguments alone, so its model, model step and train step
    are stubbed out here (the pipeline is compared below)."""
    import lstm_unet_tpu.engine.train as jax_train

    def fake_pipeline(size, dtype, tiny, fused_cell, calibrated, ccl, batch, *a):
        return (lambda state, frame: (state, jnp.zeros((batch, size, size), jnp.int32))), None

    def fake_train_step(cfg, opt, class_weights, remat, entry_layouts=False):
        return lambda p, o, s, *a: (p, o, s, {"loss": jnp.zeros(())})

    monkeypatch.setattr(ref, "build_pipeline", fake_pipeline)
    monkeypatch.setattr(ref, "preempt_chip_lease", lambda: None)
    monkeypatch.setattr(jax_train, "make_train_step", fake_train_step)
    monkeypatch.setattr(JaxNet, "init", staticmethod(lambda key, cfg: {}))
    monkeypatch.setattr(JaxNet, "init_state", staticmethod(lambda *a: None))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--tiny", "--size", "32"] + argv)
    ref.main()
    (want,) = _lines(capsys)
    got = port.main(TINY + argv)
    assert _lines(capsys) == [got]
    assert set(got) == set(want) | {"device", "power_limit"}
    for k in ("metric", "unit", "train_unit", "train_config", "train_parity_config"):
        assert got.get(k) == want.get(k), k


# ------------------------------------------------ frames and probes


@pytest.mark.parametrize("batch", [1, 3])
def test_make_frames_equal_the_reference(batch):
    want = ref.make_frames(3, 32, batch)
    got = port.make_frames(3, 32, batch)
    assert got.dtype == want.dtype == np.uint16 and got.shape == (3, batch, 32, 32, 1)
    np.testing.assert_array_equal(got, want)
    (lanes,) = {f.shape for f in port.upload(got, "cpu")}
    assert lanes == (batch, 32, 32)


@pytest.mark.parametrize("probe", ["half_enc0", "half_dec0", "half_l0"])
def test_probe_widths_equal_the_reference(probe):
    want = ref._apply_probe(jax_flagship(), probe).to_dict()
    got = port.net_params(tiny=False, probe=probe).to_dict()
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got != default_net_kernel_params().to_dict()
    with pytest.raises(ValueError):
        port._apply_probe(default_net_kernel_params(), "half_l1")


# ------------------------------------------------ the pipeline


def _jax_init_with_cells(monkeypatch):
    """The reference's init of ``PRNGKey(0)`` with the head scaled and the
    interior class biased, so that the tiny model's masks hold cells (random
    weights give near-uniform probabilities and empty masks); installed for
    the reference's ``build_pipeline``, returned for the port."""
    orig = JaxNet.init

    def init(key, cfg):
        p = orig(key, cfg)
        p["head"]["kernel"] = p["head"]["kernel"] * 200.0
        p["head"]["bias"] = p["head"]["bias"] + jnp.array([0.0, 0.7, 0.0])
        return p

    monkeypatch.setattr(JaxNet, "init", staticmethod(init))
    return init


def _stream_both(monkeypatch, dtype, calibrated):
    """3 frames through the reference's ``build_pipeline`` and the port's on
    the same weights: (reference labels, port labels, the reference's scales,
    the port's own scales). A calibrated port pipeline is built on the
    reference's scales, so the labels compare the int8 pipelines alone."""
    import lstm_unet_tpu.engine.infer as jax_infer
    from lstm_unet_tpu.models import ModelConfig as JaxConfig

    init = _jax_init_with_cells(monkeypatch)
    ref_scales = {}
    calibrate_ref = jax_infer.calibrate_act_scales

    def spy(*a):
        ref_scales.update(calibrate_ref(*a))
        return dict(ref_scales)

    monkeypatch.setattr(jax_infer, "calibrate_act_scales", spy)
    jstep, jstate = ref.build_pipeline(32, dtype, True, calibrated=calibrated)
    jcfg = JaxConfig.make(jax_tiny(), dtype="bfloat16" if dtype == "int8" else dtype)
    state_dict = params_from_jax(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jcfg)))

    def model():
        m = port.make_model(dtype, tiny=True)
        m.load_state_dict(state_dict)
        return m

    own_scales = port.calibrate(model(), 32) if calibrated else None
    monkeypatch.setattr(port, "calibrate", lambda m, size: dict(ref_scales))
    step, state = port.build_pipeline(model(), 32, calibrated=calibrated)
    frames = port.make_frames(3, 32)
    want, got = [], []
    for f, x in zip(frames, port.upload(frames, "cpu")):
        jstate, jl = jstep(jstate, jnp.asarray(f))
        state, labels = step(state, x)
        want.append(np.asarray(jl))
        got.append(labels.numpy())
    return np.stack(want), np.stack(got), ref_scales, own_scales


def test_pipeline_f32_labels_equal_the_reference(monkeypatch):
    want, got, _, _ = _stream_both(monkeypatch, "float32", calibrated=False)
    assert got.dtype == np.int32 and got.shape == (3, 1, 32, 32)
    assert all(f.max() >= 2 for f in want), [f.max() for f in want]  # cells, not an empty mask
    np.testing.assert_array_equal(got, want)


def test_calibration_equals_the_reference_in_f32():
    """``calibrate`` (the bench's 4 synthetic frames through the float model)
    against the reference's ``calibrate_act_scales`` on the same frames, f32:
    every site to rtol 1e-6."""
    import lstm_unet_tpu.engine.infer as jax_infer
    from lstm_unet_tpu.models import ModelConfig as JaxConfig
    from lstm_unet_tpu.io.synthetic import make_cell_sequence as jax_cells

    jcfg = JaxConfig.make(jax_tiny())
    params = JaxNet.init(jax.random.PRNGKey(0), jcfg)
    imgs, _ = jax_cells(num_frames=4, height=32, width=32, num_cells=40, seed=7)
    want = jax_infer.calibrate_act_scales(params, jcfg, [f.astype(np.float32) for f in imgs])
    model = port.make_model("float32", tiny=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = port.calibrate(model, 32)
    assert set(got) == set(want) and len(want) == 9
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k


def test_pipeline_int8_calibrated_matches_the_reference(monkeypatch):
    """int8 with calibrated static scales, in two parts.

    The scales: the calibration runs the bf16 model, whose carried h differs
    from the reference's in single bf16 ulps from the second frame on (XLA's
    and PyTorch's bf16 gate math round apart; ``tests/test_torch_quant.py``
    ``FRAME_BAR``). On these frames 7 of the 9 site scales are equal and 2
    (decoder/1/convs/0, head) one bf16 ulp apart, so each is held to one
    bf16 ulp here; rtol 1e-6 holds in f32 (above). The pipeline: on the
    reference's scales the port's labels equal the reference's bit for bit.
    (With each side's own scales they do not: the one-ulp scales move int8
    codes at two sites and 10-44 px a frame, at smaller head gains too;
    ROADMAP queue 3.)"""
    want, got, ref_scales, own = _stream_both(monkeypatch, "int8", calibrated=True)
    assert set(own) == set(ref_scales) and len(ref_scales) == 9
    for k, v in ref_scales.items():
        ulp = 2.0 ** (np.floor(np.log2(v)) - 7)
        assert abs(own[k] - v) <= ulp, k
    assert all(f.max() >= 2 for f in want)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ the flop count


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_conv_flops_of_the_flagship():
    """PERF.md's 3.969 TFLOP of convs a 512² frame, the four h-convs 2.147;
    the site list against the counter on the flagship's smallest frame."""
    nkp = default_net_kernel_params()
    sites = port.conv_sites(nkp, 512, 512)
    assert len(sites) == 8 + 8 + 8 + 1
    assert port.conv_flops(nkp, 512, 512) == 3969019543552
    assert sum(port._flops(s) for s in sites if s[0].endswith("/h")) == 2147483648000
    model = ULSTMnet2D(ModelConfig.make(nkp), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        n = _counted(lambda: model.step(model.init_state(1, 16, 16), torch.rand(1, 16, 16, 1)))
    assert n == port.conv_flops(nkp, 16, 16)


@pytest.mark.parametrize("batch", [1, 2])
def test_conv_flops_equal_the_flop_counter_forward(batch):
    nkp = tiny_net_kernel_params()
    model = ULSTMnet2D(ModelConfig.make(nkp), generator=torch.Generator().manual_seed(0))
    x = torch.rand(batch, 32, 32, 1)
    with torch.no_grad():
        n = _counted(lambda: model.step(model.init_state(batch, 32, 32), x))
    assert n == batch * port.conv_flops(nkp, 32, 32)


def _train_step(model, remat, b, t, h):
    opt = ClippedAdam(dict(model.named_parameters()), 1e-4, 0.0, skip_nonfinite_updates=False)
    step = make_train_step(model, opt, port.CLASS_WEIGHTS, remat=remat)
    img = torch.full((b, t, h, h, 1), 0.5)
    seg = torch.zeros((b, t, h, h), dtype=torch.int32)
    ones = torch.ones((b, t))
    return lambda: step(model.init_state(b, h, h), img, seg, ones, ones, torch.zeros((b,)))


def test_train_flops_equal_the_flop_counter_with_remat_off():
    """What autograd computes with remat off (the tiny model, B2 T3 32²).
    With full remat the counter also sees the recompute, which the count
    leaves out."""
    nkp = tiny_net_kernel_params()
    model = ULSTMnet2D(ModelConfig.make(nkp), generator=torch.Generator().manual_seed(0))
    assert _counted(_train_step(model, False, 2, 3, 32)) == port.train_flops(nkp, 32, 32, 2, 3)
    assert _counted(_train_step(model, True, 2, 3, 32)) > port.train_flops(nkp, 32, 32, 2, 3)


def test_train_flops_are_the_same_under_every_remat_policy(capsys):
    lines = {}
    for remat in ("none", "full", "save_outputs"):
        out, _ = port.bench_train(32, "float32", tiny=True, steps=1, emit=False, remat=remat,
                                  B=1, T=2, mfu=True, device="cpu")
        lines[remat] = out["train_flops_per_step"]
    assert set(lines.values()) == {port.train_flops(tiny_net_kernel_params(), 32, 32, 1, 2)}
    assert capsys.readouterr().out == ""


# ------------------------------------------------ the device


def test_cuda_without_a_gpu_prints_an_error_line_and_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reset_counts()
    with pytest.raises(SystemExit) as e:
        port.main(["--tiny", "--size", "32", "--frames", "2"])
    assert e.value.code == 1
    (d,) = _lines(capsys)
    assert d["value"] == 0.0 and d["unit"] == "frames/sec/chip" and "error" in d
    # nothing ran: no plain version stood in for a kernel
    assert all(v == {"kernel": 0, "plain": 0} for v in counts().values())
