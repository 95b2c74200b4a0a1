"""The port's training slice against the JAX reference, on the CPU.

Same weights (carried by ``params_from_jax``), same batches and state (made
with numpy from a seed) through both frameworks; the tiny model, 32² crops,
B = 2, T = 3, f32. On the CPU the port's gate update runs the plain
versions of K1 and K2 inside the same autograd Function the GPU uses; the
reference runs its XLA twin. Tolerances:

- loss, accuracy, grad_norm: 1e-5 relative (two f32 summation orders);
- grads: 1e-5 of each leaf's largest magnitude (measured ~1e-6);
- params after Adam steps: 1e-5 absolute at lr 1e-3. Adam's first update is
  lr * g / (|g| + 1e-8), so an element whose grad is near 1e-8 turns grad
  rounding into a visible part of lr (measured ~2e-6);
- the optimizer alone, on the same grads as optax: 1e-6.
"""

import glob
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu import config as jax_config
from lstm_unet_tpu import metrics as jax_metrics
from lstm_unet_tpu.engine.loss import weighted_ce_loss as jax_loss
from lstm_unet_tpu.engine.train import make_eval_step as jax_make_eval_step
from lstm_unet_tpu.engine.train import make_train_step as jax_make_train_step
from lstm_unet_tpu.models import ModelConfig as JaxModelConfig
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu_torch import config, metrics
from lstm_unet_tpu_torch.checkpoint import CheckpointManager
from lstm_unet_tpu_torch.checkpoint.convert import (flatten_tree, opt_state_from_jax,
                                                    opt_state_from_npz, opt_state_to_npz,
                                                    params_from_jax)
from lstm_unet_tpu_torch.cli import inference2d, train2d
from lstm_unet_tpu_torch.engine.loss import weighted_ce_loss
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import (Trainer, check_ported, loss_and_grads,
                                              make_eval_step, make_train_step)
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
from lstm_unet_tpu_torch.io.tiff import read_tiff
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops.kernels import counts, reset_counts

CW = (0.15, 0.25, 0.6)
LR = 1e-3
B, T, H, W = 2, 3, 32, 32
TINY_JSON = json.dumps(config.tiny_net_kernel_params().to_dict())


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _batch(seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 1, (B, T, H, W, 1)).astype(np.float32)
    seg = r.integers(0, 3, (B, T, H, W)).astype(np.int32)
    valid = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    full = np.array([[1, 0, 1], [1, 1, 1]], np.float32)  # a partial frame
    is_last = np.array([1, 0], np.float32)
    return img, seg, valid, full, is_last


def _jax_optimizer():
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(5.0), optax.adam(LR)), 10)


@pytest.fixture(scope="module")
def pair():
    """Reference params and a random nonzero state; the port's model with
    the same weights, and the same state as torch tensors."""
    cfg = JaxModelConfig.make(jax_config.tiny_net_kernel_params())
    params = JaxNet.init(jax.random.PRNGKey(0), cfg)
    r = np.random.default_rng(1)
    state = [[(r.uniform(-1, 1, h.shape).astype(np.float32),
               r.normal(size=c.shape).astype(np.float32)) for (h, c) in lvl]
             for lvl in JaxNet.init_state(cfg, B, H, W)]
    return cfg, params, state


def _port(params):
    model = ULSTMnet2D(ModelConfig.make(config.tiny_net_kernel_params()))
    model.load_state_dict(params_from_jax(flatten_tree(params)))
    return model


def _tstate(state):
    return [[(torch.tensor(h), torch.tensor(c)) for (h, c) in lvl] for lvl in state]


def _jstate(state):
    return [[(jnp.asarray(h), jnp.asarray(c)) for (h, c) in lvl] for lvl in state]


def _copy(tree):
    """A fresh copy of a reference param tree: its train step donates the
    params it is given."""
    return jax.tree_util.tree_map(jnp.copy, tree)


def _assert_params_close(model, jax_params, atol):
    want = params_from_jax(flatten_tree(jax_params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=atol, rtol=0, msg=k)


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("with_full_seg", [False, True])
def test_weighted_ce_loss_matches_jax(with_full_seg):
    r = np.random.default_rng(2)
    logits = r.normal(size=(2, 3, 6, 5, 3)).astype(np.float32)
    labels = r.integers(-1, 3, (2, 3, 6, 5)).astype(np.int32)  # -1: no class
    valid = np.array([[1, 0, 1], [1, 1, 1]], np.float32)
    full = np.array([[0, 1, 1], [1, 0, 1]], np.float32) if with_full_seg else None
    want = jax_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid), CW,
                    None if full is None else jnp.asarray(full))
    got = weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(valid), CW,
                           None if full is None else torch.from_numpy(full))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) < 1e-6


def test_weighted_ce_loss_empty_mask_is_zero():
    logits = torch.zeros(1, 2, 4, 4, 3)
    labels = torch.zeros(1, 2, 4, 4, dtype=torch.int32)  # all background
    loss, acc = weighted_ce_loss(logits, labels, torch.zeros(1, 2), CW)
    assert float(loss) == 0.0 and float(acc) == 0.0
    partial = weighted_ce_loss(logits, labels, torch.ones(1, 2), CW, torch.zeros(1, 2))
    assert float(partial[0]) == 0.0  # a partial frame trains on labelled px only


# ---------------------------------------------------------------- model


def test_remat_gives_the_same_grads(pair):
    cfg, params, state = pair
    img, seg, valid, full, _ = map(torch.from_numpy, _batch(3))
    model = _port(params)
    out = [loss_and_grads(model, _tstate(state), img, seg, valid, full, CW, remat=r)
           for r in (False, True, "full", "save_outputs")]
    for loss, acc, st, grads in out[1:]:
        assert float(loss.detach()) == float(out[0][0].detach())
        for k, g in grads.items():
            torch.testing.assert_close(g, out[0][3][k], atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown remat"):
        model.apply(_tstate(state), img, remat="save_everything")


def test_gradients_flow_through_the_gate_function(pair):
    """Every parameter gets a gradient, and the backward ran K2 (its plain
    version on the CPU) once per ConvLSTM layer and frame."""
    cfg, params, state = pair
    img, seg, valid, full, _ = map(torch.from_numpy, _batch(3))
    reset_counts()
    _, _, _, grads = loss_and_grads(_port(params), _tstate(state), img, seg, valid,
                                    full, CW)
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    ran = counts()
    assert ran["lstm_gate_update_bwd"] == {"kernel": 0, "plain": 2 * T}
    assert ran["lstm_gate_update"] == {"kernel": 0, "plain": 2 * T}


# ---------------------------------------------------------------- train step


def _jax_grads(cfg, params, state, batch):
    img, seg, valid, full, _ = batch

    def loss_fn(p):
        _, logits = JaxNet.apply(p, _jstate(state), jnp.asarray(img), cfg)
        return jax_loss(logits, jnp.asarray(seg), jnp.asarray(valid), CW,
                        jnp.asarray(full))[0]

    return params_from_jax(flatten_tree(jax.grad(loss_fn)(params)))


def test_train_step_matches_jax(pair):
    cfg, params, state = pair
    batch = _batch(4)
    want_grads = _jax_grads(cfg, params, state, batch)
    opt = _jax_optimizer()
    jstep = jax_make_train_step(cfg, opt, CW, remat=True)
    jp, jopt, jst, jm = jstep(_copy(params), opt.init(params), _jstate(state),
                              *map(jnp.asarray, batch))

    model = _port(params)
    tb = tuple(map(torch.from_numpy, batch))
    _, _, _, grads = loss_and_grads(model, _tstate(state), *tb[:4], CW, remat=True)
    for k, g in grads.items():
        torch.testing.assert_close(g, want_grads[k], rtol=0,
                                   atol=1e-5 * float(want_grads[k].abs().max()), msg=k)
    optimizer = ClippedAdam(dict(model.named_parameters()), LR, 5.0, True)
    step = make_train_step(model, optimizer, CW, remat=True)
    st, m = step(_tstate(state), *tb)
    for k in ("loss", "accuracy", "grad_norm"):
        assert _rel(m[k], jm[k]) < 1e-5, k
    _assert_params_close(model, jp, atol=1e-5)
    assert int(optimizer.count) == int(jopt.inner_state[1][0].count) == 1
    for lvl_got, lvl_want in zip(st, jst):
        for (h, c), (jh, jc) in zip(lvl_got, lvl_want):
            assert not h.requires_grad and not c.requires_grad
            assert float(h[0].abs().max()) == float(c[0].abs().max()) == 0.0  # is_last
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)


def test_three_step_trajectory_matches_jax(pair):
    cfg, params, state = pair
    opt = _jax_optimizer()
    jstep = jax_make_train_step(cfg, opt, CW)
    model = _port(params)
    step = make_train_step(model, ClippedAdam(dict(model.named_parameters()), LR, 5.0, True), CW)
    jp, jopt, jst, tst = _copy(params), opt.init(params), _jstate(state), _tstate(state)
    for i in range(3):
        batch = _batch(10 + i)
        jp, jopt, jst, jm = jstep(jp, jopt, jst, *map(jnp.asarray, batch))
        tst, m = step(tst, *map(torch.from_numpy, batch))
        assert _rel(m["loss"], jm["loss"]) < 1e-5, i
        assert _rel(m["grad_norm"], jm["grad_norm"]) < 1e-5, i
    _assert_params_close(model, jp, atol=1e-5)


def test_step_from_a_carried_jax_opt_state(pair):
    """One reference step, then the params and optax state cross over and
    both frameworks take the next step from there."""
    cfg, params, state = pair
    opt = _jax_optimizer()
    jstep = jax_make_train_step(cfg, opt, CW)
    b1, b2 = _batch(20), _batch(21)
    jp, jopt, jst, _ = jstep(_copy(params), opt.init(params), _jstate(state),
                             *map(jnp.asarray, b1))
    model = _port(jp)
    jp, jopt, jst = _copy(jp), _copy(jopt), _copy(jst)  # the next step donates them
    optimizer = ClippedAdam(dict(model.named_parameters()), LR, 5.0, True)
    optimizer.load_state_dict(opt_state_from_jax(jopt))
    assert int(optimizer.count) == 1
    tst = [[(torch.tensor(np.asarray(h)), torch.tensor(np.asarray(c)))
            for (h, c) in lvl] for lvl in jst]
    jp2, jopt2, _, jm = jstep(jp, jopt, jst, *map(jnp.asarray, b2))
    _, m = make_train_step(model, optimizer, CW)(tst, *map(torch.from_numpy, b2))
    assert _rel(m["loss"], jm["loss"]) < 1e-5
    _assert_params_close(model, jp2, atol=1e-5)
    want = opt_state_from_jax(jopt2)
    assert int(optimizer.count) == int(want["count"]) == 2
    for k, v in want["nu"].items():
        torch.testing.assert_close(optimizer.nu[k], v, atol=1e-9, rtol=1e-4)


def test_poisoned_batch_leaves_params_bit_unchanged(pair):
    cfg, params, state = pair
    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = ClippedAdam(dict(model.named_parameters()), LR, 5.0, True)
    img, seg, valid, full, last = map(torch.from_numpy, _batch(5))
    _, m = make_train_step(model, optimizer, CW)(_tstate(state), torch.full_like(img, np.nan),
                                                 seg, valid, full, last)
    assert not np.isfinite(float(m["grad_norm"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(optimizer.count) == 0 and int(optimizer.notfinite_count) == 1
    assert not bool(optimizer.last_finite)


def test_optimizer_matches_optax_on_the_same_grads():
    """Clipping on and off, skipped non-finite steps, and the update applied
    anyway after more than ``max_consecutive_errors`` skips in a row."""
    r = np.random.default_rng(6)
    p0 = {"a": r.normal(size=(3, 4)).astype(np.float32),
          "b": r.normal(size=(5,)).astype(np.float32)}
    opt = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.01)), 3)
    jp, jst = {k: jnp.asarray(v) for k, v in p0.items()}, None
    jst = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = ClippedAdam(tp, 0.01, 1.0, True, max_consecutive_errors=3)
    scales = [0.1, 3.0, np.nan, 0.5, np.nan, np.nan, np.nan, np.nan, 2.0, 0.01]
    for i, s in enumerate(scales):
        g = {k: (r.normal(size=v.shape) * (1.0 if np.isnan(s) else s)).astype(np.float32)
             for k, v in p0.items()}
        if np.isnan(s):
            g["b"][1] = np.nan
        upd, jst = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        gn = topt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        want_gn = optax.global_norm({k: jnp.asarray(v) for k, v in g.items()})
        assert np.isnan(float(gn)) == np.isnan(float(want_gn))
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"step {i} {k}")
        carried = opt_state_from_jax(jst)
        for name in ClippedAdam.SCALARS:
            assert int(getattr(topt, name)) == int(carried[name]), (i, name)
    assert np.isnan(tp["b"][1].item())  # the 4th non-finite step in a row applied


# ---------------------------------------------------------------- eval step


def test_eval_step_matches_jax(pair):
    cfg, params, state = pair
    batch = _batch(7)
    jst, jm, jprobs = jax_make_eval_step(cfg, CW)(params, _jstate(state),
                                                   *map(jnp.asarray, batch))
    st, m, probs = make_eval_step(_port(params), CW)(_tstate(state),
                                                     *map(torch.from_numpy, batch))
    for k in ("loss", "accuracy", "seg_proxy"):
        assert _rel(m[k], jm[k]) < 1e-5 or abs(float(m[k]) - float(jm[k])) < 1e-7, k
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    assert float(st[0][0][0][0].abs().max()) == 0.0


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_manager_keeps_the_newest_and_round_trips(tmp_path, pair):
    cfg, params, _ = pair
    model = _port(params)
    optimizer = ClippedAdam(dict(model.named_parameters()), LR, 5.0, True)
    flat = flatten_tree(params)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (3, 6, 9):
        mgr.save(step, flat, opt_state_to_npz(optimizer.state_dict()))
    assert mgr.all_steps() == [6, 9] and mgr.latest_step() == 9
    got, opt_flat, step = mgr.restore()
    assert step == 9 and sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], np.asarray(flat[k]))
    back = opt_state_from_npz(opt_flat)
    assert sorted(back["mu"]) == sorted(optimizer.mu)
    assert int(back["count"]) == 0 and bool(back["last_finite"])


# ---------------------------------------------------------------- config, metrics


def test_ctc_params_match_reference():
    import dataclasses

    ours = {f.name: f for f in dataclasses.fields(config.CTCParams)}
    ref = {f.name: f for f in dataclasses.fields(jax_config.CTCParams)}
    assert list(ours) == list(ref)
    a, b = config.CTCParams(), jax_config.CTCParams()
    for name in ref:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "net_kernel_params":
            va, vb = va.to_dict(), vb.to_dict()
        assert va == vb, name
    assert json.loads(a.to_json()) == json.loads(b.to_json())


def test_ctc_params_dirs_and_json(tmp_path):
    p = config.CTCParams(root_save_dir=str(tmp_path), experiment_name="E")
    p.resolve_dirs("T0")
    assert p.experiment_save_dir == os.path.join(str(tmp_path), "E_T0", "ckpt")
    assert os.path.isdir(p.experiment_log_dir)
    path = str(tmp_path / "p.json")
    p.save_json(path)
    with open(path) as f:
        saved = json.load(f)
    assert saved["experiment_save_dir"] == p.experiment_save_dir
    assert saved["net_kernel_params"] == json.loads(json.dumps(p.net_kernel_params.to_dict()))
    q = config.CTCParams(dry_run=True, root_save_dir=str(tmp_path / "x"))
    q.resolve_dirs()
    assert not os.path.exists(tmp_path / "x")  # dry_run creates no dir


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_reference(seed):
    r = np.random.default_rng(seed)
    gt = r.integers(0, 5, (24, 24)) * (r.random((24, 24)) < 0.7)
    gt[:8, :8] = 900  # a large, sparse id
    pred = np.where(r.random((24, 24)) < 0.8, gt, r.integers(0, 7, (24, 24)))
    for g, p in ((gt, pred), (gt, np.zeros_like(gt)), (np.zeros_like(gt), pred)):
        assert metrics.seg_measure(g, p) == jax_metrics.seg_measure(g, p)
        assert metrics.det_counts(g, p) == jax_metrics.det_counts(g, p)
    frames = [gt, pred]
    assert (metrics.seg_measure_sequence(frames, frames[::-1])
            == jax_metrics.seg_measure_sequence(frames, frames[::-1]))
    assert (metrics.det_measure_sequence(frames, frames[::-1])
            == jax_metrics.det_measure_sequence(frames, frames[::-1]))


# ---------------------------------------------------------------- trainer, CLI


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3, seed=1)
    return root


def _cli_args(root, save_dir, *extra):
    return ["--device", "cpu", "--root_data_dir", root,
            "--train_sequence_list", "Synth-N2DH-SIM:01",
            "--val_sequence_list", "Synth-N2DH-SIM:01", "--crop_size", "32", "32",
            "--batch_size", "2", "--unroll_len", "3", "--learning_rate", "3e-3",
            "--net_kernel_params", TINY_JSON, "--root_save_dir", save_dir,
            "--print_to_console_interval", "1", *extra]


def test_train_cli_checkpoint_feeds_inference(ctc_root, tmp_path):
    reset_counts()
    trainer = train2d.main(_cli_args(ctc_root, str(tmp_path / "runs"),
                                     "--num_iterations", "4", "--validation_interval", "2",
                                     "--save_checkpoint_iteration", "2"))
    assert [h["step"] for h in trainer.history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert {"seg", "det", "seg_proxy"} <= set(trainer.last_val_metrics)
    ran = counts()
    assert ran["lstm_gate_update_bwd"]["plain"] > 0 and ran["ccl"]["plain"] > 0
    save_dir = trainer.p.experiment_save_dir
    assert CheckpointManager(save_dir).all_steps() == [2, 4]
    assert os.path.exists(os.path.join(save_dir, "train_params.json"))
    run_dir = os.path.dirname(save_dir)
    out = str(tmp_path / "res")
    n = inference2d.main(["--model_path", run_dir, "--sequence_path",
                          os.path.join(ctc_root, "Synth-N2DH-SIM", "01"),
                          "--output_path", out, "--device", "cpu", "--dtype", "float32",
                          "--pre_sequence_frames", "2"])
    masks = sorted(glob.glob(os.path.join(out, "mask*.tif")))
    assert n == len(masks) == 8
    assert read_tiff(masks[0]).shape == (32, 32)
    # the model inference loaded is the last step's
    from lstm_unet_tpu_torch.checkpoint import load_model

    loaded = load_model(run_dir, "cpu")
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, atol=0, rtol=0)
    first = load_model(save_dir, "cpu", step=2)
    assert not torch.equal(first.head.kernel, loaded.head.kernel)


def test_dry_run_writes_nothing(ctc_root, tmp_path):
    trainer = train2d.main(_cli_args(ctc_root, str(tmp_path / "runs"), "--dry_run",
                                     "--num_iterations", "1"))
    assert trainer.ckpt is None and not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("flag", [
    ["--mesh_shape", '{"data": 2}'], ["--conv_method", "dots"], ["--entry_layouts"],
    ["--no-compact_upload"], ["--rss_relaunch_gb", "5"]])
def test_unported_train_flags_raise(flag, tmp_path):
    # --mesh_shape is ported: in one process, a mesh of 2 ranks is refused
    err, match = ((ValueError, "mesh needs 2 ranks, have 1") if flag[0] == "--mesh_shape"
                  else (NotImplementedError, "ROADMAP"))
    with pytest.raises(err, match=match):
        train2d.main(["--device", "cpu", "--root_save_dir", str(tmp_path), *flag])


@pytest.mark.parametrize("knob,value", [("mesh_shape", {"data": 1, "spatial": 2})])
def test_trainer_rejects_unported_knobs(knob, value):
    """The mesh is ported (``check_ported`` takes it); a trainer of one
    process refuses a mesh of 2 ranks before it reads any data."""
    p = config.CTCParams(dry_run=True)
    setattr(p, knob, value)
    assert check_ported(p) is None
    with pytest.raises(ValueError, match="mesh needs 2 ranks, have 1"):
        Trainer(p, device="cpu")


def test_cuda_device_without_a_gpu_raises(ctc_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(config.CTCParams(dry_run=True, root_data_dir=ctc_root), device="cuda")
