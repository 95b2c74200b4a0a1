"""The rest of the port's training against the JAX reference, on the CPU:
bf16 Adam moments, resume to a total-step target, seeded fine-tune, the
profiler, and the CLI with every training flag at once.

Tiny model, 32² crops, B = 2, T = 3. Tolerances:

- ``ClippedAdam(mu_dtype=bf16)`` against optax on the same grads: ``mu``
  bit-equal, params 1e-6 (as the f32 optimizer test);
- the npz round trip of a bf16 ``mu``: bit-equal;
- three train steps from a carried JAX bf16-``mu`` state: loss 1e-5
  relative, params 1e-5 absolute (as ``test_torch_train.py``);
- step counts, ``target_step.json`` and restored checkpoints: equal.
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
from lstm_unet_tpu.engine.train import Trainer as JaxTrainer
from lstm_unet_tpu.engine.train import make_train_step as jax_make_train_step
from lstm_unet_tpu.models import ModelConfig as JaxModelConfig
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu_torch import config
from lstm_unet_tpu_torch.checkpoint import CheckpointManager
from lstm_unet_tpu_torch.checkpoint.ckpt import OPT_STATE_FILE, average_checkpoints
from lstm_unet_tpu_torch.checkpoint.convert import (flatten_tree, opt_state_from_jax,
                                                    opt_state_from_npz, opt_state_to_npz,
                                                    params_from_jax)
from lstm_unet_tpu_torch.cli import train2d
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import TARGET_FILE, Trainer, make_train_step
from lstm_unet_tpu_torch.io.grain_reader import GrainCTCReaderSequence2D
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D

CW = (0.15, 0.25, 0.6)
B, T, H, W = 2, 3, 32, 32
TINY_JSON = json.dumps(config.tiny_net_kernel_params().to_dict())


def _bits(t):
    """The raw bits of a bf16 tensor or a JAX bf16 array, as uint16."""
    if isinstance(t, torch.Tensor):
        return t.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


# ---------------------------------------------------------------- bf16 moments


def test_bf16_moments_match_optax_bit_for_bit():
    """Three steps above and below the clip norm and one non-finite step
    between them, which leaves the bf16 ``mu`` as it was."""
    r = np.random.default_rng(0)
    p0 = {"a": r.normal(size=(64, 33)).astype(np.float32),
          "b": r.normal(size=(50,)).astype(np.float32)}
    opt = optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(1.0), optax.adam(0.01, mu_dtype=jnp.bfloat16)), 10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = ClippedAdam(tp, 0.01, 1.0, True, mu_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in topt.mu.values())
    for i, s in enumerate([0.1, 3.0, np.nan, 0.5]):
        g = {k: (r.normal(size=v.shape) * (1.0 if np.isnan(s) else s)).astype(np.float32)
             for k, v in p0.items()}
        if np.isnan(s):
            g["b"][1] = np.nan
        before = {k: _bits(m).copy() for k, m in topt.mu.items()}
        upd, jst = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        jmu = jst.inner_state[1][0].mu
        for k in p0:
            assert jmu[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(topt.mu[k]), _bits(jmu[k]),
                                          err_msg=f"step {i} {k}")
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"step {i} {k}")
            if np.isnan(s):
                np.testing.assert_array_equal(_bits(topt.mu[k]), before[k])
    assert int(topt.count) == 3


def test_bf16_moments_round_trip_the_checkpoint_bit_for_bit(tmp_path):
    r = np.random.default_rng(1)
    params = {"encoder.0.lstm.0.kernel_x": torch.tensor(r.normal(size=(8, 1, 5, 5)),
                                                         dtype=torch.float32),
              "head.bias": torch.tensor(r.normal(size=(3,)), dtype=torch.float32)}
    opt = ClippedAdam(params, 1e-3, mu_dtype=torch.bfloat16)
    for _ in range(2):
        opt.step(params, {k: torch.tensor(r.normal(size=v.shape), dtype=torch.float32)
                          for k, v in params.items()})
    flat = opt_state_to_npz(opt.state_dict())
    assert sorted(k for k in flat if "/" in k and k.startswith("mu")) == [
        "mu_bf16_bits/encoder/0/lstm/0/kernel_x", "mu_bf16_bits/head/bias"]
    assert flat["mu_bf16_bits/encoder/0/lstm/0/kernel_x"].shape == (5, 5, 1, 8)  # HWIO
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"x": np.zeros(1, np.float32)}, flat)
    back = opt_state_from_npz(mgr.restore()[1])
    for k, m in opt.mu.items():
        assert back["mu"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(back["mu"][k]), _bits(m))
        assert torch.equal(back["nu"][k], opt.nu[k])
    fresh = ClippedAdam(params, 1e-3, mu_dtype=torch.bfloat16)
    fresh.load_state_dict(back)
    assert all(torch.equal(_t, opt.mu[k]) for k, _t in fresh.mu.items())
    assert int(fresh.count) == 2
    # an f32 optimizer takes the bf16 moments widened, exactly
    wide = ClippedAdam(params, 1e-3)
    wide.load_state_dict(back)
    assert all(torch.equal(wide.mu[k], m.float()) for k, m in opt.mu.items())


@pytest.fixture(scope="module")
def pair():
    cfg = JaxModelConfig.make(jax_config.tiny_net_kernel_params())
    params = JaxNet.init(jax.random.PRNGKey(0), cfg)
    r = np.random.default_rng(1)
    state = [[(r.uniform(-1, 1, h.shape).astype(np.float32),
               r.normal(size=c.shape).astype(np.float32)) for (h, c) in lvl]
             for lvl in JaxNet.init_state(cfg, B, H, W)]
    return cfg, params, state


def _batch(seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 1, (B, T, H, W, 1)).astype(np.float32)
    seg = r.integers(0, 3, (B, T, H, W)).astype(np.int32)
    valid = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    full = np.array([[1, 0, 1], [1, 1, 1]], np.float32)
    is_last = np.array([0, 0], np.float32)
    return img, seg, valid, full, is_last


def test_three_steps_from_a_carried_jax_bf16_state(pair):
    """One reference step with ``adam(mu_dtype=bf16)``; its params and optax
    state (bf16 ``mu``) cross over and both frameworks take three more."""
    cfg, params, state = pair
    opt = optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(5.0), optax.adam(1e-3, mu_dtype=jnp.bfloat16)), 10)
    jstep = jax_make_train_step(cfg, opt, CW)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    jst = [[(jnp.asarray(h), jnp.asarray(c)) for (h, c) in lvl] for lvl in state]
    jp, jopt, jst, _ = jstep(copy(params), opt.init(params), jst,
                             *map(jnp.asarray, _batch(30)))
    model = ULSTMnet2D(ModelConfig.make(config.tiny_net_kernel_params()))
    model.load_state_dict(params_from_jax(flatten_tree(jp)))
    optimizer = ClippedAdam(dict(model.named_parameters()), 1e-3, 5.0, True,
                            mu_dtype=torch.bfloat16)
    carried = opt_state_from_jax(jopt)
    assert all(m.dtype == torch.bfloat16 for m in carried["mu"].values())
    optimizer.load_state_dict(carried)
    jmu = flatten_tree(jopt.inner_state[1][0].mu)
    for k, m in params_from_jax(jmu).items():
        np.testing.assert_array_equal(_bits(optimizer.mu[k]), _bits(m))
    jp, jopt, jst = copy(jp), copy(jopt), copy(jst)
    tst = [[(torch.tensor(np.asarray(h)), torch.tensor(np.asarray(c))) for (h, c) in lvl]
           for lvl in jst]
    step = make_train_step(model, optimizer, CW)
    for i in range(3):
        batch = _batch(31 + i)
        jp, jopt, jst, jm = jstep(jp, jopt, jst, *map(jnp.asarray, batch))
        tst, m = step(tst, *map(torch.from_numpy, batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"])), i
    want = params_from_jax(flatten_tree(jp))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=1e-5, rtol=0, msg=k)
    assert int(optimizer.count) == 4


# ---------------------------------------------------------------- resume


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3, seed=1)
    return root


def _kw(root, tmp, **kw):
    d = dict(root_data_dir=root, train_sequence_list=[("Synth-N2DH-SIM", "01")],
             crop_size=(32, 32), batch_size=2, unroll_len=3, learning_rate=3e-3,
             root_save_dir=str(tmp), print_to_console_interval=1,
             validation_interval=10 ** 6, save_checkpoint_iteration=10 ** 6,
             write_to_tb_interval=10 ** 6, num_prefetch_threads=1)
    d.update(kw)
    return d


def _port(root, tmp, seed=0, **kw):
    p = config.CTCParams(net_kernel_params=config.tiny_net_kernel_params(),
                         **_kw(root, tmp, **kw))
    return Trainer(p, seed=seed, device="cpu")


def _target(trainer):
    with open(os.path.join(trainer.p.experiment_save_dir, TARGET_FILE)) as f:
        return json.load(f)


def _assert_restored(trainer, step):
    """The trainer's params and moments equal step ``step``'s files."""
    d = os.path.join(trainer.p.experiment_save_dir, str(step))
    with np.load(os.path.join(d, "params.npz")) as f:
        want = params_from_jax({k: f[k] for k in f.files})
    with np.load(os.path.join(d, OPT_STATE_FILE)) as f:
        opt = opt_state_from_npz({k: f[k] for k in f.files})
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in trainer.optimizer.mu.items():
        assert torch.equal(v, opt["mu"][k]) and torch.equal(trainer.optimizer.nu[k],
                                                              opt["nu"][k]), k
    assert int(trainer.optimizer.count) == int(opt["count"])


def test_fresh_run_then_relaunches_train_to_the_target(ctc_root, tmp_path):
    t = _port(ctc_root, tmp_path, num_iterations=6, experiment_name="R")
    assert (t.target_step, t.initial_step, _target(t)) == (
        6, 0, {"target_step": 6, "initial_step": 0})
    t.train(num_iterations=3)  # cut short: the final save is step 3
    t2 = _port(ctc_root, tmp_path, seed=1, num_iterations=6, continue_run=True,
               experiment_name="R")
    assert t2.p.experiment_save_dir == t.p.experiment_save_dir
    assert t2.global_step == 3
    _assert_restored(t2, 3)
    t2.train()
    assert t2.global_step == 6
    t3 = _port(ctc_root, tmp_path, seed=2, num_iterations=6, continue_run=True,
               experiment_name="R")
    t3.train()  # at the target: no step
    assert t3.global_step == 6 and t3.history == []
    # a raised num_iterations extends the run and is kept for later relaunches
    t4 = _port(ctc_root, tmp_path, seed=3, num_iterations=8, continue_run=True,
               experiment_name="R")
    t4.train()
    assert t4.global_step == 8 and _target(t4) == {"target_step": 8, "initial_step": 0}


def test_seeded_fine_tune_and_its_relaunch(ctc_root, tmp_path):
    seed = _port(ctc_root, tmp_path, experiment_name="seed", num_iterations=4)
    seed.train()
    ft = _port(ctc_root, tmp_path, seed=1, experiment_name="ft", num_iterations=5,
               load_checkpoint=True, load_checkpoint_path=os.path.dirname(
                   seed.p.experiment_save_dir))  # a run dir resolves to its ckpt dir
    assert ft.global_step == 4 and ft.target_step == 9
    assert _target(ft) == {"target_step": 9, "initial_step": 4}
    for k, v in seed.model.state_dict().items():
        assert torch.equal(ft.model.state_dict()[k], v), k
    ft.train(num_iterations=2)  # final save: step 6
    # the supervisor's relaunch: same flags + continue_run; the run's own
    # checkpoint outranks the seed, and the target stays seed + budget
    ft2 = _port(ctc_root, tmp_path, seed=2, experiment_name="ft", num_iterations=5,
                continue_run=True, load_checkpoint=True,
                load_checkpoint_path=seed.p.experiment_save_dir)
    assert ft2.global_step == 6 and ft2.target_step == 9
    _assert_restored(ft2, 6)
    ft2.train()
    assert ft2.global_step == 9
    # a relaunch before the fine-tune's first save still starts from the seed
    ft3 = _port(ctc_root, tmp_path, seed=3, experiment_name="ft_nosave",
                num_iterations=5, continue_run=True, load_checkpoint=True,
                load_checkpoint_path=seed.p.experiment_save_dir)
    assert ft3.global_step == 4 and ft3.target_step == 9


def test_run_dir_without_a_target_file_takes_num_iterations_as_total(ctc_root, tmp_path):
    t = _port(ctc_root, tmp_path, experiment_name="legacy", num_iterations=3)
    t.train()
    os.remove(os.path.join(t.p.experiment_save_dir, TARGET_FILE))
    t2 = _port(ctc_root, tmp_path, seed=1, experiment_name="legacy", num_iterations=5,
               continue_run=True)
    assert t2.global_step == 3 and t2.target_step is None
    t2.train()
    assert t2.global_step == 5
    assert not os.path.exists(os.path.join(t.p.experiment_save_dir, TARGET_FILE))


def test_run_dir_without_a_checkpoint_warns_and_starts_fresh(ctc_root, tmp_path, capsys):
    _port(ctc_root, tmp_path, experiment_name="early", num_iterations=4)  # never trained
    t = _port(ctc_root, tmp_path, seed=1, experiment_name="early", num_iterations=4,
              continue_run=True)
    assert "no checkpoint under" in capsys.readouterr().out
    assert t.global_step == 0 and t.target_step == 4
    t.train()
    assert t.global_step == 4


def test_a_params_only_seed_is_refused(ctc_root, tmp_path):
    seed = _port(ctc_root, tmp_path, experiment_name="s", num_iterations=2,
                 save_checkpoint_iteration=1)
    seed.train()
    soup = str(tmp_path / "soup")
    average_checkpoints(seed.p.experiment_save_dir, soup)
    with pytest.raises(FileNotFoundError, match="opt_state.npz"):
        _port(ctc_root, tmp_path, experiment_name="ft", load_checkpoint=True,
              load_checkpoint_path=soup)


def _jax_trainer(root, tmp, **kw):
    p = jax_config.CTCParams(net_kernel_params=jax_config.tiny_net_kernel_params(),
                             **_kw(root, tmp, **kw))
    return JaxTrainer(p, seed=0)


def test_step_counts_and_target_files_equal_the_reference(ctc_root, tmp_path):
    """The same launches of both trainers: a fresh run cut short, a
    relaunch, a relaunch with a raised ``num_iterations``."""
    got, want = [], []
    for make, out, sub in ((_port, got, "port"), (_jax_trainer, want, "jax")):
        tmp = tmp_path / sub
        t = make(ctc_root, tmp, num_iterations=5, experiment_name="P")
        t.train(num_iterations=2)
        out.append((t.global_step, _target(t)))
        for n in (5, 7):
            t = make(ctc_root, tmp, num_iterations=n, experiment_name="P",
                     continue_run=True)
            out.append((t.global_step,))
            t.train()
            out.append((t.global_step, _target(t)))
    assert got == want
    assert got[-1] == (7, {"target_step": 7, "initial_step": 0})


# ---------------------------------------------------------------- profile


def test_profile_writes_a_trace_of_steps_11_to_16(ctc_root, tmp_path):
    t = _port(ctc_root, tmp_path, experiment_name="prof", num_iterations=16, profile=True,
              print_to_console_interval=100)
    t.train()
    traces = glob.glob(os.path.join(t.p.experiment_log_dir, "trace_steps_*.json"))
    assert traces == [t.profile_path] == [os.path.join(t.p.experiment_log_dir,
                                                       "trace_steps_11-16.json")]
    with open(traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("convolution" in n for n in names)
    # the port's own spans, in rows of their own, one train.step a traced step
    mine = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    steps = [e for e in mine if e["name"] == "train.step"]
    assert len({e["tid"] for e in mine}) == 2 and len(steps) == 2 * 6
    assert {"train.forward", "train.backward", "train.optimizer", "trainer.get_batch",
            "trainer.put"} <= {e["name"] for e in mine}


def test_profile_stops_when_the_run_ends_early(ctc_root, tmp_path):
    t = _port(ctc_root, tmp_path, experiment_name="prof_short", num_iterations=12,
              profile=True, print_to_console_interval=100)
    t.train()
    assert t.profile_path.endswith("trace_steps_11-12.json")
    assert os.path.exists(t.profile_path)


# ---------------------------------------------------------------- the CLI


def test_cli_resume_with_every_training_knob(ctc_root, tmp_path):
    """The deterministic provider, elastic augmentation (through the
    recipe), bf16 moments and the save_outputs remat policy: 4 steps saving
    at 2 and 4, a relaunch to 6, and 6 steps uninterrupted. The relaunch
    restores step 4 bit for bit and reads the uninterrupted run's batches of
    steps 5 and 6."""
    recipe = str(tmp_path / "recipe.json")
    with open(recipe, "w") as f:
        json.dump({"elastic_augmentation": True}, f)

    def args(name, steps, *extra):
        return ["--device", "cpu", "--root_data_dir", ctc_root,
                "--train_sequence_list", "Synth-N2DH-SIM:01", "--crop_size", "32", "32",
                "--batch_size", "2", "--unroll_len", "3", "--net_kernel_params", TINY_JSON,
                "--root_save_dir", str(tmp_path / "runs"), "--experiment_name", name,
                "--num_iterations", str(steps), "--save_checkpoint_iteration", "2",
                "--print_to_console_interval", "1", "--recipe", recipe,
                "--data_provider_class", "GrainCTCReaderSequence2D",
                "--adam_mu_dtype", "bfloat16", "--remat", "--remat_policy", "save_outputs",
                "--spike_factor", "50", "--spike_cooldown", "3", "--spike_max_rollbacks", "2",
                *extra]

    first = train2d.main(args("cut", 4))
    assert first.p.elastic_augmentation and first.p.spike_factor == 50
    assert isinstance(first.reader, GrainCTCReaderSequence2D)
    assert all(m.dtype == torch.bfloat16 for m in first.optimizer.mu.values())
    seen = []
    orig_get = GrainCTCReaderSequence2D.get_batch

    def recording(self):
        batch = orig_get(self)
        seen.append(batch)
        return batch

    GrainCTCReaderSequence2D.get_batch = recording
    try:
        from lstm_unet_tpu_torch.engine import train as engine_train

        restored = {}
        orig_restore = engine_train.Trainer._restore

        def restore(self, path):
            orig_restore(self, path)
            restored["params"] = {k: v.clone() for k, v in self.model.state_dict().items()}
            restored["mu"] = {k: v.clone() for k, v in self.optimizer.mu.items()}
            restored["step"] = self.global_step

        engine_train.Trainer._restore = restore
        try:
            resumed = train2d.main(args("cut", 6, "--continue_run"))
        finally:
            engine_train.Trainer._restore = orig_restore
    finally:
        GrainCTCReaderSequence2D.get_batch = orig_get
    assert resumed.p.experiment_save_dir == first.p.experiment_save_dir
    assert restored["step"] == 4 and resumed.global_step == 6
    d = os.path.join(first.p.experiment_save_dir, "4")
    with np.load(os.path.join(d, "params.npz")) as f:
        want = params_from_jax({k: f[k] for k in f.files})
    with np.load(os.path.join(d, OPT_STATE_FILE)) as f:
        assert "mu_bf16_bits/head/kernel" in f.files
        want_mu = opt_state_from_npz({k: f[k] for k in f.files})["mu"]
    for k, v in restored["params"].items():
        assert torch.equal(v, want[k]), k
    for k, v in restored["mu"].items():
        np.testing.assert_array_equal(_bits(v), _bits(want_mu[k]), err_msg=k)
    assert _target(resumed) == {"target_step": 6, "initial_step": 0}
    whole = train2d.main(args("whole", 6))
    assert len(seen) == 2
    for step, batch in zip((4, 5), seen):  # global steps 5 and 6
        for a, b in zip(batch, whole.reader.make_batch(step)):
            np.testing.assert_array_equal(a, b)
    assert [h["step"] for h in resumed.history] == [5, 6]
    for h, w in zip(resumed.history, whole.history[4:]):
        # the resumed run starts with a fresh LSTM state, the other carries it
        assert abs(h["loss"] - w["loss"]) <= 1e-2 * abs(w["loss"])
