"""The port's lag-1 loss-spike guard against the JAX reference's, on the CPU.

Both trainers get the same scripted losses by a patched train step (tiny
model, 32² crops; real checkpoints, so a rollback restores files). They must
roll back at the same steps, log the same EMA at each spike (the reference
keeps its EMA in a local, so its log line is compared, to its 4 decimals)
and raise at the same step once the rollbacks pass ``spike_max_rollbacks``.

The port inspects the pending loss before every save; the reference saves at
an interval before its guard has seen the step just taken
(``lstm_unet_tpu/engine/train.py:684-687``). That repair is asserted on the
port alone: the scripted losses of the parity tests keep spikes off the save
steps, where the two orders differ.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_unet_tpu import config as jax_config
from lstm_unet_tpu.engine.train import Trainer as JaxTrainer
from lstm_unet_tpu_torch import config
from lstm_unet_tpu_torch.checkpoint import CheckpointManager
from lstm_unet_tpu_torch.engine.train import Trainer
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3, seed=2)
    return root


def _kw(root, tmp, **kw):
    d = dict(root_data_dir=root, train_sequence_list=[("Synth-N2DH-SIM", "01")],
             crop_size=(32, 32), batch_size=2, unroll_len=3, root_save_dir=str(tmp),
             print_to_console_interval=10 ** 6, validation_interval=10 ** 6,
             save_checkpoint_iteration=4, write_to_tb_interval=10 ** 6,
             num_prefetch_threads=1, spike_factor=3.0, spike_warmup=3, spike_cooldown=2,
             spike_max_rollbacks=5, experiment_name="spike")
    d.update(kw)
    return d


def _losses(n, spikes):
    """Step (1-based) -> loss: ~1 with a little wobble, ``spikes`` overriding."""
    out = {s: 1.0 + 0.05 * np.sin(s) for s in range(1, n + 1)}
    out.update(spikes)
    return out


def _run_port(root, tmp, n, losses, **kw):
    t = Trainer(config.CTCParams(net_kernel_params=config.tiny_net_kernel_params(),
                                 **_kw(root, tmp, **kw)), seed=0, device="cpu")
    count = [t.global_step]

    def scripted(state, *batch):
        count[0] += 1
        return state, {"loss": torch.tensor(losses[count[0]], dtype=torch.float32),
                       "accuracy": torch.tensor(0.0), "grad_norm": torch.tensor(0.0)}

    t.step_fn = scripted
    try:
        t.train(num_iterations=n)
        err = None
    except RuntimeError as e:
        err = e
    return t, err


def _run_jax(root, tmp, n, losses, **kw):
    t = JaxTrainer(jax_config.CTCParams(
        net_kernel_params=jax_config.tiny_net_kernel_params(), **_kw(root, tmp, **kw)))
    count = [t.global_step]
    rolled = []

    def scripted(params, opt_state, state, *batch):
        count[0] += 1
        return params, opt_state, state, {"loss": jnp.float32(losses[count[0]]),
                                          "accuracy": jnp.float32(0),
                                          "grad_norm": jnp.float32(0)}

    rollback = t._rollback

    def recorded():
        rolled.append(t.global_step - 1)  # the spiked step
        rollback()

    t.step_fn, t._rollback = scripted, recorded
    try:
        t.train(num_iterations=n)
        err = None
    except RuntimeError as e:
        err = e
    return t, rolled, err


_SPIKE = re.compile(r"SPIKE at step \d+: loss=\S+ > \S+ x EMA \S+ — rolling back to last "
                    r"checkpoint \(\d+/\d+\)")


def _spike_lines(text):
    return _SPIKE.findall(text)


def test_rollbacks_and_ema_equal_the_reference(ctc_root, tmp_path, capsys):
    """Spikes at 6 (rolled back), 9 (within the cooldown: absorbed into the
    EMA), 14 (rolled back) and a non-finite loss at 21 (rolled back); none
    on a save step (4, 8, ...)."""
    n = 22
    losses = _losses(n, {6: 10.0, 9: 9.0, 14: 12.0, 21: float("nan")})
    port, err = _run_port(ctc_root, tmp_path / "port", n, losses, spike_cooldown=5)
    port_log = capsys.readouterr().out
    jax_t, rolled, jerr = _run_jax(ctc_root, tmp_path / "jax", n, losses, spike_cooldown=5)
    jax_log = capsys.readouterr().out
    assert err is None and jerr is None
    assert port.spike_guard.rollback_steps == rolled == [6, 14, 21]
    assert _spike_lines(port_log) == _spike_lines(jax_log)
    assert len(_spike_lines(port_log)) == 3
    assert port.global_step == jax_t.global_step == n
    # the EMA by hand: every inspected finite loss that did not spike, but
    # not the step after a rollback (it ran from the spiked weights)
    ema = None
    for s in range(1, n + 1):
        if s in (6, 7, 14, 15, 21, 22):
            continue
        loss = float(np.float32(losses[s]))  # the step reports an f32 loss
        ema = loss if ema is None else 0.98 * ema + 0.02 * loss
    assert port.spike_guard.ema == pytest.approx(ema, rel=1e-12)


def test_too_many_rollbacks_raise_at_the_reference_step(ctc_root, tmp_path, capsys):
    n = 30
    losses = _losses(n, {6: 10.0, 11: 10.0, 15: 10.0})
    port, err = _run_port(ctc_root, tmp_path / "port", n, losses, spike_max_rollbacks=2)
    jax_t, rolled, jerr = _run_jax(ctc_root, tmp_path / "jax", n, losses,
                                   spike_max_rollbacks=2)
    assert "spike guard" in str(err) and "spike guard" in str(jerr)
    assert port.spike_guard.rollback_steps == rolled == [6, 11]
    assert port.spike_guard.aborted
    assert port.global_step == jax_t.global_step == 16


def _run_drifting(root, tmp, n, spikes, **kw):
    """The port with a step that moves every parameter by +1 a step and by
    +1000 on a spike step (whose loss is 100): a saved spiked iterate shows."""
    t = Trainer(config.CTCParams(net_kernel_params=config.tiny_net_kernel_params(),
                                 **_kw(root, tmp, **kw)), seed=0, device="cpu")
    count = [0]

    def scripted(state, *batch):
        count[0] += 1
        spiked = count[0] in spikes
        with torch.no_grad():
            for p in t.model.parameters():
                p.add_(1000.0 if spiked else 1.0)
        loss = 100.0 if spiked else 1.0 + 0.05 * np.sin(count[0])
        return state, {"loss": torch.tensor(loss), "accuracy": torch.tensor(0.0),
                       "grad_norm": torch.tensor(0.0)}

    t.step_fn = scripted
    return t


def _saved_head(t, step):
    params, _, _ = CheckpointManager(t.p.experiment_save_dir).restore(step)
    return params["head/bias"]


def test_no_save_holds_an_uninspected_spiked_iterate(ctc_root, tmp_path):
    """A spike on step 8, a save step: the guard inspects it before the
    save, rolls back to step 4 and saves that iterate. A spike on the last
    step: the final save holds the rolled-back iterate too."""
    t = _run_drifting(ctc_root, tmp_path, 10, {8, 10}, spike_warmup=2, spike_cooldown=1)
    t.train(num_iterations=10)
    assert t.spike_guard.rollback_steps == [8, 10]
    assert CheckpointManager(t.p.experiment_save_dir).all_steps() == [4, 8, 10]
    at4 = _saved_head(t, 4)
    np.testing.assert_array_equal(_saved_head(t, 8), at4)
    np.testing.assert_array_equal(_saved_head(t, 10), at4)
    assert float(np.abs(at4).max()) < 500
    np.testing.assert_array_equal(t.model.head.bias.detach().numpy(), at4)


def test_a_guard_that_gives_up_writes_no_final_save(ctc_root, tmp_path, capsys):
    t = _run_drifting(ctc_root, tmp_path, 12, {6, 10}, spike_warmup=2, spike_cooldown=1,
                      spike_max_rollbacks=1)
    with pytest.raises(RuntimeError, match="spike guard"):
        t.train(num_iterations=12)
    assert "the spike guard gave up" in capsys.readouterr().out
    assert CheckpointManager(t.p.experiment_save_dir).all_steps() == [4, 8]
    for step in (4, 8):
        assert float(np.abs(_saved_head(t, step)).max()) < 500
    assert os.path.exists(os.path.join(t.p.experiment_save_dir, "8"))
