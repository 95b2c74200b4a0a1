"""Faults of the port against the reference, each with the test that holds
its repair (CPU, tiny model):

- a train step that raises part way must not overwrite the last good
  checkpoint with a half-updated iterate;
- ``async_checkpoint`` (default on) writes interval saves from a device-side
  copy on a thread, giving the files a synchronous save gives;
- validation writes the reference's ``val/input``, ``val/gt``, ``val/pred``
  images;
- ``inference2d``'s recipe check reads a ``mesh_shape`` of ``{"data": 1}`` as
  no mesh, as the trainer does;
- ``ParamsBase.from_json / load_json / from_dict / resolve_continue_dirs``
  read what the reference's read.
"""

import dataclasses
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from lstm_unet_tpu import config as jax_config
from lstm_unet_tpu_torch import config
from lstm_unet_tpu_torch.checkpoint import CheckpointManager
from lstm_unet_tpu_torch.checkpoint import ckpt as ckpt_module
from lstm_unet_tpu_torch.cli.inference2d import main as infer_main
from lstm_unet_tpu_torch.engine import train as engine_train
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3, seed=1)
    return root


def _params(root, save_root, **kw):
    knobs = dict(
        root_data_dir=root, train_sequence_list=[("Synth-N2DH-SIM", "01")],
        crop_size=(32, 32), batch_size=2, unroll_len=3, learning_rate=3e-3,
        net_kernel_params=config.tiny_net_kernel_params(), root_save_dir=save_root,
        print_to_console_interval=1, validation_interval=10 ** 6, write_to_tb_interval=10 ** 6,
        save_checkpoint_iteration=2)
    return config.CTCParams(**{**knobs, **kw})


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_a_step_that_raises_keeps_the_last_checkpoint(ctc_root, tmp_path, monkeypatch):
    """Step 3 raises after its optimizer updated one parameter: the final
    save must not replace step 2's checkpoint with that torn iterate (the
    port once saved it at the un-incremented step 2, deleting the good one)."""
    trainer = engine_train.Trainer(_params(ctc_root, str(tmp_path)), seed=0, device="cpu")
    real_step = ClippedAdam.step
    calls = []

    def flaky(self, params, grads):
        calls.append(1)
        if len(calls) == 3:
            with torch.no_grad():
                next(iter(params.values())).add_(1.0)  # a partial update
            raise RuntimeError("injected failure in the optimizer")
        return real_step(self, params, grads)

    monkeypatch.setattr(ClippedAdam, "step", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        trainer.train(num_iterations=5)
    save_dir = trainer.p.experiment_save_dir
    assert CheckpointManager(save_dir).all_steps() == [2]
    saved = _npz(os.path.join(save_dir, "2", "params.npz"))
    first = next(iter(trainer.model.state_dict()))
    torn = trainer.model.state_dict()[first].numpy()
    key = first.replace(".", "/")
    want = torn - 1.0  # step 2's value: the torn tensor less the injected update
    if want.ndim == 4:
        want = want.transpose(2, 3, 1, 0)
    np.testing.assert_allclose(saved[key], want, atol=1e-6)
    assert not glob.glob(os.path.join(save_dir, "*.old*")) and not glob.glob(
        os.path.join(save_dir, "*.tmp*"))


def test_resave_of_a_step_replaces_it_whole(tmp_path):
    """A re-save of a step replaces both files of its dir and leaves no
    temporary or moved-aside dir behind."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"a": np.zeros(2)}, {"count": np.int32(1)})
    mgr.save(3, {"a": np.ones(2)}, {"count": np.int32(2)})
    np.testing.assert_array_equal(_npz(tmp_path / "3" / "params.npz")["a"], np.ones(2))
    assert int(_npz(tmp_path / "3" / "opt_state.npz")["count"]) == 2
    assert sorted(os.listdir(tmp_path)) == ["3"]


def test_async_and_sync_checkpoints_write_equal_files(ctc_root, tmp_path, monkeypatch):
    """Interval saves on a thread (slowed down, so that training runs on
    while they write) give the same files as synchronous saves."""
    real_save = CheckpointManager.save
    threads = []

    def slow_save(self, *args, **kw):
        threads.append(engine_train.threading.current_thread().name)
        time.sleep(0.3)
        return real_save(self, *args, **kw)

    monkeypatch.setattr(CheckpointManager, "save", slow_save)
    dirs = {}
    for mode in (True, False):
        p = _params(ctc_root, str(tmp_path / str(mode)), async_checkpoint=mode)
        trainer = engine_train.Trainer(p, seed=0, device="cpu")
        trainer.train(num_iterations=4)
        dirs[mode] = trainer.p.experiment_save_dir
    # async: steps 2 and 4 on the thread, then the final save of step 4 waits
    assert threads.count("checkpoint") == 2 and len(threads) == 6
    for step in ("2", "4"):
        for f in (ckpt_module.PARAMS_FILE, ckpt_module.OPT_STATE_FILE):
            a, b = _npz(os.path.join(dirs[True], step, f)), _npz(os.path.join(dirs[False], step, f))
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{step}/{f}/{k}")
    s2 = _npz(os.path.join(dirs[True], "2", ckpt_module.PARAMS_FILE))
    s4 = _npz(os.path.join(dirs[True], "4", ckpt_module.PARAMS_FILE))
    assert any(not np.array_equal(s2[k], s4[k]) for k in s2)


def test_a_failed_background_save_raises_at_the_next_save(ctc_root, tmp_path, monkeypatch):
    real_save = CheckpointManager.save

    def failing(self, step, *args, **kw):
        if step == 2:
            raise OSError("disk full")
        return real_save(self, step, *args, **kw)

    monkeypatch.setattr(CheckpointManager, "save", failing)
    trainer = engine_train.Trainer(_params(ctc_root, str(tmp_path)), seed=0, device="cpu")
    with pytest.raises(OSError, match="disk full"):
        trainer.train(num_iterations=4)


class _Board:
    """Records what the trainer writes to TensorBoard."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def add_image(self, tag, img, step):
        self.images[tag] = np.asarray(img)

    def close(self):
        pass


def test_validation_writes_the_reference_images(ctc_root, tmp_path):
    p = _params(ctc_root, str(tmp_path), val_sequence_list=[("Synth-N2DH-SIM", "01")],
                validation_interval=2, dry_run=True)
    trainer = engine_train.Trainer(p, seed=0, device="cpu")
    trainer.tb = board = _Board()
    trainer.train(num_iterations=2)
    assert {"val/input", "val/gt", "val/pred"} <= set(board.images)
    for tag, img in board.images.items():
        assert img.shape == (1, 32, 32), tag
    x = board.images["val/input"]
    assert x.min() == 0.0 and x.max() == pytest.approx(1.0)
    assert set(np.unique(board.images["val/pred"])) <= {0.0, 0.5, 1.0}
    assert set(np.unique(board.images["val/gt"])) <= {-0.5, 0.0, 0.5, 1.0}
    assert "val/seg" in board.scalars


@pytest.mark.parametrize("mesh", [{}, {"data": 1}])
def test_inference_recipe_reads_one_data_shard_as_no_mesh(tmp_path, mesh):
    from lstm_unet_tpu_torch.io import synthetic

    seq, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), num_frames=3, height=32,
                                         width=32, num_cells=3, seed=123)
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps({"mesh_shape": mesh, "cell_thresh": 0.5}))
    n = infer_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"), "--sequence_path", seq,
                    "--output_path", str(tmp_path / "res"), "--device", "cpu",
                    "--dtype", "float32", "--pre_sequence_frames", "1", "--recipe", str(recipe)])
    assert n == 3
    assert engine_train.check_ported(config.CTCParams(mesh_shape=mesh)) is None


def _asdict(p):
    d = dataclasses.asdict(p)
    d["net_kernel_params"] = {k: [list(map(list, lvl)) for lvl in v]
                              for k, v in p.net_kernel_params.to_dict().items()}
    return d


def test_params_json_readers_match_reference(tmp_path):
    ref = jax_config.CTCParams(experiment_name="E", batch_size=3, crop_size=(64, 48),
                               train_sequence_list=[("Fluo-N2DH-SIM+", "02")],
                               net_kernel_params=jax_config.tiny_net_kernel_params(),
                               learning_rate=3e-4, mesh_shape={"data": 1})
    path = str(tmp_path / "train_params.json")
    ref.save_json(path)
    theirs = jax_config.CTCParams.load_json(path)
    ours = config.CTCParams.load_json(path)
    want, got = _asdict(theirs), _asdict(ours)
    shared = set(want) & set(got)
    assert len(shared) > 40 and set(got) <= set(want)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert isinstance(ours.net_kernel_params, config.NetKernelParams)
    # the port's own file reads back, and from_json / from_dict agree
    ours.save_json(path)
    again = config.CTCParams.load_json(path)
    assert _asdict(again) == _asdict(config.CTCParams.from_json(open(path).read()))
    assert _asdict(again) == _asdict(config.CTCParams.from_dict(json.load(open(path))))
    assert config.CTCParams.from_dict({"batch_size": 7, "not_a_knob": 1}).batch_size == 7


def test_resolve_continue_dirs_matches_reference(tmp_path):
    root = str(tmp_path)
    for ours_cls, ref_cls in ((config.CTCParams, jax_config.CTCParams),):
        a = ours_cls(root_save_dir=root, experiment_name="E")
        b = ref_cls(root_save_dir=root, experiment_name="E")
        assert a.resolve_continue_dirs() is b.resolve_continue_dirs() is False
        for ts in ("2026-01-01_000000", "2026-02-01_000000", "2026-03-01_000000"):
            os.makedirs(os.path.join(root, f"E_{ts}", "ckpt" if ts < "2026-03" else "logs"))
        assert a.resolve_continue_dirs() is b.resolve_continue_dirs() is True
        assert (a.experiment_save_dir, a.experiment_log_dir) == \
            (b.experiment_save_dir, b.experiment_log_dir)
        assert a.experiment_save_dir.endswith(os.path.join("E_2026-02-01_000000", "ckpt"))
