"""``lstm_unet_tpu_torch/scripts/select_best.py`` against the reference's
``scripts/select_best.py`` on the CPU. The cases of
``tests/test_select_best.py`` run through both under the same stubbed
``run_sweep``, the reference on orbax steps and the port on its own step
layout, and each summary JSON is held equal; then what the reference gets
wrong (``--prune`` without ``--best_dir``) and one real ``ctc_sweep
--device cpu`` child."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lstm_unet_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from lstm_unet_tpu.checkpoint import save_model_params as jax_save_model_params
from lstm_unet_tpu_torch.checkpoint.ckpt import CheckpointManager, save_model_params
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.scripts import select_best

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TORCH_CKPT = os.path.join(HERE, "golden", "torch_ckpt")


def reference():
    spec = importlib.util.spec_from_file_location(
        "reference_select_best", os.path.join(ROOT, "scripts", "select_best.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fake_run(path, steps, orbax):
    """A training run dir whose step i holds ``w`` = i (2x2 f32): orbax
    steps for the reference, the port's ``<step>/params.npz`` for the port."""
    ckpt = path / "ckpt"
    ckpt.mkdir(parents=True)
    (jax_save_model_params if orbax else save_model_params)(str(ckpt), {"model_config": {}})
    mgr = JaxCheckpointManager(str(ckpt)) if orbax else CheckpointManager(str(ckpt))
    for i, s in enumerate(steps):
        params = {"w": np.full((2, 2), float(i), np.float32)}
        mgr.save(s, params, {"count": np.int32(i)})
    if orbax:
        mgr.wait()
        mgr.close()
    return path


def soup_w(best_dir):
    """The port artifact's ``w``."""
    steps = sorted(int(d) for d in os.listdir(best_dir) if d.isdigit())
    with np.load(os.path.join(best_dir, str(steps[-1]), "params.npz")) as f:
        return f["w"]


def run_both(tmp_path, monkeypatch, steps, sweep, argv, make_best=False):
    """``main()`` of the reference and of the port on their own fake runs
    under the stub ``sweep``; returns ``{"ref" | "port": (summary, run dir,
    best dir, sweep calls)}``. A raised exception is returned in place of
    the summary."""
    out = {}
    for name, mod, orbax in (("ref", reference(), True), ("port", select_best, False)):
        base = tmp_path / name
        run = fake_run(base / "run", steps, orbax)
        data = base / "heldout"
        (data / "train").mkdir(parents=True)
        (data / "eval").mkdir()
        best = base / "best"
        if make_best:
            best.mkdir()
            (best / "PRECIOUS").write_text("previous round's artifact")
        calls = []

        def stub(model_path, data_root, output_root, recipe_arg, seqs="", ckpt_step=0,
                 dtype="", calibrate=0, timeout=0, device="cuda", calls=calls):
            calls.append((os.path.basename(data_root), ckpt_step, dtype, calibrate))
            return sweep(data_root, ckpt_step)

        monkeypatch.setattr(mod, "run_sweep", stub)
        full = ["--model_path", str(run), "--data_root", str(data),
                *[a.replace("{best}", str(best)).replace("{out}", str(base / "s.json"))
                  for a in argv]]
        monkeypatch.setattr(sys, "argv", ["select_best.py", *full])
        try:
            if name == "ref":
                mod.main()
            else:
                mod.main(full + ["--device", "cpu"])
            result = json.loads((base / "s.json").read_text())
            if result.get("best_dir"):
                assert result.pop("best_dir") == str(best)
        except Exception as e:  # the failure is what the case compares
            result = e
        out[name] = (result, run, best, calls)
    return out


VAL_MEAN = {6500: 0.88, 7000: 0.93, 7500: 0.89, 8000: 0.91}


def rank_sweep(data_root, ckpt_step):
    if ckpt_step:  # ranking pass on val: 7000 > 8000 > 7500 > 6500
        m = VAL_MEAN[ckpt_step]
        return {"seg": {"val/03": m + 0.01, "val/10": m - 0.01},
                "det": {"val/03": m, "val/10": m - 0.02}}
    if os.path.basename(data_root) == "train":  # the soup's val sweep wins
        return {"seg": {"val/03": 0.95, "val/10": 0.94}, "det": {}}
    return {"seg": {"eval/01": 0.92, "eval/02": 0.91, "eval/03": 0.93},
            "det": {"eval/01": 0.95}}


def test_ranks_soups_prunes_as_the_reference(tmp_path, monkeypatch):
    recipe = tmp_path / "recipe.json"
    recipe.write_text(json.dumps({"cell_thresh": 0.55}))
    got = run_both(tmp_path, monkeypatch, tuple(VAL_MEAN), rank_sweep,
                   ["--val_seqs", "03,10", "--recipe", str(recipe), "--best_dir", "{best}",
                    "--prune", "--skip_int8", "--out", "{out}"])
    summary, run, best, calls = got["port"]
    assert summary == got["ref"][0]
    assert summary["soup_steps"] == [7000, 8000] and summary["val_seg_det_tau"] == 1.0
    assert summary["pruned_steps"] == [6500, 7500]
    assert calls == got["ref"][3]
    assert [c for c in calls if c[0] == "eval"] == [("eval", 0, "", 0)]
    assert sorted(os.listdir(run / "ckpt")) == ["7000", "8000", "model_params.json"]
    for f in ("model_params.json", "recipe.json", "provenance.json"):
        assert os.path.exists(best / f), f
    assert json.loads((best / "provenance.json").read_text())["soup_steps"] == [7000, 8000]
    np.testing.assert_array_equal(soup_w(best), np.full((2, 2), 2.0, np.float32))


@pytest.mark.parametrize("case", ["no_scores", "partial_val"])
def test_fails_loud_as_the_reference(case, tmp_path, monkeypatch):
    if case == "no_scores":
        def sweep(data_root, ckpt_step):
            return {"seg": {}, "det": {}}
        argv, match = [], "SEG scores"
    else:
        def sweep(data_root, ckpt_step):
            return {"seg": {"train/Synth-N2DH-SIM/03": 0.9}, "det": {}}
        argv, match = ["--val_seqs", "03,10"], "1 SEG scores for 2 requested"
    got = run_both(tmp_path, monkeypatch, (500,), sweep, argv)
    err, want = got["port"][0], got["ref"][0]
    assert isinstance(err, RuntimeError) and isinstance(want, RuntimeError)
    assert str(err) == str(want) and match in str(err)


def test_failed_rerun_keeps_the_previous_artifact(tmp_path, monkeypatch):
    def sweep(data_root, ckpt_step):
        if os.path.basename(data_root) == "train":
            return {"seg": {"val/03": 0.9, "val/10": 0.9}, "det": {}}
        return {"seg": {}, "det": {}}  # the eval confirm parses nothing

    got = run_both(tmp_path, monkeypatch, (7000, 8000), sweep,
                   ["--val_seqs", "03,10", "--best_dir", "{best}", "--skip_int8"],
                   make_best=True)
    err, _, best, _ = got["port"]
    assert str(err) == str(got["ref"][0]) and "refusing to record 0.0" in str(err)
    assert (best / "PRECIOUS").read_text() == "previous round's artifact"


def test_transient_tail_ships_one_step_as_the_reference(tmp_path, monkeypatch):
    def sweep(data_root, ckpt_step):
        if ckpt_step:
            return {"seg": {"val/03": {10500: 0.55, 11000: 0.86}[ckpt_step]}, "det": {}}
        if os.path.basename(data_root) == "train":
            return {"seg": {"val/03": 0.70}, "det": {}}  # the soup loses on val
        return {"seg": {"eval/01": 0.84}, "det": {}}

    got = run_both(tmp_path, monkeypatch, (10500, 11000), sweep,
                   ["--val_seqs", "03", "--best_dir", "{best}", "--skip_int8",
                    "--out", "{out}"])
    summary, _, best, _ = got["port"]
    assert summary == got["ref"][0]
    assert summary["soup_steps"] == [10500, 11000] and summary["artifact_steps"] == [11000]
    np.testing.assert_array_equal(soup_w(best), np.full((2, 2), 1.0, np.float32))


def test_prune_without_best_dir_keeps_the_best_two_and_the_latest(tmp_path, monkeypatch):
    """The reference binds ``chosen`` only under ``--best_dir`` and then
    reads it to prune: NameError. The port keeps the two best-ranked steps
    and the latest."""
    got = run_both(tmp_path, monkeypatch, tuple(VAL_MEAN) + (8500,),
                   rank_sweep,
                   ["--val_seqs", "03,10", "--steps", "6500,7000,7500,8000", "--prune",
                    "--out", "{out}"])
    assert isinstance(got["ref"][0], NameError)
    summary, run, _, calls = got["port"]
    assert summary["soup_steps"] == [7000, 8000] and summary["pruned_steps"] == [6500, 7500]
    assert sorted(int(d) for d in os.listdir(run / "ckpt") if d.isdigit()) == [7000, 8000, 8500]
    assert "artifact_steps" not in summary and all(c[1] for c in calls)


def test_run_sweep_score_cache(tmp_path, monkeypatch):
    """A cache of the same inputs wins; one of other inputs (a legacy
    format, another recipe, another device) reruns the sweep."""
    ran = []

    def failing_child(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 3, "", "")

    monkeypatch.setattr(select_best.subprocess, "run", failing_child)
    out_root = tmp_path / "val"
    out_root.mkdir()
    seg = {"runs/heldout/train/Synth-N2DH-SIM/03": 0.91}
    recipe = tmp_path / "a.json"
    recipe.write_text(json.dumps({"cell_thresh": 0.55}))
    fp = select_best._sweep_fingerprint("/nonexistent/model", str(recipe), 0, "", 0, "cpu")
    assert fp == dict(reference()._sweep_fingerprint("/nonexistent/model", str(recipe), 0,
                                                     "", 0), device="cpu")
    cache = out_root / "seg_scores.json"
    cache.write_text(json.dumps({"fingerprint": fp, "seg": seg, "det": {}}))
    assert select_best.run_sweep("/nonexistent/model", "/d", str(out_root), str(recipe),
                                 device="cpu") == {"seg": seg, "det": {}}
    assert ran == []
    for stale in ({"recipe": {"cell_thresh": 0.6}}, {"device": "cuda"}, {"legacy": True}):
        recipe.write_text(json.dumps(stale.get("recipe", {"cell_thresh": 0.55})))
        cache.write_text(json.dumps({"val/03": 0.9} if "legacy" in stale else
                                    {"fingerprint": fp, "seg": seg, "det": {}}))
        with pytest.raises(RuntimeError, match="ctc_sweep rc=3"):
            select_best.run_sweep("/nonexistent/model", "/d", str(out_root), str(recipe),
                                  device=stale.get("device", "cpu"))
    assert len(ran) == 3 and ran[-1][2] == "lstm_unet_tpu_torch.cli.ctc_sweep"
    assert ran[-1][ran[-1].index("--device") + 1] == "cpu"


def test_kendall_tau_equals_the_reference():
    ref = reference()
    for pairs in ([(1, 10), (2, 20), (3, 30)], [(1, 30), (2, 20), (3, 10)],
                  [(1, 10), (1, 20), (2, 30)], [(0.5, 0.1), (0.4, 0.3), (0.9, 0.2)]):
        assert select_best.kendall_tau(pairs) == ref.kendall_tau(pairs)


def test_run_sweep_through_a_real_ctc_sweep_child(tmp_path):
    """Two steps made from the golden model (the second, the latest, with
    its weights scaled); a ``ctc_sweep --device cpu`` child sweeps step 1
    on the golden sequence: SEG and DET parsed, and cached with the step."""
    ckpt = tmp_path / "run" / "ckpt"
    ckpt.mkdir(parents=True)
    shutil.copy(os.path.join(TORCH_CKPT, "model_params.json"), ckpt)
    with np.load(os.path.join(TORCH_CKPT, "params.npz")) as f:
        params = {k: f[k] for k in f.files}
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, params, None)
    mgr.save(2, {k: (v * np.float32(1.25)).astype(v.dtype) for k, v in params.items()}, None)
    data = tmp_path / "data"
    synthetic.write_ctc_dataset(str(data), num_frames=8, height=32, width=32, num_cells=3,
                                seed=123)
    out = tmp_path / "val_1"
    scores = select_best.run_sweep(str(tmp_path / "run"), str(data), str(out), "",
                                   ckpt_step=1, dtype="float32", device="cpu")
    seq = str(data / "Synth-N2DH-SIM" / "01")
    assert list(scores["seg"]) == list(scores["det"]) == [seq]
    assert 0.0 < scores["seg"][seq] <= 1.0 and 0.0 < scores["det"][seq] <= 1.0
    cached = json.loads((out / "seg_scores.json").read_text())
    assert cached["fingerprint"]["ckpt_step"] == 1 and cached["seg"] == scores["seg"]
    assert cached["fingerprint"]["device"] == "cpu"
