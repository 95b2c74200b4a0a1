"""The port's workflow scripts (``lstm_unet_tpu_torch/scripts/``) against the
reference's ``scripts/*.py`` on the CPU: the same seeded inputs through both,
at 32² to 96². The discrete scripts are held equal (numbers, printed text,
JSON, TIFF pixels); ``carry_drift`` within the int8 frame bar of
``tests/test_torch_quant.py``. ``select_best`` is in
``test_torch_scripts_select.py``."""

import contextlib
import glob
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lstm_unet_tpu.io.tiff import read_tiff as jax_read_tiff
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff, write_tiff
from lstm_unet_tpu_torch.ops.postprocess import postprocess_frame
from lstm_unet_tpu_torch.scripts import (calibrate_recipe, carry_drift, heldout_protocol,
                                         mask_agreement, oracle_ceiling, postprocess_sweep,
                                         seg_error_decomposition, split_sweep)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCRIPTS = os.path.join(ROOT, "scripts")
GOLDEN = os.path.join(HERE, "golden")


def reference(name, monkeypatch=None):
    """The reference's ``scripts/<name>.py`` as a module (scripts/ is no
    package; ``postprocess_sweep`` imports its sibling ``split_sweep``)."""
    if monkeypatch is not None:
        monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(mod, argv, monkeypatch, capsys):
    """The reference's ``main()`` under ``argv``; returns (result, stdout)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    result = mod.main()
    return result, capsys.readouterr().out


def run_port(main, argv, capsys):
    capsys.readouterr()
    result = main(list(argv))
    return result, capsys.readouterr().out


def two_cells(h=96, w=96, x1=40, x2=56):
    """Two Gaussian cells whose 0.5-threshold interiors merge: (probs, gt)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g1 = 0.95 * np.exp(-(((yy - 48) ** 2 + (xx - x1) ** 2) / (2 * 81)))
    g2 = 0.95 * np.exp(-(((yy - 48) ** 2 + (xx - x2) ** 2) / (2 * 81)))
    p_cell = np.maximum(g1, g2).astype(np.float32)
    probs = np.stack([1 - p_cell, p_cell, np.zeros_like(p_cell)], -1)
    gt = np.zeros((h, w), np.uint16)
    gt[g1 > 0.5] = 1
    gt[(g2 > 0.5) & (gt == 0)] = 2
    return probs, gt


@pytest.fixture(scope="module")
def dump_root(tmp_path_factory):
    """``tests/test_postprocess_sweep.py``'s fixture made with the port's
    helpers: 2 frames of the merged pair, the production config's masks,
    the probabilities as ``ctc_sweep --save_intermediate`` dumps them."""
    root = tmp_path_factory.mktemp("dumps")
    gt_dir = root / "gt" / "Synth-N2DH-SIM" / "01_GT" / "SEG"
    pred_dir = root / "pred" / "Synth-N2DH-SIM" / "01_RES"
    inter = pred_dir / "intermediate"
    for d in (gt_dir, inter):
        d.mkdir(parents=True)
    probs, gt = two_cells()
    base = postprocess_frame(torch.from_numpy(probs), cell_thresh=0.5, edge_thresh=0.3,
                             min_cell_size=50, grow_iters=0, fov=0).numpy().astype(np.uint16)
    assert base.max() == 1  # merged at the production threshold
    for t in range(2):
        write_tiff(str(gt_dir / f"man_seg{t:03d}.tif"), gt)
        write_tiff(str(pred_dir / f"mask{t:03d}.tif"), base)
        np.save(str(inter / f"probs{t:03d}.npy"), probs)
    return root


# ---------------------------------------------------------------- split_sweep


@pytest.mark.parametrize("method", ["dist", "prob"])
def test_split_sweep_helpers_equal_the_reference(method):
    ref = reference("split_sweep")
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 6, (64, 64)).astype(np.uint16)
    pred = rng.integers(0, 6, (64, 64)).astype(np.uint16)
    assert split_sweep.seg_measure(gt, pred) == ref.seg_measure(gt, pred)
    # sparse ids (the reference's histogram is ids^2 long), a GT with no background
    ids = rng.choice(np.arange(1, 1000), 12, replace=False).astype(np.uint16)
    sparse_gt, sparse_pred = ids[rng.integers(0, 12, (64, 64))], ids[pred]
    sparse_pred[:8] = 0
    assert split_sweep.seg_measure(sparse_gt, sparse_pred) == ref.seg_measure(sparse_gt,
                                                                               sparse_pred)
    probs, gt = two_cells(x1=30, x2=62)
    merged = (probs[..., 1] > 0.5).astype(np.uint16)
    np.testing.assert_array_equal(split_sweep.octagon_distance(merged),
                                  ref.octagon_distance(merged))
    if method == "prob":
        cfgs, windows = [(0.8, 1, 0), (0.7, 0, 3500)], []
    else:
        cfgs = [(12, 4, 1, 0.65, 48, 0), (16, 4, 2, 0.0, 0, 0), (12, 4, 1, 0.5, 48, 6000)]
        windows = [12, 16, 48]
    for cfg in cfgs:
        comps = {}
        for name, mod in (("port", split_sweep), ("ref", ref)):
            comps[name] = mod.components_of(merged)
            for c in comps[name]:
                c.p_cell = probs[..., 1][c.slice]
        got = split_sweep.apply_config(merged, comps["port"], windows, cfg, method=method)
        want = ref.apply_config(merged, comps["ref"], windows, cfg, method=method)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    # the merged pair splits under the ungated configs
    assert split_sweep.apply_config(merged, comps["port"], windows, cfgs[0],
                                    method=method)[1] == 1


def test_split_sweep_prints_the_reference_table(dump_root, monkeypatch, capsys):
    argv = ["--gt_root", str(dump_root / "gt"), "--pred_root", str(dump_root / "pred"),
            "--method", "prob"]
    _, want = run_reference(reference("split_sweep"), argv, monkeypatch, capsys)
    _, got = run_port(split_sweep.main, argv, capsys)
    assert got == want and "nsplit" in got


# ------------------------------------------------ seg_error_decomposition


@pytest.fixture(scope="module")
def decomposition_root(tmp_path_factory):
    """GT of touching synthetic cells, and predictions that merge, drop,
    oversplit and shift some of them."""
    root = tmp_path_factory.mktemp("decomp")
    for seq, seed in (("01", 5), ("02", 6)):
        synthetic.write_ctc_dataset(str(root / "gt"), seq=seq, num_frames=3, height=64,
                                    width=64, num_cells=6, seed=seed, overlap_frac=0.5)
        gt_dir = root / "gt" / "Synth-N2DH-SIM" / f"{seq}_GT" / "SEG"
        pred_dir = root / "pred" / "Synth-N2DH-SIM" / f"{seq}_RES"
        pred_dir.mkdir(parents=True)
        for t in range(3):
            gt = read_tiff(str(gt_dir / f"man_seg{t:03d}.tif"))
            pred = np.roll(gt, t, axis=1).astype(np.uint16)
            ids = [i for i in np.unique(gt) if i]
            pred[pred == ids[1]] = ids[0]                      # merged
            pred[gt == ids[2]] = 0                             # dropped
            half = (gt == ids[3]) & (np.arange(64)[None, :] % 2 == 0)
            pred[half] = 200                                   # oversplit
            write_tiff(str(pred_dir / f"mask{t:03d}.tif"), pred)
    return root


def test_seg_error_decomposition_prints_the_reference_report(decomposition_root,
                                                             monkeypatch, capsys):
    argv = ["--gt_root", str(decomposition_root / "gt"),
            "--pred_root", str(decomposition_root / "pred"), "--top", "5"]
    _, want = run_reference(reference("seg_error_decomposition"), argv, monkeypatch, capsys)
    _, got = run_port(seg_error_decomposition.main, argv, capsys)
    assert got == want
    for cat in ("shape", "merged", "dropped", "oversplit"):
        assert cat in got


# ------------------------------------------------------------ mask_agreement


def test_mask_agreement_prints_the_reference_line(decomposition_root, tmp_path,
                                                  monkeypatch, capsys):
    a = str(decomposition_root / "pred" / "Synth-N2DH-SIM" / "01_RES")
    b = str(decomposition_root / "pred" / "Synth-N2DH-SIM" / "02_RES")
    gold = os.path.join(GOLDEN, "masks")
    ref = reference("mask_agreement")
    for argv in ([gold, gold], [a, b], [gold, str(tmp_path)]):
        want = run_reference(ref, argv, monkeypatch, capsys)
        got = run_port(mask_agreement.main, argv, capsys)
        assert got == want
    assert run_port(mask_agreement.main, [gold, gold], capsys) == (
        0, "agreement=1.0000 frames=8\n")
    assert got[0] == 1  # no overlapping masks


# ------------------------------------------------------- postprocess_sweep


def test_postprocess_sweep_json_equals_the_reference(dump_root, tmp_path, monkeypatch, capsys):
    common = ["--gt_root", str(dump_root / "gt"), "--pred_root", str(dump_root / "pred"),
              "--min_cell_size", "50", "--baseline_check", "--cell_grid", "0.5,0.92",
              "--edge_grid", "0.3", "--size_filter_grid", "pre,post",
              "--split_hi_grid", "0.8"]
    ref = reference("postprocess_sweep", monkeypatch)
    _, want = run_reference(ref, common + ["--json_out", str(tmp_path / "ref.json")],
                            monkeypatch, capsys)
    rc, got = run_port(postprocess_sweep.main, common + [
        "--json_out", str(tmp_path / "port.json"), "--device", "cpu"], capsys)
    assert rc == 0 and "BASELINE MISMATCH" not in got
    assert got.replace("port.json", "ref.json") == want
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert port_json == json.loads((tmp_path / "ref.json").read_text())
    assert len(port_json["rows"]) == 4 and port_json["rows"][0]["mean"] > 0.9


def test_postprocess_sweep_baseline_mismatch_exits_1(dump_root, tmp_path, monkeypatch, capsys):
    """A saved mask the production config does not reproduce prints the
    reference's line; the port then exits 1 (the reference carries on)."""
    root = tmp_path / "tampered"
    shutil.copytree(dump_root, root)
    mask = root / "pred" / "Synth-N2DH-SIM" / "01_RES" / "mask000.tif"
    m = read_tiff(str(mask))
    m[0, :5] = 1
    write_tiff(str(mask), m)
    argv = ["--gt_root", str(root / "gt"), "--pred_root", str(root / "pred"),
            "--baseline_check", "--cell_grid", "0.5", "--edge_grid", "0.3"]
    ref = reference("postprocess_sweep", monkeypatch)
    _, want = run_reference(ref, argv, monkeypatch, capsys)
    rc, got = run_port(postprocess_sweep.main, argv + ["--device", "cpu"], capsys)
    assert rc == 1 and got == want
    assert "BASELINE MISMATCH seq 01 t=0: 5 px differ" in got


def test_port_scripts_refuse_cuda_without_a_gpu(dump_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: 'cuda' is valid here")
    argv = ["--gt_root", str(dump_root / "gt"), "--pred_root", str(dump_root / "pred")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        postprocess_sweep.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        oracle_ceiling.main(["--root", str(dump_root / "gt")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calibrate_recipe.main(["--gt_root_val", "a", "--pred_root_val", "b", "--gt_root_eval",
                               "c", "--pred_root_eval", "d", "--out", str(tmp_path / "o")])


# -------------------------------------------------------- calibrate_recipe


def in_process(main):
    """A stand-in for ``subprocess.run`` that runs a sweep child's argv
    (what follows the script or module) through ``main`` in this process."""
    def run(cmd, **kw):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(cmd[cmd.index("--gt_root"):])
        return subprocess.CompletedProcess(cmd, rc or 0, out.getvalue(), "")
    return run


def test_calibrate_recipe_equals_the_reference(dump_root, tmp_path, monkeypatch):
    """Both scripts on one fixture: the same result JSON. The port's first
    sweep child (the val split sweep, with ``--baseline_check``) runs as
    the real ``-m`` subprocess it ships as; its other two children, and
    the reference's three, run their sweep's ``main`` in this process."""
    args = ["--gt_root_val", str(dump_root / "gt"), "--pred_root_val", str(dump_root / "pred"),
            "--val_seqs", "01", "--gt_root_eval", str(dump_root / "gt"),
            "--pred_root_eval", str(dump_root / "pred"), "--cell_grid", "0.5,0.55",
            "--edge_grid", "0.3", "--size_filter_grid", "pre", "--split_hi_grid", "0.8",
            "--split_min_size_grid", "0"]
    ref_sweep = reference("postprocess_sweep", monkeypatch)
    ref = reference("calibrate_recipe")
    children, real = [], subprocess.run  # both scripts' subprocess is this module

    def ref_main(argv):
        monkeypatch.setattr(sys, "argv", ["postprocess_sweep.py"] + argv)
        return ref_sweep.main()

    monkeypatch.setattr(ref.subprocess, "run", in_process(ref_main))
    monkeypatch.setattr(sys, "argv", ["calibrate_recipe.py", *args,
                                      "--out", str(tmp_path / "ref.json")])
    ref.main()

    def first_real(cmd, **kw):
        children.append(cmd)
        if len(children) == 1:
            return real(cmd, **kw)
        return in_process(postprocess_sweep.main)(cmd, **kw)

    monkeypatch.setattr(calibrate_recipe.subprocess, "run", first_real)
    monkeypatch.chdir(tmp_path)
    got = calibrate_recipe.main([*args, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got == want
    assert got["winner"]["instance_split"] and got["val_best"] > 0.9
    assert len(children) == 3 and children[0][1:3] == ["-m", calibrate_recipe.SWEEP]
    assert all(c[c.index("--device") + 1] == "cpu" for c in children)
    assert "--baseline_check" in children[0]


# ---------------------------------------------------------- oracle_ceiling


@pytest.mark.parametrize("extra", [[], ["--instance_split", "--split_window", "8"],
                                   ["--size_filter", "post", "--max_frames", "1"]])
def test_oracle_ceiling_equals_the_reference(decomposition_root, extra, monkeypatch, capsys):
    argv = ["--root", str(decomposition_root / "gt"), "--min_cell_size", "20", *extra]
    _, want = run_reference(reference("oracle_ceiling"), argv, monkeypatch, capsys)
    mean, got = run_port(oracle_ceiling.main, argv + ["--device", "cpu"], capsys)
    assert got == want and 0.5 < mean <= 1.0


# --------------------------------------------------------- heldout_protocol


def test_heldout_tables_equal_the_reference():
    ref = reference("heldout_protocol")
    for name in ("TRAIN", "TRAIN_V4", "HELDOUT", "NS_EVAL", "NS_AGREE", "SIZE", "NS_H",
                 "NS_W", "DATASET"):
        assert getattr(heldout_protocol, name) == getattr(ref, name), name


def test_heldout_writes_the_reference_tiffs(tmp_path, monkeypatch, capsys):
    """One TRAIN_V4 row and one HELDOUT row at 64², 3 frames, and one
    non-square eval row: the reference's files, pixel for pixel in their
    dtype. (Not byte for byte: the reference encodes through its native
    library, cv2 or PIL, the port with its own numpy writer; each package
    reads the other's files.)"""
    ref = reference("heldout_protocol")
    for mod in (ref, heldout_protocol):
        monkeypatch.setattr(mod, "SIZE", 64)
        monkeypatch.setattr(mod, "NS_H", 40)
        monkeypatch.setattr(mod, "NS_W", 44)
        monkeypatch.setattr(mod, "TRAIN", [])
        monkeypatch.setattr(mod, "TRAIN_V4", [mod.TRAIN_V4[1][:4] + (3,) + mod.TRAIN_V4[1][5:]])
        monkeypatch.setattr(mod, "HELDOUT", [mod.HELDOUT[2][:4] + (3,) + mod.HELDOUT[2][5:]])
        monkeypatch.setattr(mod, "NS_EVAL", [mod.NS_EVAL[0][:4] + (2,) + mod.NS_EVAL[0][5:]])
        monkeypatch.setattr(mod, "NS_AGREE", [])
    _, want = run_reference(ref, ["gen", "--root", str(tmp_path / "ref"), "--v4"],
                            monkeypatch, capsys)
    run_reference(ref, ["gen_ns", "--root", str(tmp_path / "ref")], monkeypatch, capsys)
    _, got = run_port(heldout_protocol.main, ["gen", "--root", str(tmp_path / "port"), "--v4"],
                      capsys)
    run_port(heldout_protocol.main, ["gen_ns", "--root", str(tmp_path / "port")], capsys)
    assert got == want
    files = sorted(os.path.relpath(p, tmp_path / "ref")
                   for p in glob.glob(str(tmp_path / "ref" / "**" / "*.tif"), recursive=True))
    assert len(files) == 2 * (3 + 3) + 2 * 2
    for rel in files:
        want = jax_read_tiff(str(tmp_path / "ref" / rel))
        for got in (read_tiff(str(tmp_path / "port" / rel)),
                    jax_read_tiff(str(tmp_path / "port" / rel)),
                    read_tiff(str(tmp_path / "ref" / rel))):
            assert got.dtype == want.dtype == np.uint16, rel
            np.testing.assert_array_equal(got, want, err_msg=rel)


# -------------------------------------------------------------- carry_drift

# int8 streamed frames' bar (tests/test_torch_quant.py::FRAME_BAR): the
# XLA-vs-PyTorch sigmoid / tanh ulps flip bf16 values
LOGIT_BAR = 2.0 ** -5


def test_carry_drift_matches_the_reference(monkeypatch, capsys):
    """The port's rows against the reference's on the golden model. Its
    two variants keep distinct carries (bf16 and f32), and their gap is the
    reference's to within a factor of 2: a port that dropped
    ``state_dtype`` would report a gap of 0."""
    argv = ["--frames", "8", "--size", "32", "--segment", "4", "--report_every", "4"]
    _, want = run_reference(reference("carry_drift"),
                            ["--model_path", os.path.join(GOLDEN, "ckpt"), *argv],
                            monkeypatch, capsys)
    models = {}
    load = carry_drift.load_model

    def recording(path, device, **kw):
        models[kw["state_dtype"]] = load(path, device, **kw)
        return models[kw["state_dtype"]]

    monkeypatch.setattr(carry_drift, "load_model", recording)
    out, got = run_port(carry_drift.main, ["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                                           *argv, "--device", "cpu"], capsys)
    for state_dtype, dtype in (("auto", torch.bfloat16), ("float32", torch.float32)):
        carry = [t for level in models[state_dtype].init_state(1, 32, 32)
                 for cell in level for t in cell]
        assert carry and {t.dtype for t in carry} == {dtype}, state_dtype
    want_rows = [ln for ln in want.splitlines() if ln and ln[0].isdigit()]
    assert got.splitlines()[0] == want.splitlines()[want.splitlines().index(
        carry_drift.COLUMNS)] and len(out["rows"]) == len(want_rows) == 2
    # the largest |logit| of the golden model on this stream, f32
    from lstm_unet_tpu_torch.io.preprocess import percentile_normalize_np
    model = load(os.path.join(GOLDEN, "torch_ckpt"), "cpu", dtype="float32")
    state, top = model.init_state(1, 32, 32), 0.0
    for seg in range(2):
        imgs, _ = synthetic.make_cell_sequence(num_frames=4, height=32, width=32,
                                               num_cells=30, seed=1000 + seg)
        for f in imgs:
            with torch.no_grad():
                state, logits = model.step(state, torch.from_numpy(
                    percentile_normalize_np(f))[None, ..., None])
            top = max(top, float(logits.abs().max()))
    for g, w in zip(out["rows"], want_rows):
        g, w = g.split(","), w.split(",")
        assert g[0] == w[0] and g[3:] == w[3:], (g, w)  # instances, SEG
        assert abs(float(g[1]) - float(w[1])) <= LOGIT_BAR * top, (g, w)
        assert 0.5 * float(w[1]) <= float(g[1]) <= 2 * float(w[1]) and float(g[1]) > 0, (g, w)
        assert abs(int(g[2]) - int(w[2])) <= 3, (g, w)
    assert set(out["ms_per_frame"]) == {"auto", "float32"}
