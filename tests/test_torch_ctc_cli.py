"""The port's sweep, score, soup and import CLIs against the JAX package's,
on the CPU: ``cli/ctc_sweep.py``, ``cli/ctc_score.py``, ``cli/ckpt_avg.py``
(``checkpoint/ckpt.py::average_checkpoints``) and ``cli/import_tf.py``
(``checkpoint/tf_bundle.py``, ``checkpoint/tf_import.py``)."""

import dataclasses
import glob
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from lstm_unet_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from lstm_unet_tpu.checkpoint import average_checkpoints as jax_average
from lstm_unet_tpu.checkpoint import save_model_params as jax_save_model_params
from lstm_unet_tpu.checkpoint.tf_bundle import write_bundle as jax_write_bundle
from lstm_unet_tpu.checkpoint.tf_import import export_tf_bundle as jax_export
from lstm_unet_tpu.checkpoint.tf_import import import_keras_ulstm as jax_import
from lstm_unet_tpu.cli.ctc_score import main as jax_score
from lstm_unet_tpu.cli.ctc_sweep import main as jax_sweep
from lstm_unet_tpu.engine.infer import load_model as jax_load_model
from lstm_unet_tpu_torch.checkpoint import ckpt, convert, tf_bundle, tf_import
from lstm_unet_tpu_torch.cli import ckpt_avg, ctc_score, ctc_sweep, import_tf, inference2d
from lstm_unet_tpu_torch.config import default_net_kernel_params, tiny_net_kernel_params
from lstm_unet_tpu_torch.engine.infer import ACT_SCALES_FILE
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff, write_tiff
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
TORCH_CKPT = os.path.join(GOLDEN, "torch_ckpt")
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)


def _masks(root):
    return {os.path.relpath(p, root): read_tiff(p)
            for p in sorted(glob.glob(os.path.join(root, "**", "mask*.tif"), recursive=True))}


def _scores(text):
    """The 'SEG <seq_dir>: x' / 'DET <seq_dir>: x' lines of a sweep's log."""
    return sorted(m.group(0) for m in re.finditer(r"(SEG|DET) \S+: [0-9.]+", text))


# ---------------------------------------------------------------- ctc_sweep


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    """Two 32^2 sequences of 8 and 6 frames and a 30 x 29 one of 5 frames
    (a group of its own)."""
    root = str(tmp_path_factory.mktemp("ctc"))
    for seq, n, h, w, seed in (("01", 8, 32, 32, 123), ("02", 6, 32, 32, 2),
                               ("03", 5, 30, 29, 5)):
        synthetic.write_ctc_dataset(root, seq=seq, num_frames=n, height=h, width=w,
                                    num_cells=3, seed=seed)
    return root


def test_ctc_sweep_equals_jax(ctc_root, tmp_path, capsys):
    common = ["--root_data_dir", ctc_root, "--min_cell_size", "5", "--pre_sequence_frames",
              "1", "--dtype", "float32", "--score_seg", "--score_det", "--save_intermediate"]
    jax_sweep(["--model_path", os.path.join(GOLDEN, "ckpt"), "--output_root",
               str(tmp_path / "jax"), *common])
    want_log = capsys.readouterr().out
    n = ctc_sweep.main(["--model_path", TORCH_CKPT, "--output_root", str(tmp_path / "port"),
                        "--device", "cpu", *common])
    got_log = capsys.readouterr().out
    got, want = _masks(str(tmp_path / "port")), _masks(str(tmp_path / "jax"))
    assert n == 8 + 6 + 5 == len(got) and sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert len(_scores(got_log)) == 6 and _scores(got_log) == _scores(want_log)
    probs = glob.glob(str(tmp_path / "port" / "*" / "03_RES" / "intermediate" / "*.npy"))
    assert len(probs) == 5 and np.load(probs[0]).shape == (30, 29, 3)


def test_sweep_batches_similar_lengths(tmp_path, monkeypatch):
    root = str(tmp_path / "root")
    for seq, n in (("01", 4), ("02", 10), ("03", 5)):
        synthetic.write_ctc_dataset(root, seq=seq, num_frames=n, height=16, width=16,
                                    num_cells=2, seed=int(seq))
    calls = []

    def fake(ip, seqs, outs, device="cuda", model=None):
        calls.append([os.path.basename(s) for s in seqs])
        return 0

    monkeypatch.setattr(ctc_sweep, "run_inference_batched", fake)
    ctc_sweep.main(["--model_path", TORCH_CKPT, "--root_data_dir", root, "--output_root",
                    str(tmp_path / "o"), "--max_batch", "2", "--dtype", "float32",
                    "--device", "cpu"])
    assert calls == [["01", "03"], ["02"]]  # lengths 4, 5 | 10


@pytest.mark.parametrize("argv,explicit", [
    (["--tta"], {"tta"}),                          # the option itself, not tta_mode
    (["--tta", "--tta_m", "flip"], {"tta", "tta_mode"}),  # a strict, unique prefix
    (["--split_rel", "0.5"], {"split_rel"}),       # not split_rel_window
    (["--split_rel_w=7"], {"split_rel_window"}),
    (["--split", "1"], set()),                     # ambiguous: names nothing
])
def test_sweep_recipe_precedence(tmp_path, argv, explicit):
    """A flag on the command line wins over its recipe key, and only its
    own: an exact option string names that option alone, and a prefix names
    an option only when it is the prefix of no other. (The reference counts
    every option its token prefixes, so its ``--tta`` also drops a recipe's
    ``tta_mode``: a reference fault the port does not copy.)"""
    ap = ctc_sweep.build_parser()
    assert ctc_sweep.explicit_dests(ap, argv) == explicit
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps({"tta": True, "tta_mode": "d4", "split_rel": 0.3,
                                  "split_rel_window": 9, "model_path": "elsewhere"}))
    base = ["--model_path", "m", "--root_data_dir", "r", "--output_root", "o",
            "--recipe", str(recipe)]
    cli = [a for a in argv if a != "--split" and a != "1"]
    args = ap.parse_args(base + cli)
    ctc_sweep.apply_recipe(ap, args, base + argv)
    assert args.model_path == "m"  # paths never come from a recipe
    assert args.tta is True
    assert args.tta_mode == ("flip" if "tta_mode" in explicit else "d4")
    assert args.split_rel == (0.5 if "split_rel" in explicit else 0.3)
    assert args.split_rel_window == (7 if "split_rel_window" in explicit else 9)


@pytest.mark.parametrize("flags", [["--conv_method", "dots"], ["--entry_layouts"]])
def test_sweep_rejects_tpu_knobs(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="Do not port"):
        ctc_sweep.main(["--model_path", TORCH_CKPT, "--root_data_dir", str(tmp_path),
                        "--output_root", str(tmp_path / "o"), "--device", "cpu", *flags])


# ---------------------------------------------------------------- ctc_score


@pytest.fixture(scope="module")
def score_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("score") / "data")
    synthetic.write_ctc_dataset(root, num_frames=6, height=64, width=64)
    return root


def _write_preds(gt_root, pred_root, mutate=None):
    for g in sorted(glob.glob(os.path.join(gt_root, "*", "*_GT", "SEG", "man_seg*.tif"))):
        m = re.search(r"([^/]+)/(\d+)_GT/SEG/man_seg(\d+)\.tif$", g)
        res = os.path.join(pred_root, m.group(1), f"{m.group(2)}_RES")
        os.makedirs(res, exist_ok=True)
        arr = read_tiff(g).astype(np.uint16)
        write_tiff(os.path.join(res, "mask%03d.tif" % int(m.group(3))),
                   arr if mutate is None else mutate(arr))


SCORE_CASES = {
    "perfect": ([], None),
    "dropped_objects": ([], lambda a: np.where(a == a.max(), 0, a)),
    "seg_only": (["--seg"], None),
    "det_seg_fallback": (["--det"], None),
    "no_gt": (["--gt_root_missing"], None),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_ctc_score_json_equals_jax(score_data, tmp_path, capsys, case):
    flags, mutate = SCORE_CASES[case]
    pred = str(tmp_path / "pred")
    _write_preds(score_data, pred, mutate)
    if flags == ["--gt_root_missing"]:
        for main in (jax_score, ctc_score.main):
            with pytest.raises(SystemExit):
                main(["--pred_root", pred, "--gt_root", str(tmp_path / "nowhere")])
        return
    outs = {}
    for name, main in (("jax", jax_score), ("port", ctc_score.main)):
        outs[name] = str(tmp_path / f"{name}.json")
        main(["--pred_root", pred, "--gt_root", score_data, *flags, "--json", outs[name]])
    got, want = (json.load(open(outs[k])) for k in ("port", "jax"))
    assert got == want
    if case == "perfect":
        assert got["mean_seg"] == pytest.approx(1.0) and got["mean_det"] == pytest.approx(1.0)
    if case == "dropped_objects":
        assert got["mean_seg"] < 1.0 and got["mean_det"] < 1.0
    if case == "det_seg_fallback":
        assert "SEG-fallback" in capsys.readouterr().out


# ---------------------------------------------------------------- ckpt_avg


@pytest.fixture(scope="module")
def saved_steps(tmp_path_factory):
    """Three steps of the tiny model's params (seeded), saved as a JAX
    (orbax) training dir and as a port training dir."""
    import jax

    from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D

    base = tmp_path_factory.mktemp("steps")
    cfg = ModelConfig.make(tiny_net_kernel_params())
    jax_dir, port_dir = str(base / "jax"), str(base / "port" / "ckpt")
    jmgr, pmgr = JaxCheckpointManager(jax_dir), ckpt.CheckpointManager(port_dir)
    for step in (2, 4, 6):
        params = jax.tree_util.tree_map(np.asarray, ULSTMnet2D.init(jax.random.PRNGKey(step),
                                                                    cfg))
        jmgr.save(step, params, {"x": np.zeros((1,), np.float32)})
        pmgr.save(step, convert.flatten_tree(params), {"x": np.zeros((1,), np.float32)})
    jmgr.wait()
    jmgr.close()
    jax_save_model_params(jax_dir, {"model_config": dataclasses.asdict(cfg)})
    shutil.copy(os.path.join(TORCH_CKPT, "model_params.json"), port_dir)
    with open(os.path.join(port_dir, ACT_SCALES_FILE), "w") as f:
        json.dump({"head": 1.0}, f)
    return jax_dir, port_dir


@pytest.mark.parametrize("steps", [[2, 6], None])
def test_average_checkpoints_equals_jax(saved_steps, tmp_path, steps):
    """Bit for bit in f32: the port's soup against the reference's soup of
    the same steps, converted with the bridge; the source dirs keep their
    steps, and the soup has no act_scales.json."""
    jax_dir, port_dir = saved_steps
    want_step = jax_average(jax_dir, str(tmp_path / "jax_soup"), steps=steps)
    argv = ["--model_path", os.path.dirname(port_dir), "--output_dir", str(tmp_path / "soup")]
    got_step = ckpt_avg.main(argv + (["--steps", ",".join(map(str, steps))] if steps else []))
    assert got_step == want_step == 6
    want, _ = jax_load_model(str(tmp_path / "jax_soup"))
    got = dict(np.load(os.path.join(tmp_path, "soup", "6", "params.npz")))
    flat_want = convert.flatten_tree(want)
    assert sorted(got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    model = convert.load_model(str(tmp_path / "soup"), "cpu", dtype="float32")
    for k, v in convert.params_from_jax(flat_want).items():
        assert torch.equal(model.state_dict()[k].contiguous(), v), k
    assert ckpt.saved_steps(port_dir) == [2, 4, 6]
    assert not os.path.exists(os.path.join(tmp_path, "soup", ACT_SCALES_FILE))
    assert not os.path.exists(os.path.join(tmp_path, "soup", "6", "opt_state.npz"))
    with pytest.raises(ValueError, match="source"):
        ckpt.average_checkpoints(port_dir, port_dir)


# ---------------------------------------------------------------- import_tf


def test_crc32c_and_snappy_known_vectors():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    assert tf_bundle.crc32c(b"") == 0
    assert tf_bundle.crc32c(b"\x00" * 32) == 0x8A9136AA
    payload = bytes([8, (3 << 2) | 0]) + b"abcd" + bytes([1, 4])
    assert tf_bundle.snappy_decompress(payload) == b"abcdabcd"


@pytest.mark.parametrize("n", [65536, 65537, 300003])
def test_crc32c_parallel_path_equals_the_references(n):
    """Data of 64 KiB or more is summed in parallel chunks: the same value as
    the reference's byte loop, from a fresh or a continued crc."""
    from lstm_unet_tpu.checkpoint.tf_bundle import crc32c as jax_crc32c

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tf_bundle.crc32c(data) == jax_crc32c(data)
    assert tf_bundle.crc32c(data, 0x1234) == jax_crc32c(data, 0x1234)


def test_bundle_reads_the_references_bundles(tmp_path):
    """A single-shard bundle the reference writes, a two-shard one built
    entry by entry, and a bfloat16 entry (read widened to f32)."""
    prefix = str(tmp_path / "one")
    tensors = {"a/kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
               "a/bias": np.arange(4, dtype=np.float64), "b/steps": np.array(7, np.int64),
               "b/flags": np.array([True, False]),
               "c/half": np.linspace(-1, 1, 8, dtype=np.float16)}
    jax_write_bundle(prefix, tensors)
    bundle = tf_bundle.TFBundle.open(prefix)
    assert [n for n, _ in bundle.list_variables()] == sorted(tensors)
    for name, ref in tensors.items():
        got = bundle.load(name, verify_crc=True)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    prefix = str(tmp_path / "ms")
    a = np.arange(6, dtype=np.float32)
    bf = np.array([1.0, -2.5, 3.0e38, 2.0 ** -130], np.float32)
    bf_bits = (bf.view(np.uint32) >> 16).astype(np.uint16)
    open(f"{prefix}.data-00000-of-00002", "wb").write(a.tobytes())
    open(f"{prefix}.data-00001-of-00002", "wb").write(bf_bits.tobytes())
    w = tf_bundle.TableWriter(prefix + ".index")
    w.add(b"", tf_bundle._emit_field(1, 0, 2))

    def entry(code, shape, shard, buf):
        msg = tf_bundle._emit_field(1, 0, code)
        msg += tf_bundle._emit_field(2, 2, b"".join(
            tf_bundle._emit_field(2, 2, tf_bundle._emit_field(1, 0, d)) for d in shape))
        msg += tf_bundle._emit_field(3, 0, shard) if shard else b""
        return (msg + tf_bundle._emit_field(5, 0, len(buf))
                + tf_bundle._emit_field(6, 0, tf_bundle.masked_crc32c(buf)))

    w.add(b"alpha", entry(1, (6,), 0, a.tobytes()))
    w.add(b"beta", entry(14, (2, 2), 1, bf_bits.tobytes()))
    w.finish()
    bundle = tf_bundle.TFBundle.open(prefix)
    assert bundle.num_shards == 2
    np.testing.assert_array_equal(bundle.load("alpha", verify_crc=True), a)
    beta = bundle.load("beta", verify_crc=True)
    assert beta.dtype == np.float32
    np.testing.assert_array_equal(beta.reshape(-1), (bf_bits.astype(np.uint32) << 16)
                                  .view(np.float32))
    data = bytearray(open(prefix + ".index", "rb").read())
    data[0] ^= 0xFF
    open(prefix + ".index", "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        tf_bundle.TFBundle.open(prefix)


def _golden_tree():
    with np.load(os.path.join(TORCH_CKPT, "params.npz")) as npz:
        return convert._unflatten({k: npz[k] for k in npz.files})


def _fake_tf2_checkpoint(prefix, params):
    """A TF2 object-graph checkpoint of the same architecture with Keras-like
    paths, optimizer slots and a save counter, and seeded values."""
    rng = np.random.default_rng(0)
    tensors = {}

    def add(path, shape):
        tensors[path + "/.ATTRIBUTES/VARIABLE_VALUE"] = rng.normal(size=shape).astype(
            np.float32)
        tensors[path + "/.OPTIMIZER_SLOT/optimizer/m/.ATTRIBUTES/VARIABLE_VALUE"] = \
            np.zeros(shape, np.float32)

    for lvl, level in enumerate(params["encoder"]):
        for j, cell in enumerate(level["lstm"]):
            base = f"net/down_blocks/{lvl}/lstm_layers/{j}/cell"
            add(f"{base}/kernel", cell["kernel_x"].shape)
            add(f"{base}/recurrent_kernel", cell["kernel_h"].shape)
            add(f"{base}/bias", cell["bias"].shape)
        for j, conv in enumerate(level["convs"]):
            add(f"net/down_blocks/{lvl}/conv_layers/{j}/kernel", conv["kernel"].shape)
            add(f"net/down_blocks/{lvl}/conv_layers/{j}/bias", conv["bias"].shape)
    for lvl, level in enumerate(params["decoder"]):
        for j, conv in enumerate(level["convs"]):
            add(f"net/up_blocks/{lvl}/conv_layers/{j}/kernel", conv["kernel"].shape)
            add(f"net/up_blocks/{lvl}/conv_layers/{j}/bias", conv["bias"].shape)
    add("net/head_conv/kernel", params["head"]["kernel"].shape)
    add("net/head_conv/bias", params["head"]["bias"].shape)
    tensors["save_counter/.ATTRIBUTES/VARIABLE_VALUE"] = np.array(1, np.int64)
    jax_write_bundle(prefix, tensors)


def test_import_keras_checkpoint_equals_jax(tmp_path):
    params = _golden_tree()
    prefix = str(tmp_path / "tf_ckpt")
    _fake_tf2_checkpoint(prefix, params)
    variables = tf_import.load_tf_variables(prefix)
    assert "save_counter" not in variables
    assert not any(".OPTIMIZER_SLOT" in k for k in variables)
    got, got_report = tf_import.import_keras_ulstm(prefix, params)
    want, want_report = jax_import(prefix, params)
    assert got_report == want_report
    assert got_report["encoder[0].lstm[0]"] == "net/down_blocks/0/lstm_layers/0/cell"
    flat_got, flat_want = convert.flatten_tree(got), convert.flatten_tree(want)
    assert sorted(flat_got) == sorted(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)


def test_export_bundle_of_golden_params_imports_bit_for_bit(tmp_path):
    """A bundle the reference's ``export_tf_bundle`` writes from the golden
    params imports back to them exactly (by slot name; the reference's own
    importer matches only object-graph checkpoints and raises on it)."""
    params = _golden_tree()
    prefix = str(tmp_path / "export")
    jax_export(prefix, params)
    got, report = tf_import.import_keras_ulstm(prefix, params)
    flat = convert.flatten_tree(params)
    assert sorted(report) == sorted(flat)
    for k, v in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    with pytest.raises(ValueError, match="no TF layer matches"):
        jax_import(prefix, params)
    tf_import.export_tf_bundle(str(tmp_path / "port_export"), params)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(prefix + suffix, "rb").read() == \
            open(str(tmp_path / "port_export") + suffix, "rb").read()


@pytest.mark.parametrize("kind", ["object_graph", "export"])
def test_import_shape_mismatch_fails_loudly(tmp_path, kind):
    params = _golden_tree()
    prefix = str(tmp_path / "tf_ckpt")
    if kind == "export":
        params["head"]["kernel"] = np.zeros((1, 1, 8, 4), np.float32)
        tf_import.export_tf_bundle(prefix, params)
        params = _golden_tree()
    else:
        _fake_tf2_checkpoint(prefix, params)
        params["encoder"][1]["lstm"][0]["kernel_h"] = np.zeros((3, 3, 12, 48), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tf_import.import_keras_ulstm(prefix, params)


def test_import_refuses_a_layer_that_fits_several_flagship_slots(tmp_path):
    """At the flagship, encoder level 0's two convs and decoder level 0's
    second conv share one shape: the structural mapping refuses a TF layer
    of that shape instead of taking the first slot (the reference takes it).
    The tree holds shapes only; the checkpoint holds those three layers."""
    with torch.device("meta"):
        model = ULSTMnet2D(ModelConfig.make(default_net_kernel_params()))
    zero = np.float32(0)
    params = convert._unflatten({
        k.replace(".", "/"): np.broadcast_to(
            zero, (t.shape[2], t.shape[3], t.shape[1], t.shape[0]) if t.ndim == 4
            else tuple(t.shape))
        for k, t in model.state_dict().items()})
    conv = params["encoder"][0]["convs"][0]
    assert np.shape(params["decoder"][0]["convs"][1]["kernel"]) == np.shape(conv["kernel"])
    rng = np.random.default_rng(0)
    tensors = {}
    for path in ("net/down_blocks/0/conv_layers/0", "net/down_blocks/0/conv_layers/1",
                 "net/up_blocks/0/conv_layers/1"):
        for leaf in ("kernel", "bias"):
            tensors[f"{path}/{leaf}/.ATTRIBUTES/VARIABLE_VALUE"] = rng.normal(
                size=np.shape(conv[leaf])).astype(np.float32)
    prefix = str(tmp_path / "tf_ckpt")
    jax_write_bundle(prefix, tensors)
    with pytest.raises(ValueError, match=r"fits 3 slots \(encoder\[0\]\.convs\[0\], "
                                         r"encoder\[0\]\.convs\[1\], decoder\[0\]"
                                         r"\.convs\[1\]\).*ambiguous"):
        tf_import.import_keras_ulstm(prefix, params)


def test_import_tf_cli_list_and_end_to_end_into_inference2d(tmp_path, capsys):
    """The golden params exported, imported by the CLI into a model dir, and
    streamed by inference2d: the golden masks, bit for bit."""
    prefix = str(tmp_path / "tf" / "model.ckpt")
    jax_export(prefix, _golden_tree())
    import_tf.main(["--tf_prefix", prefix, "--output_dir", "unused", "--list"])
    listed = capsys.readouterr().out.splitlines()
    assert "encoder/0/lstm/0/kernel_x [3, 3, 1, 32]" in listed and len(listed) == 16
    out_dir = str(tmp_path / "imported")
    import_tf.main(["--tf_prefix", prefix, "--output_dir", out_dir, "--net_kernel_params",
                    json.dumps(tiny_net_kernel_params().to_dict())])
    arch = json.load(open(os.path.join(out_dir, "model_params.json")))
    assert arch["imported_from"] == prefix
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), **GOLDEN_DATA)
    res = str(tmp_path / "res")
    assert inference2d.main(["--model_path", out_dir, "--sequence_path", seq_dir,
                             "--output_path", res, "--device", "cpu",
                             "--pre_sequence_frames", "2", "--min_cell_size", "5",
                             "--dtype", "float32"]) == 8
    for g in sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif"))):
        np.testing.assert_array_equal(read_tiff(os.path.join(res, os.path.basename(g))),
                                      read_tiff(g))
