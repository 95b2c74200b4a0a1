"""The port's io, preprocessing, engine and CLI against the JAX reference.

Percentile bounds of integer frames are exact (equal); float percentiles
agree with ``jnp.percentile`` to 1e-6 relative (both f32 linear
interpolation). The golden end-to-end run must reproduce the committed masks
bit for bit.
"""

import glob
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_unet_tpu.io import preprocess as jax_pre
from lstm_unet_tpu.io import synthetic as jax_synth
from lstm_unet_tpu.io.dataset import CTCInferenceReader as JaxReader
from lstm_unet_tpu.io.tiff import read_tiff as jax_read_tiff
from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
from lstm_unet_tpu_torch.config import InferenceParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.engine import infer
from lstm_unet_tpu_torch.io import preprocess, synthetic, tiff
from lstm_unet_tpu_torch.io.dataset import CTCInferenceReader
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops.kernels.ccl import INT_MAX
from lstm_unet_tpu_torch.utils import StallWatchdog

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)


# ---------------------------------------------------------------- preprocess


@pytest.mark.parametrize("dtype,shape", [(np.uint16, (33, 47)), (np.uint8, (64, 64)),
                                         (np.uint16, (1, 5))])
def test_integer_percentile_bounds_equal_jax(dtype, shape):
    r = np.random.default_rng(0)
    x = r.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    x.flat[:3] = 7  # ties
    got = preprocess.integer_percentile_bounds(torch.from_numpy(x.astype(np.int32)))
    want = jax_pre.integer_percentile_bounds(jnp.asarray(x), 1.0, 99.0)
    want_sort = np.percentile(x.astype(np.float32), [1.0, 99.0])
    for g, w, s in zip(got, want, want_sort):
        assert g.dtype == torch.float32
        assert float(g) == float(w)
        np.testing.assert_allclose(float(g), s, rtol=1e-6)


def test_float_percentile_bounds_match_jnp_percentile():
    x = np.random.default_rng(1).normal(100, 30, (37, 29)).astype(np.float32)
    got = preprocess.float_percentile_bounds(torch.from_numpy(x))
    want = np.asarray(jnp.percentile(jnp.asarray(x.reshape(-1)), jnp.array([1.0, 99.0])))
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-6)


def test_normalize_frame_uses_the_unpadded_crop():
    frame = np.zeros((16, 16), np.uint16)
    frame[:10, :12] = np.arange(120, dtype=np.uint16).reshape(10, 12)
    frame[10:, :] = 60000  # padding-like rows must not move the stats
    got = preprocess.normalize_frame(torch.from_numpy(frame.astype(np.int32)), 10, 12)
    lo, hi = np.percentile(frame[:10, :12].astype(np.float32), [1.0, 99.0])
    np.testing.assert_allclose(got.numpy(), (frame.astype(np.float32) - lo) / (hi - lo),
                               rtol=1e-6)


def test_numpy_twins_match_reference():
    img = np.random.default_rng(2).integers(0, 4000, (20, 30)).astype(np.uint16)
    np.testing.assert_array_equal(preprocess.percentile_normalize_np(img),
                                  jax_pre.percentile_normalize_np(img))
    for m in (4, 8):
        a, pa = preprocess.pad_to_multiple(img, m)
        b, pb = jax_pre.pad_to_multiple(img, m)
        np.testing.assert_array_equal(a, b)
        assert pa == pb


# ---------------------------------------------------------------- io


def test_tiff_codec_reads_golden_masks_like_reference():
    paths = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    assert paths
    for p in paths:
        with open(p, "rb") as f:
            got = tiff._read_uncompressed(f.read())  # the numpy path itself
        want = jax_read_tiff(p)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_tiff_round_trip_and_reference_layout(tmp_path, dtype):
    arr = np.random.default_rng(3).integers(0, np.iinfo(dtype).max, (7, 13)).astype(dtype)
    path = str(tmp_path / "x.tif")
    tiff.write_tiff(path, arr)
    np.testing.assert_array_equal(tiff.read_tiff(path), arr)
    np.testing.assert_array_equal(jax_read_tiff(path), arr)
    if dtype == np.uint16:  # byte-for-byte the reference native writer's masks
        golden = os.path.join(GOLDEN, "masks", "mask000.tif")
        tiff.write_tiff(path, jax_read_tiff(golden))
        with open(path, "rb") as a, open(golden, "rb") as b:
            assert a.read() == b.read()


def test_tiff_reads_big_endian(tmp_path):
    arr = np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000
    pix = arr.astype(">u2").tobytes()
    entries = [(256, 4), (257, 3), (258, 16), (259, 1), (273, 8), (277, 1),
               (278, 3), (279, len(pix))]
    ifd = struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHIHH", t, 3, 1, v, 0) for t, v in entries) + b"\0" * 4
    path = tmp_path / "be.tif"
    path.write_bytes(struct.pack(">2sHI", b"MM", 42, 8 + len(pix)) + pix + ifd)
    np.testing.assert_array_equal(tiff.read_tiff(str(path)), arr)


def test_tiff_rejects_unsupported_writes(tmp_path):
    with pytest.raises(ValueError, match="uint8/uint16"):
        tiff.write_tiff(str(tmp_path / "f.tif"), np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("kw", [dict(), dict(overlap_frac=0.5, overlap_gap=(0.45, 0.95),
                                             overlap_match_intensity=True,
                                             overlap_rel_velocity=0.3)])
def test_synthetic_sequence_equals_reference(kw):
    args = dict(num_frames=3, height=40, width=36, num_cells=5, seed=7, **kw)
    for got, want in zip(synthetic.make_cell_sequence(**args),
                         jax_synth.make_cell_sequence(**args)):
        np.testing.assert_array_equal(got, want)


def test_reader_yields_warm_up_frames_reversed_like_reference(tmp_path):
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path), num_frames=5, height=16,
                                             width=16, seed=1)
    got = list(CTCInferenceReader(seq_dir, pre_sequence_frames=3, normalize=False))
    want = list(JaxReader(seq_dir, pre_sequence_frames=3, normalize=False))
    assert [i for i, _ in got] == [None, None, None, 0, 1, 2, 3, 4]
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][1], got[5][1])  # warm-up starts at t002
    with pytest.raises(FileNotFoundError):
        CTCInferenceReader(str(tmp_path / "missing"))


# ---------------------------------------------------------------- end to end


def _golden_cli(tmp_path, *extra):
    root = str(tmp_path / "ctc")
    seq_dir, _ = synthetic.write_ctc_dataset(root, **GOLDEN_DATA)
    out = str(tmp_path / "res")
    n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"),
                  "--sequence_path", seq_dir, "--output_path", out, "--device", "cpu",
                  "--pre_sequence_frames", "2", "--min_cell_size", "5",
                  "--dtype", "float32", *extra])
    return n, out


def test_golden_masks_bit_exact_on_cpu(tmp_path):
    n, out = _golden_cli(tmp_path)
    golden = sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif")))
    assert n == len(golden) == 8
    nonzero = 0
    for g in golden:
        want = tiff.read_tiff(g)
        got = tiff.read_tiff(os.path.join(out, os.path.basename(g)))
        np.testing.assert_array_equal(got, want, err_msg=os.path.basename(g))
        nonzero += int(want.max() > 0)
    assert nonzero > 0


def test_cli_digit_4_and_intermediate_probs(tmp_path):
    n, out = _golden_cli(tmp_path, "--digit_4", "--save_intermediate", "--fused_cell")
    assert n == 8 and os.path.exists(os.path.join(out, "mask0007.tif"))
    probs = np.load(os.path.join(out, "intermediate", "probs007.npy"))
    assert probs.shape == (32, 32, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("flag", [["--dtype", "int8"], ["--tta"], ["--tta_mode", "d4"],
                                  ["--instance_split"], ["--split_rel", "0.5"],
                                  ["--reset_on_jump", "0.2"], ["--conv_method", "conv"],
                                  ["--entry_layouts"], ["--calibrate", "2"]])
def test_cli_rejects_unported_flags(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_main(["--model_path", "m", "--sequence_path", "s", "--output_path",
                  str(tmp_path), "--device", "cpu", *flag])


def test_cli_recipe(tmp_path):
    with pytest.raises(NotImplementedError, match="instance_split"):
        cli_main(["--model_path", "m", "--sequence_path", "s", "--output_path",
                  str(tmp_path), "--device", "cpu", "--recipe",
                  os.path.join(HERE, "..", "configs", "recommended.json")])
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps({"winner": {"fov": 3, "cell_thresh": 0.6,
                                             "class_weights": [1, 2, 3]}}))
    n, out = _golden_cli(tmp_path, "--recipe", str(recipe), "--cell_thresh", "0.5")
    assert n == 8


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        infer.resolve_device("cuda")


def test_engine_raises_past_uint16(tmp_path, monkeypatch):
    """A poisoned map (more than 65535 instances) stops the stream."""
    seq_dir, _ = synthetic.write_ctc_dataset(str(tmp_path), num_frames=2, height=16,
                                             width=16, seed=0)
    monkeypatch.setattr(infer, "postprocess_frame",
                        lambda p, **kw: torch.full(p.shape[:2], INT_MAX, dtype=torch.int32))
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()))
    ip = InferenceParams(sequence_path=seq_dir, output_path=str(tmp_path / "o"),
                         pre_sequence_frames=0, dtype="float32")
    with pytest.raises(ValueError, match="uint16"):
        infer.run_inference(ip, device="cpu", model=model)


def test_engine_pads_odd_frames_and_crops_back():
    ip = InferenceParams(dtype="float32", min_cell_size=0)
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()),
                       generator=torch.Generator().manual_seed(0))
    engine = infer.StreamingInferenceEngine(model, ip, "cpu")
    frame = np.random.default_rng(0).integers(0, 900, (13, 30)).astype(np.uint16)
    labels, probs = engine.process_frame(frame)
    assert labels.shape == (13, 30) and labels.dtype == np.int32 and probs is None
    assert [h.shape[1:3] for h, _ in (lvl[0] for lvl in engine._state)] == [(16, 32), (8, 16)]
    with pytest.raises(ValueError, match="uint8/uint16"):
        engine.process_frame(frame.astype(np.int64))


def test_stall_watchdog_fires_and_stops():
    fired = []
    wd = StallWatchdog(timeout_s=0.05, on_stall=fired.append).start()
    wd._thread.join(timeout=5)
    assert fired and not wd._thread.is_alive()
    wd2 = StallWatchdog(timeout_s=5.0, on_stall=fired.append).start()
    wd2.feed()
    wd2.stop()
    wd2._thread.join(timeout=5)
    assert len(fired) == 1 and not wd2._thread.is_alive()
