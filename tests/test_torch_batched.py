"""Batched streams of the port (``engine/infer.py::run_inference_batched``)
against single-sequence streams and the JAX package's `run_inference_batched`, on
the golden model on the CPU: masks bit for bit."""

import glob
import os

import numpy as np
import pytest
import torch

from lstm_unet_tpu.config import CTCInferenceParams
from lstm_unet_tpu.engine.infer import run_inference_batched as jax_batched
from lstm_unet_tpu_torch.config import InferenceParams
from lstm_unet_tpu_torch.engine import infer
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff, write_tiff

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
TORCH_CKPT = os.path.join(GOLDEN, "torch_ckpt")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """Two 32^2 sequences of 8 and 6 frames: lane 1 ends first."""
    root = str(tmp_path_factory.mktemp("ctc"))
    return [synthetic.write_ctc_dataset(root, seq=seq, num_frames=n, height=32, width=32,
                                        num_cells=3, seed=seed)[0]
            for seq, n, seed in (("01", 8, 123), ("02", 6, 7))]


def _masks(out):
    return {os.path.basename(p): read_tiff(p)
            for p in sorted(glob.glob(os.path.join(out, "mask*.tif")))}


def _assert_same(a, b):
    assert a and sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


KW = dict(min_cell_size=5, pre_sequence_frames=2, dtype="float32")


@pytest.mark.parametrize("extra", [{}, dict(tta=True), dict(tta=True, tta_mode="d4"),
                                   dict(reset_on_jump=0.4)])
def test_batched_equals_single_and_jax(seqs, tmp_path, extra):
    """Each lane of a batched run equals its sequence streamed alone, and
    the masks of the JAX package's batched run."""
    ip = InferenceParams(model_path=TORCH_CKPT, **KW, **extra)
    outs = [str(tmp_path / f"b{i}") for i in range(2)]
    assert infer.run_inference_batched(ip, seqs, outs, device="cpu") == 8 + 6
    jax_outs = [str(tmp_path / f"j{i}") for i in range(2)]
    assert jax_batched(CTCInferenceParams(model_path=os.path.join(GOLDEN, "ckpt"), **KW,
                                          **extra), seqs, jax_outs) == 8 + 6
    for i, seq in enumerate(seqs):
        single = InferenceParams(model_path=TORCH_CKPT, sequence_path=seq,
                                 output_path=str(tmp_path / f"s{i}"), **KW, **extra)
        infer.run_inference(single, device="cpu")
        got = _masks(outs[i])
        _assert_same(got, _masks(single.output_path))
        _assert_same(got, _masks(jax_outs[i]))
    assert any(m.max() > 0 for m in got.values())


def test_batched_int8_dynamic_scale_is_shared_across_lanes(seqs, tmp_path):
    """int8 with dynamic scales: the scale of a conv is one abs-max over all
    lanes, as the reference takes it, so the batched masks equal the JAX
    batched int8 run's, and a lane's probabilities depend on the other
    lane (they differ from the same sequence streamed alone)."""
    kw = dict(KW, dtype="int8", save_intermediate=True)
    outs = [str(tmp_path / f"b{i}") for i in range(2)]
    infer.run_inference_batched(InferenceParams(model_path=TORCH_CKPT, **kw), seqs, outs,
                                device="cpu")
    jax_outs = [str(tmp_path / f"j{i}") for i in range(2)]
    jax_batched(CTCInferenceParams(model_path=os.path.join(GOLDEN, "ckpt"), **kw), seqs,
                jax_outs)
    for got, want in zip(outs, jax_outs):
        _assert_same(_masks(got), _masks(want))
    single = InferenceParams(model_path=TORCH_CKPT, sequence_path=seqs[0],
                             output_path=str(tmp_path / "s0"), **kw)
    infer.run_inference(single, device="cpu")
    p_batched = np.load(os.path.join(outs[0], "intermediate", "probs005.npy"))
    p_single = np.load(os.path.join(single.output_path, "intermediate", "probs005.npy"))
    assert not np.array_equal(p_batched, p_single)


@pytest.mark.parametrize("poison_live", [False, True])
def test_overflow_check_is_per_surviving_lane(seqs, tmp_path, monkeypatch, poison_live):
    """A poisoned (> uint16) label map on a lane whose sequence has ended is
    discarded; on a live lane it stops the stream, naming the lane."""
    ip = InferenceParams(model_path=TORCH_CKPT, **dict(KW, pre_sequence_frames=0))
    step = infer.StreamingInferenceEngine.step_batch_async
    calls = [0]

    def poisoned(self, frames):
        labels, probs = step(self, frames)
        calls[0] += 1
        labels = labels.clone()
        if poison_live:
            labels[0] = 2 ** 31 - 1  # lane 0 runs 8 frames
        elif calls[0] > 6:  # lane 1 (6 frames) has ended
            labels[1] = 2 ** 31 - 1
        return labels, probs

    monkeypatch.setattr(infer.StreamingInferenceEngine, "step_batch_async", poisoned)
    outs = [str(tmp_path / "o0"), str(tmp_path / "o1")]
    if poison_live:
        with pytest.raises(ValueError, match="lane 0"):
            infer.run_inference_batched(ip, seqs, outs, device="cpu")
    else:
        assert infer.run_inference_batched(ip, seqs, outs, device="cpu") == 8 + 6
        assert len(_masks(outs[0])) == 8 and len(_masks(outs[1])) == 6


def test_batched_save_intermediate_per_lane(seqs, tmp_path):
    ip = InferenceParams(model_path=TORCH_CKPT, save_intermediate=True,
                         save_intermediate_path=str(tmp_path / "shared"), **KW)
    outs = [str(tmp_path / "o0"), str(tmp_path / "o1")]
    infer.run_inference_batched(ip, seqs, outs, device="cpu")
    for out, n in zip(outs, (8, 6)):
        probs = sorted(glob.glob(os.path.join(out, "intermediate", "probs*.npy")))
        assert len(probs) == n
        p = np.load(probs[-1])
        assert p.shape == (32, 32, 3)
        np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    assert not os.path.exists(str(tmp_path / "shared"))


def test_batched_rejects_unequal_shapes(seqs, tmp_path):
    other = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), num_frames=3, height=32,
                                        width=36, seed=1)[0]
    ip = InferenceParams(model_path=TORCH_CKPT, **KW)
    with pytest.raises(ValueError, match="equal frame shapes"):
        infer.run_inference_batched(ip, [seqs[0], other], [str(tmp_path / "a"),
                                                           str(tmp_path / "b")], device="cpu")
    # a frame of another shape in the middle of a lane's sequence
    write_tiff(os.path.join(other, "t001.tif"), np.zeros((32, 32), np.uint16))
    with pytest.raises(ValueError, match="mid-sequence"):
        infer.run_inference_batched(ip, [other], [str(tmp_path / "c")], device="cpu")


def test_batched_engine_state_has_a_lane_per_sequence_and_variant():
    model = infer.load_model(TORCH_CKPT, "cpu", dtype="float32")
    eng = infer.StreamingInferenceEngine(model, InferenceParams(tta=True, reset_on_jump=0.3),
                                         "cpu")
    frames = np.random.default_rng(0).integers(0, 900, (3, 13, 30)).astype(np.uint16)
    labels, probs = eng.step_batch_async(frames)
    assert labels.shape == (3, 13, 30) and probs is None
    assert eng._state[0][0][0].shape == (12, 16, 32, 8)
    assert eng._prev.shape == (3, 16, 32) and torch.isfinite(eng._prev).all()
