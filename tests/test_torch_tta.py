"""Test-time augmentation and reset_on_jump of the port's streaming engine
against the JAX package's, on the golden model in f32 on the CPU.

Probabilities are held to the reference TTA test's tolerance (rtol 2e-5,
atol 2e-6: the mean over the variants is an f32 sum in another order than
XLA's), masks bit for bit.
"""

import os

import numpy as np
import pytest

from lstm_unet_tpu.config import CTCInferenceParams
from lstm_unet_tpu.engine.infer import StreamingInferenceEngine as JaxEngine
from lstm_unet_tpu.engine.infer import load_model as jax_load_model
from lstm_unet_tpu_torch.checkpoint import load_model
from lstm_unet_tpu_torch.config import InferenceParams
from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine
from lstm_unet_tpu_torch.io.synthetic import make_cell_sequence

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module")
def models():
    params, cfg = jax_load_model(os.path.join(GOLDEN, "ckpt"), dtype="float32")
    return (params, cfg), load_model(os.path.join(GOLDEN, "torch_ckpt"), "cpu",
                                     dtype="float32")


def _engines(models, **kw):
    (params, cfg), model = models
    kw = dict(dict(min_cell_size=5, dtype="float32", save_intermediate=True), **kw)
    return (JaxEngine(params, cfg, CTCInferenceParams(**kw)),
            StreamingInferenceEngine(model, InferenceParams(**kw), "cpu"))


def _golden_frames(n=4, height=32, width=32):
    return list(make_cell_sequence(num_frames=n, height=height, width=width, num_cells=3,
                                   seed=123)[0])


def _stream_both(models, frames, **kw):
    jax_eng, eng = _engines(models, **kw)
    for t, f in enumerate(frames):
        want_mask, want_probs = jax_eng.process_frame(f)
        got_mask, got_probs = eng.process_frame(f)
        np.testing.assert_allclose(got_probs, want_probs, rtol=RTOL, atol=ATOL,
                                   err_msg=f"frame {t}")
        np.testing.assert_array_equal(got_mask, want_mask, err_msg=f"frame {t}")
    return eng


@pytest.mark.parametrize("mode,shape", [("flip", (32, 32)), ("d4", (32, 32)),
                                        ("flip", (30, 37))])
def test_tta_equals_jax(models, mode, shape):
    """Uint16 frames of the golden recipe; (30, 37) pads, so the variants
    move the reflect padding to other borders."""
    eng = _stream_both(models, _golden_frames(4, *shape), tta=True, tta_mode=mode)
    assert eng.n_var == (8 if mode == "d4" else 4)
    assert eng._state[0][0][0].shape[0] == eng.n_var


def test_tta_mode_without_tta_is_the_plain_stream(models):
    (_, _), model = models
    frames = _golden_frames(3)
    plain = StreamingInferenceEngine(model, InferenceParams(dtype="float32",
                                                            save_intermediate=True), "cpu")
    d4 = StreamingInferenceEngine(model, InferenceParams(dtype="float32", tta_mode="d4",
                                                         save_intermediate=True), "cpu")
    assert d4.n_var == 1
    for f in frames:
        a, b = plain.process_frame(f), d4.process_frame(f)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


FLIPS = (lambda a: a, lambda a: a[::-1], lambda a: a[:, ::-1], lambda a: a[::-1, ::-1])
D4 = FLIPS + tuple((lambda f: lambda a: f(np.swapaxes(a, 0, 1)))(f) for f in FLIPS)
# inverse of (transpose, then flip) = (undo the flip, then transpose)
D4_INV = FLIPS + tuple((lambda f: lambda a: np.swapaxes(f(a), 0, 1))(f) for f in FLIPS)


@pytest.mark.parametrize("mode", ["flip", "d4"])
def test_tta_probs_are_the_mean_of_transformed_streams(models, mode):
    """At a size that needs no padding, the TTA engine's probabilities are
    the mean over independent plain streams of each transformed frame,
    aligned back: the variants' order, their separate states and the
    inverse transforms in one property (the reference's own oracle)."""
    (_, _), model = models
    fwd, inv = (FLIPS, FLIPS) if mode == "flip" else (D4, D4_INV)
    kw = dict(dtype="float32", save_intermediate=True, min_cell_size=3)
    tta = StreamingInferenceEngine(model, InferenceParams(tta=True, tta_mode=mode, **kw), "cpu")
    singles = [StreamingInferenceEngine(model, InferenceParams(**kw), "cpu") for _ in fwd]
    rng = np.random.default_rng(5)
    for _ in range(3):
        frame = rng.normal(0.5, 0.2, (32, 32)).astype(np.float32)
        _, probs = tta.process_frame(frame)
        want = np.mean([i(eng.process_frame(np.ascontiguousarray(f(frame)))[1])
                        for f, i, eng in zip(fwd, inv, singles)], axis=0)
        np.testing.assert_allclose(probs, want, rtol=RTOL, atol=ATOL)


def test_tta_d4_pads_a_non_square_frame_square(models):
    eng = _stream_both(models, _golden_frames(3, 32, 20), tta=True, tta_mode="d4",
                       min_cell_size=3)
    assert [lvl[0][0].shape[1:3] for lvl in eng._state] == [(32, 32), (16, 16)]
    mask, probs = eng.process_frame(_golden_frames(1, 32, 20)[0])
    assert mask.shape == (32, 20) and probs.shape == (32, 20, 3)


def _with_cut(frames):
    """The golden frames with an intensity-inverted frame spliced in: two
    scene cuts (into it and out of it)."""
    return frames[:3] + [(60000 - frames[3].astype(np.int64)).astype(np.uint16)] + frames[3:]


@pytest.mark.parametrize("tta", [False, True])
def test_reset_on_jump_equals_jax(models, tta):
    _stream_both(models, _with_cut(_golden_frames(5)), reset_on_jump=0.4, tta=tta)


def test_reset_on_jump_resets_at_the_cut_only(models):
    """The frame after a cut equals a fresh stream's first frame; without
    the option the carried state leaks into it; frames without a cut are
    the plain stream's."""
    (_, _), model = models
    frames = _with_cut(_golden_frames(5))
    kw = dict(dtype="float32", save_intermediate=True, min_cell_size=3)

    def stream(thresh, fs):
        eng = StreamingInferenceEngine(model, InferenceParams(reset_on_jump=thresh, **kw),
                                       "cpu")
        return [eng.process_frame(f) for f in fs]

    reset, plain = stream(0.4, frames), stream(0.0, frames)
    for t in range(3):  # before the cut: no reset
        np.testing.assert_array_equal(reset[t][1], plain[t][1])
    for t in (3, 4):  # each cut: the state starts from zero
        fresh = stream(0.0, [frames[t]])[0]
        np.testing.assert_array_equal(reset[t][1], fresh[1])
        np.testing.assert_array_equal(reset[t][0], fresh[0])
        assert not np.array_equal(plain[t][1], fresh[1])
    np.testing.assert_array_equal(reset[5][1], stream(0.0, frames[4:6])[1][1])


def test_unknown_tta_mode_raises(models):
    with pytest.raises(ValueError, match="tta_mode"):
        StreamingInferenceEngine(models[1], InferenceParams(tta=True, tta_mode="d8"), "cpu")


def test_inference_params_surface_defaults_are_the_references():
    ours, ref = InferenceParams(), CTCInferenceParams()
    for name in ("tta", "tta_mode", "reset_on_jump"):
        assert getattr(ours, name) == getattr(ref, name), name
