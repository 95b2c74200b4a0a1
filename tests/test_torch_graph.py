"""The port's compiled step (``engine/graph.py``) on the CPU.

The streaming step is one function, ``StreamingInferenceEngine._body``,
run by ``CompiledStep`` over two sets of carried buffers that the steps
read and write in turn. On a card it is captured as CUDA graphs; here it
runs eagerly, and through a stand-in for the graphs (:class:`StandIn`)
that warms up, captures (running nothing that stays: the buffers are put
back) and replays (running the body again and writing the captured
outputs, counting no launch itself), as a card's graphs do.

Streamed frames are held to the JAX package's engine on the golden model:
labels bit for bit; probabilities in f32 within the TTA test's bar (rtol
2e-5, atol 2e-6, ``tests/test_torch_tta.py``), and in bf16 and int8 within
what ``tests/test_torch_quant.py``'s logit bar implies (a logit gap below
2^-5 of the largest |logit|; a softmax moves no probability by more than
half the largest logit gap, so 2^-6 of the largest |logit|, read from the
port's logits).
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import CTCInferenceParams
from lstm_unet_tpu.engine import infer as jax_infer
from lstm_unet_tpu.engine.infer import StreamingInferenceEngine as JaxEngine
from lstm_unet_tpu_torch.checkpoint import load_model
from lstm_unet_tpu_torch.config import InferenceParams
from lstm_unet_tpu_torch.engine import infer
from lstm_unet_tpu_torch.engine.graph import CompiledStep
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff
from lstm_unet_tpu_torch.ops import kernels

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)
RTOL, ATOL = 2e-5, 2e-6  # f32 probabilities (tests/test_torch_tta.py)
FRAME_BAR = 2.0 ** -5  # bf16 / int8 logits, relative (tests/test_torch_quant.py)
FRAMES = 6


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


class _Replay:
    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        """Run the captured body again into the captured outputs; a replay
        runs no wrapper, so the wrappers' counts are put back."""
        before = kernels.snapshot()
        for out, new in zip(self.outputs, self.fn()):
            if out is not None:
                out.copy_(new)
        for name, (k, p) in before.items():
            kernels.KERNELS[name].kernel, kernels.KERNELS[name].plain = k, p


class StandIn:
    """``engine/graph.py::CudaGraphs`` on the CPU, for the carried ``sets``."""

    def __init__(self, sets, fail: bool = False):
        self.sets, self.fail, self.pools = sets, fail, 0

    def warm_up(self, fn):
        return fn()

    def new_pool(self):
        self.pools += 1

    def capture(self, fn):
        saved = [t.clone() for t in _tensors(self.sets)]
        out = fn()
        for t, s in zip(_tensors(self.sets), saved):  # a capture runs nothing
            t.copy_(s)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return _Replay(fn, out), out


def _stand_in(engine, b, oh, ow):
    """Build ``engine``'s step for B lanes of oh x ow frames, its graphs
    the stand-in."""
    engine._build(oh, ow, b)
    engine._step.graphs = StandIn(engine._step.sets)
    return engine


def _frames(n=FRAMES, seed=123):
    return list(synthetic.make_cell_sequence(num_frames=n, height=32, width=32, num_cells=3,
                                             seed=seed)[0])


def _with_cut(frames):
    """An intensity-inverted frame spliced in at 3: two scene cuts."""
    return frames[:3] + [(60000 - frames[3].astype(np.int64)).astype(np.uint16)] + frames[3:-1]


@pytest.fixture(scope="module")
def int8_dirs(tmp_path_factory):
    """Copies of the golden model dirs (JAX, port), each calibrated on 4
    golden frames by its own package."""
    tmp = tmp_path_factory.mktemp("int8")
    seq, _ = synthetic.write_ctc_dataset(str(tmp / "ctc"), **GOLDEN_DATA)
    jdir, tdir = str(tmp / "ckpt"), str(tmp / "torch_ckpt")
    shutil.copytree(os.path.join(GOLDEN, "ckpt"), jdir)
    shutil.copytree(os.path.join(GOLDEN, "torch_ckpt"), tdir)
    jax_infer.calibrate_model_dir(jdir, seq, n_frames=4)
    infer.calibrate_model_dir(tdir, seq, n_frames=4, device="cpu")
    return jdir, tdir


def _fused_twin(gx, h, c, wh, recurrent_activation="sigmoid"):
    """The reference fused kernel's math in XLA (as ``tests/test_torch_quant.py``
    holds it), for the tiny levels its TPU kernel does not take."""
    from lstm_unet_tpu.ops.pallas.convlstm_cell import _recurrent_act

    feat = c.shape[-1]
    acc = jax.lax.conv_general_dilated(
        h.astype(wh.dtype)[None], wh, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)[0]
    z = acc + gx.astype(jnp.float32)
    act = recurrent_activation
    i, f = _recurrent_act(z[..., :feat], act), _recurrent_act(z[..., feat:2 * feat], act)
    g, o = jnp.tanh(z[..., 2 * feat:3 * feat]), _recurrent_act(z[..., 3 * feat:], act)
    c_new = f * c.astype(jnp.float32) + i * g
    return (o * jnp.tanh(c_new)).astype(h.dtype), c_new.astype(c.dtype)


# name -> (dtype, fused, lanes, InferenceParams fields, frames)
CASES = {
    "f32": ("float32", False, 1, {}, _frames),
    "f32 fused": ("float32", True, 1, {}, _frames),
    "bf16": ("bfloat16", False, 1, {}, _frames),
    "bf16 fused": ("bfloat16", True, 1, {}, _frames),
    "int8 calibrated": ("int8", False, 1, {}, _frames),
    "tta flip": ("float32", False, 1, dict(tta=True), _frames),
    "reset_on_jump": ("float32", False, 1, dict(reset_on_jump=0.4),
                      lambda: _with_cut(_frames())),
    "B = 2": ("float32", False, 2, {}, lambda: [np.stack(f) for f in
                                                zip(_frames(), _frames(seed=7))]),
}


def _jax_stream(case, frames, jdir, monkeypatch):
    """(labels, probs) of each frame, ``[B, H, W]`` and ``[B, H, W, 3]``,
    from the JAX package's engine."""
    dtype, fused, lanes, kw, _ = CASES[case]
    if fused:
        from lstm_unet_tpu.ops.pallas import convlstm_cell as jcell

        monkeypatch.setattr(jcell, "supported", lambda *a: True)
        monkeypatch.setattr(jcell, "fused_convlstm_level", _fused_twin)
    params, cfg = jax_infer.load_model(jdir, dtype=dtype, fused_cell=fused)
    eng = JaxEngine(params, cfg, CTCInferenceParams(model_path=jdir, dtype=dtype,
                                                    min_cell_size=5, save_intermediate=True,
                                                    **kw))
    eng._build(*frames[0].shape[1:], batch=lanes)
    out = []
    for f in frames:
        x = jnp.asarray(np.stack([eng._pad_frame(lane) for lane in f]))[..., None]
        eng._state, labels, probs = eng._step(eng._state, x)
        out.append((np.asarray(labels), np.asarray(probs)))
    return out


def _engine(case, tdir):
    dtype, fused, _, kw, _ = CASES[case]
    model = load_model(tdir, "cpu", dtype=dtype, fused_cell=fused)
    return infer.StreamingInferenceEngine(
        model, InferenceParams(model_path=tdir, dtype=dtype, min_cell_size=5,
                               save_intermediate=True, **kw), "cpu")


# Labels differing from the JAX engine's, per frame, where the two packages'
# arithmetic differs: bf16 with the fused cell, whose K4 plain version sums
# the h-conv in f32 in PyTorch's order and rounds h' to bf16, where the
# reference's XLA twin sums in its own order (1 px at frame 4, measured, the
# same before the compiled step: the eager step of the parent tree gives
# these frames bit for bit). The bar is the repo's cross-backend one for a
# fused cell (``tests/test_torch_quant.py``: int8 fused <= 3 px), with equal
# instance counts.
LABEL_PX = {"bf16 fused": 3}


@pytest.mark.parametrize("case", list(CASES))
def test_body_in_ping_pong_equals_jax(case, int8_dirs, monkeypatch):
    """6 frames through the body over the two sets of carried buffers, run
    eagerly and through the stand-in graphs (warm-up, two captures, then
    replays): the two bit-equal, and both against the JAX engine. The sets
    keep their storage (the new state is written into them, never
    allocated) and alternate."""
    dtype, _, lanes, _, make = CASES[case]
    jdir, tdir = int8_dirs if dtype == "int8" else (os.path.join(GOLDEN, "ckpt"),
                                                     os.path.join(GOLDEN, "torch_ckpt"))
    frames = [f if f.ndim == 3 else f[None] for f in make()]
    want = _jax_stream(case, frames, jdir, monkeypatch)
    eager = []
    for mode in ("eager", "graphs"):
        eng = _engine(case, tdir)
        logits = []
        eng.model.head.register_forward_hook(lambda m, i, o: logits.append(o.float()))
        if mode == "graphs":
            _stand_in(eng, lanes, 32, 32)
        ptrs = None
        for t, f in enumerate(frames):
            turn = None if eng._step is None else eng._step.turn
            labels, probs = eng.step_batch_async(f)
            step = eng._step
            if ptrs is None:
                ptrs = [t_.data_ptr() for t_ in _tensors(step.sets)]
            assert [t_.data_ptr() for t_ in _tensors(step.sets)] == ptrs, (mode, t)
            assert turn is None or step.turn == 1 - turn
            assert step.captured == (mode == "graphs")
            if mode == "eager":
                eager.append((labels, probs))
            else:
                torch.testing.assert_close(labels, eager[t][0], rtol=0, atol=0)
                torch.testing.assert_close(probs, eager[t][1], rtol=0, atol=0)
            want_labels, want_probs = want[t]
            differ = int((labels.numpy() != want_labels).sum())
            assert differ <= LABEL_PX.get(case, 0), (mode, t, differ)
            assert len(np.unique(labels.numpy())) == len(np.unique(want_labels))
            if dtype == "float32":
                np.testing.assert_allclose(probs.numpy(), want_probs, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{mode} frame {t}")
            else:
                bar = FRAME_BAR / 2 * float(logits[-1].abs().max())
                gap = float(np.abs(probs.float().numpy() - want_probs).max())
                assert gap < bar, (mode, t, gap, bar)


@pytest.mark.parametrize("case", ["f32", "tta flip"])
def test_outputs_outlive_later_steps(case):
    """Each step's labels and probabilities are its own: no later step
    (a replay of either graph) writes them."""
    eng = _stand_in(_engine(case, os.path.join(GOLDEN, "torch_ckpt")), 1, 32, 32)
    kept = []
    for f in _frames():
        labels, probs = eng.step_batch_async(f[None])
        kept.append(((labels, labels.clone()), (probs, probs.clone())))
    for t, pairs in enumerate(kept):
        for got, then in pairs:
            torch.testing.assert_close(got, then, rtol=0, atol=0, msg=f"frame {t}")
    assert eng._step.graphs.pools == 1


def _stream_masks(tmp_path, seq, tag, graphs, monkeypatch):
    """``run_inference`` of the golden sequence ``seq`` with
    ``save_intermediate``; with the stand-in graphs when ``graphs``.
    Returns the output dir."""
    if graphs:
        build = infer.StreamingInferenceEngine._build

        def build_with_stand_in(self, oh, ow, batch=1):
            build(self, oh, ow, batch)
            self._step.graphs = StandIn(self._step.sets)

        monkeypatch.setattr(infer.StreamingInferenceEngine, "_build", build_with_stand_in)
    out = str(tmp_path / tag)
    ip = InferenceParams(model_path=os.path.join(GOLDEN, "torch_ckpt"), sequence_path=seq,
                         output_path=out, pre_sequence_frames=2, min_cell_size=5,
                         dtype="float32", save_intermediate=True)
    assert infer.run_inference(ip, device="cpu") == GOLDEN_DATA["num_frames"]
    monkeypatch.undo()
    return out


def test_stream_writes_each_frames_probabilities_under_its_index(tmp_path, monkeypatch):
    """``_stream`` dispatches frame t + 1 before it writes frame t: through
    the graphs each ``probs###.npy`` is still frame ###'s, as eagerly, and
    the masks are the golden ones."""
    seq, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), **GOLDEN_DATA)
    eager = _stream_masks(tmp_path, seq, "eager", False, monkeypatch)
    graphs = _stream_masks(tmp_path, seq, "graphs", True, monkeypatch)
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(eager, "intermediate",
                                                                       "probs*.npy")))
    assert len(names) == GOLDEN_DATA["num_frames"]
    for name in names:
        a = np.load(os.path.join(eager, "intermediate", name))
        b = np.load(os.path.join(graphs, "intermediate", name))
        np.testing.assert_array_equal(b, a, err_msg=name)
    for p in sorted(glob.glob(os.path.join(GOLDEN, "masks", "mask*.tif"))):
        np.testing.assert_array_equal(read_tiff(os.path.join(graphs, os.path.basename(p))),
                                      read_tiff(p), err_msg=os.path.basename(p))


@pytest.mark.parametrize("case", ["f32", "int8 calibrated"])
def test_replays_count_one_steps_launches(case, int8_dirs):
    """N steps through the graphs add N times one eager step's launches
    (on the CPU: the plain versions' calls), whatever the captures counted;
    the graph count reads 2 captures and N - 1 replays."""
    tdir = int8_dirs[1] if case == "int8 calibrated" else os.path.join(GOLDEN, "torch_ckpt")
    frames = _frames()
    eager = _engine(case, tdir)
    eager.step_batch_async(frames[0][None])
    kernels.reset_counts()
    eager.step_batch_async(frames[1][None])
    one = {k: v for k, v in kernels.snapshot().items() if v != (0, 0)}
    assert one and all(k == 0 for k, _ in one.values())  # the CPU: plain versions only
    eng = _stand_in(_engine(case, tdir), 1, 32, 32)
    kernels.reset_counts()
    for n, f in enumerate(frames, start=1):
        eng.step_batch_async(f[None])
        got = {k: v for k, v in kernels.snapshot().items() if v != (0, 0)}
        assert got == {k: (n * a, n * b) for k, (a, b) in one.items()}, n
        assert kernels.graph_counts() == {"captures": 2, "replays": n - 1}


def test_record_capture_and_replay():
    """The bookkeeping alone: what was counted since the snapshot is taken
    back and returned; each replay adds it again."""
    kernels.reset_counts()
    kernels.KERNELS["ccl"].kernel += 3
    before = kernels.snapshot()
    kernels.KERNELS["ccl"].kernel += 2
    kernels.KERNELS["lstm_gate_update"].kernel += 4
    held = kernels.record_capture(before)
    assert held == {"ccl": (2, 0), "lstm_gate_update": (4, 0)}
    assert kernels.counts()["ccl"]["kernel"] == 3
    assert kernels.counts()["lstm_gate_update"]["kernel"] == 0
    for _ in range(5):
        kernels.record_replay(held)
    assert kernels.counts()["ccl"]["kernel"] == 13
    assert kernels.counts()["lstm_gate_update"]["kernel"] == 20
    assert kernels.graph_counts() == {"captures": 1, "replays": 5}
    kernels.reset_counts()
    assert kernels.graph_counts() == {"captures": 0, "replays": 0}


def test_a_failed_capture_raises_and_counts_nothing():
    """A capture that fails raises, naming the failure, after the warm-up
    step ran: no launch of the capture is counted, and no later step runs
    the body eagerly in its place."""
    calls = []

    def body(x, src, dst):
        calls.append(1)
        dst[0].copy_(src[0] + x)
        kernels.KERNELS["ccl"].plain += 1
        return (dst[0].clone(),)

    sets = [[torch.zeros(3)], [torch.zeros(3)]]
    step = CompiledStep(sets, StandIn(sets, fail=True))
    step.input((3,), torch.float32, "cpu").fill_(1.0)
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA graph capture of the streaming step "
                                           "failed: RuntimeError: operation not permitted"):
        step.step(body)
    assert kernels.counts()["ccl"]["plain"] == 1  # the warm-up's, not the capture's
    assert kernels.graph_counts() == {"captures": 0, "replays": 0}
    assert not step.captured
    with pytest.raises(RuntimeError, match="capture"):
        step.step(body)
    with pytest.raises(RuntimeError, match="before the first step"):
        CompiledStep(sets).step(body)
    with pytest.raises(ValueError, match="two sets"):
        CompiledStep(sets[:1])


def test_a_new_input_dtype_captures_anew():
    """Another input dtype makes the static input anew and drops the graphs;
    the next step captures again, on the same carried sets."""
    def body(x, src, dst):
        dst[0].copy_(src[0] + x.float())
        return (dst[0].clone(),)

    sets = [[torch.zeros(2)], [torch.zeros(2)]]
    graphs = StandIn(sets)
    step = CompiledStep(sets, graphs)
    for v in (1, 2, 3):
        step.input((2,), torch.float32, "cpu").fill_(v)
        out, = step.step(body)
    assert step.captured and graphs.pools == 1 and out.tolist() == [6.0, 6.0]
    step.input((2,), torch.int32, "cpu").fill_(4)
    assert not step.captured
    out, = step.step(body)
    assert step.captured and graphs.pools == 2 and out.tolist() == [10.0, 10.0]


@pytest.mark.parametrize("dtype,fused", [("float32", False), ("float32", True),
                                         ("int8", False), ("int8", True)])
def test_step_writes_the_new_state_into_out(dtype, fused):
    """``ULSTMnet2D.step(..., out=state)``: the new state written into the
    given buffers (by K1's and K4's plain versions here), equal to the step
    that allocates it, the input state untouched."""
    from lstm_unet_tpu_torch.models import quantize_model_int8

    model = load_model(os.path.join(GOLDEN, "torch_ckpt"), "cpu",
                       dtype="bfloat16" if dtype == "int8" else dtype, fused_cell=fused)
    if dtype == "int8":
        quantize_model_int8(model, None, float_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
    state = model.init_state(2, 32, 32)
    with torch.inference_mode():
        state, _ = model.step(state, x)  # a nonzero state
        before = [t.clone() for t in _tensors(state)]
        want_state, want_logits = model.step(state, x)
        out = model.init_state(2, 32, 32)
        got_state, got_logits = model.step(state, x, out=out)
    assert all(a is b for a, b in zip(_tensors(got_state), _tensors(out)))
    for a, b in zip(_tensors(got_state), _tensors(want_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=0)
    for a, b in zip(_tensors(state), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_wrappers_write_into_out():
    """K1's and K4's wrappers with ``out``: the given tensors, holding what
    the wrapper returns without it; anything unlike the state raises, and
    K1 refuses ``out`` when a gradient is wanted."""
    from lstm_unet_tpu_torch.ops.kernels import convlstm_cell, lstm_gates

    g = torch.Generator().manual_seed(0)
    gates, c = torch.randn(2, 5, 5, 32, generator=g), torch.randn(2, 5, 5, 8, generator=g)
    out = (torch.empty_like(c), torch.empty_like(c))
    got = lstm_gates.lstm_gate_update(gates, c, "sigmoid", out)
    assert got[0] is out[0] and got[1] is out[1]
    for a, b in zip(got, lstm_gates.lstm_gate_update(gates, c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous tensor like c"):
        lstm_gates.fused_lstm_gate_update(gates, c, "sigmoid", (out[0], out[1].double()))
    with pytest.raises(RuntimeError, match="no gradient"):
        lstm_gates.lstm_gate_update(gates.requires_grad_(), c, "sigmoid", out)
    gx, h = torch.randn(1, 6, 6, 32, generator=g), torch.randn(1, 6, 6, 8, generator=g)
    c, wh = torch.randn(1, 6, 6, 8, generator=g), torch.randn(3, 3, 8, 32, generator=g) * 0.1
    out = (torch.empty_like(h), torch.empty_like(c))
    got = convlstm_cell.fused_convlstm_level(gx, h, c, wh, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for a, b in zip(got, convlstm_cell.fused_convlstm_level(gx, h, c, wh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous tensor like"):
        convlstm_cell.fused_convlstm_level(gx, h, c, wh, out=(out[0][:, :3], out[1]))
