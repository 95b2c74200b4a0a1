"""int8 inference of the port against the JAX reference (CPU).

The same seeded numpy weights and frames go through ``lstm_unet_tpu``'s
int8 path (``ops/quant.py``, ``ULSTMnet2D.step`` with ``quant='int8'``,
``engine/infer.py``) and the port's. Quantized weights, activations and the
int32 conv sums are bit-identical; the dequantized conv outputs are equal
(f32 and bf16: the same f32 ops, then one rounding); streamed logits agree to
a bar set from the measured gap (XLA's and PyTorch's bf16 elementwise math
can move an activation across an int8 rounding boundary).
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import CTCInferenceParams
from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
from lstm_unet_tpu.engine import infer as jax_infer
from lstm_unet_tpu.metrics import seg_measure_sequence
from lstm_unet_tpu.models import ModelConfig as JaxConfig
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu.ops import quant as jq
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell as JaxCell
from lstm_unet_tpu.ops.pallas import lstm_gates as jax_lg
from lstm_unet_tpu_torch.checkpoint.convert import params_from_jax
from lstm_unet_tpu_torch.cli.inference2d import main as cli_main
from lstm_unet_tpu_torch.config import tiny_net_kernel_params
from lstm_unet_tpu_torch.engine import infer
from lstm_unet_tpu_torch.io import synthetic, tiff
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.models.ulstm_unet import QConv, quantize_model_int8
from lstm_unet_tpu_torch.ops import quant
from lstm_unet_tpu_torch.ops.convlstm import ConvLSTMCell, QConvLSTMCell
from lstm_unet_tpu_torch.ops.kernels import conv_int8, counts, reset_counts

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)


def _hwio_to_oihw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, dtype=np.float32)))
    return t if dtype is None else t.to(dtype)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


# int8 convs a frame of the tiny model by route, (small-K, wgmma), fused cell
# off and on: cin 1, 8 and 24 take the small-K kernel, cin 16 and 32 the
# wgmma kernel (kernels/conv_int8.py::route); none the mma_sync kernel
TINY_INT8_CONVS = {False: (6, 3), True: (5, 2)}


def _int8_plain():
    ran = counts()
    assert ran["conv2d_int8"]["plain"] == 0
    return ran["conv2d_int8_smallk"]["plain"], ran["conv2d_int8_wgmma"]["plain"]


# ---------------------------------------------------------------- weights, acts


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (5, 5, 1, 512), (1, 1, 8, 3), (3, 3, 24, 8)])
def test_quantize_weight_bit_identical(shape):
    k = np.random.default_rng(0).normal(0, 0.1, shape).astype(np.float32)
    k[..., 0] = 0.0  # an all-zero output channel takes the 1e-12 floor
    qj, sj = jq.quantize_weight(jnp.asarray(k))
    q, s = quant.quantize_weight(_hwio_to_oihw(k))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, _hwio_to_oihw(qj))
    assert torch.equal(s, torch.from_numpy(np.asarray(sj)))
    assert float(s[0]) == pytest.approx(1e-12, rel=1e-6)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_act_bit_identical(static, dtype):
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1.5, (2, 9, 7, 16))
                         .astype(np.float32)).to(dtype)
    x[0, 0, 0, :4] = torch.tensor([0.5, -0.5, 1.5, -2.5])  # halves: round to even
    scale_j = jq._scale_of({"s": 2.0}, "s") if static else None
    qj, sj = jq.quantize_act(_j(x), scale_j)
    q, s = quant.quantize_act(x, quant._scale_of({"s": 2.0}, "s") if static else None)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert torch.equal(q, torch.from_numpy(np.asarray(qj)))
    assert float(s) == float(sj)
    assert quant._scale_of(None, "s") is None and quant._scale_of({}, "s") is None


# ---------------------------------------------------------------- convs

CONV_CASES = {  # (B, H, W, Cin, K, Cout): cin = 1 (level 0 x-conv), cout = 3 (head)
    "cin1_5x5": (1, 12, 10, 1, 5, 32),
    "3x3": (2, 8, 8, 16, 3, 24),
    "head_1x1": (1, 8, 8, 8, 1, 3),
    "cin24_3x3": (1, 6, 10, 24, 3, 8),
}


def _conv_inputs(case, bias=True):
    b, h, w, cin, k, cout = CONV_CASES[case]
    r = np.random.default_rng(2)
    x = r.normal(0, 1.0, (b, h, w, cin)).astype(np.float32)
    kern = r.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    bias_v = r.normal(0, 0.5, (cout,)).astype(np.float32) if bias else None
    return x, kern, bias_v


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_q_sums_bit_identical_and_outputs_equal(case, bias):
    x, kern, bias_v = _conv_inputs(case, bias)
    qk, sk = jq.quantize_weight(jnp.asarray(kern))
    qx, sx = jq.quantize_act(jnp.asarray(x))
    acc_j = np.asarray(jq._conv_int8(qx, qk))
    weight = quant.QWeight(_hwio_to_oihw(kern), None if bias_v is None else _t(bias_v))
    xq, s_x = quant.quantize_act(_t(x))
    acc = conv_int8.conv_acc_plain(xq, weight.kernel_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        qd = {"kernel_q": qk, "w_scale": sk}
        if bias_v is not None:
            qd["bias"] = jnp.asarray(bias_v)
        want = np.asarray(jq.conv2d_q(jnp.asarray(x).astype(jdt), qd, out_dtype=jdt)
                          .astype(jnp.float32))
        got = quant.conv2d_q(_t(x, dt), weight, None, dt)
        assert got.dtype == dt
        # the same f32 ops on the same sums, then one rounding: equal, with
        # no bf16 ulp of slack
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("static", [False, True])
def test_conv2d_q_pair_equal(static):
    r = np.random.default_rng(3)
    a = r.normal(0, 1.0, (1, 8, 8, 16)).astype(np.float32)
    b = r.normal(0, 3.0, (1, 8, 8, 8)).astype(np.float32)
    kern = r.normal(0, 0.2, (3, 3, 24, 16)).astype(np.float32)
    bias_v = r.normal(0, 0.5, (16,)).astype(np.float32)
    qk, sk = jq.quantize_weight(jnp.asarray(kern))
    scales = {"d.a": 2.5, "d.b": 7.0} if static else {}
    qd = {"kernel_q": qk, "w_scale": sk, "bias": jnp.asarray(bias_v)}
    for key, site in (("x_scale_a", "d.a"), ("x_scale_b", "d.b")):
        if site in scales:
            qd[key] = jq._scale_of(scales, site)
    weight = quant.QWeight(_hwio_to_oihw(kern), _t(bias_v))
    reset_counts()
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jq.conv2d_q_pair(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                                           qd, out_dtype=jdt).astype(jnp.float32))
        got = quant.conv2d_q_pair(_t(a, dt), _t(b, dt), weight, quant._scale_of(scales, "d.a"),
                                  quant._scale_of(scales, "d.b"), dt)
        np.testing.assert_array_equal(got.float().numpy(), want)
    # two launches a pair: a (cin 16) on the wgmma route, b (cin 8) on small-K
    assert counts()["conv2d_int8_smallk"] == {"kernel": 0, "plain": 2}
    assert counts()["conv2d_int8_wgmma"] == {"kernel": 0, "plain": 2}


def test_conv_int8_pack_and_wrapper_checks():
    kq = torch.randint(-127, 128, (3, 24, 3, 3), dtype=torch.int32).to(torch.int8)
    packed = conv_int8.pack_weight(kq)
    assert packed.shape == (128, 256) and packed.dtype == torch.int8
    assert torch.equal(conv_int8.unpack_weight(packed, 3, 24, 3, 3), kq)
    assert not packed[3:].any() and not packed[:, 216:].any()  # zero padding
    xq = torch.zeros(1, 4, 4, 24, dtype=torch.int8)
    s, ws = torch.tensor(1.0), torch.ones(3)
    with pytest.raises(ValueError, match="pack"):
        conv_int8.conv2d_int8(xq, s, packed[:, :192], ws, None, 3, 3)
    with pytest.raises(ValueError, match="int8"):
        conv_int8.conv2d_int8(xq.float(), s, packed, ws, None, 3, 3)
    with pytest.raises(ValueError, match="device"):
        conv_int8.conv2d_int8(xq.to("meta"), s, packed, ws, None, 3, 3)
    with pytest.raises(ValueError, match="odd"):
        conv_int8.conv2d_int8(xq, s, packed, ws, None, 2, 2)


# ---------------------------------------------------------------- the model


def _ref_flat(jcfg, seed=0):
    tree = jax.eval_shape(lambda: JaxNet.init(jax.random.PRNGKey(0), jcfg))
    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v.shape
              for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    r = np.random.default_rng(seed)

    def draw(shape):  # glorot-uniform kernels, as the models initialise them
        if len(shape) == 4:
            lim = np.sqrt(6.0 / (shape[0] * shape[1] * (shape[2] + shape[3])))
            return r.uniform(-lim, lim, shape)
        return r.uniform(-0.2, 0.2, shape)

    return {k: draw(s).astype(np.float32) for k, s in shapes.items()}


def _unflatten(flat):
    from lstm_unet_tpu_torch.checkpoint.convert import _unflatten

    return jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))


def _pair(fused=False, split=False, scales=None, keep=(), seed=0):
    """(reference int8 params, reference cfg, the port's quantized model),
    the same f32 weights quantized on each side."""
    kw = dict(dtype="bfloat16", quant="int8", fused_cell=fused, split_skip_convs=split)
    jcfg = JaxConfig.make(jax_tiny(), **kw)
    flat = _ref_flat(jcfg, seed)
    qparams = jq.quantize_params_int8(_unflatten(flat), scales, keep_float=keep,
                                      float_dtype=jnp.bfloat16)
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), **kw))
    model.load_state_dict(params_from_jax(flat), strict=True)
    quantize_model_int8(model, scales, keep, float_dtype=torch.bfloat16)
    return qparams, jcfg, model, flat


def _sites(model):
    for i, lvl in enumerate(model.encoder):
        for j, m in enumerate(lvl.lstm):
            yield f"encoder/{i}/lstm/{j}", m, ("encoder", i, "lstm", j)
        for j, m in enumerate(lvl.convs):
            yield f"encoder/{i}/convs/{j}", m, ("encoder", i, "convs", j)
    for i, lvl in enumerate(model.decoder):
        for j, m in enumerate(lvl.convs):
            yield f"decoder/{i}/convs/{j}", m, ("decoder", i, "convs", j)
    yield "head", model.head, ("head",)


def _ref_node(tree, path):
    if path == ("head",):
        return tree["head"]
    kind, i, group, j = path
    return tree[kind][i][group][j]


TREE_CASES = {
    "dynamic": dict(scales=None, keep=()),
    "keep_encoder0_head": dict(scales=None, keep=("encoder/0", "head")),
    "keep_string": dict(scales=None, keep="encoder/1 , decoder/0,"),
    "static_all": dict(scales="all", keep=()),
    "static_some": dict(scales={"head": 3.0, "encoder/0/lstm/0/x": 1.2,
                                "decoder/1/convs/0": 0.0}, keep=("encoder/1",)),
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_quantized_tree_matches_reference(case):
    spec = TREE_CASES[case]
    scales = spec["scales"]
    if scales == "all":
        scales = {s: 0.5 + 0.1 * n for n, s in enumerate(
            ["encoder/0/lstm/0/x", "encoder/0/lstm/0/h", "encoder/0/convs/0",
             "encoder/1/lstm/0/x", "encoder/1/lstm/0/h", "encoder/1/convs/0",
             "decoder/1/convs/0", "decoder/0/convs/0", "head"])}
    qparams, _, model, _ = _pair(scales=scales, keep=spec["keep"])
    keep = quant.parse_keep_float(spec["keep"])
    assert keep == jq.parse_keep_float(spec["keep"])
    n_q = 0
    for site, m, path in _sites(model):
        ref = _ref_node(qparams, path)
        kept = quant._site_kept(site, keep)
        assert kept == jq._site_kept(site, keep)
        if kept:  # float, cast to bf16 as the reference's _cast_float_site
            assert isinstance(m, (ConvLSTMCell,)) or hasattr(m, "kernel"), site
            for name, p in m.named_parameters():
                want = np.asarray(ref[name].astype(jnp.float32))
                got = p.detach().float().numpy()
                assert p.dtype == torch.bfloat16
                np.testing.assert_array_equal(got if got.ndim != 4 else
                                              got.transpose(2, 3, 1, 0), want)
            continue
        n_q += 1
        if "lstm" in site:
            assert isinstance(m, QConvLSTMCell)
            pairs = [(m.kernel_x_q, ref["kernel_x_q"]), (m.kernel_h_q, ref["kernel_h_q"])]
            pairs += [(m.wx.w_scale, ref["wx_scale"]), (m.wh.w_scale, ref["wh_scale"]),
                      (m.wx.bias, ref["bias"])]
            statics = {"x_scale": m.x_scale, "h_scale": m.h_scale}
            assert m.wh.bias is None
        else:
            assert isinstance(m, QConv)
            pairs = [(m.kernel_q, ref["kernel_q"]), (m.weight.w_scale, ref["w_scale"]),
                     (m.weight.bias, ref["bias"])]
            statics = {k: getattr(m, k) for k in ("x_scale", "x_scale_a", "x_scale_b")}
        for got, want in pairs:
            want = np.asarray(want)
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            assert got.dtype == (torch.int8 if want.dtype == np.int8 else torch.float32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=site)
        for key, got in statics.items():
            if key in ref:
                assert got is not None and float(got) == float(ref[key]), (site, key)
            else:
                assert got is None, (site, key)
    assert n_q > 0


@pytest.mark.parametrize("split", [False, True])
def test_collect_scales_sites_match_reference(split):
    jcfg = JaxConfig.make(jax_tiny(), split_skip_convs=split)
    flat = _ref_flat(jcfg)
    params = _unflatten(flat)
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), split_skip_convs=split))
    model.load_state_dict(params_from_jax(flat), strict=True)
    frames = np.random.default_rng(4).uniform(0, 1, (2, 1, 16, 16, 1)).astype(np.float32)
    jstate = JaxNet.init_state(jcfg, 1, 16, 16)
    state = model.init_state(1, 16, 16)
    for t in range(2):  # the second frame has a nonzero h at every level
        want, got = {}, {}
        jstate, _ = JaxNet.step(params, jstate, jnp.asarray(frames[t]), jcfg,
                                collect_scales=want)
        with torch.no_grad():
            state, _ = model.step(state, torch.from_numpy(frames[t]), collect_scales=got)
        assert sorted(got) == sorted(want)
        n_lstm, n_convs = 2, 4
        assert len(got) == 2 * n_lstm + n_convs + 1 + (2 if split else 0)
        assert any(k.endswith(".a") for k in got) == split
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=1e-6, abs=1e-12), k


def _fused_twin(gx, h, c, wh, recurrent_activation="sigmoid"):
    """The reference fused kernel's math (``ops/pallas/convlstm_cell.py::
    _kernel``) in XLA, for levels its TPU kernel does not take: the h-conv
    of h rounded to wh's dtype with f32 sums, plus gx in f32, then the gate
    math in f32."""
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


def _stream(qparams, jcfg, model, frames, monkeypatch):
    """Stream ``frames [T,1,H,W,1]`` through both; returns (reference logits,
    port logits), each [T,H,W,3] f32 numpy."""
    if jcfg.fused_cell:  # the reference's fused route on levels of any shape
        from lstm_unet_tpu.ops.pallas import convlstm_cell as jcell

        monkeypatch.setattr(jcell, "supported", lambda *a: True)
        monkeypatch.setattr(jcell, "fused_convlstm_level", _fused_twin)
    h, w = frames.shape[2:4]
    jstate = JaxNet.init_state(jcfg, 1, h, w)
    state = model.init_state(1, h, w)
    ref, ours = [], []
    for f in frames:
        jstate, jl = JaxNet.step(qparams, jstate, jnp.asarray(f), jcfg)
        with torch.no_grad():
            state, lg = model.step(state, torch.from_numpy(f))
        ref.append(np.asarray(jl[0]))
        ours.append(lg[0].numpy())
    return np.stack(ref), np.stack(ours)


# Measured on these weights and frames (glorot draws of seed 0): the largest
# logit gap is 0.0190 of the largest |logit| (unfused, dynamic scales, frame
# 2), 0 with calibrated scales, and 0 on seeds 1-3. The cause is not the
# int8 path, which is bit-identical op by op (tests above): XLA's and
# PyTorch's f32 sigmoid / tanh differ by an ulp now and then, an h' in bf16
# rounds the other way, and a dynamic per-tensor scale or an int8 code of
# the next conv moves with it. The bar is the power of two above the gap
# seen (the 2^-6 first proposed is below it).
FRAME_BAR = 2.0 ** -5


@pytest.mark.parametrize("scales", ["dynamic", "calibrated"])
@pytest.mark.parametrize("fused", [False, True])
def test_streamed_int8_frames_match_reference(fused, scales, monkeypatch):
    frames = np.random.default_rng(5).uniform(0, 1, (3, 1, 32, 32, 1)).astype(np.float32)
    sc = None
    if scales == "calibrated":
        fcfg = JaxConfig.make(jax_tiny())
        sc = jax_infer.calibrate_act_scales(_unflatten(_ref_flat(fcfg)), fcfg,
                                            [f[0, ..., 0] * 1000 for f in frames])
    qparams, jcfg, model, _ = _pair(fused=fused, scales=sc)
    reset_counts()
    ref, ours = _stream(qparams, jcfg, model, frames, monkeypatch)
    ran = counts()
    assert _int8_plain() == tuple(3 * n for n in TINY_INT8_CONVS[fused])
    assert ran["fused_convlstm_level_narrow"]["plain"] == (6 if fused else 0)
    assert ran["lstm_gate_update"]["plain"] == (0 if fused else 6)
    gap = np.abs(ours - ref).max() / np.abs(ref).max()
    assert gap < FRAME_BAR, gap


def test_split_skip_convs_int8_matches_reference(monkeypatch):
    frames = np.random.default_rng(6).uniform(0, 1, (2, 1, 16, 16, 1)).astype(np.float32)
    qparams, jcfg, model, _ = _pair(split=True)
    reset_counts()
    ref, ours = _stream(qparams, jcfg, model, frames, monkeypatch)
    # each decoder first conv: 2 (decoder 0's skip operand, cin 8, on small-K)
    assert _int8_plain() == (2 * 6, 2 * 5)
    assert np.abs(ours - ref).max() / np.abs(ref).max() < FRAME_BAR
    # and the pair changes the int8 math against the concat conv
    _, _, plain_model, _ = _pair(split=False)
    _, concat = _stream(qparams, JaxConfig.make(jax_tiny(), dtype="bfloat16", quant="int8"),
                        plain_model, frames, monkeypatch)
    assert not np.array_equal(concat, ours)


def test_int8_close_to_f32_and_mixed_tree():
    """The reference's own bar (``tests/test_quant.py``): int8 logits within
    0.15 of the f32 logits' largest magnitude, full int8 and mixed."""
    frames = np.random.default_rng(7).uniform(0, 1, (1, 16, 16, 1)).astype(np.float32)
    flat = _ref_flat(JaxConfig.make(jax_tiny()))
    f32 = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params()))
    f32.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        _, want = f32.step(f32.init_state(1, 16, 16), torch.from_numpy(frames))
        for keep in ((), ("encoder/0", "head")):
            _, _, model, _ = _pair(keep=keep)
            _, got = model.step(model.init_state(1, 16, 16), torch.from_numpy(frames))
            assert float((got - want).abs().max() / want.abs().max()) < 0.15


def test_fused_int8_cell_matches_reference_pallas_kernel(monkeypatch):
    """The fused int8 route against the reference's own fused Pallas kernel
    (interpret mode on the CPU) at a shape that kernel takes (5x5, F = 128,
    W = 128); the unfused route (here the gate epilogue's, F % 64 == 0)
    against the reference's unfused cell, with its XLA gate update and with
    its K1 Pallas kernel interpreted; and the fused and unfused int8 routes
    within the reference's 5e-3 of each other (``tests/test_ops.py``): they
    differ by design."""
    from lstm_unet_tpu.ops.quant import quantize_weight

    r = np.random.default_rng(8)
    kx = r.uniform(-0.05, 0.05, (5, 5, 1, 512)).astype(np.float32)
    kh = r.uniform(-0.02, 0.02, (5, 5, 128, 512)).astype(np.float32)
    bias = np.zeros(512, np.float32)
    bias[128:256] = 1.0
    h0 = r.uniform(-0.5, 0.5, (1, 16, 128, 128)).astype(np.float32)
    c0 = r.uniform(-0.5, 0.5, (1, 16, 128, 128)).astype(np.float32)
    x = r.normal(0, 1, (1, 16, 128, 1)).astype(np.float32)
    qx, sx = quantize_weight(jnp.asarray(kx))
    qh, sh = quantize_weight(jnp.asarray(kh))
    qcell = {"kernel_x_q": qx, "wx_scale": sx, "kernel_h_q": qh, "wh_scale": sh,
             "bias": jnp.asarray(bias)}
    carry = (jnp.asarray(h0), jnp.asarray(c0))
    (hj, cj), _ = JaxCell.apply(qcell, carry, jnp.asarray(x), use_pallas=False, fused_cell=True)
    cell = ConvLSTMCell(5, 1, 128)
    cell.load_state_dict({"kernel_x": _hwio_to_oihw(kx), "kernel_h": _hwio_to_oihw(kh),
                          "bias": _t(bias)})
    qc = QConvLSTMCell(cell)
    assert qc.wh.gates
    with torch.no_grad():
        (h, c), _ = qc((_t(h0), _t(c0)), _t(x), fused_cell=True)
        reset_counts()
        (hu, cu), _ = qc((_t(h0), _t(c0)), _t(x), fused_cell=False)
    assert counts()["conv2d_int8_wgmma_gates"] == {"kernel": 0, "plain": 1}
    # f32 sums of the same exact products in other orders
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)
    # the same int32 sums and gates; the gate math in f32 (tanh, sigmoid)
    for pallas in (False, True):
        monkeypatch.setattr(jax_lg, "FORCE_INTERPRET", pallas)
        (hju, cju), _ = JaxCell.apply(qcell, carry, jnp.asarray(x), use_pallas=pallas,
                                      fused_cell=False)
        np.testing.assert_allclose(hu.numpy(), np.asarray(hju), atol=1e-6)
        np.testing.assert_allclose(cu.numpy(), np.asarray(cju), atol=1e-6)
    np.testing.assert_allclose(hu.numpy(), h.numpy(), atol=5e-3)
    np.testing.assert_allclose(cu.numpy(), c.numpy(), atol=5e-3)
    assert not np.array_equal(hu.numpy(), h.numpy())


# ---------------------------------------------------------------- gate epilogue


@pytest.mark.parametrize("k,filters", [(3, 64), (5, 128), (1, 64)])
def test_gate_pack_round_trips(k, filters):
    """An h-conv the gate epilogue takes is packed once, in K4's column
    order: ``kernel_q`` is the quantized OIHW kernel, ``gate_scale`` the
    per-cout scale in the pack's order, and the dequantized Wh of the fused
    route is the natural one. A cell whose 4F is not a multiple of 256, or
    a conv with a bias, keeps the natural pack."""
    from lstm_unet_tpu_torch.ops.kernels import convlstm_cell

    gen = torch.Generator().manual_seed(k + filters)
    cell = ConvLSTMCell(k, 16, filters, generator=gen)
    qc = QConvLSTMCell(cell)
    q, s = quant.quantize_weight(cell.kernel_h)
    assert qc.wh.gates and torch.equal(qc.kernel_h_q, q) and torch.equal(qc.wh.w_scale, s)
    order = conv_int8.gate_order(4 * filters)
    assert sorted(order.tolist()) == list(range(4 * filters))
    assert torch.equal(qc.wh.gate_scale, s[order])
    assert torch.equal(qc.wh.packed, conv_int8.pack_weight_wgmma(q[order]))
    assert torch.equal(qc.wh.kernel_q[:, :, 0, 0], q[:, :, 0, 0])
    want = (q.float() * s[:, None, None, None]).permute(2, 3, 1, 0)
    assert torch.equal(qc.wh_dequantized(torch.float32), want)
    # K4's bf16 pack puts natural column n of tile t at the same place
    wh = torch.arange(4 * filters, dtype=torch.float32).expand(1, 1, filters, 4 * filters)
    k4 = convlstm_cell._pack(wh, convlstm_cell.TC_FEAT, convlstm_cell.TC_CHUNK, 8)
    assert torch.equal(k4[:, 0, 0, 0, :, 0].reshape(-1).long(), order)
    # each lane's fragment (columns 8j + 2(lane % 4) + {0, 1} of a 128- or
    # 256-column tile) holds i, f, g, o of the same features
    for col0 in range(0, 4 * filters, 128):
        for lane in range(4):
            cols = [col0 + 8 * j + 2 * lane + e for j in range(16) for e in (0, 1)]
            gate, feat = order[cols] // filters, order[cols] % filters
            for g in range(4):
                assert sorted(feat[gate == g].tolist()) == sorted(set(feat.tolist()))
    assert not QConvLSTMCell(ConvLSTMCell(k, 16, 16, generator=gen)).wh.gates
    assert not quant.QWeight(cell.kernel_h, cell.bias[:4 * filters], gates=True).gates


GATE_CASES = {
    "bf16/bf16": (torch.bfloat16, torch.bfloat16),
    "bf16/f32": (torch.bfloat16, torch.float32),
    "f32/f32": (torch.float32, torch.float32),
}


@pytest.mark.parametrize("with_out", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtypes", list(GATE_CASES))
def test_unfused_int8_cell_gate_route_equals_parent_formula(dtypes, static, with_out):
    """The unfused int8 cell on a gate-ordered Wh (F = 64, 3x3, frames of
    32 x 48) against the formula it replaced, on natural packs: ``conv2d_q(x)
    + conv2d_q(h)`` in x's dtype, then K1's plain version; output and new
    state bit for bit, for each (gate, state) dtype pair, static and dynamic
    scales, with ``out`` given and not. On the CPU the gate epilogue runs its
    plain version: 0 kernel launches."""
    from lstm_unet_tpu_torch.ops.kernels import lstm_gates

    dt, sdt = GATE_CASES[dtypes]
    gen = torch.Generator().manual_seed(5)
    cell = ConvLSTMCell(3, 16, 64, generator=gen)
    scales = {"s/x": 2.7, "s/h": 0.9} if static else None
    qc = QConvLSTMCell(cell, scales, "s")
    r = np.random.default_rng(6)
    x = _t(r.normal(0, 1, (1, 32, 48, 16)), dt)
    h = _t(r.uniform(-0.9, 0.9, (1, 32, 48, 64)), sdt)
    c = _t(r.normal(0, 1.5, (1, 32, 48, 64)), sdt)
    wx, wh = quant.QWeight(cell.kernel_x, cell.bias), quant.QWeight(cell.kernel_h, None)
    assert qc.wh.gates and not wh.gates
    act = "hard_sigmoid" if static and with_out else "sigmoid"
    with torch.no_grad():
        gates = (quant.conv2d_q(x, wx, qc.x_scale, dt) + quant.conv2d_q(h, wh, qc.h_scale, dt))
        c_want, h_want = lstm_gates.lstm_gate_update_plain(gates, c, act)
        out = (torch.empty_like(h), torch.empty_like(c)) if with_out else None
        reset_counts()
        (h_new, c_new), y = qc((h, c), x, recurrent_activation=act, out=out)
    ran = counts()
    assert ran["conv2d_int8_wgmma_gates"] == {"kernel": 0, "plain": 1}
    assert ran["lstm_gate_update"]["kernel"] == 0
    assert h_new.dtype == c_new.dtype == sdt and y is h_new
    if with_out:
        assert h_new is out[0] and c_new is out[1]
    assert torch.equal(h_new, h_want) and torch.equal(c_new, c_want)


def _within_one_bf16_ulp(got: torch.Tensor, want) -> None:
    """``got`` (bf16) within 1e-6 (the f32 gate math's rounding, as with f32
    states) plus one bf16 unit in the last place, 2^(e - 7) at exponent e,
    of ``want`` (the reference's, bf16)."""
    want = np.asarray(want).astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp + 1e-6).all()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtypes", list(GATE_CASES))
def test_unfused_int8_gate_route_matches_reference(dtypes, static, monkeypatch):
    """The gate epilogue's route (F = 64, 3x3, a frame of 16 x 32) against
    the reference's unfused int8 cell on the same inputs, with its XLA gate
    update and with its K1 Pallas kernel interpreted: the same int32 sums
    and gate pre-activations, so a state in f32 agrees to f32 rounding
    (1e-6: tanh and the sigmoid differ in the last bits) and one in bf16 to
    one more bf16 unit in the last place, for each (gate, state) dtype pair,
    static and dynamic scales."""
    dt, sdt = GATE_CASES[dtypes]
    r = np.random.default_rng(9)
    kx = r.uniform(-0.1, 0.1, (3, 3, 16, 256)).astype(np.float32)
    kh = r.uniform(-0.05, 0.05, (3, 3, 64, 256)).astype(np.float32)
    bias = r.normal(0, 0.3, 256).astype(np.float32)
    x = _t(r.normal(0, 1, (1, 16, 32, 16)), dt)
    h = _t(r.uniform(-0.9, 0.9, (1, 16, 32, 64)), sdt)
    c = _t(r.normal(0, 1.5, (1, 16, 32, 64)), sdt)
    scales = {"s/x": 2.7, "s/h": 0.9} if static else None
    jcell = jq._quantize_lstm_dict({"kernel_x": jnp.asarray(kx), "kernel_h": jnp.asarray(kh),
                                    "bias": jnp.asarray(bias)}, scales, "s")
    cell = ConvLSTMCell(3, 16, 64)
    cell.load_state_dict({"kernel_x": _hwio_to_oihw(kx), "kernel_h": _hwio_to_oihw(kh),
                          "bias": _t(bias)})
    qc = QConvLSTMCell(cell, scales, "s")
    assert qc.wh.gates and (qc.h_scale is None) != static
    with torch.no_grad():
        reset_counts()
        (h_new, c_new), _ = qc((h, c), x)
    assert counts()["conv2d_int8_wgmma_gates"] == {"kernel": 0, "plain": 1}
    for pallas in (False, True):
        monkeypatch.setattr(jax_lg, "FORCE_INTERPRET", pallas)
        (hj, cj), _ = JaxCell.apply(jcell, (_j(h), _j(c)), _j(x), use_pallas=pallas,
                                    fused_cell=False)
        for got, want in ((h_new, hj), (c_new, cj)):
            if sdt == torch.float32:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
            else:
                _within_one_bf16_ulp(got, want)


def test_gate_epilogue_wrapper_checks():
    """``conv2d_int8_wgmma_gates`` refuses an ``out`` that aliases an input,
    a pack that is not a gate pack, and mismatched h and c (so does a cell
    on a gate pack); ``conv2d_q`` refuses a gate pack, which runs only with
    the gate epilogue."""
    cell = ConvLSTMCell(3, 16, 64, generator=torch.Generator().manual_seed(2))
    qc = QConvLSTMCell(cell)
    h, c = torch.zeros(1, 8, 8, 64), torch.zeros(1, 8, 8, 64)
    gx = torch.zeros(1, 8, 8, 256)
    args = (None, qc.wh.packed, qc.wh.gate_scale, gx, c, 3)
    h2, c2 = conv_int8.conv2d_int8_wgmma_gates(h, *args)
    assert h2.shape == c2.shape == h.shape
    with pytest.raises(ValueError, match="alias"):
        conv_int8.conv2d_int8_wgmma_gates(h, *args, out=(h, torch.empty_like(c)))
    with pytest.raises(ValueError, match="alias"):
        conv_int8.conv2d_int8_wgmma_gates(h, *args, out=(torch.empty_like(h), c))
    with pytest.raises(ValueError, match="like h"):
        conv_int8.conv2d_int8_wgmma_gates(h.bfloat16(), *args)
    natural = conv_int8.pack_weight_wgmma(qc.kernel_h_q, tile_n=128)
    with pytest.raises(ValueError, match="256-column"):
        conv_int8.conv2d_int8_wgmma_gates(h, None, natural, qc.wh.w_scale, gx, c, 3)
    with pytest.raises(ValueError, match="gate epilogue"):
        quant.conv2d_q_gates(h, quant.QWeight(cell.kernel_h, None), None, gx, c)
    with torch.no_grad(), pytest.raises(ValueError, match="like h"):
        qc((h.bfloat16(), c), gx[..., :16])
    with pytest.raises(ValueError, match="conv2d_q_gates"):
        quant.conv2d_q(h, qc.wh)


# ---------------------------------------------------------------- scales file


def test_act_scales_file_provenance(tmp_path):
    d = str(tmp_path / "model")
    os.makedirs(os.path.join(d, "100"))
    with open(os.path.join(d, "model_params.json"), "w") as f:
        json.dump({"model_config": {"dtype": "float32"}}, f)
    infer.save_act_scales(d, {"head": 1.5})
    assert infer.load_act_scales(d) == {"head": 1.5}
    assert jax_infer.load_act_scales(d) == {"head": 1.5}  # the reference reads ours
    os.makedirs(os.path.join(d, "200"))  # the checkpoint advanced: stale
    assert infer.load_act_scales(d) is None
    os.rmdir(os.path.join(d, "200"))
    with open(os.path.join(d, "model_params.json"), "w") as f:  # arch changed: stale
        json.dump({"model_config": {"dtype": "bfloat16"}}, f)
    assert infer.load_act_scales(d) is None
    with open(os.path.join(d, "act_scales.json"), "w") as f:  # unstamped: loads
        json.dump({"head": 2.0}, f)
    assert infer.load_act_scales(d) == {"head": 2.0}
    os.makedirs(os.path.join(d, "200"))
    infer.save_act_scales(d, {"head": 3.0}, step=100)
    assert infer.load_act_scales(d, step=100) == {"head": 3.0}
    assert infer.load_act_scales(d, step=200) is None
    assert infer.load_act_scales(d) is None
    # a file the reference wrote loads in the port, stamp and all
    jax_infer.save_act_scales(d, {"head": 4.0, "encoder/0/lstm/0/x": 0.25})
    assert infer.load_act_scales(d) == {"head": 4.0, "encoder/0/lstm/0/x": 0.25}
    assert infer._scales_provenance(d) == jax_infer._scales_provenance(d)
    assert infer.load_act_scales(str(tmp_path / "none")) is None


# ---------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def golden_int8(tmp_path_factory):
    """The golden sequence through the reference's int8 ``run_inference`` on
    ``tests/golden/ckpt``, dynamic and calibrated on 4 frames (in a copy of
    the model dir); returns (sequence dir, {tag: masks})."""
    tmp = tmp_path_factory.mktemp("golden_int8")
    seq, _ = synthetic.write_ctc_dataset(str(tmp / "ctc"), **GOLDEN_DATA)
    ckpt = str(tmp / "ckpt")
    shutil.copytree(os.path.join(GOLDEN, "ckpt"), ckpt)
    masks = {}
    for tag in ("dynamic", "calibrated"):
        if tag == "calibrated":
            jax_infer.calibrate_model_dir(ckpt, seq, n_frames=4)
        out = str(tmp / f"ref_{tag}")
        jax_infer.run_inference(CTCInferenceParams(
            model_path=ckpt, sequence_path=seq, output_path=out, min_cell_size=5,
            pre_sequence_frames=2, dtype="int8"))
        masks[tag] = [tiff.read_tiff(p) for p in sorted(glob.glob(os.path.join(out, "mask*.tif")))]
    return seq, masks


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tag", ["dynamic", "calibrated"])
def test_golden_int8_cli_matches_reference(golden_int8, tmp_path, tag, fused):
    seq, ref = golden_int8
    model_dir = str(tmp_path / "model")  # a copy: calibration writes into it
    shutil.copytree(os.path.join(GOLDEN, "torch_ckpt"), model_dir)
    out = str(tmp_path / "res")
    extra = (["--calibrate", "4"] if tag == "calibrated" else []) + \
        (["--fused_cell"] if fused else [])
    reset_counts()
    n = cli_main(["--model_path", model_dir, "--sequence_path", seq, "--output_path", out,
                  "--device", "cpu", "--pre_sequence_frames", "2", "--min_cell_size", "5",
                  "--dtype", "int8", *extra])
    assert n == 8
    assert os.path.exists(os.path.join(model_dir, "act_scales.json")) == (tag == "calibrated")
    assert _int8_plain() == tuple(10 * n for n in TINY_INT8_CONVS[fused])
    got = [tiff.read_tiff(p) for p in sorted(glob.glob(os.path.join(out, "mask*.tif")))]
    golden = [tiff.read_tiff(p) for p in sorted(glob.glob(os.path.join(GOLDEN, "masks", "*.tif")))]
    diffs = [int((a != b).sum()) for a, b in zip(got, ref[tag])]
    for a, b in zip(got, ref[tag]):
        assert len(np.unique(a)) == len(np.unique(b))
    # unfused: the reference's own path (the tiny levels are not its fused
    # kernel's), measured equal; fused: h is not quantized, by design
    assert max(diffs) <= (0 if not fused else 3), diffs
    assert seg_measure_sequence(golden, got) > 0.9


def test_cli_int8_keep_float_and_recipe(tmp_path):
    seq, _ = synthetic.write_ctc_dataset(str(tmp_path / "ctc"), **GOLDEN_DATA)
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps({"dtype": "int8", "int8_keep_float": "encoder/0,head",
                                  "mesh_shape": {"data": 1}}))
    reset_counts()
    n = cli_main(["--model_path", os.path.join(GOLDEN, "torch_ckpt"), "--sequence_path", seq,
                  "--output_path", str(tmp_path / "res"), "--device", "cpu",
                  "--pre_sequence_frames", "2", "--min_cell_size", "5", "--recipe", str(recipe)])
    assert n == 8
    # encoder/0 (x-conv, h-conv, conv) and the head stay float: 9 - 4 int8 convs
    # (encoder/1's x-conv and decoder/0's conv on small-K)
    assert _int8_plain() == (10 * 2, 10 * 3)
    # a mesh of more ranks than the run has is refused before the model loads
    recipe.write_text(json.dumps({"mesh_shape": {"data": 2}}))
    with pytest.raises(ValueError, match="mesh needs 2 ranks, have 1"):
        cli_main(["--model_path", "m", "--sequence_path", "s", "--output_path",
                  str(tmp_path), "--device", "cpu", "--recipe", str(recipe)])
