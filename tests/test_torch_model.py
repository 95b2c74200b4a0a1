"""ULSTMnet2D of the port against the JAX reference (CPU, f32, tiny model).

The same weights (drawn by JAX, carried over by ``params_from_jax``) and the
same frames stream through both models. Logits and states agree to 1e-5:
both sum each conv in f32, in different orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
from lstm_unet_tpu.models import ModelConfig as JaxConfig
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu_torch.checkpoint.convert import params_from_jax, params_to_jax
from lstm_unet_tpu_torch.config import tiny_net_kernel_params
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu_torch.ops.kernels import counts, reset_counts

VARIANTS = {
    "default": {},
    "layernorm-bilinear-hard_sigmoid": dict(norm="layernorm", upsample="bilinear",
                                            recurrent_activation="hard_sigmoid"),
}


def _ref_shapes(jcfg):
    """``{"encoder/0/lstm/0/kernel_x": shape}`` of the reference param tree,
    traced without computing it."""
    tree = jax.eval_shape(lambda: JaxNet.init(jax.random.PRNGKey(0), jcfg))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(variant, fused=False):
    """(jax params, jax cfg, port model) with the same weights: numpy draws
    from a seed, carried into the port by ``params_from_jax``."""
    kw = VARIANTS[variant]
    jcfg = JaxConfig.make(jax_tiny(), **kw)
    r = np.random.default_rng(0)
    flat = {k: r.uniform(-0.4, 0.4, shape).astype(np.float32)
            + (1.0 if k.endswith("ln_scale") else 0.0)
            for k, shape in _ref_shapes(jcfg).items()}
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), fused_cell=fused, **kw))
    model.load_state_dict(params_from_jax(flat), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    return params, jcfg, model


def _frames(t, b=1, h=32, w=32, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (t, b, h, w, 1)).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streaming_logits_match_jax(variant, fused):
    params, jcfg, model = _pair(variant, fused)
    frames = _frames(3, b=2)
    jstep = jax.jit(lambda p, s, f: JaxNet.step(p, s, f, jcfg))
    jstate = JaxNet.init_state(jcfg, 2, 32, 32)
    tstate = model.init_state(2, 32, 32)
    reset_counts()
    with torch.no_grad():
        for f in frames:
            jstate, jlog = jstep(params, jstate, jnp.asarray(f))
            tstate, tlog = model.step(tstate, torch.from_numpy(f))
            assert tlog.dtype == torch.float32 and tlog.shape == (2, 32, 32, 3)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    for jl, tl in zip(jstate, tstate):
        for (jh, jc), (th, tc) in zip(jl, tl):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    ran = counts()  # the tiny levels (3x3, F=8/16) are K4's when fused
    assert ran["fused_convlstm_level"]["plain"] == (6 if fused else 0)
    assert ran["lstm_gate_update"]["plain"] == (0 if fused else 6)


def test_step_equals_apply():
    _, _, model = _pair("default")
    frames = torch.from_numpy(_frames(3, b=2, h=16, w=16)).permute(1, 0, 2, 3, 4)
    with torch.no_grad():
        s_apply, logits = model.apply(model.init_state(2, 16, 16), frames)
        state = model.init_state(2, 16, 16)
        for t in range(3):
            state, lg = model.step(state, frames[:, t])
            torch.testing.assert_close(logits[:, t], lg, atol=0, rtol=0)
    for la, ls in zip(s_apply, state):
        for a, s in zip(la, ls):
            torch.testing.assert_close(a[0], s[0], atol=0, rtol=0)


def test_init_state_needs_multiple_of_2_depth():
    _, _, model = _pair("default")
    with pytest.raises(ValueError, match="multiples of 2"):
        model.init_state(1, 30, 32)
    shapes = [[h.shape for h, _ in lvl] for lvl in model.init_state(1, 32, 8)]
    assert shapes == [[(1, 32, 8, 8)], [(1, 16, 4, 16)]]


def test_reset_lanes_zeroes_only_finished_lanes():
    state = [[(torch.ones(2, 4, 4, 3), torch.full((2, 4, 4, 3), 2.0))]]
    out = ULSTMnet2D.reset_lanes(state, torch.tensor([0.0, 1.0]))
    h, c = out[0][0]
    assert bool((h[0] == 1).all()) and bool((c[0] == 2).all())
    assert bool((h[1] == 0).all()) and bool((c[1] == 0).all())


def test_param_tree_matches_reference():
    """Same names and shapes as the reference tree (kernels OIHW)."""
    jcfg = JaxConfig.make(jax_tiny(), norm="layernorm")
    ref = _ref_shapes(jcfg)
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), norm="layernorm"))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k.replace("/", "."): (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
            for k, s in ref.items()}
    assert got == want


def test_config_state_dtype_and_bf16_step():
    cfg = ModelConfig.make(tiny_net_kernel_params(), dtype="bfloat16",
                           state_dtype="float32")
    assert cfg.compute_dtype == torch.bfloat16 and cfg.carry_dtype == torch.float32
    model = ULSTMnet2D(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16)
    with torch.no_grad():
        state, logits = model.step(model.init_state(1, 16, 16),
                                   torch.rand(1, 16, 16, 1))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert state[0][0][0].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="int8"):
        dataclasses.replace(cfg, quant="int8")
