"""The 'save_outputs' remat policy against the JAX reference's, on the CPU.

The reference checkpoints each frame and saves only the tensors it names
``lstm_out`` (each ConvLSTM layer's output) and ``skip`` (each encoder
level's conv-stack output); the port checkpoints the frame in segments
whose inputs are those tensors. Tiny model, 32² crops, B = 2, T = 3, f32.
Grads: 1e-5 of each leaf's largest magnitude against the reference (two
frameworks' f32 convs) and 1e-6 against the port without remat (the same
ops, recomputed). Memory: the bytes the forward leaves alive for the
backward, counted by a dispatch mode over every tensor the ops return, lie
strictly between full remat and none, and exceed full remat's by exactly
the skips.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from lstm_unet_tpu import config as jax_config
from lstm_unet_tpu.engine.loss import weighted_ce_loss as jax_loss
from lstm_unet_tpu.models import ModelConfig as JaxModelConfig
from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
from lstm_unet_tpu_torch import config
from lstm_unet_tpu_torch.checkpoint.convert import flatten_tree, params_from_jax
from lstm_unet_tpu_torch.engine.loss import weighted_ce_loss
from lstm_unet_tpu_torch.engine.train import loss_and_grads
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D

CW = (0.15, 0.25, 0.6)
B, T, H, W = 2, 3, 32, 32


@pytest.fixture(scope="module")
def setup():
    cfg = JaxModelConfig.make(jax_config.tiny_net_kernel_params())
    params = JaxNet.init(jax.random.PRNGKey(3), cfg)
    r = np.random.default_rng(4)
    state = [[(r.uniform(-1, 1, h.shape).astype(np.float32),
               r.normal(size=c.shape).astype(np.float32)) for (h, c) in lvl]
             for lvl in JaxNet.init_state(cfg, B, H, W)]
    batch = (r.uniform(0, 1, (B, T, H, W, 1)).astype(np.float32),
             r.integers(0, 3, (B, T, H, W)).astype(np.int32),
             np.ones((B, T), np.float32), np.array([[1, 0, 1], [1, 1, 1]], np.float32))
    model = ULSTMnet2D(ModelConfig.make(config.tiny_net_kernel_params()))
    model.load_state_dict(params_from_jax(flatten_tree(params)))
    return cfg, params, state, batch, model


def _tstate(state):
    return [[(torch.tensor(h), torch.tensor(c)) for (h, c) in lvl] for lvl in state]


def test_save_outputs_grads_match_the_reference(setup):
    cfg, params, state, batch, model = setup
    img, seg, valid, full = batch
    jstate = [[(jnp.asarray(h), jnp.asarray(c)) for (h, c) in lvl] for lvl in state]

    def loss_fn(p):
        _, logits = JaxNet.apply(p, jstate, jnp.asarray(img), cfg, remat="save_outputs")
        return jax_loss(logits, jnp.asarray(seg), jnp.asarray(valid), CW,
                        jnp.asarray(full))[0]

    want = params_from_jax(flatten_tree(jax.grad(loss_fn)(params)))
    tb = tuple(map(torch.from_numpy, batch))
    _, _, _, got = loss_and_grads(model, _tstate(state), *tb, CW, remat="save_outputs")
    _, _, _, plain = loss_and_grads(model, _tstate(state), *tb, CW, remat=False)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = float(want[k].abs().max())
        torch.testing.assert_close(g, want[k], rtol=0, atol=1e-5 * scale, msg=k)
        torch.testing.assert_close(g, plain[k], rtol=0, atol=1e-6 * scale, msg=k)


class _Alive(TorchDispatchMode):
    """Weak references to every tensor an op returns; ``nbytes`` sums the
    distinct storages still alive."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs.extend(weakref.ref(t) for t in pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor))
        return out

    def nbytes(self):
        alive = {}
        for ref in self.refs:
            t = ref()
            if t is not None:
                alive[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return sum(alive.values())


def test_save_outputs_holds_memory_between_full_and_none(setup):
    _, _, state, batch, model = setup
    img, seg, valid, full = map(torch.from_numpy, batch)
    held = {}
    for remat in (False, "full", "save_outputs"):
        mode = _Alive()
        with mode:
            _, logits = model.apply(_tstate(state), img, remat=remat)
            loss = weighted_ce_loss(logits, seg, valid, CW, full)[0]
        gc.collect()
        held[remat] = mode.nbytes()
        loss.backward()
        del logits, loss
    assert held["full"] < held["save_outputs"] < held[False]
    # full remat keeps each frame's state, so in f32, where a ConvLSTM
    # layer's output is its new h, 'save_outputs' adds each level's skip
    nkp = config.tiny_net_kernel_params()
    skips = sum(B * (H >> lvl) * (W >> lvl) * 4 * nkp.down_conv_kernels[lvl][-1][1]
                for lvl in range(nkp.depth)) * T
    assert held["save_outputs"] - held["full"] == skips
