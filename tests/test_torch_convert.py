"""The port's checkpoint bridge and configuration against the JAX reference."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lstm_unet_tpu import config as jax_config
from lstm_unet_tpu.engine.infer import load_model as jax_load_model
from lstm_unet_tpu.models import ModelConfig as JaxModelConfig
from lstm_unet_tpu_torch import config
from lstm_unet_tpu_torch.checkpoint.convert import (flatten_tree, load_model,
                                                    params_from_jax, params_to_jax)
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
TORCH_CKPT = os.path.join(GOLDEN, "torch_ckpt")


@pytest.fixture(scope="module")
def golden_tree():
    params, _ = jax_load_model(os.path.join(GOLDEN, "ckpt"))
    return {k: np.asarray(v) for k, v in flatten_tree(params).items()}


def test_committed_npz_equals_orbax_golden_checkpoint(golden_tree):
    with np.load(os.path.join(TORCH_CKPT, "params.npz")) as npz:
        assert sorted(npz.files) == sorted(golden_tree)
        for k in npz.files:
            assert npz[k].dtype == golden_tree[k].dtype
            np.testing.assert_array_equal(npz[k], golden_tree[k], err_msg=k)
    with open(os.path.join(TORCH_CKPT, "model_params.json"), "rb") as a, \
            open(os.path.join(GOLDEN, "ckpt", "model_params.json"), "rb") as b:
        assert a.read() == b.read()


def test_params_round_trip_exactly(golden_tree):
    back = flatten_tree(params_to_jax(params_from_jax(golden_tree)))
    assert sorted(back) == sorted(golden_tree)
    for k, v in golden_tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # a nested tree with layernorm params round-trips to the same nesting
    model = ULSTMnet2D(ModelConfig.make(config.tiny_net_kernel_params(), norm="layernorm"),
                       generator=torch.Generator().manual_seed(0))
    tree = params_to_jax(model.state_dict())
    assert isinstance(tree["encoder"], list) and "ln_scale" in tree["decoder"][1]["convs"][0]
    for k, v in params_from_jax(tree).items():
        torch.testing.assert_close(v, model.state_dict()[k], atol=0, rtol=0)


def test_load_model_builds_the_golden_model():
    model = load_model(TORCH_CKPT, "cpu")
    assert model.cfg.dtype == "float32" and not model.cfg.fused_cell
    assert model.encoder[0].lstm[0].kernel_x.shape == (32, 1, 3, 3)
    bf = load_model(TORCH_CKPT, "cpu", dtype="bfloat16", state_dtype="float32",
                    fused_cell=True)
    assert bf.cfg.fused_cell and bf.head.kernel.dtype == torch.bfloat16
    assert bf.cfg.carry_dtype == torch.float32
    with pytest.raises(NotImplementedError, match="int8"):
        load_model(TORCH_CKPT, "cpu", dtype="int8")
    with pytest.raises(FileNotFoundError, match="params.npz"):
        load_model(os.path.join(GOLDEN, "ckpt"), "cpu")


def test_layernorm_params_stay_f32_under_bf16():
    from lstm_unet_tpu_torch.models import cast_params_for_inference

    model = ULSTMnet2D(ModelConfig.make(config.tiny_net_kernel_params(), norm="layernorm"))
    cast_params_for_inference(model, torch.bfloat16)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert all(d == torch.float32 for n, d in dtypes.items() if ".ln_" in n)
    assert all(d == torch.bfloat16 for n, d in dtypes.items() if ".ln_" not in n)


def test_config_matches_reference():
    jip = jax_config.CTCInferenceParams()
    for f in dataclasses.fields(config.InferenceParams):
        assert getattr(config.InferenceParams(), f.name) == getattr(jip, f.name), f.name
    for name in ("default_net_kernel_params", "tiny_net_kernel_params"):
        assert (getattr(config, name)().to_dict()
                == getattr(jax_config, name)().to_dict())
    ref = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert ours == ref
    recipe = os.path.join(HERE, "..", "configs", "recommended.json")
    assert config.load_recipe(recipe) == jax_config.load_recipe(recipe)
    with pytest.raises(AttributeError):
        config.InferenceParams().override(no_such_knob=1)
    with pytest.raises(ValueError, match="same number of levels"):
        config.NetKernelParams([[(3, 8)]], [[(3, 8)]], [])


def test_golden_model_params_json_is_read_verbatim():
    with open(os.path.join(TORCH_CKPT, "model_params.json")) as f:
        cfg = ModelConfig(**json.load(f)["model_config"])
    assert cfg.nkp.to_dict() == config.tiny_net_kernel_params().to_dict()
