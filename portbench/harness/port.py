"""The system under test, reached through the port's public entry points.

The one module of the harness that imports ``lstm_unet_tpu_torch``: its
model (``models.ULSTMnet2D``, loaded with the benchmark's weights by
parameter name), int8 calibration and quantisation
(``engine.infer.calibrate_act_scales``, ``models.quantize_model_int8``) or
the cast of a float model, the streaming engine
(``engine.infer.StreamingInferenceEngine``), the training step
(``engine.train.make_train_step`` with ``engine.optim.ClippedAdam``), the
postprocess (``ops.postprocess.postprocess_frame``) and the round counter of its
postprocess loop kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from lstm_unet_tpu_torch.config import InferenceParams, NetKernelParams
from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine, calibrate_act_scales
from lstm_unet_tpu_torch.engine.optim import ClippedAdam
from lstm_unet_tpu_torch.engine.train import make_train_step
from lstm_unet_tpu_torch.models import (ModelConfig, ULSTMnet2D, cast_params_for_inference,
                                        quantize_model_int8)
from lstm_unet_tpu_torch.ops.kernels import postprocess_loops
from lstm_unet_tpu_torch.ops.postprocess import postprocess_frame  # noqa: F401 (stream.py)

POSTPROCESS_KEYS = ("cell_thresh", "edge_thresh", "min_cell_size", "max_cell_size",
                    "size_filter", "boundary_growth", "grow_iters", "instance_split",
                    "split_method", "split_window", "split_min_dist", "split_slack",
                    "split_rel", "split_rel_window", "split_min_size", "split_hi_thresh",
                    "split_erode")


def model_config(cfg: Dict, training: bool = False) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file. Training builds it
    as the trainer does: without the fused cell, which is inference-only."""
    nkp = NetKernelParams.from_dict({k: cfg[k] for k in
                                     ("lstm_kernels", "down_conv_kernels", "up_conv_kernels")})
    return ModelConfig.make(nkp, in_channels=cfg["in_channels"],
                            num_classes=cfg["num_classes"], activation=cfg["activation"],
                            recurrent_activation=cfg["recurrent_activation"],
                            upsample=cfg["upsample"], norm=cfg["norm"], dtype=cfg["dtype"],
                            quant="none" if training else cfg["quant"],
                            fused_cell=False if training else cfg["fused_cell"],
                            state_dtype=cfg["state_dtype"])


def load_model(cfg: Dict, weights: Dict[str, torch.Tensor], device,
               training: bool = False) -> ULSTMnet2D:
    model = ULSTMnet2D(model_config(cfg, training), device="meta")
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def serving_model(cfg: Dict, weights: Dict[str, torch.Tensor], calibration: List[np.ndarray],
                  device) -> ULSTMnet2D:
    """The model as it serves: int8 calibrated on ``calibration`` (raw
    frames) and quantised, or cast to its compute dtype."""
    model = load_model(cfg, weights, device)
    if cfg["quant"] == "int8":
        scales = calibrate_act_scales(model, [f.astype(np.float32) for f in calibration])
        quantize_model_int8(model, scales, float_dtype=model.cfg.compute_dtype)
    else:
        cast_params_for_inference(model, model.cfg.compute_dtype)
    return model


def inference_params(cfg: Dict, traffic: Dict) -> InferenceParams:
    known = {f.name for f in dataclasses.fields(InferenceParams)}
    over = dict(traffic.get("inference", {}))
    unknown = set(over) - known
    if unknown:
        raise KeyError(f"unknown inference knobs {sorted(unknown)}")
    return InferenceParams(dtype="int8" if cfg["quant"] == "int8" else cfg["dtype"],
                           fused_cell=cfg["fused_cell"], **over)


def engine(model: ULSTMnet2D, ip: InferenceParams, device) -> StreamingInferenceEngine:
    return StreamingInferenceEngine(model, ip, device)


def postprocess_kwargs(ip: InferenceParams) -> Dict:
    out = {k: getattr(ip, k) for k in POSTPROCESS_KEYS}
    out["fov"] = ip.FOV
    return out


def train_step(model: ULSTMnet2D, optim: Dict, class_weights, remat):
    opt = ClippedAdam(dict(model.named_parameters()), optim["learning_rate"],
                      grad_clip_norm=optim["grad_clip_norm"],
                      skip_nonfinite_updates=optim["skip_nonfinite_updates"])
    return opt, make_train_step(model, opt, class_weights, remat=remat)


def loop_rounds(device) -> Dict[str, int]:
    return postprocess_loops.device_rounds(device)


def clear_loop_rounds() -> None:
    postprocess_loops.clear_rounds()

