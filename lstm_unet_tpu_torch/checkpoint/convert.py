"""The bridge between the reference's param tree and the port's modules.

The reference keeps parameters as a pytree of nested dicts and lists
(``encoder[l]["lstm"][j]["kernel_x"]``, ``decoder[l]["convs"][j]``,
``head``) with HWIO conv kernels. The port's ``state_dict`` uses the same
path joined with ``.`` and OIHW kernels. The ConvLSTM gate order (i, f, g, o)
on the 4F axis is the same in both, so only the 4-D kernels are transposed.

A port model dir holds the reference's ``model_params.json``, read verbatim,
and ``params.npz``: the reference tree flattened to ``/``-joined keys, arrays
in the reference layout. ``scripts/export_params_npz.py`` writes it from an
orbax model dir.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import ModelConfig, ULSTMnet2D, cast_params_for_inference

MODEL_PARAMS_FILE = "model_params.json"
PARAMS_FILE = "params.npz"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> ``{"encoder/0/lstm/0/kernel_x": array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """Reference param tree (nested, or flat with ``/`` keys; numpy arrays)
    -> port ``state_dict`` (HWIO -> OIHW)."""
    flat = tree if isinstance(tree, dict) and all(
        "/" in k for k in tree) else flatten_tree(tree)
    sd = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[key.replace("/", ".")] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Any:
    """Port ``state_dict`` -> reference param tree of numpy arrays (OIHW ->
    HWIO); the inverse of :func:`params_from_jax`."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        flat[key.replace(".", "/")] = arr
    return _unflatten(flat)


def load_model(model_path: str, device="cpu", dtype: Optional[str] = None,
               state_dtype: Optional[str] = None,
               fused_cell: Optional[bool] = None) -> ULSTMnet2D:
    """Build the model of a port model dir on ``device``, weights cast to the
    compute dtype (``dtype`` etc. override ``model_params.json``)."""
    arch_path = os.path.join(model_path, MODEL_PARAMS_FILE)
    params_path = os.path.join(model_path, PARAMS_FILE)
    for p in (arch_path, params_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} missing: a port model dir holds {MODEL_PARAMS_FILE} and "
                f"{PARAMS_FILE} (scripts/export_params_npz.py writes them)")
    with open(arch_path) as f:
        cfg_kw = dict(json.load(f)["model_config"])
    if dtype == "int8":
        raise NotImplementedError(
            "dtype int8 is not ported yet (ROADMAP.md queue 1 item 9)")
    for k, v in (("dtype", dtype), ("state_dtype", state_dtype),
                 ("fused_cell", fused_cell)):
        if v is not None:
            cfg_kw[k] = v
    cfg = ModelConfig(**cfg_kw)
    with np.load(params_path) as npz:
        sd = params_from_jax({k: npz[k] for k in npz.files})
    with torch.device("meta"):
        model = ULSTMnet2D(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return cast_params_for_inference(model.to(device), cfg.compute_dtype)
