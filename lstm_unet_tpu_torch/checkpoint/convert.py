"""The bridge between the reference's param tree and the port's modules.

The reference keeps parameters as a pytree of nested dicts and lists
(``encoder[l]["lstm"][j]["kernel_x"]``, ``decoder[l]["convs"][j]``,
``head``) with HWIO conv kernels. The port's ``state_dict`` uses the same
path joined with ``.`` and OIHW kernels. The ConvLSTM gate order (i, f, g, o)
on the 4F axis is the same in both, so only the 4-D kernels are transposed.

A port model dir holds the reference's ``model_params.json``, read verbatim,
and ``params.npz``: the reference tree flattened to ``/``-joined keys, arrays
in the reference layout. ``scripts/export_params_npz.py`` writes it from an
orbax model dir; the port's trainer writes one ``params.npz`` per saved step
(``checkpoint/ckpt.py``), which :func:`load_model` reads too.

The optimizer state maps the same way: :func:`opt_state_from_jax` takes
optax's Adam ``mu``/``nu``/``count`` (inside the clip / apply_if_finite
chain) to the state of the port's ``engine.optim.ClippedAdam``, so a
reference run can be carried across mid-training.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import ModelConfig, ULSTMnet2D, cast_params_for_inference
from ..utils import resolve_device
from .ckpt import MODEL_PARAMS_FILE, PARAMS_FILE, resolve_model_dir, saved_steps


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
    -> port ``state_dict`` (HWIO -> OIHW). A bf16 array (a JAX bf16 array
    made numpy) becomes a bf16 tensor, bit for bit."""
    flat = tree if isinstance(tree, dict) and all(
        "/" in k for k in tree) else flatten_tree(tree)
    sd = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        arr = np.array(arr, order="C")
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it out
            sd[key.replace("/", ".")] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            sd[key.replace("/", ".")] = torch.from_numpy(arr)
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


_SCALARS = ("count", "notfinite_count", "last_finite", "total_notfinite")


def _find_state(tree: Any, attrs) -> Any:
    """The first node of an optax state tree that has all of ``attrs``."""
    if all(hasattr(tree, a) for a in attrs):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find_state(t, attrs)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state: Any) -> Dict[str, Any]:
    """optax state of ``[apply_if_finite](chain([clip_by_global_norm], adam))``
    (arrays as numpy or jax arrays) -> ``ClippedAdam.state_dict()`` layout on
    the CPU. Without apply_if_finite the skip counters start at zero."""
    adam = _find_state(opt_state, ("mu", "nu", "count"))
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    out: Dict[str, Any] = {
        "mu": params_from_jax(flatten_tree(adam.mu)),
        "nu": params_from_jax(flatten_tree(adam.nu)),
        "count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32)}
    fin = _find_state(opt_state, ("notfinite_count", "last_finite", "total_notfinite"))
    for k in _SCALARS[1:]:
        v = np.asarray(getattr(fin, k)) if fin is not None else np.asarray(k == "last_finite")
        out[k] = torch.from_numpy(np.array(v, dtype=bool if k == "last_finite" else np.int32))
    return out


# npz has no bf16: a bf16 moment is stored as its raw bits under this suffix
_BF16_BITS = "_bf16_bits"


def opt_state_to_npz(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``ClippedAdam.state_dict()`` -> flat ``opt_state.npz`` arrays: ``mu/<key>``
    and ``nu/<key>`` in the reference layout, and the scalars. A bf16 moment
    goes under ``mu_bf16_bits/<key>`` as its uint16 bits."""
    flat: Dict[str, np.ndarray] = {}
    for moment in ("mu", "nu"):
        tensors = state[moment]
        if any(t.dtype == torch.bfloat16 for t in tensors.values()):
            bits = {k: t.view(torch.int16) for k, t in tensors.items()}
            flat.update({k: v.view(np.uint16) for k, v in flatten_tree(
                params_to_jax(bits), moment + _BF16_BITS).items()})
        else:
            flat.update(flatten_tree(params_to_jax(tensors), moment))
    flat.update({k: state[k].detach().cpu().numpy() for k in _SCALARS})
    return flat


def opt_state_from_npz(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_to_npz`."""
    out: Dict[str, Any] = {}
    for m in ("mu", "nu"):
        bits = {k[len(m + _BF16_BITS) + 1:]: v.view(np.int16) for k, v in flat.items()
                if k.startswith(m + _BF16_BITS + "/")}
        if bits:
            out[m] = {k: t.view(torch.bfloat16) for k, t in params_from_jax(bits).items()}
        else:
            out[m] = params_from_jax({k[len(m) + 1:]: v for k, v in flat.items()
                                      if k.startswith(m + "/")})
    out.update({k: torch.from_numpy(np.asarray(flat[k])) for k in _SCALARS})
    return out


def resolve_params_path(model_path: str, step: Optional[int] = None) -> str:
    """The ``params.npz`` of a model dir: the dir's own, or that of its saved
    step ``step`` (default: the latest) when a trainer wrote it. A run dir
    resolves to its ``ckpt`` dir."""
    own = os.path.join(model_path, PARAMS_FILE)
    steps = saved_steps(model_path)
    if step:
        if step not in steps:
            raise FileNotFoundError(f"no step {step} under {model_path} "
                                    f"(saved: {steps})")
        return os.path.join(model_path, str(step), PARAMS_FILE)
    if os.path.exists(own) or not steps:
        return own
    return os.path.join(model_path, str(steps[-1]), PARAMS_FILE)


def load_model(model_path: str, device="cuda", dtype: Optional[str] = None,
               state_dtype: Optional[str] = None,
               fused_cell: Optional[bool] = None,
               step: Optional[int] = None) -> ULSTMnet2D:
    """Build the model of a port model dir on ``device``, weights cast to the
    compute dtype (``dtype`` etc. override ``model_params.json``). The dir
    may be an experiment save dir or run dir of the port's trainer: then
    ``step`` (default: the latest) picks the saved step.

    ``dtype='int8'`` sets ``dtype='bfloat16', quant='int8'``, as the
    reference does, and keeps the weights as restored (f32): they are
    quantized from those, not from a bf16 copy, by
    ``models/ulstm_unet.py::quantize_model_int8``, which the streaming
    engine runs with the calibrated scales when it is built. ``device``
    'cuda' (the default) without a GPU raises, as every entry point of the
    port does."""
    device = resolve_device(device)
    model_path = resolve_model_dir(model_path)
    arch_path = os.path.join(model_path, MODEL_PARAMS_FILE)
    params_path = resolve_params_path(model_path, step)
    for p in (arch_path, params_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} missing: a port model dir holds {MODEL_PARAMS_FILE} and "
                f"{PARAMS_FILE} (scripts/export_params_npz.py writes them), or "
                f"step dirs with {PARAMS_FILE} (the port's trainer writes them)")
    with open(arch_path) as f:
        cfg_kw = dict(json.load(f)["model_config"])
    if dtype == "int8":
        cfg_kw.update(dtype="bfloat16", quant="int8")
        dtype = None
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
    if cfg.quant == "int8":
        return model.to(device)
    return cast_params_for_inference(model.to(device), cfg.compute_dtype)
