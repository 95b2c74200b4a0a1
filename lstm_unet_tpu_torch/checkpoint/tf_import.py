"""Import TF2 / Keras U-Net weights into the reference param tree, and export
that tree as a TF bundle.

The port's own copy of ``lstm_unet_tpu/checkpoint/tf_import.py`` (numpy
only). The param tree is the one ``params.npz`` holds (nested dicts and
lists, HWIO kernels; ``checkpoint/convert.py`` maps it to the modules), so
an import becomes a port model dir that ``load_model`` reads.

A TF2 object-based checkpoint keys each variable by its object path plus
``/.ATTRIBUTES/VARIABLE_VALUE`` (optimizer slots carry ``/.OPTIMIZER_SLOT``).
The mapping is structural, as in the reference: variables are grouped by
parent path into layers, and the tree's slots, walked in construction order
(encoder levels: LSTM cells, then convs; decoder levels; head), each take
the first unused layer (natural path order) whose weight names and shapes
match: ``kernel`` / ``recurrent_kernel`` / ``bias`` for a ConvLSTM cell
(Keras' ConvLSTM2D layout and gate order are the tree's), ``kernel`` /
``bias`` for a conv. Unlike the reference, a layer that fits more than one
slot raises instead of going to the first: path order alone would decide
it. The flagship has such slots (decoder level 0's second conv has the
shape of encoder level 0's two convs; likewise at levels 1-3), so a TF
checkpoint of it imports only as a bundle that :func:`export_tf_bundle`
wrote, which carries the slot paths themselves (``encoder/0/lstm/0/kernel_x``)
and is read by name. Any mismatch raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np

from .tf_bundle import TFBundle, write_bundle

_VAR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _walk(tree: Any, path: str = ""):
    """Yield ``(slot path, leaf)`` of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def load_tf_variables(prefix: str) -> Dict[str, np.ndarray]:
    """The model variables of a TF2 checkpoint, ``{object_path: array}``
    (optimizer slots, the optimizer and ``save_counter`` left out)."""
    bundle = TFBundle.open(prefix)
    out: Dict[str, np.ndarray] = {}
    for name in bundle.entries:
        if not name.endswith(_VAR_SUFFIX) or "/.OPTIMIZER_SLOT" in name:
            continue
        path = name[:-len(_VAR_SUFFIX)]
        if path.split("/")[0] in ("optimizer", "save_counter"):
            continue
        out[path] = bundle.load(name)
    return out


def _group_layers(variables: Dict[str, np.ndarray]
                  ) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Variables grouped by parent path, natural-sorted: one group a layer."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in variables.items():
        parent, leaf = path.rsplit("/", 1)
        groups.setdefault(parent, {})[leaf] = arr
    return sorted(groups.items(), key=lambda kv: _natural_key(kv[0]))


def _take(layers, kind: str, shapes: Dict[str, tuple], context: str):
    """Pop the first unused layer whose weight names are exactly ``shapes``'
    keys, with those shapes."""
    for i, (path, weights) in enumerate(layers):
        if set(weights) != set(shapes):
            continue
        if all(weights[k].shape == tuple(s) for k, s in shapes.items()):
            layers.pop(i)
            return path, weights
    raise ValueError(
        f"no TF layer matches {context} ({kind} with shapes {shapes}); remaining layers: "
        f"{[(p, {k: v.shape for k, v in w.items()}) for p, w in layers]}")


def _slot_shapes(params) -> List[Tuple[str, Dict[str, tuple]]]:
    """``(slot, {TF weight name: shape})`` of every layer slot of the tree,
    in construction order."""
    out = []
    for lvl, level in enumerate(params["encoder"]):
        for j, cell in enumerate(level["lstm"]):
            out.append((f"encoder[{lvl}].lstm[{j}]",
                        {"kernel": np.shape(cell["kernel_x"]),
                         "recurrent_kernel": np.shape(cell["kernel_h"]),
                         "bias": np.shape(cell["bias"])}))
        out += [(f"encoder[{lvl}].convs[{j}]",
                 {"kernel": np.shape(c["kernel"]), "bias": np.shape(c["bias"])})
                for j, c in enumerate(level["convs"])]
    for lvl, level in enumerate(params["decoder"]):
        out += [(f"decoder[{lvl}].convs[{j}]",
                 {"kernel": np.shape(c["kernel"]), "bias": np.shape(c["bias"])})
                for j, c in enumerate(level["convs"])]
    out.append(("head", {"kernel": np.shape(params["head"]["kernel"]),
                         "bias": np.shape(params["head"]["bias"])}))
    return out


def _refuse_ambiguous(layers, params) -> None:
    """Raise when a TF layer's weight names and shapes fit more than one slot."""
    slots = _slot_shapes(params)
    for path, weights in layers:
        shapes = {k: v.shape for k, v in weights.items()}
        fits = [slot for slot, want in slots if want == shapes]
        if len(fits) > 1:
            raise ValueError(
                f"TF layer {path!r} {shapes} fits {len(fits)} slots ({', '.join(fits)}): "
                "the mapping by shape is ambiguous for this architecture; import a bundle "
                "keyed by slot path (export_tf_bundle) instead")


def _import_by_name(bundle: TFBundle, params) -> Tuple[dict, Dict[str, str]]:
    """The tree's leaves read from the bundle entries of their slot paths."""
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        arr = bundle.load(path)
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(f"TF tensor {path!r} has shape {arr.shape}, the model's "
                             f"slot {tuple(np.shape(leaf))}")
        flat[path] = arr.astype(np.float32)

    def rebuild(node, path=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v, f"{path}/{i}") for i, v in enumerate(node)]
        return None if node is None else flat[path]

    return rebuild(params), {p: p for p in flat}


def import_keras_ulstm(prefix: str, params) -> Tuple[dict, Dict[str, str]]:
    """Map a TF checkpoint onto the param tree ``params`` (it gives the
    structure and shapes, e.g. a freshly initialised model's tree): returns
    (the tree with the TF values as f32 numpy, ``{slot: TF layer path}``).
    Raises ``ValueError`` listing the shapes when the architectures
    disagree, or when a layer fits more than one slot."""
    bundle = TFBundle.open(prefix)
    if all(path in bundle.entries for path, _ in _walk(params)):
        return _import_by_name(bundle, params)
    layers = _group_layers(load_tf_variables(prefix))
    _refuse_ambiguous(layers, params)
    report: Dict[str, str] = {}

    def conv_slot(conv: dict, slot: str) -> dict:
        path, w = _take(layers, "Conv2D", {"kernel": np.shape(conv["kernel"]),
                                           "bias": np.shape(conv["bias"])}, slot)
        report[slot] = path
        return dict(conv, kernel=w["kernel"].astype(np.float32),
                    bias=w["bias"].astype(np.float32))

    new = {"encoder": [], "decoder": [], "head": None}
    for lvl, level in enumerate(params["encoder"]):
        new_level = {"lstm": [], "convs": []}
        for j, cell in enumerate(level["lstm"]):
            slot = f"encoder[{lvl}].lstm[{j}]"
            path, w = _take(layers, "ConvLSTM2D",
                            {"kernel": np.shape(cell["kernel_x"]),
                             "recurrent_kernel": np.shape(cell["kernel_h"]),
                             "bias": np.shape(cell["bias"])}, slot)
            report[slot] = path
            new_level["lstm"].append({"kernel_x": w["kernel"].astype(np.float32),
                                      "kernel_h": w["recurrent_kernel"].astype(np.float32),
                                      "bias": w["bias"].astype(np.float32)})
        new_level["convs"] = [conv_slot(conv, f"encoder[{lvl}].convs[{j}]")
                              for j, conv in enumerate(level["convs"])]
        new["encoder"].append(new_level)
    for lvl, level in enumerate(params["decoder"]):
        new["decoder"].append({"convs": [conv_slot(conv, f"decoder[{lvl}].convs[{j}]")
                                         for j, conv in enumerate(level["convs"])]})
    new["head"] = conv_slot(params["head"], "head")
    return new, report


def export_tf_bundle(prefix: str, params) -> None:
    """Write the param tree as a TF bundle, one f32 tensor per leaf keyed by
    its slot path (``encoder/0/lstm/0/kernel_x``, ...)."""
    write_bundle(prefix, {path: np.asarray(leaf, dtype=np.float32)
                          for path, leaf in _walk(params)})
