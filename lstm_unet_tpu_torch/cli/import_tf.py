"""Convert a TF2 / Keras checkpoint of the U-Net into a port model dir.

Same flags as ``python -m lstm_unet_tpu.cli.import_tf``. The weights are
mapped onto the param tree of a model of ``--net_kernel_params`` (a JSON
file or inline JSON; default: the flagship) by
``checkpoint/tf_import.py::import_keras_ulstm``, which fails on any shape
mismatch, and written as ``model_params.json`` + ``params.npz``: a dir that
``inference2d`` / ``ctc_sweep`` ``--model_path`` read. Weights only; no
optimizer state. ``--list`` prints the checkpoint's variables and exits.

Usage:
    python -m lstm_unet_tpu_torch.cli.import_tf \
        --tf_prefix models/Fluo-N2DH-SIM+/model.ckpt \
        --net_kernel_params arch.json --output_dir runs/imported
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..checkpoint.ckpt import PARAMS_FILE, save_model_params
from ..checkpoint.convert import flatten_tree, params_to_jax
from ..checkpoint.tf_bundle import TFBundle
from ..checkpoint.tf_import import import_keras_ulstm
from ..config import NetKernelParams, default_net_kernel_params
from ..models import ModelConfig, ULSTMnet2D
from ..utils import log_print


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tf_prefix", type=str, required=True,
                    help="TF checkpoint prefix (<prefix>.index + <prefix>.data-*)")
    ap.add_argument("--output_dir", type=str, required=True)
    ap.add_argument("--net_kernel_params", type=str,
                    help="JSON file or inline JSON; default: the flagship")
    ap.add_argument("--list", action="store_true", dest="list_only",
                    help="only list the checkpoint's variables and exit")
    args = ap.parse_args(argv)

    if args.list_only:
        for name, shape in TFBundle.open(args.tf_prefix).list_variables():
            print(name, list(shape))
        return ""

    if args.net_kernel_params:
        try:
            d = json.loads(args.net_kernel_params)
        except json.JSONDecodeError:
            with open(args.net_kernel_params) as f:
                d = json.load(f)
        nkp = NetKernelParams.from_dict(d)
    else:
        nkp = default_net_kernel_params()
    cfg = ModelConfig.make(nkp)
    # the template: the tree (and initial values of slots a TF layer does
    # not carry) of a model of this architecture, built on the CPU
    model = ULSTMnet2D(cfg, generator=torch.Generator().manual_seed(0))
    imported, report = import_keras_ulstm(args.tf_prefix, params_to_jax(model.state_dict()))
    for slot, path in report.items():
        log_print(f"  {slot} <- {path}")
    os.makedirs(args.output_dir, exist_ok=True)
    np.savez(os.path.join(args.output_dir, PARAMS_FILE), **flatten_tree(imported))
    save_model_params(args.output_dir, {"model_config": dataclasses.asdict(cfg),
                                        "imported_from": args.tf_prefix})
    log_print(f"imported {len(report)} tensors or layers -> {args.output_dir}")
    return args.output_dir


if __name__ == "__main__":
    main()
