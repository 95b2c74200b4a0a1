"""Export an orbax model dir to the PyTorch port's model dir.

Reads the model with ``lstm_unet_tpu.engine.infer.load_model`` and writes
``params.npz`` (the param tree flattened to ``/``-joined keys, arrays in
the JAX layout) next to a verbatim copy of ``model_params.json`` — the dir
``lstm_unet_tpu_torch.checkpoint.load_model`` and
``python -m lstm_unet_tpu_torch.cli.inference2d --model_path`` read.

    JAX_PLATFORMS=cpu python scripts/export_params_npz.py \
        --model_path tests/golden/ckpt --out tests/golden/torch_ckpt
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def export(model_path: str, out: str, step=None) -> str:
    from lstm_unet_tpu.checkpoint.ckpt import MODEL_PARAMS_FILE, resolve_model_dir
    from lstm_unet_tpu.engine.infer import load_model
    from lstm_unet_tpu_torch.checkpoint.convert import PARAMS_FILE, flatten_tree

    params, _ = load_model(model_path, step=step)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, PARAMS_FILE)
    np.savez(path, **flat)
    shutil.copyfile(os.path.join(resolve_model_dir(model_path), MODEL_PARAMS_FILE),
                    os.path.join(out, MODEL_PARAMS_FILE))
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", required=True, help="orbax model (or run) dir")
    ap.add_argument("--out", required=True, help="port model dir to write")
    ap.add_argument("--step", type=int, default=0,
                    help="checkpoint step to export (0 = latest)")
    args = ap.parse_args(argv)
    print(export(args.model_path, args.out, step=args.step or None))


if __name__ == "__main__":
    main()
