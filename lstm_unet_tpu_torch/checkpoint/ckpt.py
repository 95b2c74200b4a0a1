"""Training checkpoints in the port's own format.

Counterpart of ``lstm_unet_tpu/checkpoint/ckpt.py`` (orbax there). An
experiment's save dir holds the architecture file ``model_params.json`` and
one dir per saved step::

    <save_dir>/model_params.json
    <save_dir>/<step>/params.npz      the reference's param tree, '/'-joined
                                      keys, reference layout (HWIO kernels)
    <save_dir>/<step>/opt_state.npz   'mu/<key>', 'nu/<key>' in the same
                                      layout, and the optimizer's scalars

so ``params.npz`` is the same file a port model dir holds
(``checkpoint/convert.py``) and ``inference2d --model_path`` reads a step dir,
a save dir (latest step) or the run dir above it. A step is written to a
temporary dir and renamed into place, and a re-save of a step replaces its
dir only once the new one is complete; ``max_to_keep`` prunes the oldest. The trainer's interval saves may run on a
thread (``async_checkpoint``), from a device-side copy of its tensors
(``engine/train.py``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MODEL_PARAMS_FILE = "model_params.json"
PARAMS_FILE = "params.npz"
OPT_STATE_FILE = "opt_state.npz"


def resolve_model_dir(directory: str) -> str:
    """A run dir (``<run>/ckpt/model_params.json``) resolves to its ``ckpt``
    dir; anything else is returned unchanged."""
    if not os.path.exists(os.path.join(directory, MODEL_PARAMS_FILE)):
        sub = os.path.join(directory, "ckpt")
        if os.path.exists(os.path.join(sub, MODEL_PARAMS_FILE)):
            return sub
    return directory


def save_model_params(directory: str, arch: Dict[str, Any]) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_PARAMS_FILE), "w") as f:
        json.dump(arch, f, indent=2)


def saved_steps(directory: str) -> List[int]:
    """Steps saved under ``directory`` (numeric dirs holding params.npz)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, PARAMS_FILE)))


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


class CheckpointManager:
    """Save and restore ``(params, opt_state, step)`` as flat numpy dicts.
    ``create=False`` (the ranks of a multi-process run that do not write)
    reads the directory and does not make it."""

    def __init__(self, directory: str, max_to_keep: int = 5, create: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, params: Dict[str, np.ndarray],
             opt_state: Optional[Dict[str, np.ndarray]]) -> str:
        """Write step ``step`` (params only when ``opt_state`` is None); an
        existing dir of that step is replaced once the new one is complete."""
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, PARAMS_FILE), **params)
        if opt_state is not None:
            np.savez(os.path.join(tmp, OPT_STATE_FILE), **opt_state)
        old = f"{final}.old{os.getpid()}"
        if os.path.exists(final):  # a re-save of the same step
            os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
        if self.max_to_keep and self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def all_steps(self) -> List[int]:
        return saved_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = os.path.join(self.directory, str(step))
        return (_load_npz(os.path.join(d, PARAMS_FILE)),
                _load_npz(os.path.join(d, OPT_STATE_FILE)), step)


def average_checkpoints(src_dir: str, out_dir: str, steps: Optional[List[int]] = None,
                        out_step: Optional[int] = None) -> int:
    """Average saved steps into a new model dir ("model soup"); returns the
    step it wrote.

    The uniform mean over ``steps`` (default: every step saved under
    ``src_dir``, a save dir or the run dir above it) is summed in f32 in step
    order, multiplied by f32 ``1 / len(steps)`` and cast back to each
    array's dtype, as the reference does. ``out_dir`` gets a params-only step
    ``out_step`` (default: the newest averaged step) and a copy of
    ``model_params.json``, so ``load_model`` reads it as any model dir. The
    source dir is never written to, and its ``act_scales.json`` is not
    copied: averaged weights need their own calibration."""
    src_dir = resolve_model_dir(src_dir)
    if os.path.realpath(out_dir) == os.path.realpath(src_dir):
        raise ValueError(f"the soup must go to a new dir, not the source {src_dir}")
    steps = sorted(int(s) for s in (steps or saved_steps(src_dir)))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {src_dir}")
    acc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, np.dtype] = {}
    for s in steps:
        params = _load_npz(os.path.join(src_dir, str(s), PARAMS_FILE))
        if acc and set(params) != set(acc):
            raise ValueError(f"step {s} param tree differs from step {steps[0]}")
        for k, v in params.items():
            if k in acc:
                acc[k] += v.astype(np.float32)
            else:
                acc[k] = np.array(v, dtype=np.float32, copy=True)
                dtypes[k] = v.dtype
    inv = np.float32(1.0 / len(steps))
    avg = {k: (a * inv).astype(dtypes[k]) for k, a in acc.items()}
    out_step = max(steps) if out_step is None else out_step
    os.makedirs(out_dir, exist_ok=True)
    arch = os.path.join(src_dir, MODEL_PARAMS_FILE)
    if os.path.exists(arch):
        shutil.copyfile(arch, os.path.join(out_dir, MODEL_PARAMS_FILE))
    CheckpointManager(out_dir, max_to_keep=0).save(out_step, avg, None)
    return out_step
