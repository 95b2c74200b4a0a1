"""The output check: the program's outputs against the plain reference.

The reference (``portbench/reference/``) works out again, in f32 with TF32
off, everything the program derived from the benchmark's inputs (int8
scales and codes from the float weights, the normalised frames), and reads
the program's outputs only to judge them.

Streaming cells. Set-up hands the engine the sequence's first frames, one
by one from the zero state, through the same entry and the same captured
graphs as the window; the reference streams the same frames from the zero
state beside them. It reads only what the program returns, never its
carried buffers. The numbers:

- ``prob_gap``: over those frames, the worst relative L2 gap of the
  probabilities the step returned (``save_intermediate``) against the
  reference's; after the first frame each depends on the state carried so
  far, so a state that is lost or mangled shows here;
- ``label_gap``: the program's labels against the reference postprocess
  run on the program's own probabilities, by
  :func:`reference.postprocess.label_mismatch`, over the same frames: the
  postprocess is exact, so its limit is 0.

Training cells. The set-up drives the program's own training step through
its first steps, which cross a sequence's end (a lane's state reset); the
reference follows them from the same weights on the same batches. Numbers:
``loss_gap`` (the largest relative gap of a step's loss), ``grad_gap``
(per leaf, the gap between the norms of the first gradient as the
optimizer got it, the program's worked out from Adam's first moment after
one step, over the larger of the reference's norm of that leaf and of the
median leaf; the worst leaf), ``change_gap`` (the same of the parameters'
change over the steps, leaving out leaves whose reference gradient is under
a thousandth of the median leaf's), ``state_gap`` (the state the first step
carries on, by :func:`state_gap`: later steps' states differ by Adam's
first updates, which follow the sign of gradients that are all but zero)
and ``reset_gap`` (:func:`max_abs_gap` of the state a step that ends the
sequence leaves, which is zeros: an exact comparison, limit 0).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float(torch.linalg.vector_norm(prog.float().to(ref.device) - ref)
                 / torch.clamp(torch.linalg.vector_norm(ref), min=1e-30))


def state_gap(prog_nhwc: List, ref_nchw: List) -> float:
    """Worst gap over the carried tensors (h and c of every ConvLSTM layer,
    every lane): the RMS of a tensor's difference over the larger of the
    reference's RMS of that tensor and the median of those RMSs (a deep
    level's state can be all but zero). The program's state is NHWC, the
    reference's NCHW."""
    pairs = [(p.permute(0, 3, 1, 2), r) for lvl_p, lvl_r in zip(prog_nhwc, ref_nchw)
             for pair_p, pair_r in zip(lvl_p, lvl_r) for p, r in zip(pair_p, pair_r)]

    def rms(t):
        return float(torch.linalg.vector_norm(t.float()) / t.numel() ** 0.5)

    floor = float(np.median([rms(r) for _, r in pairs]))
    return max(rms(p.float().to(r.device) - r) / max(rms(r), floor, 1e-30) for p, r in pairs)


def max_abs_gap(prog_nhwc: List, ref_nchw: List) -> float:
    """The largest absolute difference over the carried tensors; a missing
    state reads as infinitely far."""
    if prog_nhwc is None:
        return float("inf")
    return max(float((p.permute(0, 3, 1, 2).float().to(r.device) - r).abs().max())
               for lvl_p, lvl_r in zip(prog_nhwc, ref_nchw)
               for pair_p, pair_r in zip(lvl_p, lvl_r) for p, r in zip(pair_p, pair_r))


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leave_out: Sequence[str] = ()) -> float:
    """The worst leaf's ``|n_prog - n_ref| / max(n_ref, median n_ref)``."""
    med = float(np.median([ref[k] for k in ref]))
    worst = 0.0
    for k, r in ref.items():
        if k in leave_out:
            continue
        worst = max(worst, abs(prog[k] - r) / max(r, med, 1e-30))
    return worst


def decide(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{"correct": ..., "numbers": {name: {"value", "limit"}}}``; a number
    that is not finite fails, and so does a limit that has no number."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        ok &= good
        out[name] = {"value": v, "limit": limit}
    return {"correct": ok, "numbers": out}


def report(verdict: Dict) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for name, nl in verdict["numbers"].items():
        print(f"check {name} = {nl['value']!r} (limit {nl['limit']!r})", file=sys.stderr)
    print(f"check correct = {verdict['correct']}", file=sys.stderr, flush=True)
