"""bf16 LSTM-carry drift over a long stream.

Counterpart of the reference's ``scripts/carry_drift.py``, with its flags,
CSV columns and ``#`` summary line, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and a second ``#`` line with each
variant's ms/frame.

The ConvLSTM cell state accumulates across an unbounded stream; under bf16
compute the carry can be kept in bf16 (state_dtype='auto') or f32
(state_dtype='float32'). This measures the actual divergence between the two
over a 1000+-frame stateful stream: per-frame max |logits delta| and the
instance-mask pixel disagreement, every K frames, and each variant's SEG
against the generator's instance GT. Both models come from
``checkpoint/convert.py::load_model`` (``fused_cell`` as the model dir's
``model_params.json`` says); each frame runs ``model.step``, softmax and
``postprocess_frame`` on the device.

The stream concatenates many synthetic segments (different seeds) WITHOUT
state resets — scene changes stress the carry more than a quasi-static
field of drifting cells.

Usage:
    python -m lstm_unet_tpu_torch.scripts.carry_drift --model_path RUN_DIR \\
        --frames 1200 --size 512
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.convert import load_model
from ..io.preprocess import percentile_normalize_np
from ..io.synthetic import make_cell_sequence
from ..metrics import seg_measure
from ..ops.postprocess import postprocess_frame
from ..utils import resolve_device

VARIANTS = ("auto", "float32")
COLUMNS = ("frame,max_abs_dlogits,mask_diff_px,instances_bf16,instances_f32,"
           "seg_bf16,seg_f32")


def main(argv=None) -> dict:
    """Returns ``{"rows": [CSV row strings], "ms_per_frame": {variant: ms}}``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--segment", type=int, default=40,
                    help="frames per synthetic segment; state is NEVER "
                         "reset across segment boundaries")
    ap.add_argument("--velocity_scale", type=float, default=1.0,
                    help="cell drift per frame; with --segment == --frames "
                         "use ~0.2 so one coherent sequence keeps its cells "
                         "in frame for 1000+ frames")
    ap.add_argument("--report_every", type=int, default=100)
    ap.add_argument("--cells", type=int, default=30)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the hand kernels) or 'cpu' (plain PyTorch); "
                         "'cuda' without a GPU raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    runs = {}
    for state_dtype in VARIANTS:
        model = load_model(args.model_path, device, dtype="bfloat16",
                           state_dtype=state_dtype)
        runs[state_dtype] = (model, model.init_state(1, args.size, args.size))

    def step(model, state, x):
        with torch.no_grad():
            new_state, logits = model.step(state, x)
            probs = torch.softmax(logits[0], dim=-1)
            labels = postprocess_frame(probs, cell_thresh=0.5,
                                       edge_thresh=0.3, min_cell_size=10)
        return new_state, logits, labels

    n_seg = (args.frames + args.segment - 1) // args.segment
    spent = dict.fromkeys(VARIANTS, 0.0)
    rows = []
    t0 = time.perf_counter()
    # divergence alone doesn't pick a default (two chaotic-but-equal
    # variants also diverge) — score each variant against the generator's
    # instance GT so drift is measured as QUALITY, not distance
    print(COLUMNS)
    frame_idx = 0
    for seg in range(n_seg):
        imgs, gts = make_cell_sequence(num_frames=args.segment,
                                       height=args.size, width=args.size,
                                       num_cells=args.cells, seed=1000 + seg,
                                       velocity_scale=args.velocity_scale)
        for f, gt in zip(imgs, gts):
            x = torch.from_numpy(percentile_normalize_np(f)).to(device)[None, ..., None]
            out = {}
            for k, (model, state) in runs.items():
                t1 = time.perf_counter()
                new_state, logits, labels = step(model, state, x)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                spent[k] += time.perf_counter() - t1
                runs[k] = (model, new_state)
                out[k] = (logits, labels)
            frame_idx += 1
            if frame_idx % args.report_every == 0 or frame_idx == args.frames:
                la, ma = out["auto"]
                lf, mf = out["float32"]
                dl = float((la.float() - lf.float()).abs().max())
                dm = int(((ma > 0) != (mf > 0)).sum())
                ia = int(ma.max())
                if_ = int(mf.max())
                sa, na = seg_measure(gt, ma.cpu().numpy())
                sf, nf = seg_measure(gt, mf.cpu().numpy())
                sa = sa / max(na, 1)
                sf = sf / max(nf, 1)
                rows.append(f"{frame_idx},{dl:.5f},{dm},{ia},{if_},"
                            f"{sa:.4f},{sf:.4f}")
                print(rows[-1], flush=True)
            if frame_idx >= args.frames:
                break
        if frame_idx >= args.frames:
            break
    dt = time.perf_counter() - t0
    ms = {k: 1e3 * v / max(frame_idx, 1) for k, v in spent.items()}
    print(f"# {frame_idx} frames x 2 variants in {dt:.1f}s")
    print("# ms/frame (step + softmax + postprocess): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    return {"rows": rows, "ms_per_frame": ms}


if __name__ == "__main__":
    main()
