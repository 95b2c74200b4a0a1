"""Held-out generalization protocol: the synthetic train / eval data.

Counterpart of the reference's ``scripts/heldout_protocol.py``: the same
tables, value for value, so the same seeds write the same TIFFs
(``io/synthetic.py`` draws as the reference does). With no real CTC data to
download, the substitute for a generalization claim is a held-out synthetic
protocol: train on one set of synthetic sequences, score SEG on sequences
drawn with different seeds and a shifted distribution (cell count and
radius scale) that the model never saw.

Usage:
    python -m lstm_unet_tpu_torch.scripts.heldout_protocol gen --root HELDOUT
    python -m lstm_unet_tpu_torch.cli.train2d --root_data_dir HELDOUT/train ...
    python -m lstm_unet_tpu_torch.cli.ctc_sweep --model_path RUN_DIR \
        --root_data_dir HELDOUT/eval --output_root RESULTS --score_seg

Protocol versions (the claims differ):

- v1 (sequences 01–03): train only on 30 cells / radius 1.0; the eval
  configs (20/0.8, 35/1.0, 45/1.2) are unseen seeds AND a shifted
  density/size distribution — an out-of-distribution generalization score.
- v2 (adds 04–06): the training set covers the eval density/size range, so
  the holdout is seed-only (matched distribution, unseen data) — the
  standard train/test split claim, NOT a distribution-shift claim.
- v3 (adds 07–09): occlusion-heavy training, half the cells placed touching
  an anchor and drifting with it.
- v4 (``gen --v4`` adds 10–12): each sequence deletes one more cue between
  touching cells (matched intensity, contacts that form and break).
The eval sequences are the same under every version.
"""

from __future__ import annotations

import argparse
import os

from ..io.synthetic import write_ctc_dataset

SIZE = 512
DATASET = "Synth-N2DH-SIM"

TRAIN = [  # (seq, seed, num_cells, radius_scale, frames, overlap_frac)
    ("01", 1, 30, 1.0, 100, 0.0),
    ("02", 2, 30, 1.0, 100, 0.0),
    ("03", 3, 30, 1.0, 40, 0.0),  # validation
    # protocol v2: broaden the TRAINING distribution to cover the
    # density/size range; eval seeds stay unseen. v1 trained only on
    # 30-cell/1.0 and was scored out-of-distribution on density.
    ("04", 4, 20, 0.8, 100, 0.0),
    ("05", 5, 35, 1.0, 100, 0.0),
    ("06", 6, 45, 1.2, 100, 0.0),
    # protocol v3: occlusion-heavy regime — half the cells placed
    # touching/overlapping an anchor and drifting with it, so persistent
    # faint inter-cell boundaries are abundant in training. Eval sequences
    # are UNCHANGED from v1/v2 so scores stay directly comparable.
    ("07", 7, 35, 1.0, 100, 0.5),
    ("08", 8, 45, 1.2, 100, 0.5),
    ("09", 9, 50, 1.1, 100, 0.4),
]
# protocol v4: the residual failure is merges where the brightness cue
# between touching cells vanishes. Each v4 sequence deletes one remaining
# cue (see the make_cell_sequence docstring): 10 = intensity-matched
# occluders with deep forced overlap; 11 = intensity-matched AND dynamic
# (contacts form / break mid-sequence); 12 = dynamic-only at high density.
# Eval sequences stay UNCHANGED so scores remain directly comparable.
TRAIN_V4 = [  # (seq, seed, num_cells, radius_scale, frames, overlap_frac, extra)
    ("10", 10, 40, 1.0, 100, 0.6,
     dict(overlap_match_intensity=True, overlap_gap=(0.45, 0.95))),
    ("11", 11, 50, 1.2, 100, 0.6,
     dict(overlap_match_intensity=True, overlap_rel_velocity=0.35)),
    ("12", 12, 45, 1.1, 100, 0.5, dict(overlap_rel_velocity=0.5)),
]
HELDOUT = [
    ("01", 101, 20, 0.8, 40, 0.0),
    ("02", 102, 35, 1.0, 40, 0.0),
    ("03", 103, 45, 1.2, 40, 0.0),
]

# Non-square geometry: Fluo-N2DH-SIM+ is 690 wide x 628 high uint16, which
# exercises the pad-to-a-multiple crop-back and FOV at original size. eval/
# gets the three held-out configs at this geometry; agree/ one short
# sequence for the card-bf16 vs CPU-f32 mask-agreement check
# (mask_agreement; CPU f32 at 40 frames is slow).
NS_H, NS_W = 628, 690
NS_EVAL = [
    ("01", 201, 20, 0.8, 40, 0.0),
    ("02", 202, 35, 1.0, 40, 0.0),
    ("03", 203, 45, 1.2, 40, 0.0),
]
NS_AGREE = [("01", 211, 30, 1.0, 8, 0.3)]


def gen_ns(root: str) -> None:
    for sub, cfgs in (("eval", NS_EVAL), ("agree", NS_AGREE)):
        for seq, seed, n, rs, frames, ov in cfgs:
            write_ctc_dataset(os.path.join(root, sub), dataset=DATASET,
                              seq=seq, num_frames=frames, height=NS_H,
                              width=NS_W, num_cells=n, seed=seed,
                              radius_scale=rs, overlap_frac=ov)
            print(f"{sub}/{DATASET}/{seq}: seed={seed} cells={n} rs={rs} "
                  f"T={frames} ov={ov} {NS_H}x{NS_W}")


def gen(root: str, v4: bool = False) -> None:
    train = (TRAIN + [t[:6] for t in TRAIN_V4]) if v4 else TRAIN
    extras = ({t[0]: t[6] for t in TRAIN_V4} if v4 else {})
    for seq, seed, n, rs, frames, ov in train:
        write_ctc_dataset(os.path.join(root, "train"), dataset=DATASET,
                          seq=seq, num_frames=frames, height=SIZE, width=SIZE,
                          num_cells=n, seed=seed, radius_scale=rs,
                          overlap_frac=ov, **extras.get(seq, {}))
        print(f"train/{DATASET}/{seq}: seed={seed} cells={n} rs={rs} "
              f"T={frames} ov={ov} {extras.get(seq, '')}")
    for seq, seed, n, rs, frames, ov in HELDOUT:
        write_ctc_dataset(os.path.join(root, "eval"), dataset=DATASET,
                          seq=seq, num_frames=frames, height=SIZE, width=SIZE,
                          num_cells=n, seed=seed, radius_scale=rs,
                          overlap_frac=ov)
        print(f"eval/{DATASET}/{seq}: seed={seed} cells={n} rs={rs} "
              f"T={frames} ov={ov}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen")
    g.add_argument("--root", type=str, required=True)
    g.add_argument("--v4", action="store_true",
                   help="also write the v4 occlusion-hardness sequences "
                        "(10-12); 01-09 and eval are bit-identical either way")
    n = sub.add_parser("gen_ns", help="non-square 628x690 rehearsal data")
    n.add_argument("--root", type=str, required=True)
    args = ap.parse_args(argv)
    if args.cmd == "gen":
        gen(args.root, v4=args.v4)
    elif args.cmd == "gen_ns":
        gen_ns(args.root)


if __name__ == "__main__":
    main()
