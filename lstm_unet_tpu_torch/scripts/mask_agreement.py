"""Cross-backend mask agreement: score one mask dir against another.

Counterpart of the reference's ``scripts/mask_agreement.py``. Two backends
(bf16 on a card, f32 on the CPU) need not give bit-identical masks, so the
check is an agreement score: dir A's masks are taken as ground truth and dir
B's are SEG-scored against them (a mismatch either way lowers the
per-object Jaccard). 1.0 means label-map-identical instances.

Usage: python -m lstm_unet_tpu_torch.scripts.mask_agreement <dir_a> <dir_b>
Prints one line: agreement=<mean SEG> frames=<n>  (exit 1 on no overlap)
"""

from __future__ import annotations

import glob
import os
import sys

from ..io.tiff import read_tiff
from ..metrics import seg_measure_sequence


def main(argv=None) -> int:
    dir_a, dir_b = (sys.argv[1:] if argv is None else argv)[:2]
    gts, preds = [], []
    for pa in sorted(glob.glob(os.path.join(dir_a, "mask*.tif"))):
        pb = os.path.join(dir_b, os.path.basename(pa))
        if os.path.exists(pb):
            gts.append(read_tiff(pa))
            preds.append(read_tiff(pb))
    if not gts:
        print(f"agreement: no overlapping masks between {dir_a} and {dir_b}")
        return 1
    score = seg_measure_sequence(gts, preds)
    print(f"agreement={score:.4f} frames={len(gts)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
