"""Frame reader for streaming inference.

Counterpart of ``lstm_unet_tpu/io/dataset.py::CTCInferenceReader``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np

from .preprocess import percentile_normalize_np
from .tiff import read_tiff

_FRAME_RE = re.compile(r"t(\d+)\.tif$")


def _frame_index(path: str) -> Optional[int]:
    m = _FRAME_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


class CTCInferenceReader:
    """Yields ``(frame_index or None, frame [H, W])`` for a sequence dir.

    The first ``pre_sequence_frames`` frames are yielded first, in reverse
    order and with index None: warm-up frames whose output is discarded but
    whose LSTM state is kept. With ``normalize=False`` frames come raw in
    their stored dtype (the engine normalizes them on the device).
    """

    def __init__(self, sequence_path: str, filename_format: str = "t*.tif",
                 pre_sequence_frames: int = 0, normalize: bool = True):
        self.paths = sorted(glob.glob(os.path.join(sequence_path, filename_format)))
        if not self.paths:
            raise FileNotFoundError(
                f"no frames matching {filename_format} under {sequence_path}")
        self.pre = min(pre_sequence_frames, len(self.paths))
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.paths)

    def frame_indices(self) -> List[int]:
        out = []
        for p in self.paths:
            idx = _frame_index(p)
            out.append(idx if idx is not None else len(out))
        return out

    def _load(self, path: str) -> np.ndarray:
        img = read_tiff(path)
        return percentile_normalize_np(img) if self.normalize else img

    def __iter__(self):
        for p in reversed(self.paths[:self.pre]):
            yield None, self._load(p)
        for p, idx in zip(self.paths, self.frame_indices()):
            yield idx, self._load(p)
