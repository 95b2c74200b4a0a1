"""Architecture and inference configuration.

Counterpart of ``lstm_unet_tpu/config/params.py``: the same knob names and
defaults (``tests/test_torch_convert.py`` holds them equal), carried here so
that the port runs where only PyTorch is installed. Only the knobs of the
streaming-inference slice live in :class:`InferenceParams`; the CLI rejects
the others by name (``cli/inference2d.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

# Per-level list of (kernel_size, filters); one outer entry per U-Net level.
LevelSpec = List[List[Tuple[int, int]]]


@dataclass
class NetKernelParams:
    """Per-level ``(kernel_size, filters)`` lists, the reference schema:
    ``lstm_kernels`` (ConvLSTM layers), ``down_conv_kernels`` (encoder conv
    stack) and ``up_conv_kernels`` (decoder conv stack, applied deepest
    first). The model appends a 1x1 head to ``num_classes`` logits."""

    lstm_kernels: LevelSpec
    down_conv_kernels: LevelSpec
    up_conv_kernels: LevelSpec

    def __post_init__(self):
        d = len(self.down_conv_kernels)
        if not (len(self.lstm_kernels) == len(self.up_conv_kernels) == d):
            raise ValueError(
                "lstm_kernels / down_conv_kernels / up_conv_kernels must have "
                f"the same number of levels, got {len(self.lstm_kernels)}/"
                f"{d}/{len(self.up_conv_kernels)}")
        self.lstm_kernels = [[tuple(k) for k in lvl] for lvl in self.lstm_kernels]
        self.down_conv_kernels = [[tuple(k) for k in lvl]
                                  for lvl in self.down_conv_kernels]
        self.up_conv_kernels = [[tuple(k) for k in lvl] for lvl in self.up_conv_kernels]

    @property
    def depth(self) -> int:
        return len(self.down_conv_kernels)

    def to_dict(self) -> Dict[str, Any]:
        return {"lstm_kernels": self.lstm_kernels,
                "down_conv_kernels": self.down_conv_kernels,
                "up_conv_kernels": self.up_conv_kernels}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NetKernelParams":
        return cls(lstm_kernels=d["lstm_kernels"],
                   down_conv_kernels=d["down_conv_kernels"],
                   up_conv_kernels=d["up_conv_kernels"])


def default_net_kernel_params() -> NetKernelParams:
    """The flagship: 4 levels, 5x5 ConvLSTM with F = 128/256/256/512, two
    3x3 convs per level (83.1 M parameters)."""
    return NetKernelParams(
        lstm_kernels=[[(5, 128)], [(5, 256)], [(5, 256)], [(5, 512)]],
        down_conv_kernels=[[(3, 128), (3, 128)], [(3, 256), (3, 256)],
                           [(3, 256), (3, 256)], [(3, 512), (3, 512)]],
        up_conv_kernels=[[(3, 128), (3, 128)], [(3, 256), (3, 256)],
                         [(3, 256), (3, 256)], [(3, 512), (3, 512)]],
    )


def tiny_net_kernel_params() -> NetKernelParams:
    """Small 2-level architecture for tests and the golden checkpoint."""
    return NetKernelParams(
        lstm_kernels=[[(3, 8)], [(3, 16)]],
        down_conv_kernels=[[(3, 8)], [(3, 16)]],
        up_conv_kernels=[[(3, 8)], [(3, 16)]],
    )


@dataclass
class InferenceParams:
    """Knobs of streaming inference (reference: ``CTCInferenceParams``)."""

    model_path: str = ""           # dir with model_params.json + params.npz
    ckpt_step: int = 0             # only 0: params.npz holds one step
    sequence_path: str = ""        # dir of t*.tif frames
    output_path: str = "./output"
    filename_format: str = "t*.tif"
    FOV: int = 0                   # drop instances that never enter the
                                   # region FOV px in from every border
    min_cell_size: int = 10
    max_cell_size: int = 0         # 0 = unlimited
    edge_thresh: float = 0.3       # p(boundary) threshold of the growth band
    cell_thresh: float = 0.5       # p(cell) threshold of the interior mask
    boundary_growth: str = "marker"  # 'marker' | 'dilate' | 'none'
    grow_iters: int = 0            # 0 = to exhaustion ('marker'), 3 ('dilate')
    size_filter: str = "pre"       # 'pre' | 'post' boundary growth
    pre_sequence_frames: int = 4   # warm-up: first frames fed reversed
    save_intermediate: bool = False
    save_intermediate_path: str = ""
    dtype: str = "bfloat16"        # 'float32' | 'bfloat16'
    state_dtype: str = "auto"      # LSTM carry dtype; 'auto' follows dtype
    fused_cell: bool = False       # whole-level fused ConvLSTM kernel (K4)
    digit_4: bool = False          # mask%04d.tif instead of mask%03d.tif
    watchdog_secs: float = 0.0     # >0: exit 17 when no frame completes

    def override(self, **kwargs) -> "InferenceParams":
        """Set each knob that is not None (argparse leaves unset flags None)."""
        names = {f.name for f in dataclasses.fields(self)}
        for k, v in kwargs.items():
            if v is None:
                continue
            if k not in names:
                raise AttributeError(f"unknown param: {k}")
            setattr(self, k, v)
        return self


def load_recipe(path: str) -> Dict[str, Any]:
    """Load a knob recipe (``configs/recommended.json`` or the ``"winner"`` of
    a ``scripts/calibrate_recipe.py`` output), as the reference's
    ``load_recipe`` does: lists become tuples, ``fov`` is an alias of
    ``FOV``, and ``instance_split`` without a ``split_method`` means
    ``'prob'``."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("winner"), dict):
        d = d["winner"]
    d = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}
    if "fov" in d and "FOV" not in d:
        d["FOV"] = d.pop("fov")
    if d.get("instance_split") and "split_method" not in d:
        d["split_method"] = "prob"
    return d
