"""Architecture, training and inference configuration.

Counterpart of ``lstm_unet_tpu/config/params.py``: the same knob names and
defaults (``tests/test_torch_convert.py`` and ``tests/test_torch_train.py``
hold them equal), carried here so that the port runs where only PyTorch is
installed. :class:`CTCParams` carries every training knob of the reference,
ported or not; the trainer and ``cli/train2d.py`` reject the unported ones by
name. Only the knobs of streaming inference live in :class:`InferenceParams`; its
CLI rejects the TPU-only ones (``cli/inference2d.py``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

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
class ParamsBase:
    """Experiment naming and dirs, as the reference's ``ParamsBase``:
    ``<root_save_dir>/<experiment_name>_<timestamp>/{logs,ckpt}``."""

    experiment_name: str = "MyRun"
    root_save_dir: str = "./runs"
    dry_run: bool = False          # no file is written
    experiment_log_dir: Optional[str] = None   # set by resolve_dirs
    experiment_save_dir: Optional[str] = None

    def resolve_dirs(self, timestamp: Optional[str] = None) -> None:
        ts = timestamp or time.strftime("%Y-%m-%d_%H%M%S")
        base = os.path.join(self.root_save_dir, f"{self.experiment_name}_{ts}")
        self.experiment_log_dir = os.path.join(base, "logs")
        self.experiment_save_dir = os.path.join(base, "ckpt")
        if not self.dry_run:
            os.makedirs(self.experiment_log_dir, exist_ok=True)
            os.makedirs(self.experiment_save_dir, exist_ok=True)

    def resolve_continue_dirs(self) -> bool:
        """Point the log and save dirs at the latest existing run of this
        ``experiment_name`` (one with a ``ckpt`` dir; the timestamps sort in
        time order); False when there is none (then :meth:`resolve_dirs`)."""
        pattern = os.path.join(self.root_save_dir, f"{self.experiment_name}_*")
        runs = sorted(d for d in glob.glob(pattern) if os.path.isdir(os.path.join(d, "ckpt")))
        if not runs:
            return False
        self.experiment_log_dir = os.path.join(runs[-1], "logs")
        self.experiment_save_dir = os.path.join(runs[-1], "ckpt")
        return True

    def to_json(self) -> str:
        def enc(o):
            if isinstance(o, NetKernelParams):
                return o.to_dict()
            raise TypeError(type(o))

        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    @classmethod
    def load_json(cls, path: str):
        """Read a params file :meth:`save_json` wrote (``train_params.json``)."""
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        """The knobs of ``d`` this class has (others are dropped), with
        ``net_kernel_params`` rebuilt; other values as JSON gives them."""
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: (NetKernelParams.from_dict(v)
                      if k == "net_kernel_params" and isinstance(v, dict) else v)
                  for k, v in d.items() if k in names}
        return cls(**kwargs)

    def override(self, **kwargs):
        """Set each knob that is not None (argparse leaves unset flags None)."""
        for k, v in kwargs.items():
            if v is None:
                continue
            if not hasattr(self, k):
                raise AttributeError(f"unknown param: {k}")
            setattr(self, k, v)
        return self


@dataclass
class CTCParams(ParamsBase):
    """Training knobs (reference: ``CTCParams``). The trainer raises
    ``NotImplementedError`` for those of unported features when they are set
    away from their defaults (``engine/train.py::check_ported``)."""

    # data
    root_data_dir: str = "./data/CTC"
    train_sequence_list: List[Tuple[str, str]] = field(
        default_factory=lambda: [("Fluo-N2DH-SIM+", "01"), ("Fluo-N2DH-SIM+", "02")])
    val_sequence_list: List[Tuple[str, str]] = field(default_factory=list)
    data_provider_class: str = "CTCRAMReaderSequence2D"
    crop_size: Tuple[int, int] = (256, 256)
    batch_size: int = 5
    unroll_len: int = 7
    data_format: str = "NHWC"
    num_prefetch_threads: int = 1
    elastic_augmentation: bool = False
    randomize: bool = True
    gt_is_full_seg: Optional[bool] = None  # None: _ST and "SIM" datasets full

    # model
    net_kernel_params: NetKernelParams = field(default_factory=default_net_kernel_params)
    num_classes: int = 3
    activation: str = "leaky_relu"
    recurrent_activation: str = "sigmoid"
    norm: str = "none"
    dtype: str = "float32"
    state_dtype: str = "auto"

    # optimization: optax.apply_if_finite(chain(clip_by_global_norm, adam))
    learning_rate: float = 1e-5
    grad_clip_norm: float = 5.0          # 0 disables
    skip_nonfinite_updates: bool = True
    adam_mu_dtype: str = "float32"
    num_iterations: int = 100000
    class_weights: Tuple[float, float, float] = (0.15, 0.25, 0.6)

    # bookkeeping
    validation_interval: int = 1000
    val_seg_min_cell_size: int = 10
    print_to_console_interval: int = 100
    save_checkpoint_iteration: int = 5000
    write_to_tb_interval: int = 500
    save_checkpoint_max_to_keep: int = 5
    async_checkpoint: bool = True
    load_checkpoint: bool = False
    load_checkpoint_path: str = ""
    continue_run: bool = False
    profile: bool = False
    watchdog_secs: float = 0.0

    # loss-spike rollback guard (0 disables)
    spike_factor: float = 0.0
    spike_ema_decay: float = 0.98
    spike_warmup: int = 50
    spike_cooldown: int = 100
    spike_max_rollbacks: int = 5

    # workarounds of the reference's tunnelled TPU client (not ported)
    rss_relaunch_gb: float = 90.0
    compact_upload: bool = True

    # parallelism and backward-pass memory
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 1})
    remat: bool = True
    remat_policy: str = "full"
    conv_method: str = "conv"
    entry_layouts: bool = False


@dataclass
class InferenceParams:
    """Knobs of streaming inference (reference: ``CTCInferenceParams``)."""

    model_path: str = ""           # model dir, or a port training run's dir
    ckpt_step: int = 0             # saved step of a training run (0 = latest)
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
    instance_split: bool = False   # split merged components of touching cells
    split_method: str = "dist"     # 'dist' (distance ridge) | 'prob' (p(cell) dips)
    split_window: int = 16         # dist: regional-max window radius (px)
    split_min_dist: int = 4        # dist: least distance to background of a marker
    split_slack: int = 1           # dist: tolerance below the window max (px)
    split_rel: float = 0.65        # dist: marker reaches rel * the wider window's max
    split_rel_window: int = 48     # dist: the wider window's radius (px)
    split_min_size: int = 0        # only components of at least this size are split
    split_hi_thresh: float = 0.8   # prob: marker threshold on p(cell)
    split_erode: int = 1           # prob: erosion rounds of the markers
    pre_sequence_frames: int = 4   # warm-up: first frames fed reversed
    save_intermediate: bool = False
    save_intermediate_path: str = ""
    dtype: str = "bfloat16"        # 'float32' | 'bfloat16' | 'int8'
    int8_keep_float: str = ""      # int8: comma-separated site prefixes kept float
    state_dtype: str = "auto"      # LSTM carry dtype; 'auto' follows dtype
    fused_cell: bool = False       # whole-level fused ConvLSTM kernel (K4)
    digit_4: bool = False          # mask%04d.tif instead of mask%03d.tif
    watchdog_secs: float = 0.0     # >0: exit 17 when no frame completes
    tta: bool = False              # test-time augmentation: variants as extra lanes
    tta_mode: str = "flip"         # 'flip' (4 variants) | 'd4' (8, pads square); needs tta
    reset_on_jump: float = 0.0     # >0: zero a lane's state when the clipped mean
                                   # |frame delta| exceeds this (a scene cut)
    mesh_shape: Dict[str, int] = field(default_factory=dict)  # {'data': N, 'spatial': M}

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


def load_recipe(path: str, known: Optional[set] = None) -> Dict[str, Any]:
    """Load a knob recipe (``configs/recommended.json`` or the ``"winner"`` of
    a ``scripts/calibrate_recipe.py`` output), as the reference's
    ``load_recipe`` does: lists become tuples, ``fov`` is an alias of
    ``FOV``, ``instance_split`` without a ``split_method`` means ``'prob'``,
    and with ``known`` only those keys are kept."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("winner"), dict):
        d = d["winner"]
    d = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}
    if "fov" in d and "FOV" not in d:
        d["FOV"] = d.pop("fov")
    if d.get("instance_split") and "split_method" not in d:
        d["split_method"] = "prob"
    if known is not None:
        d = {k: v for k, v in d.items() if k in known}
    return d
