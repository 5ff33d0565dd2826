"""Configuration: copies of the JAX package's dataclasses
(pcseg_tpu/core/config.py) with the fields the port reads, under the same
names, defaults and meanings.

Ported: the ``ModelConfig`` fields of the three families, and the parts
of ``DataConfig``, ``OptimConfig`` and ``TrainConfig`` that a one-device
training run reads: the HDF5 event files and the prefetch depth, resume's
'latest' checkpoints, the metrics log, the profiler trace and
``debug_nans`` among them. Not yet: parallel strategies. The fields
default as the
JAX package's do: ``voxelize_impl`` and ``devox_impl`` "auto", which at
64^3 in bf16 resolve to the one-hot matmul voxelize/devoxelize forms;
``impl`` "block", the sparse family's block impl, which the voxel family
reads as "auto" (the fused core in bf16).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass
class DataConfig:
    # HDF5 event files: datasets 'data' (flat float arrays reshaped (N, 4))
    # and 'labels' (int (N,)), data/hdf5.py
    data_path: str = "data/train_xyze_1e4.h5"
    label_path: str = "data/train_label_1e4.h5"
    batch_size: int = 64
    val_fraction: float = 0.2
    split_seed: int = 0
    shuffle_seed: int = 0
    class_scan_events: int = 1000
    # ragged -> static batching: the per-batch max point count is padded
    # up to one of these lengths
    buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192)
    # batches read, packed and copied to the device ahead of the step by a
    # thread (data/prefetch.py); 0 = inline
    prefetch_depth: int = 2


@dataclass
class ModelConfig:
    name: str = "pointnet_seg"    # or "voxel_unet3d", "sparse_voxelnet"
    num_classes: int = 0          # 0 = infer from the data
    input_dim: int = 4            # x, y, z + features
    dropout: float = 0.3
    compute_dtype: str = "float32"
    # PointNet batch statistics: "exact" (two-pass variance), "fast"
    # (single pass), or "fused" (the fused kernel chain, ops/fused_*.py)
    bn_stats: str = "exact"
    # exclude padded positions from BN statistics and the global pool
    mask_norm_and_pool: bool = False
    # voxel family
    grid_size: int = 64
    unet_width: int = 16
    levels: int = 0               # 0 = family default (3)
    # voxel family: recompute the U-Net core in the backward
    # (torch.utils.checkpoint) instead of keeping its activations
    remat: bool = False
    # voxel family: the conv core, "fused" (the CUDA kernels), "xla" (plain
    # torch convs, named after the JAX core it mirrors) or anything else
    # for "auto"; sparse family: "block" (the only impl ported)
    impl: str = "block"
    # "scatter" / "gather" (f32-exact), "matmul" (the one-hot contraction's
    # values, ops/voxel.py) or "auto" (the JAX package's crossover rules)
    voxelize_impl: str = "auto"
    devox_impl: str = "auto"
    # sparse family: conv blocks a level, the gather impl's site capacity,
    # the block impl's occupied-tile capacity per event and tile edge,
    # optional per-level capacities (level 0 first), and whether a nonzero
    # overflow count raises instead of warning
    depth: int = 4
    max_active: int = 8192
    max_tiles: int = 128
    tile: int = 8
    max_tiles_schedule: tuple = ()
    strict_capacity: bool = False

    def __post_init__(self):
        # a checkpoint's JSON brings the schedule back as a list
        self.max_tiles_schedule = tuple(int(v)
                                        for v in self.max_tiles_schedule)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class OptimConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4    # Adam L2 (coupled), not AdamW
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    lr_step_epochs: int = 20      # StepLR step_size
    lr_gamma: float = 0.5         # StepLR gamma


@dataclass
class TrainConfig:
    num_epochs: int = 128
    patience: int = 16
    target_class: int = 2         # best-model selection on this class's F1
    target_class_weight_boost: float = 2.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_name: str = "best_model.pt"
    log_every_steps: int = 20     # 0 = off
    # also write the 'latest' checkpoint (the resume target) every N
    # epochs, after selection; 0 = only the best-model checkpoint
    save_latest_every: int = 1
    # raise FloatingPointError at the first non-finite loss or gradient
    # (one host sync a step)
    debug_nans: bool = False
    profile_dir: str = ""         # non-empty => torch.profiler trace of
                                  # the first epoch run
    metrics_log: str = ""         # non-empty => JSONL per-epoch metrics
    tensorboard_dir: str = ""     # non-empty => TensorBoard scalars


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["data"]["buckets"] = list(d["data"]["buckets"])
        return d


def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (tuple, list)):
        return tuple(int(x) for x in raw.split(",") if x)
    return raw


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.field=value`` overrides in place, e.g.
    ``["optim.lr=3e-4", "data.batch_size=32"]``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like "
                             "section.field=value")
        key, raw = item.split("=", 1)
        key = key.lstrip("-")
        if "." not in key:
            raise ValueError(f"override key {key!r} must look like "
                             "section.field")
        section, name = key.split(".", 1)
        sub = getattr(cfg, section, None)
        if sub is None or not hasattr(sub, name):
            raise KeyError(f"unknown config field {key!r}")
        setattr(sub, name, _coerce(getattr(sub, name), raw))
    return cfg
