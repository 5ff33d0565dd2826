"""Model factory: config -> model instance (counterpart of
pcseg_tpu/models/factory.py). PointNetSeg and the voxel U-Net are
ported; the sparse family is not yet."""

from __future__ import annotations

import torch

from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

FAMILIES = ("pointnet_seg", "voxel_unet3d", "sparse_voxelnet")
_NOT_PORTED = {
    "sparse_voxelnet": "ROADMAP Queue A item 8 and Queue B item 3",
}


def build_model(cfg: ModelConfig, num_classes: int,
                generator: torch.Generator | None = None):
    if cfg.name == "pointnet_seg":
        return PointNetSeg(
            num_classes=num_classes,
            input_dim=cfg.input_dim,
            dropout=cfg.dropout,
            mask_norm_and_pool=cfg.mask_norm_and_pool,
            compute_dtype=cfg.compute_dtype,
            bn_stats=cfg.bn_stats,
            generator=generator,
        )
    if cfg.name == "voxel_unet3d":
        return VoxelUNet3d(
            num_classes=num_classes,
            input_dim=cfg.input_dim,
            grid_size=cfg.grid_size,
            width=cfg.unet_width,
            levels=cfg.levels or 3,
            compute_dtype=cfg.compute_dtype,
            conv_impl=cfg.impl if cfg.impl in ("fused", "xla") else "auto",
            voxelize_impl=cfg.voxelize_impl,
            devox_impl=cfg.devox_impl,
            generator=generator,
        )
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.name!r} is not ported to pcseg_tpu_torch "
            f"yet: {_NOT_PORTED[cfg.name]}"
        )
    raise ValueError(f"unknown model family {cfg.name!r}; options: {FAMILIES}")
