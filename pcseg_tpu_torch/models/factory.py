"""Model factory: config -> model instance (counterpart of
pcseg_tpu/models/factory.py), for the three families. The sparse family
takes its width from ``unet_width``, one level by default and its impl
("block", "gather" or "dense") and capacities from the config, as in the
JAX package."""

from __future__ import annotations

import torch

from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

FAMILIES = ("pointnet_seg", "voxel_unet3d", "sparse_voxelnet")


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
            remat=cfg.remat,
            compute_dtype=cfg.compute_dtype,
            conv_impl=cfg.impl if cfg.impl in ("fused", "xla") else "auto",
            voxelize_impl=cfg.voxelize_impl,
            devox_impl=cfg.devox_impl,
            generator=generator,
        )
    if cfg.name == "sparse_voxelnet":
        return SparseVoxelNet(
            num_classes=num_classes,
            input_dim=cfg.input_dim,
            grid_size=cfg.grid_size,
            width=cfg.unet_width,
            depth=cfg.depth,
            max_active=cfg.max_active,
            impl=cfg.impl,
            max_tiles=cfg.max_tiles,
            tile=cfg.tile,
            max_tiles_schedule=tuple(cfg.max_tiles_schedule),
            levels=cfg.levels or 1,
            compute_dtype=cfg.compute_dtype,
            voxelize_impl=cfg.voxelize_impl,
            generator=generator,
        )
    raise ValueError(f"unknown model family {cfg.name!r}; options: {FAMILIES}")
