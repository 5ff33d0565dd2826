"""Model configuration of the voxel family.

A copy of the ``ModelConfig`` fields that ``voxel_unet3d`` reads in the
JAX package (pcseg_tpu/core/config.py), with the same names and meanings.
Training knobs (``remat``) and the other families' fields are not ported
yet. The defaults of ``impl`` and the voxelize/devoxelize forms are the
ported ones: the JAX "auto" resolves to its one-hot matmul forms at 64^3,
whose kernels are still to be ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class ModelConfig:
    name: str = "voxel_unet3d"
    num_classes: int = 0
    input_dim: int = 4            # x, y, z + features
    compute_dtype: str = "float32"
    grid_size: int = 64
    unet_width: int = 16
    levels: int = 0               # 0 = family default (3)
    # conv implementation: "fused" (the CUDA kernels), "xla" (plain
    # torch convs, named after the JAX core it mirrors) or anything else
    # for "auto"
    impl: str = "auto"
    voxelize_impl: str = "scatter"
    devox_impl: str = "gather"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
