"""Carry JAX-package parameters into the port.

``VoxelUNet3d.init`` in the JAX package returns
``{"params": {name: {leaf: array}}, "batch_stats": {}}``; the port's
module keeps the same names as ``name.leaf`` state_dict keys.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """Nested JAX variables (numpy leaves) -> the port's state_dict."""
    if variables_np.get("batch_stats"):
        raise ValueError("batch_stats are not empty: only the voxel U-Net "
                         "(no running statistics) is ported")
    out = {}
    for name, group in variables_np["params"].items():
        for leaf, arr in group.items():
            out[f"{name}.{leaf}"] = torch.from_numpy(
                np.array(arr, dtype=np.float32))
    return out
