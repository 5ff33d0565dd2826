"""Carry JAX-package variables into the port.

A JAX model's ``init`` returns ``{"params": {name: {leaf: array}},
"batch_stats": {name: {leaf: array}}}``; the port's modules keep the same
names as ``name.leaf`` state_dict keys, parameters and BN running
statistics (``bn1.mean``, ``bn1.var``, ...) alike.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """Nested JAX variables (numpy leaves) -> the port's state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for name, group in (variables_np.get(collection) or {}).items():
            for leaf, arr in group.items():
                out[f"{name}.{leaf}"] = torch.from_numpy(
                    np.array(arr, dtype=np.float32))
    return out
