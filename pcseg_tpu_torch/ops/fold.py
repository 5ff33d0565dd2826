"""Eval-mode BN folding (counterpart of pcseg_tpu/ops/fold.py).

In eval mode BatchNorm is a per-channel affine map with constants (the
running statistics), so

    BN(x @ W + b) = x @ (W * s) + ((b - mean) * s + beta),
    s = gamma / sqrt(var + eps)

and the folded network is a matmul + ReLU chain with no normalize pass.
This is the serving path; training keeps live statistics.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.models.pointnet import BN_FOR
from pcseg_tpu_torch.ops.batchnorm import EPS


def fold_dense_bn(dense: dict, bn_params: dict, bn_state: dict) -> dict:
    """Fold one [dense -> eval-BN] pair into an equivalent dense layer."""
    s = bn_params["scale"] * torch.rsqrt(bn_state["var"] + EPS)
    return {
        "kernel": dense["kernel"] * s[None, :],
        "bias": (dense["bias"] - bn_state["mean"]) * s + bn_params["bias"],
    }


def fold_pointnet(variables: dict) -> dict:
    """Fold every BN of a PointNetSeg ``{"params", "batch_stats"}`` into
    its layer. Returns the folded layers under the same names (the logits
    layer ``seg_conv4`` has no BN and passes through unchanged)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    folded = {name: fold_dense_bn(params[name], params[bn_name],
                                  stats[bn_name])
              for name, bn_name in BN_FOR.items()}
    folded["seg_conv4"] = dict(params["seg_conv4"])
    return folded
