"""Parameters of the sparse family's layers (counterpart of the init
functions of pcseg_tpu/ops/sparse.py), shared by every sparse impl.

Only the block impl is ported (ops/block_sparse.py); the rulebook-gather
and masked-dense layers of the JAX module (``subm_conv``, ``sparse_pool``,
``sparse_down2x`` / ``sparse_up2x``, ``subm_conv_dense``) wait for ROADMAP
Queue A item 8.
"""

from __future__ import annotations

import math

import torch


def subm_conv_init(cin: int, cout: int,
                   generator: torch.Generator | None = None,
                   kernel: int = 3) -> dict:
    """He-uniform (k^3, Cin, Cout) taps in (dz, dy, dx)-major order + zero
    bias."""
    k3 = kernel ** 3
    bound = math.sqrt(6.0 / (k3 * cin))
    u = torch.rand((k3, cin, cout), generator=generator)
    return {"kernel": u * (2 * bound) - bound, "bias": torch.zeros(cout)}


def site_layer_norm_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}
