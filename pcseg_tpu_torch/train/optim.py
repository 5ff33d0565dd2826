"""Optimizer: torch Adam with coupled L2 and StepLR (counterpart of
pcseg_tpu/train/optim.py).

The reference trains with ``optim.Adam(lr=0.001, weight_decay=1e-4)`` and
``StepLR(step_size=20, gamma=0.5)`` stepped per epoch. ``torch.optim.Adam``
with ``weight_decay`` is exactly the JAX package's rule (``g += wd * p``
before the moments, decay on every parameter, BN affines included). The
learning rate is set per step by the caller, from ``step_lr``.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.core.config import OptimConfig


def make_optimizer(params, cfg: OptimConfig | None = None
                   ) -> torch.optim.Adam:
    cfg = cfg or OptimConfig()
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def step_lr(base_lr: float, epoch: int, step_epochs: int = 20,
            gamma: float = 0.5) -> float:
    """torch StepLR: lr = base * gamma^(epoch // step_epochs)."""
    return float(base_lr * (gamma ** (epoch // step_epochs)))
