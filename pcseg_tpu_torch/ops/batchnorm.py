"""BatchNorm over the point axis, matching ``torch.nn.BatchNorm1d``
(counterpart of pcseg_tpu/ops/batchnorm.py).

- training: normalize with the biased batch variance over the (B, M)
  positions; running stats move as ``(1 - m) * running + m * stat`` with
  the UNBIASED variance, momentum 0.1, eps 1e-5 (torch's rule);
- eval: normalize with the running stats;
- ``mask=None`` takes every position, padding included (the reference's
  behaviour); a (B, M) mask restricts the statistics to its positions.

Two variance algorithms: two-pass centred ("exact", torch's numbers) and
single-pass E[x^2] - mu^2 ("fast", clamped at 0). Synced BN (``group``,
a ``parallel.mesh.Mesh``) pools the batch moments over the data axis in
two passes whatever ``fast_stats`` says, as the JAX package's
``axis_name`` does: one sum of (sum, count), then one of the centred
squares, each a differentiable all-reduce (the backward all-reduces the
cotangent). ``nn.SyncBatchNorm``'s Welford merge is other arithmetic, so
it is not used. The affine
``scale``/``bias`` are parameters; ``mean``/``var`` are state that the
caller writes back (the functions return the new state, they never
mutate it).
"""

from __future__ import annotations

import torch

EPS = 1e-5
MOMENTUM = 0.1


def bn_param_init(num_features: int) -> dict:
    """Trainable affine params (torch: weight=1, bias=0)."""
    return {"scale": torch.ones(num_features),
            "bias": torch.zeros(num_features)}


def bn_state_init(num_features: int) -> dict:
    """Running statistics (torch: running_mean=0, running_var=1)."""
    return {"mean": torch.zeros(num_features),
            "var": torch.ones(num_features)}


def masked_moments(x: torch.Tensor, mask: torch.Tensor | None,
                   fast: bool = False):
    """Biased (mean, var, n) per channel over (B, M); x (B, M, C) f32."""
    if mask is None:
        mean = x.mean(dim=(0, 1))
        if fast:
            var = x.square().mean(dim=(0, 1)) - mean.square()
        else:
            var = (x - mean).square().mean(dim=(0, 1))
        return mean, var, float(x.shape[0] * x.shape[1])
    m = mask.to(x.dtype)[..., None]
    n = m.sum().clamp_min(1.0)
    mean = (x * m).sum(dim=(0, 1)) / n
    if fast:
        var = (x.square() * m).sum(dim=(0, 1)) / n - mean.square()
    else:
        var = ((x - mean).square() * m).sum(dim=(0, 1)) / n
    return mean, var, n


def running_update(state: dict, mean: torch.Tensor, var: torch.Tensor, n):
    """New running stats from a batch's biased moments (detached)."""
    with torch.no_grad():
        denom = (max(n - 1.0, 1.0) if isinstance(n, float)
                 else (n - 1.0).clamp_min(1.0))
        unbiased = var * (n / denom)
        return {
            "mean": (1.0 - MOMENTUM) * state["mean"] + MOMENTUM * mean,
            "var": (1.0 - MOMENTUM) * state["var"] + MOMENTUM * unbiased,
        }


def synced_moments(x: torch.Tensor, mask: torch.Tensor | None, group):
    """Biased (mean, var, n) per channel over every rank's (B, M) rows;
    x (B, M, C) f32. Two passes, as pcseg_tpu/ops/batchnorm.py's synced
    branch: the global mean from the all-reduced (sum, count), then the
    all-reduced centred squares."""
    m = (mask.to(x.dtype)[..., None] if mask is not None
         else torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device))
    c = x.shape[-1]
    sums = group.psum(torch.cat([(x * m).sum(dim=(0, 1)),
                                 m.sum().reshape(1)]))
    n = sums[c].detach().clamp_min(1.0)
    mean = sums[:c] / n
    var = group.psum(((x - mean).square() * m).sum(dim=(0, 1))) / n
    return mean, var, n


def batchnorm_train(bn_params: dict, bn_state: dict, x: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    fast_stats: bool = False, group=None):
    """Training-mode BN. Returns (y in x's dtype, new_bn_state).
    ``group``: None for this rank's statistics (per-replica BN, the
    reference's DataParallel), or the mesh whose data axis pools them
    (sync-BN)."""
    xf = x.float()
    if group is not None:
        mean, var, n = synced_moments(xf, mask, group)
    else:
        mean, var, n = masked_moments(xf, mask, fast=fast_stats)
        if fast_stats:
            var = var.clamp_min(0.0)    # E[x^2] - mu^2 can dip below 0
    inv = torch.rsqrt(var + EPS)
    y = (xf - mean) * inv * bn_params["scale"] + bn_params["bias"]
    return y.to(x.dtype), running_update(bn_state, mean, var, n)


def batchnorm_eval(bn_params: dict, bn_state: dict, x: torch.Tensor):
    """Eval-mode BN with the running stats (torch ``.eval()``)."""
    xf = x.float()
    inv = torch.rsqrt(bn_state["var"] + EPS)
    y = (xf - bn_state["mean"]) * inv * bn_params["scale"] + bn_params["bias"]
    return y.to(x.dtype)
