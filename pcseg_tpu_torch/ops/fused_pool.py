"""BN-apply + ReLU + first-max global pool: a CUDA kernel + its plain
version, forward and backward.

Counterpart of pcseg_tpu/ops/pallas/fused_pool.py (``fused_global_pool``).
For (N, C) activations ``y`` whose rows come in B contiguous groups of
``rows_per_batch`` and (C,) f32 batch-norm terms:

    z  = ((y - mu) * inv) * gamma + beta      (f32, each step rounded)
    g[b, c]   = max over the group of relu(z)           (B, C) f32
    idx[b, c] = the FIRST row of the group attaining it (B, C) int32

The accumulator starts at 0, so a channel with no positive z pools to
exactly 0 with idx 0. The JAX package reaches this op only from its tests
(the fused PointNet chain took the one-kernel form of
ops/fused_global.py), and so does the port.

Backward, closed form on (B, C) arrays in plain PyTorch, as in the JAX
package: dz = dg where g > 0; x_hat at the winner = (g - beta) / gamma (0
where |gamma| <= 1e-12); dgamma = sum_b dz x_hat, dbeta = sum_b dz; dmu =
-gamma inv dbeta, dinv = gamma dgamma / inv; dy = dz gamma inv at each
winner row, zeros elsewhere, in y's dtype: the one write-only kernel. The
gradient goes to the first max, as torch.max's does.

On the card the forward kernel keeps per thread the running max and row
of its channels, folds a block's threads in shared memory and combines
blocks with a 64-bit ``atomicMax`` key (the float above the inverted
row); the TPU kernel's row-tile gate (``_pick_pool_tile``, a VMEM rule)
is not ported.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)
from pcseg_tpu_torch.ops.fused_block import check, norm_vecs
from pcseg_tpu_torch.ops.fused_global import first_max

LAUNCHES = {"fused_pool": 0, "fused_pool_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _groups(y: torch.Tensor, rows_per_batch: int) -> int:
    n = y.shape[0]
    if y.dim() != 2 or rows_per_batch <= 0 or n % rows_per_batch:
        raise ValueError(f"y must be (N, C) with N a multiple of "
                         f"rows_per_batch={rows_per_batch}, got "
                         f"{tuple(y.shape)}")
    return n // rows_per_batch


def fused_pool_fwd_plain(y, mu, inv, gamma, beta, rows_per_batch):
    """-> (g (B, C) f32, idx (B, C) int32). A group with no positive z
    has relu(z) = 0 on every row, so its first max is row 0."""
    nb = _groups(y, rows_per_batch)
    z = ((y.float() - mu) * inv) * gamma + beta
    return first_max(torch.relu(z).reshape(nb, rows_per_batch, -1))


def fused_pool_fwd_cuda(y, mu, inv, gamma, beta, rows_per_batch):
    nb = _groups(y, rows_per_batch)
    n, c = y.shape
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"y must be bf16 or f32, got {y.dtype}")
    y = y.contiguous()
    vecs = norm_vecs(mu, inv, gamma, beta, c)
    dev = y.device
    keys = torch.empty((nb, c), dtype=torch.int64, device=dev)
    g = torch.empty((nb, c), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, c), dtype=torch.int32, device=dev)
    rc = load_library("pointnet_fused").pcseg_fused_pool_fwd(
        y.data_ptr(), int(y.dtype == torch.float32),
        *(v.data_ptr() for v in vecs), keys.data_ptr(), g.data_ptr(),
        idx.data_ptr(), n, c, rows_per_batch, stream_of(y))
    raise_on(rc, "fused_pool")
    LAUNCHES["fused_pool"] += 1
    return g, idx


def fused_pool_bwd_plain(idx, val, n, dtype):
    """The write-only pass: dy (N, C) in ``dtype``, ``val[b, c]`` at row
    ``idx[b, c]`` of group b, zeros elsewhere."""
    nb, c = idx.shape
    rows = torch.arange(n // nb, device=idx.device)[None, :, None]
    dy = torch.where(rows == idx[:, None, :].long(), val[:, None, :],
                     torch.zeros((), device=val.device))
    return dy.reshape(n, c).to(dtype)


def fused_pool_bwd_cuda(idx, val, n, dtype):
    nb, c = idx.shape
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dy must be bf16 or f32, got {dtype}")
    if n % nb:
        raise ValueError(f"N={n} is not a multiple of B={nb}")
    val = val.float().contiguous()
    check("idx", idx, (nb, c), torch.int32)
    check("val", val, (nb, c), torch.float32)
    dy = torch.empty((n, c), dtype=dtype, device=val.device)
    rc = load_library("pointnet_fused").pcseg_fused_pool_bwd(
        idx.data_ptr(), val.data_ptr(), dy.data_ptr(),
        int(dtype == torch.float32), n, c, n // nb, stream_of(val))
    raise_on(rc, "fused_pool_bwd")
    LAUNCHES["fused_pool_bwd"] += 1
    return dy


def pool_cotangents(dg, g, mu, inv, gamma, beta):
    """The (B, C) glue of the backward: (val (B, C) for the dy pass, dmu,
    dinv, dgamma, dbeta)."""
    dz = torch.where(g > 0.0, dg, torch.zeros((), device=dg.device))
    ok = gamma.abs() > 1e-12
    safe = torch.where(ok, gamma, torch.ones((), device=gamma.device))
    x_hat_w = torch.where(ok, (g - beta) / safe,
                          torch.zeros((), device=g.device))
    dgamma = (dz * x_hat_w).sum(0)
    dbeta = dz.sum(0)
    dmu = -gamma * inv * dbeta
    dinv = gamma * dgamma / inv
    return dz * (gamma * inv), dmu, dinv, dgamma, dbeta


class _FusedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mu, inv, gamma, beta, rows_per_batch, plain):
        kern = on_cuda(y, plain)
        fwd = fused_pool_fwd_cuda if kern else fused_pool_fwd_plain
        g, idx = fwd(y, mu, inv, gamma, beta, rows_per_batch)
        ctx.save_for_backward(idx, g, mu, inv, gamma, beta)
        ctx.cfg = (y.shape[0], y.dtype, kern)
        return g

    @staticmethod
    def backward(ctx, dg):
        idx, g, mu, inv, gamma, beta = ctx.saved_tensors
        n, dtype, kern = ctx.cfg
        val, dmu, dinv, dgamma, dbeta = pool_cotangents(
            dg.float(), g, mu, inv, gamma, beta)
        bwd = fused_pool_bwd_cuda if kern else fused_pool_bwd_plain
        dy = bwd(idx, val, n, dtype)
        return dy, dmu, dinv, dgamma, dbeta, None, None


def fused_global_pool(y, mu, inv, gamma, beta, rows_per_batch, *,
                      plain=False):
    """(N, C) raw pre-norm activations -> (B, C) f32 pooled features
    (JAX ``pcseg_tpu.ops.pallas.fused_pool.fused_global_pool``).

    ``y`` bf16 or f32, rows grouped per batch element (N = B *
    rows_per_batch, contiguous); mu / inv / gamma / beta (C,) f32. Returns
    the max over each group of relu(((y - mu) * inv) * gamma + beta).
    Launches the CUDA kernels on a CUDA tensor unless ``plain``.
    """
    return _FusedPool.apply(y, mu, inv, gamma, beta, int(rows_per_batch),
                            bool(plain))
