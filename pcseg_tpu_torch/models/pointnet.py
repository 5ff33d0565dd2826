"""PointNetSeg — the reference's segmentation network (counterpart of
pcseg_tpu/models/pointnet.py).

Shared per-point MLPs 4->64->64->64->128->1024, a 1024->1024 global
stage, a global max pool over the points, broadcast + concat with the
64-channel skip (1088 channels), then a head 1088->512->256->128->C with
dropout 0.3 after its first two stages; BN + ReLU after every layer but
the logits. Activations are channels-last (B, M, C).

Parameters carry the JAX names: a module per layer (``conv1`` ...
``seg_conv4``) holding ``kernel`` (Cin, Cout) and ``bias``, a module per
BN (``bn1`` ... ``bn_seg3``) holding the parameters ``scale``/``bias``
and the buffers ``mean``/``var``, so ``ckpt.convert.from_jax_variables``
maps ``params`` and ``batch_stats`` one to one.

Like the JAX model, ``apply`` is functional over the batch statistics:
in training it returns the new running stats, which the train step
writes back (``load_batch_stats``).

Dispatch: ``bn_stats="fused"`` trains through the fused chain of
models/pointnet_fused.py (the four CUDA kernels of ops/fused_*.py and
ops/dropout.py). The JAX package picks its fused chain only on a TPU;
the port picks it from ``bn_stats`` alone, on the CPU too, where every
wrapper runs its plain version, so the CPU tests drive the same chain.
Point counts M with M % 8 != 0 take the plain path with single-pass
statistics, as in the JAX package. ``"exact"`` (two-pass variance) and
``"fast"`` (single pass) run plain torch layers and the dropout kernel.
Synced BN (``group``, a ``parallel.mesh.Mesh``) needs statistics across
ranks, which the fused chain's kernels do not take: with it
``bn_stats="fused"`` trains on the plain path, with a warning, as the
JAX package routes it (its ``axis_name``).
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from pcseg_tpu_torch.ops.batchnorm import bn_param_init, bn_state_init
from pcseg_tpu_torch.ops.dropout import dropout as drop
from pcseg_tpu_torch.ops.pointwise import (
    dense_init,
    pointwise_block,
    pointwise_dense,
)
from pcseg_tpu_torch.ops.pooling import global_max_pool

# (name, in_dim, out_dim) of every parameterized stage, in forward order
ENCODER = [
    ("conv1", 4, 64),
    ("conv2", 64, 64),
    ("conv3", 64, 64),
    ("conv4", 64, 128),
    ("conv5", 128, 1024),
]
GLOBAL = ("global_feat", 1024, 1024)
HEAD = [
    ("seg_conv1", 1088, 512),   # 1088 = 64 skip + 1024 global
    ("seg_conv2", 512, 256),
    ("seg_conv3", 256, 128),
]
BN_FOR = {
    "conv1": "bn1",
    "conv2": "bn2",
    "conv3": "bn3",
    "conv4": "bn4",
    "conv5": "bn5",
    "global_feat": "bn_global",
    "seg_conv1": "bn_seg1",
    "seg_conv2": "bn_seg2",
    "seg_conv3": "bn_seg3",
}
DROPOUT_RATE = 0.3
BN_STATS = ("exact", "fast", "fused")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Group(nn.Module):
    """One JAX parameter group: trainable tensors, plus state buffers."""

    def __init__(self, params: dict, state: dict | None = None):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v))
        for k, v in (state or {}).items():
            self.register_buffer(k, v)


def _stages(num_classes: int, input_dim: int):
    stages = list(ENCODER) + [GLOBAL] + list(HEAD) + [
        ("seg_conv4", 128, num_classes)]
    stages[0] = ("conv1", input_dim, 64)
    return stages


class PointNetSeg(nn.Module):
    def __init__(self, num_classes: int, input_dim: int = 4,
                 dropout: float = DROPOUT_RATE,
                 mask_norm_and_pool: bool = False,
                 compute_dtype: str = "float32", bn_stats: str = "exact",
                 generator: torch.Generator | None = None):
        super().__init__()
        if num_classes < 1:
            raise ValueError("num_classes must be >= 1")
        if bn_stats not in BN_STATS:
            raise ValueError(f"bn_stats must be one of {BN_STATS}, got "
                             f"{bn_stats!r}")
        if compute_dtype not in DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if bn_stats == "fused" and mask_norm_and_pool:
            raise ValueError(
                "bn_stats='fused' computes statistics over all padded "
                "positions and cannot honor mask_norm_and_pool=True; use "
                "bn_stats='exact'/'fast' for masked statistics")
        self.num_classes = num_classes
        self.input_dim = input_dim
        self.dropout = dropout
        self.mask_norm_and_pool = mask_norm_and_pool
        self.compute_dtype = compute_dtype
        self.bn_stats = bn_stats
        for name, din, dout in _stages(num_classes, input_dim):
            self.add_module(name, _Group(dense_init(generator, din, dout)))
            bn_name = BN_FOR.get(name)
            if bn_name is not None:
                self.add_module(bn_name, _Group(bn_param_init(dout),
                                                bn_state_init(dout)))

    # -- the JAX variables, as dicts of this module's tensors
    def params(self) -> dict:
        return {name: dict(m.named_parameters(recurse=False))
                for name, m in self.named_children()}

    def batch_stats(self) -> dict:
        return {name: dict(m.named_buffers(recurse=False))
                for name, m in self.named_children()
                if name in BN_FOR.values()}

    @torch.no_grad()
    def load_batch_stats(self, new_bn: dict) -> None:
        for name, st in new_bn.items():
            m = getattr(self, name)
            for k, v in st.items():
                getattr(m, k).copy_(v)

    # -- forward passes
    def supports_fused_loss(self) -> bool:
        """True when training runs the fused chain INCLUDING the
        classifier + CE kernel (ops/fused_ce.py)."""
        return self.bn_stats == "fused" and not self.mask_norm_and_pool

    def fused_train_loss(self, points, labels, class_weights, *, seeds,
                         plain: bool = False):
        """((num, den, correct), new_batch_stats): see
        models/pointnet_fused.pointnet_fused_train_loss. Labels must be -1
        exactly at padded positions (data/batching.py)."""
        from pcseg_tpu_torch.models.pointnet_fused import (
            pointnet_fused_train_loss,
        )

        return pointnet_fused_train_loss(
            self.params(), self.batch_stats(), points, labels,
            class_weights, seeds=seeds, dropout_rate=self.dropout,
            plain=plain)

    def apply(self, points, *, train: bool = False, mask=None, seeds=None,
              plain: bool = False, group=None):
        """Logits (B, M, C) f32; ``(logits, new_batch_stats)`` when
        ``train=True``. ``seeds``: two 32-bit ints for the two dropout
        masks (needed when training with dropout). ``group``: the mesh
        whose data axis pools the training statistics (sync-BN)."""
        if self.bn_stats == "fused" and train and group is not None:
            warnings.warn(
                "sync-BN needs cross-device statistics; bn_stats='fused' "
                "falls back to the plain path (single-pass stats) for this "
                "configuration", stacklevel=2)
        elif (self.bn_stats == "fused" and train
                and points.shape[1] % 8 == 0):
            from pcseg_tpu_torch.models.pointnet_fused import (
                pointnet_apply_fused,
            )

            return pointnet_apply_fused(
                self.params(), self.batch_stats(), points, seeds=seeds,
                dropout_rate=self.dropout, plain=plain)
        return pointnet_apply(
            self.params(), self.batch_stats(), points, train=train,
            mask=mask, seeds=seeds, dropout_rate=self.dropout,
            mask_norm_and_pool=self.mask_norm_and_pool,
            compute_dtype=DTYPES[self.compute_dtype],
            fast_bn_stats=self.bn_stats in ("fast", "fused"), plain=plain,
            group=group)

    def forward(self, points, mask=None):
        """Eval-mode logits."""
        return self.apply(points, train=False, mask=mask)


def pointnet_apply(params: dict, batch_stats: dict, points: torch.Tensor, *,
                   train: bool = False, mask=None, seeds=None,
                   dropout_rate: float = DROPOUT_RATE,
                   mask_norm_and_pool: bool = False,
                   compute_dtype: torch.dtype = torch.float32,
                   fast_bn_stats: bool = False, plain: bool = False,
                   group=None):
    """Forward pass on plain torch layers. points (B, M, input_dim).

    Statistics include padded POINTS of real events (the reference's
    behaviour) but never all-masked dummy ROWS (batch padding of a short
    final batch); ``mask_norm_and_pool`` excludes every padded position
    from the statistics and the pool. ``group``: the mesh of synced BN,
    whose two-pass moments take the place of ``fast_bn_stats``.
    """
    new_bn = {}
    if mask_norm_and_pool:
        stat_mask, pool_mask = mask, mask
    elif mask is not None:
        rows = mask.any(dim=1)
        stat_mask, pool_mask = rows[:, None].expand(mask.shape), None
    else:
        stat_mask, pool_mask = None, None

    def block(name, x, relu=True):
        bn_name = BN_FOR[name]
        y, nb = pointwise_block(
            params[name], params[bn_name], batch_stats[bn_name], x,
            train=train, relu=relu, mask=stat_mask,
            compute_dtype=compute_dtype, fast_stats=fast_bn_stats,
            group=group)
        if train:
            new_bn[bn_name] = nb
        return y

    x = points.to(compute_dtype)
    x = block("conv1", x)
    point_feat = block("conv2", x)          # the 64-channel skip
    x = block("conv3", point_feat)
    x = block("conv4", x)
    x = block("conv5", x)
    g = global_max_pool(block("global_feat", x), mask=pool_mask)
    g = g[:, None, :].expand(x.shape[0], x.shape[1], g.shape[-1])
    x = torch.cat([point_feat, g], dim=-1)  # (B, M, 1088)

    use_dropout = train and dropout_rate > 0.0
    if use_dropout and seeds is None:
        raise ValueError("train=True with dropout needs seeds")

    x = block("seg_conv1", x)
    if use_dropout:
        x = drop(x, seeds[0], dropout_rate, plain=plain)
    x = block("seg_conv2", x)
    if use_dropout:
        x = drop(x, seeds[1], dropout_rate, plain=plain)
    x = block("seg_conv3", x)
    logits = pointwise_dense(params["seg_conv4"], x, compute_dtype).float()
    if train:
        return logits, new_bn
    return logits


def pointnet_apply_folded(folded: dict, points: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          pool_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Serving forward on BN-folded layers (ops/fold.py): a matmul + ReLU
    chain, logits (B, M, C) f32. Equal to ``pointnet_apply(train=False)``
    up to float reassociation.

    ``pool_mask`` (B, M) bool restricts the global max pool to valid rows,
    so bucket padding cannot win it: padded rows are zero-filled before
    the max, which is exact for post-ReLU (>= 0) features as long as each
    event has a valid point."""

    def layer(name, x, relu=True):
        y = pointwise_dense(folded[name], x, compute_dtype)
        return torch.relu(y).to(compute_dtype) if relu else y

    x = points.to(compute_dtype)
    x = layer("conv1", x)
    point_feat = layer("conv2", x)
    x = layer("conv3", point_feat)
    x = layer("conv4", x)
    x = layer("conv5", x)
    g = layer("global_feat", x)
    if pool_mask is not None:
        g = torch.where(pool_mask[..., None], g, torch.zeros((), dtype=g.dtype,
                                                             device=g.device))
    g = g.amax(dim=1)
    g = g[:, None, :].expand(x.shape[0], x.shape[1], g.shape[-1])
    x = torch.cat([point_feat, g.to(compute_dtype)], dim=-1)
    x = layer("seg_conv1", x)
    x = layer("seg_conv2", x)
    x = layer("seg_conv3", x)
    return layer("seg_conv4", x, relu=False).float()
