"""Train and eval steps (counterpart of pcseg_tpu/train/steps.py), on one
device or data-parallel over a ``parallel.mesh.Mesh``, one process per
device.

- ``train_step``: forward + loss + backward + Adam + running stats. With
  ``bn_stats="fused"`` (and a point count divisible by 8) the loss is the
  fused chain's classifier + CE op; otherwise the logits go through
  ``cross_entropy_sums``. The loss is the weighted CE, num / den. The
  voxel U-Net and SparseVoxelNet always take the ``apply`` path; they have
  no running statistics (GroupNorm, LayerNorm), so their
  ``load_batch_stats`` loads nothing. The sparse family's capacity
  overflow rides the aux dict under ``__overflow__``: it is popped before
  the running stats load and summed over the batch into a ``dropped``
  metric.
- ``eval_step``: loss, accuracy and the confusion matrix in one pass, and
  the sparse family's ``dropped`` count from the same forward.
- ``scan_train_steps``: K train steps over one bucket's stacked batches
  (the JAX ``make_scan_train_steps``), stacked metrics.

With a ``mesh`` each rank runs the step on its rows of the global batch,
as the JAX ``shard_map`` over the ``data`` axis does, with the same rules:
the loss is the global weighted CE, psum(num) / psum(den), not a mean of
the ranks' means (den is all-reduced before the backward, and each rank
back-propagates num_r / den); the gradients are summed over the ranks in
one all-reduce after the backward, before ``debug_nans`` and the
optimizer, which then takes the same step on every rank; each replica
draws its own dropout masks (``replica_seeds``, replica 0 the seeds
given); correct, total, ``dropped`` and the confusion matrix are summed.
Running statistics are per replica by default (the reference's
DataParallel) and the ones kept are replica 0's, broadcast after the
step; ``sync_batchnorm`` pools the batch moments over the mesh instead
(``ops/batchnorm.synced_moments``), which takes PointNetSeg's
``bn_stats="fused"`` off the fused chain onto the plain path. The
collectives are explicit rather than a ``DistributedDataParallel`` wrap,
which averages gradients and expects every parameter to get one.

Metrics stay on the device as tensors; the caller reads them when it
needs them, so a step never waits for the card on its own, unless
``debug_nans`` asks it to check the loss and every gradient.

Dropout seeds come from ``dropout_seeds(seed, epoch, step)``, a stateless
function of the run's seed and the step's place in it (the JAX package
folds (epoch * 1,000,000 + step) into its dropout key), so a resumed
epoch draws the uninterrupted run's masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pcseg_tpu_torch.core.config import OptimConfig
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from pcseg_tpu_torch.ops.metrics import confusion_matrix, masked_accuracy
from pcseg_tpu_torch.train.optim import make_optimizer

_TINY = torch.finfo(torch.float32).tiny


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module,
                       optim_cfg: OptimConfig | None = None) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), optim_cfg))


# the purpose tag of the dropout stream (the JAX package's core/prng.py)
_DROPOUT_PURPOSE = 1


def dropout_seeds(seed: int, epoch: int, step: int) -> tuple[int, int]:
    """Two 31-bit dropout seeds of step ``step`` of epoch ``epoch`` of a
    run seeded ``seed``: a pure function of the three, on the host."""
    words = np.random.SeedSequence(
        [seed, _DROPOUT_PURPOSE, epoch * 1_000_000 + step]).generate_state(2)
    return int(words[0] >> 1), int(words[1] >> 1)


def replica_seeds(seeds: tuple[int, int], replica: int) -> tuple[int, int]:
    """The dropout seeds of data-axis replica ``replica`` for a step drawn
    ``seeds``: ``seeds`` on replica 0 (so a one-rank mesh steps as one
    device does), two seeds of their own elsewhere (the JAX step folds the
    axis index into its key; DataParallel replicas draw independent
    masks)."""
    if replica == 0:
        return seeds
    words = np.random.SeedSequence(
        [*seeds, _DROPOUT_PURPOSE, replica]).generate_state(2)
    return int(words[0] >> 1), int(words[1] >> 1)


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _unflat(flat: torch.Tensor, like: list[torch.Tensor]) -> list:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


def _check_finite(loss: torch.Tensor, model: torch.nn.Module, step: int):
    """FloatingPointError naming the non-finite loss or gradients (one
    host sync)."""
    named = [("loss", loss)] + [(n, p.grad) for n, p in
                                model.named_parameters()
                                if p.grad is not None]
    finite = torch.stack([t.detach().isfinite().all() for _, t in named])
    if not bool(finite.all()):
        bad = [n for (n, _), ok in zip(named, finite.tolist()) if not ok]
        raise FloatingPointError(
            f"non-finite values at optimizer step {step}: {bad[:8]}"
            + (f" and {len(bad) - 8} more" if len(bad) > 8 else ""))


def train_step(state: TrainState, batch, lr: float, seeds: tuple[int, int],
               class_weights: torch.Tensor, *, debug_nans: bool = False,
               mesh=None, sync_batchnorm: bool = False):
    """One step on ``batch = (points (B,M,D), labels (B,M), masks (B,M))``
    tensors on the model's device: this rank's rows with a ``mesh``.
    ``seeds``: the step's two dropout seeds (``dropout_seeds``). Updates
    the model, its running stats and the optimizer in place; returns
    (state, metrics) with metrics {loss, correct, total} as device
    scalars (over the whole global batch with a mesh), and ``dropped``
    (occupied tiles or sites beyond the capacities, summed over the batch)
    for the sparse family. ``debug_nans``: raise FloatingPointError before
    the update when the loss or a gradient is not finite. ``mesh``,
    ``sync_batchnorm``: data parallelism (the module docstring); sync-BN
    needs a mesh."""
    points, labels, masks = batch
    model = state.model
    if sync_batchnorm and mesh is None:
        raise ValueError("sync_batchnorm pools statistics over a mesh; "
                         "pass mesh=")
    if mesh is not None:
        seeds = replica_seeds(seeds, mesh.rank)
    if (not sync_batchnorm and model.supports_fused_loss()
            and points.shape[1] % 8 == 0):
        (num, den, correct), new_bn = model.fused_train_loss(
            points, labels, class_weights, seeds=seeds)
        total = masks.float().sum()
    else:
        sync = ({"group": mesh} if sync_batchnorm
                and isinstance(model, PointNetSeg) else {})
        logits, new_bn = model.apply(points, train=True, mask=masks,
                                     seeds=seeds, **sync)
        num, den = cross_entropy_sums(logits, labels, class_weights)
        correct, total = masked_accuracy(logits, labels, masks)
    if mesh is not None and mesh.distributed:
        den = mesh.all_reduce_(den.detach().clone())
    den = den.clamp_min(_TINY)
    loss = num / den
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    overflow = (new_bn.pop("__overflow__", None)
                if isinstance(new_bn, dict) else None)
    counts = [correct.detach(), total] + (
        [overflow.sum()] if overflow is not None else [])
    if mesh is not None and mesh.distributed:
        # one all-reduce: every gradient, num and the counts
        params = [p for p in model.parameters() if p.grad is not None]
        parts = [p.grad for p in params] + [num.detach()] + counts
        summed = _unflat(mesh.all_reduce_(_flat(parts)), parts)
        for p, g in zip(params, summed):
            p.grad = g
        num_sum, *counts = summed[len(params):]
        loss = num_sum / den
    if debug_nans:
        _check_finite(loss, model, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    if mesh is not None and mesh.distributed and new_bn \
            and not sync_batchnorm:
        # per-replica BN keeps replica 0's running stats
        leaves = [v for st in new_bn.values() for v in st.values()]
        got = iter(_unflat(mesh.broadcast_(_flat(leaves)), leaves))
        new_bn = {name: {k: next(got) for k in st}
                  for name, st in new_bn.items()}
    model.load_batch_stats(new_bn)
    state.step += 1
    metrics = {"loss": loss.detach(), "correct": counts[0],
               "total": counts[1]}
    if overflow is not None:
        metrics["dropped"] = counts[2]
    return state, metrics


def scan_train_steps(state: TrainState, batches, lr: float, seeds,
                     class_weights: torch.Tensor, mesh=None,
                     sync_batchnorm: bool = False):
    """K train steps over one bucket's stacked batches (points (K,B,M,D),
    labels (K,B,M), masks (K,B,M)) with ``seeds[k]`` the k-th step's
    dropout seeds: the JAX ``make_scan_train_steps``. Returns (state,
    metrics) with each metric stacked to (K,)."""
    points, labels, masks = batches
    stepped = []
    for k in range(points.shape[0]):
        state, m = train_step(state, (points[k], labels[k], masks[k]), lr,
                              seeds[k], class_weights, mesh=mesh,
                              sync_batchnorm=sync_batchnorm)
        stepped.append(m)
    return state, {key: torch.stack([m[key] for m in stepped])
                   for key in stepped[0]}


@torch.no_grad()
def eval_step(state: TrainState, batch, class_weights: torch.Tensor,
              num_classes: int, *, mesh=None) -> dict:
    """{loss, correct, total, confusion (C, C)} of one batch, and
    ``dropped`` for the sparse family; with a ``mesh``, of the global
    batch whose rows this rank holds (num, den and the counts summed in
    one all-reduce)."""
    points, labels, masks = batch
    model = state.model
    surfaces_overflow = hasattr(model, "overflow_counts")
    if surfaces_overflow:
        logits, dropped = model.apply(points, train=False, mask=masks,
                                      return_overflow=True)
    else:
        logits = model.apply(points, train=False, mask=masks)
    num, den = cross_entropy_sums(logits, labels, class_weights)
    correct, total = masked_accuracy(logits, labels, masks)
    cm = confusion_matrix(logits.argmax(dim=-1), labels, masks, num_classes)
    dropped = dropped.sum() if surfaces_overflow else None
    if mesh is not None and mesh.distributed:
        parts = [num, den, correct, total] + (
            [dropped] if surfaces_overflow else [])
        flat = mesh.all_reduce_(torch.cat(
            [torch.stack([t.double() for t in parts]), cm.double().reshape(-1)]))
        num, den, correct, total = (flat[i].float() for i in range(4))
        if surfaces_overflow:
            dropped = flat[4].to(dropped.dtype)
        cm = flat[len(parts):].round().long().view_as(cm)
    metrics = {
        "loss": num / den.clamp_min(_TINY),
        "correct": correct,
        "total": total,
        "confusion": cm,
    }
    if surfaces_overflow:
        metrics["dropped"] = dropped
    return metrics
