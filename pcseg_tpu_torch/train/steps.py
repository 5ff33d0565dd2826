"""Train and eval steps on one device (counterpart of
pcseg_tpu/train/steps.py without its mesh data parallelism).

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
               class_weights: torch.Tensor, *, debug_nans: bool = False):
    """One step on ``batch = (points (B,M,D), labels (B,M), masks (B,M))``
    tensors on the model's device. ``seeds``: the step's two dropout seeds
    (``dropout_seeds``). Updates the
    model, its running stats and the optimizer in place; returns (state,
    metrics) with metrics {loss, correct, total} as device scalars, and
    ``dropped`` (occupied tiles or sites beyond the capacities, summed over the
    batch) for the sparse family. ``debug_nans``: raise FloatingPointError
    before the update when the loss or a gradient is not finite."""
    points, labels, masks = batch
    model = state.model
    if model.supports_fused_loss() and points.shape[1] % 8 == 0:
        (num, den, correct), new_bn = model.fused_train_loss(
            points, labels, class_weights, seeds=seeds)
        total = masks.float().sum()
    else:
        logits, new_bn = model.apply(points, train=True, mask=masks,
                                     seeds=seeds)
        num, den = cross_entropy_sums(logits, labels, class_weights)
        correct, total = masked_accuracy(logits, labels, masks)
    loss = num / den.clamp_min(_TINY)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if debug_nans:
        _check_finite(loss, model, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    overflow = (new_bn.pop("__overflow__", None)
                if isinstance(new_bn, dict) else None)
    model.load_batch_stats(new_bn)
    state.step += 1
    metrics = {"loss": loss.detach(), "correct": correct.detach(),
               "total": total}
    if overflow is not None:
        metrics["dropped"] = overflow.sum()
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch, class_weights: torch.Tensor,
              num_classes: int) -> dict:
    """{loss, correct, total, confusion (C, C)} of one batch, and
    ``dropped`` for the sparse family."""
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
    metrics = {
        "loss": num / den.clamp_min(_TINY),
        "correct": correct,
        "total": total,
        "confusion": confusion_matrix(logits.argmax(dim=-1), labels, masks,
                                      num_classes),
    }
    if surfaces_overflow:
        metrics["dropped"] = dropped.sum()
    return metrics
