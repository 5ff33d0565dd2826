"""Metrics: masked accuracy, confusion matrix, sklearn-parity F1
(counterpart of pcseg_tpu/ops/metrics.py).

F1 comes from a confusion matrix accumulated during the one validation
pass. sklearn's conventions hold: a class with tp + fp + fn == 0 gets
0.0; the macro mean runs over the labels present in y_true or y_pred;
the weighted mean is support-weighted. Model selection reads
``per_class[2]``, so these conventions matter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor):
    """(num_correct, num_valid) as f32 scalars; argmax takes the first
    class on ties."""
    pred = logits.argmax(dim=-1)
    correct = ((pred == labels) & mask).float().sum()
    return correct, mask.float().sum()


def confusion_matrix(pred: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64, rows = true class, cols = predicted class."""
    valid = mask & (labels >= 0)
    idx = labels[valid] * num_classes + pred[valid]
    return torch.bincount(idx.reshape(-1), minlength=num_classes ** 2)[
        : num_classes ** 2].reshape(num_classes, num_classes)


class F1Scores(NamedTuple):
    per_class: np.ndarray   # (C,) f64
    macro: float
    weighted: float


def f1_from_confusion(cm) -> F1Scores:
    """sklearn-identical F1 from a confusion matrix (host-side, float64)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    denom = support + predicted       # = 2tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1e-300), 0.0)
    observed = (support > 0) | (predicted > 0)
    macro = float(f1[observed].mean()) if observed.any() else 0.0
    total_support = support.sum()
    weighted = (float((f1 * support).sum() / total_support)
                if total_support > 0 else 0.0)
    return F1Scores(per_class=f1, macro=macro, weighted=weighted)
