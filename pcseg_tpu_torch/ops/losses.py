"""Losses (counterpart of pcseg_tpu/ops/losses.py).

``nn.CrossEntropyLoss(ignore_index=-1, weight=w)``: the sum of
``w[y_i] * nll_i`` over non-ignored targets divided by the SUM of their
weights, not their count. ``cross_entropy_sums`` returns the two sums so
a caller can combine partial batches before dividing.
"""

from __future__ import annotations

import torch


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: torch.Tensor | None = None,
                       ignore_index: int = -1):
    """(sum_i w[y_i] * nll_i, sum_i w[y_i]) over targets != ignore_index."""
    num_classes = logits.shape[-1]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    onehot = (safe[..., None] == torch.arange(
        num_classes, device=labels.device)).float()
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - (logits * onehot).sum(dim=-1)
    if class_weights is None:
        w = valid.float()
    else:
        class_weights = class_weights.float()
        if class_weights.shape != (num_classes,):
            raise ValueError(f"class_weights shape {tuple(class_weights.shape)}"
                             f" != ({num_classes},)")
        w = torch.where(valid, (onehot * class_weights).sum(dim=-1),
                        torch.zeros((), device=logits.device))
    return (w * nll).sum(), w.sum()



def weighted_masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  class_weights: torch.Tensor | None = None,
                                  ignore_index: int = -1) -> torch.Tensor:
    """Mean weighted CE over targets != ``ignore_index``: a scalar f32,
    ``nn.CrossEntropyLoss(ignore_index=-1, weight=w)``'s value, the sums
    divided by the weights' sum floored at f32's smallest normal (0, not
    NaN, for a batch whose every target is ignored)."""
    total, denom = cross_entropy_sums(logits, labels, class_weights,
                                      ignore_index)
    return total / denom.clamp_min(torch.finfo(torch.float32).tiny)
