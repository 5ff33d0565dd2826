"""Global max pool over the point axis (counterpart of
pcseg_tpu/ops/pooling.py).

``mask=None`` pools over all M positions, padding included (the
reference's ``torch.max(feat, dim=2)``); a (B, M) mask pools only valid
points. ``amax`` splits the gradient evenly between tied maxima, as
JAX's max reduction does.
"""

from __future__ import annotations

import torch


def global_max_pool(x: torch.Tensor, mask: torch.Tensor | None = None):
    """(B, M, C) -> (B, C)."""
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        x = torch.where(mask[..., None], x,
                        torch.full((), neg, dtype=x.dtype, device=x.device))
    return x.amax(dim=1)
