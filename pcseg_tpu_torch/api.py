"""High-level serving API (counterpart of pcseg_tpu/api.py; training,
``fit`` and ``evaluate``, are not ported yet)."""

from __future__ import annotations

import numpy as np

from pcseg_tpu_torch.infer import Predictor


def predictor(checkpoint_path: str, **kw) -> Predictor:
    """Load a checkpoint written by the port."""
    return Predictor.from_checkpoint(checkpoint_path, **kw)


def predict(checkpoint_path: str, points: np.ndarray, **kw) -> np.ndarray:
    """One-shot: checkpoint + (N, D) points -> (N,) predicted classes."""
    return predictor(checkpoint_path, **kw).predict(points)
