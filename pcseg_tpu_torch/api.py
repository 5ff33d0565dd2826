"""High-level API (counterpart of pcseg_tpu/api.py): ``fit`` on in-memory
events (PointNetSeg, the voxel U-Net and the block-sparse SparseVoxelNet,
``model.name=sparse_voxelnet``), and serving, through ``predictor`` /
``predict``, of a checkpoint of any of the three families in the port's
format (the best checkpoint ``fit`` wrote, or one saved from weights
carried over from the JAX package) or of the reference's
``best_model.pth``. HDF5 datasets, resume and ``evaluate`` are not ported
yet."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pcseg_tpu_torch.core.config import Config, apply_overrides
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.train.loop import TrainResult, train_model


class ArrayDataset:
    """Map-style dataset over in-memory ragged events."""

    def __init__(self, events: Sequence[tuple[np.ndarray, np.ndarray]]):
        self.events = [(np.asarray(p, np.float32), np.asarray(lab, np.int64))
                       for p, lab in events]

    def __len__(self):
        return len(self.events)

    def __getitem__(self, idx):
        return self.events[idx]

    def num_points(self, idx):
        return self.events[idx][0].shape[0]


def fit(events: Sequence[tuple[np.ndarray, np.ndarray]], *,
        config: Config | None = None, overrides: Sequence[str] = (),
        device=None, log=print) -> TrainResult:
    """Train on in-memory (points (N, D), labels (N,)) events; returns the
    TrainResult, whose ``checkpoint_path`` holds the best model and whose
    history records, for the sparse family, the tiles dropped beyond the
    capacities in each epoch (``dropped_train`` / ``dropped_val``).
    ``device``: None for CUDA, ``"cpu"`` for the plain versions."""
    cfg = config or Config()
    apply_overrides(cfg, overrides)
    return train_model(cfg, ArrayDataset(events), device=device, log=log)


def predictor(checkpoint_path: str, **kw) -> Predictor:
    """Load a checkpoint in the port's format or a reference
    ``best_model.pth`` (``Predictor.from_checkpoint`` keywords, e.g.
    ``device="cpu"``, ``fold``, ``dtype``)."""
    return Predictor.from_checkpoint(checkpoint_path, **kw)


def predict(checkpoint_path: str, points: np.ndarray, **kw) -> np.ndarray:
    """One-shot: checkpoint (the port's or a ``best_model.pth``) + (N, D)
    points -> (N,) predicted classes."""
    return predictor(checkpoint_path, **kw).predict(points)
