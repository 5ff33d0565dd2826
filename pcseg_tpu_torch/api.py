"""High-level API (counterpart of pcseg_tpu/api.py): ``fit`` on in-memory
events or on HDF5 event files (PointNetSeg, the voxel U-Net and the
block-sparse SparseVoxelNet, ``model.name=sparse_voxelnet``), resumed
from a checkpoint it wrote with ``resume_from`` (usually
``<checkpoint_dir>/latest.pt``); ``evaluate``, the validation pass's
metrics of a checkpoint on labelled events or files; and serving, through
``predictor`` / ``predict``, of a checkpoint of any of the three families
in the port's format (the best checkpoint ``fit`` wrote), a JAX
checkpoint directory, or the reference's ``best_model.pth``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint, load_train_state
from pcseg_tpu_torch.core.config import Config, apply_overrides
from pcseg_tpu_torch.core.device import resolve_device
from pcseg_tpu_torch.data.batching import DEFAULT_BUCKETS, BucketBatcher
from pcseg_tpu_torch.data.hdf5 import PointCloudDataset
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.ops.metrics import f1_from_confusion
from pcseg_tpu_torch.train.loop import (
    TrainResult,
    _run_epoch_eval,
    train_model,
)
from pcseg_tpu_torch.train.steps import TrainState


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


def fit(events: Sequence[tuple[np.ndarray, np.ndarray]] | None = None, *,
        data_path: str | None = None, label_path: str | None = None,
        config: Config | None = None, overrides: Sequence[str] = (),
        resume_from: str | None = None, device=None,
        log=print) -> TrainResult:
    """Train on in-memory (points (N, D), labels (N,)) events or, with no
    ``events``, on the HDF5 event files ``data_path`` / ``label_path``
    (the config's ``data.data_path`` / ``data.label_path`` where not
    given; closed after the run). Returns the TrainResult, whose
    ``checkpoint_path`` holds the best model and whose history records,
    for the sparse family, the tiles dropped beyond the capacities in
    each epoch (``dropped_train`` / ``dropped_val``). ``resume_from``: a
    checkpoint a run wrote (usually ``<checkpoint_dir>/latest.pt``) to
    continue from: the parameters, Adam's state and step, the epoch
    counter and the best-model selection state all restore. ``device``:
    None for CUDA, ``"cpu"`` for the plain versions."""
    cfg = config or Config()
    apply_overrides(cfg, overrides)
    if events is not None:
        return train_model(cfg, ArrayDataset(events), device=device,
                           resume_from=resume_from, log=log)
    with PointCloudDataset(data_path or cfg.data.data_path,
                           label_path or cfg.data.label_path,
                           feature_dim=cfg.model.input_dim) as ds:
        return train_model(cfg, ds, device=device, resume_from=resume_from,
                           log=log)


def evaluate(checkpoint_path: str,
             events: Sequence[tuple[np.ndarray, np.ndarray]] | None = None,
             *, data_path: str | None = None, label_path: str | None = None,
             batch_size: int = 64, buckets: Sequence[int] = DEFAULT_BUCKETS,
             device=None) -> dict:
    """A checkpoint (the port's of any family, or a JAX checkpoint
    directory) on labelled events, or on the HDF5 event files
    ``data_path`` / ``label_path`` (closed after use): {loss, accuracy,
    f1_macro, f1_weighted, f1_per_class, dropped, confusion}, computed as
    the training run's validation pass computes them (the class weights
    the run stored, ones for a checkpoint without them; ``dropped``: the
    sparse family's occupied tiles beyond its capacities over the events,
    0 elsewhere). ``device``: None for CUDA, ``"cpu"`` for the plain
    versions."""
    dev = resolve_device(device)
    state_dict, num_classes, model_cfg = load_checkpoint(checkpoint_path)
    _, meta = load_train_state(checkpoint_path)
    model = build_model(model_cfg, num_classes)
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    cw = torch.tensor(meta.get("class_weights") or np.ones(num_classes),
                      dtype=torch.float32, device=dev)
    dataset = (ArrayDataset(events) if events is not None else
               PointCloudDataset(data_path, label_path,
                                 feature_dim=model_cfg.input_dim))
    try:
        batcher = BucketBatcher(dataset, batch_size, buckets=buckets,
                                feature_dim=model_cfg.input_dim)
        loss, acc, cm, dropped = _run_epoch_eval(
            TrainState(model=model, optimizer=None), batcher, cw,
            num_classes, dev)
    finally:
        if events is None:
            dataset.close()
    f1 = f1_from_confusion(cm)
    return {
        "loss": loss,
        "accuracy": acc,
        "f1_macro": f1.macro,
        "f1_weighted": f1.weighted,
        "f1_per_class": f1.per_class.tolist(),
        "dropped": dropped,
        "confusion": cm.tolist(),
    }


def predictor(checkpoint_path: str, **kw) -> Predictor:
    """Load a checkpoint in the port's format, a JAX checkpoint directory
    or a reference ``best_model.pth`` (``Predictor.from_checkpoint``
    keywords, e.g. ``device="cpu"``, ``fold``, ``dtype``)."""
    return Predictor.from_checkpoint(checkpoint_path, **kw)


def predict(checkpoint_path: str, points: np.ndarray, **kw) -> np.ndarray:
    """One-shot: checkpoint (the port's, a JAX directory or a
    ``best_model.pth``) + (N, D) points -> (N,) predicted classes."""
    return predictor(checkpoint_path, **kw).predict(points)
