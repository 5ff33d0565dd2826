"""The port's own checkpoint: one file holding the tensors, the class
count and the model config as JSON, and for a training run the optimizer
state and metadata (epoch, metrics, class weights).

A training run writes two: the best model (``train.checkpoint_name``) on
improvement, and the rolling resume target ``latest.pt``
(``latest_path``) every ``train.save_latest_every`` epochs, both in
``train.checkpoint_dir``. The 'latest' metadata carries the JAX package's
keys (``epoch``, ``num_classes``, ``class_weights``, ``config``,
``best_f1_target``, ``best_val_loss``, ``best_epoch``,
``patience_counter``) and the optimizer ``step``; ``train_model
(resume_from=)`` reads either checkpoint.

Written with ``torch.save`` to a temporary file in the same directory and
renamed into place, so a crash never leaves a torn checkpoint; read with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only. JAX msgpack checkpoint directories need ``flax`` and are
not read here yet.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

from pcseg_tpu_torch.core.config import ModelConfig

LATEST_NAME = "latest.pt"


def latest_path(checkpoint_dir: str) -> str:
    """Where a training run writes its 'latest' checkpoint."""
    return os.path.join(checkpoint_dir, LATEST_NAME)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: dict, num_classes: int,
                    config: ModelConfig, *, optimizer_state: dict | None = None,
                    metadata: dict | None = None) -> str:
    """``state_dict``: the model's (parameters and BN running stats);
    ``optimizer_state``: ``torch.optim.Optimizer.state_dict()`` of a
    training run; ``metadata``: JSON-serializable run facts."""
    payload = {
        "state_dict": _to_cpu(dict(state_dict)),
        "num_classes": int(num_classes),
        "config": json.dumps(config.to_dict()),
    }
    if optimizer_state is not None:
        payload["optimizer"] = _to_cpu(optimizer_state)
    if metadata is not None:
        payload["metadata"] = json.dumps(metadata, default=float)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str):
    """-> (state_dict of CPU tensors, num_classes, ModelConfig)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfg = ModelConfig(**json.loads(payload["config"]))
    return payload["state_dict"], int(payload["num_classes"]), cfg


def load_train_state(path: str):
    """-> (optimizer state_dict or None, metadata dict) of a training
    checkpoint."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = json.loads(payload["metadata"]) if "metadata" in payload else {}
    return payload.get("optimizer"), meta
