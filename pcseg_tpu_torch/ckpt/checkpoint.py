"""The port's own checkpoint: one file holding the tensors, the class
count and the model config as JSON.

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


def save_checkpoint(path: str, state_dict: dict, num_classes: int,
                    config: ModelConfig) -> str:
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "num_classes": int(num_classes),
        "config": json.dumps(config.to_dict()),
    }
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
