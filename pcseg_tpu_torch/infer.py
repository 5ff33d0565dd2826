"""Serving: ``Predictor`` (counterpart of pcseg_tpu/infer.py for the voxel
and sparse families), from weights in memory or from a checkpoint that
``api.fit`` wrote or that ``ckpt.checkpoint.save_checkpoint`` made from
carried JAX weights.

Events are padded to bucket lengths, and a short batch with all-masked
dummy rows, as in the JAX package; the valid-point mask goes to voxelize
and devoxelize, so padding never changes a prediction. A sparse model's
forward also returns its count of occupied tiles beyond the static
capacity: their points read zero logits, so a nonzero count warns, or
raises with ``strict_capacity=True``.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint
from pcseg_tpu_torch.core.device import resolve_device
from pcseg_tpu_torch.data.batching import DEFAULT_BUCKETS, pad_events, pick_bucket
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import PointNetSeg


class Predictor:
    """Eval-mode model bound to loaded weights.

    ``variables``: the model's state_dict (``ckpt.convert.
    from_jax_variables`` makes one from JAX parameters). ``model``: the
    module to load them into, a VoxelUNet3d or a SparseVoxelNet; serving
    the JAX default (PointNetSeg) is not ported yet. ``device``: None for
    CUDA, ``"cpu"`` for the plain versions. ``strict_capacity``: raise
    instead of warning when a sparse model drops occupied tiles.
    """

    def __init__(
        self,
        variables: dict,
        num_classes: int,
        input_dim: int = 4,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        model: torch.nn.Module | None = None,
        device=None,
        strict_capacity: bool = False,
    ):
        self.device = resolve_device(device)
        if model is None or isinstance(model, PointNetSeg):
            raise NotImplementedError(
                "serving PointNetSeg (the default model) through Predictor "
                "is not ported to pcseg_tpu_torch yet (ROADMAP Queue A); "
                "pass a VoxelUNet3d or a SparseVoxelNet as model="
            )
        model.load_state_dict(variables)
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes
        self.input_dim = input_dim
        self.buckets = tuple(sorted(buckets))
        self.strict_capacity = strict_capacity
        # sparse family: one forward returns (logits, dropped)
        self._returns_overflow = hasattr(self.model, "overflow_counts")

    def _check_capacity(self, dropped: np.ndarray) -> None:
        """Warn, or raise with ``strict_capacity``, on a nonzero count of
        occupied tiles beyond the model's static capacity."""
        n = int(dropped.sum())
        if n:
            msg = (f"capacity overflow: {n} occupied tiles beyond the "
                   f"model's static capacity; their points read zero "
                   f"logits (raise max_tiles)")
            if self.strict_capacity:
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=3)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "Predictor":
        """Load a checkpoint written by ``ckpt.checkpoint.save_checkpoint``;
        the model is rebuilt from the config stored in it, and so is
        ``strict_capacity``."""
        state, num_classes, cfg = load_checkpoint(path)
        if "model" not in kw:
            kw["model"] = build_model(cfg, num_classes)
        kw.setdefault("input_dim", cfg.input_dim)
        kw.setdefault("strict_capacity", cfg.strict_capacity)
        return cls(state, num_classes, **kw)

    def _forward(self, pts: np.ndarray, msk: np.ndarray) -> np.ndarray:
        points = torch.from_numpy(pts).to(self.device)
        mask = torch.from_numpy(msk).to(self.device)
        if not self._returns_overflow:
            return self.model(points, mask).cpu().numpy()
        logits, dropped = self.model(points, mask, return_overflow=True)
        self._check_capacity(dropped.cpu().numpy())
        return logits.cpu().numpy()

    def logits(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, C) float32 logits for one event."""
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        bucket = pick_bucket(n, self.buckets)
        pts, _, msk = pad_events([(points, np.zeros(n, np.int64))], bucket,
                                 batch_size=1, feature_dim=self.input_dim)
        return self._forward(pts, msk)[0, :n]

    def predict(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N,) int per-point class (argmax)."""
        return np.argmax(self.logits(points), axis=-1)

    def predict_batch(self, events: Sequence[np.ndarray],
                      batch_size: int = 8) -> list[np.ndarray]:
        """Ragged events -> per-point predictions, ``batch_size`` events
        per forward, grouped by length so each group pads to one bucket."""
        events = [np.asarray(e, np.float32) for e in events]
        order = sorted(range(len(events)), key=lambda i: events[i].shape[0])
        out: list = [None] * len(events)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            group = [events[i] for i in idx]
            bucket = pick_bucket(max(e.shape[0] for e in group), self.buckets)
            pts, _, msk = pad_events(
                [(e, np.zeros(e.shape[0], np.int64)) for e in group], bucket,
                batch_size=batch_size, feature_dim=self.input_dim,
            )
            logits = self._forward(pts, msk)
            for j, i in enumerate(idx):
                out[i] = np.argmax(logits[j, : events[i].shape[0]], axis=-1)
        return out
