"""Serving: ``Predictor`` (counterpart of pcseg_tpu/infer.py) for the
three families, from weights in memory, from a checkpoint that
``api.fit`` wrote or that ``ckpt.checkpoint.save_checkpoint`` made from
carried JAX weights, from a JAX checkpoint directory, or from the
reference's ``best_model.pth``; and ``inference_example``, the
reference's demo, on any dataset of (points, labels) events (an HDF5
``data.hdf5.PointCloudDataset`` included).

Events are padded to bucket lengths, and a short batch with all-masked
dummy rows, as in the JAX package; the valid-point mask goes to the
global max pool (PointNetSeg) or to voxelize and devoxelize, so padding
never changes a prediction. PointNetSeg serves BN-folded by default
(``fold=True``, ops/fold.py: a matmul + ReLU chain in ``dtype``). A
sparse model's forward also returns its count of occupied tiles beyond
the static capacity: their points read zero logits, so a nonzero count
warns, or raises with ``strict_capacity=True``.
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint
from pcseg_tpu_torch.ckpt.torch_import import load_best_model_pth
from pcseg_tpu_torch.core.device import resolve_device
from pcseg_tpu_torch.data.batching import DEFAULT_BUCKETS, pad_events, pick_bucket
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import (
    DTYPES,
    PointNetSeg,
    pointnet_apply_folded,
)
from pcseg_tpu_torch.ops.fold import fold_pointnet


class Predictor:
    """Eval-mode model bound to loaded weights.

    ``variables``: the model's state_dict (``ckpt.convert.
    from_jax_variables`` makes one from JAX parameters). ``model``: the
    module to load them into; None builds ``PointNetSeg(num_classes,
    input_dim)``, the JAX default. A PointNetSeg serves BN-folded
    (``fold=True``) in ``dtype`` ("float32": logits within ~1e-5 of the
    unfolded path; "bfloat16": the fast mode), or unfolded (``fold=False``)
    with its pool masked, which a ``bn_stats="fused"`` model refuses
    (ValueError), as in the JAX package. ``device``: None for CUDA,
    ``"cpu"`` for the plain versions. ``strict_capacity``: raise instead of
    warning when a sparse model drops occupied tiles.
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
        fold: bool = True,
        dtype: str = "float32",
    ):
        self.device = resolve_device(device)
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got "
                             f"{dtype!r}")
        if model is None:
            model = PointNetSeg(num_classes=num_classes, input_dim=input_dim)
        self._folded = None
        if isinstance(model, PointNetSeg) and not fold:
            if model.bn_stats == "fused":
                raise ValueError(
                    "bn_stats='fused' computes statistics over all padded "
                    "positions and cannot honor mask_norm_and_pool=True; use "
                    "bn_stats='exact'/'fast' for masked statistics")
            # eval-mode BN reads running stats, so this masks only the
            # global max pool
            model.mask_norm_and_pool = True
        model.load_state_dict(variables)
        self.model = model.to(self.device).eval()
        if isinstance(model, PointNetSeg) and fold:
            with torch.no_grad():
                self._folded = fold_pointnet({
                    "params": self.model.params(),
                    "batch_stats": self.model.batch_stats()})
            self._dtype = DTYPES[dtype]
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
        """Load a reference ``best_model.pth`` (a PointNetSeg; its
        ``num_classes`` from the file), a checkpoint written by
        ``ckpt.checkpoint.save_checkpoint`` or a JAX checkpoint directory,
        whose stored config rebuilds the model (PointNetSeg where a JAX
        directory has none) and sets ``strict_capacity``."""
        if os.path.isfile(path) and path.endswith(".pth"):
            state, meta = load_best_model_pth(path)
            return cls(state, int(meta["num_classes"]), **kw)
        state, num_classes, cfg = load_checkpoint(path)
        if "model" not in kw:
            kw["model"] = build_model(cfg, num_classes)
        kw.setdefault("input_dim", cfg.input_dim)
        kw.setdefault("strict_capacity", cfg.strict_capacity)
        return cls(state, num_classes, **kw)

    @torch.no_grad()
    def device_forward(self, points: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """(B, M, D) points and (B, M) bool mask on the device -> (B, M, C)
        f32 logits there."""
        if self._folded is not None:
            return pointnet_apply_folded(self._folded, points, self._dtype,
                                         pool_mask=mask)
        if not self._returns_overflow:
            return self.model(points, mask)
        logits, dropped = self.model(points, mask, return_overflow=True)
        self._check_capacity(dropped.cpu().numpy())
        return logits

    def _forward(self, pts: np.ndarray, msk: np.ndarray) -> np.ndarray:
        points = torch.from_numpy(pts).to(self.device)
        mask = torch.from_numpy(msk).to(self.device)
        return self.device_forward(points, mask).cpu().numpy()

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


def inference_example(checkpoint_path: str, dataset, event_idx: int = 0,
                      log=print, **kw) -> np.ndarray:
    """The reference demo: load a checkpoint, predict event ``event_idx``
    of ``dataset`` (a sequence of (points, labels)), log the accuracy
    against its labels and return the predictions. ``kw`` goes to
    ``Predictor.from_checkpoint`` (e.g. ``device="cpu"``)."""
    predictor = Predictor.from_checkpoint(checkpoint_path, **kw)
    points, true_labels = dataset[event_idx]
    preds = predictor.predict(points)
    acc = float((preds == np.asarray(true_labels)).mean()) * 100.0
    log(f"event {event_idx}: {points.shape[0]} points, accuracy {acc:.2f}%")
    return preds
