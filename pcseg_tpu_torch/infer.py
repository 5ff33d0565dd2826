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
sparse model's forward also returns its count of occupied tiles (block
impl) or sites (gather impl) beyond the static capacity: their points
read zero logits, so a nonzero count warns, or raises with
``strict_capacity=True`` (the dense impl has no capacity).

Data-axis serving (``mesh``, a ``parallel.mesh.Mesh``): the JAX
``Predictor``'s ``mesh``, one process per device. Every rank calls the
same method on the same events; each forwards its rows of each batch
(the batch rounded up to a multiple of the data axis with all-masked
rows), the logits are all-gathered and the dropped counts summed, so
every rank returns the full predictions and warns or raises alike.
Depth-sharded serving (``gp_mesh``) is not ported yet (ROADMAP A9b).
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
from pcseg_tpu_torch.data.batching import (
    DEFAULT_BUCKETS,
    pad_events,
    pick_bucket,
    predict_in_buckets,
)
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import (
    DTYPES,
    PointNetSeg,
    pointnet_apply_folded,
)
from pcseg_tpu_torch.models.sparse_unet import capacity_words
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
    warning when a sparse model drops occupied tiles or sites. ``mesh``:
    serve over the data axis (the module docstring) on the mesh's device;
    ``gp_mesh`` raises NotImplementedError.
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
        mesh=None,
        gp_mesh=None,
    ):
        if gp_mesh is not None:
            raise NotImplementedError(
                "Predictor(gp_mesh=...): depth-sharded serving "
                "(parallel/gp.py) is not ported yet (ROADMAP A9b)")
        self.mesh = mesh
        self._n_data = mesh.data if mesh is not None else 1
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
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
        occupied tiles (sites) beyond the model's static capacity."""
        n = int(dropped.sum())
        if n:
            what, knob = capacity_words(self.model.impl)
            msg = (f"capacity overflow: {n} occupied {what} beyond the "
                   f"model's static capacity; their points read zero "
                   f"logits (raise {knob})")
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
    def _logits_dropped(self, points: torch.Tensor, mask: torch.Tensor):
        """(logits, the sparse model's (B,) dropped counts or None)."""
        if self._folded is not None:
            return pointnet_apply_folded(self._folded, points, self._dtype,
                                         pool_mask=mask), None
        if not self._returns_overflow:
            return self.model(points, mask), None
        return self.model(points, mask, return_overflow=True)

    def device_forward(self, points: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """(B, M, D) points and (B, M) bool mask on the device -> (B, M, C)
        f32 logits there."""
        logits, dropped = self._logits_dropped(points, mask)
        if dropped is not None:
            self._check_capacity(dropped.cpu().numpy())
        return logits

    def _forward(self, pts: np.ndarray, msk: np.ndarray) -> np.ndarray:
        if self.mesh is None:
            points = torch.from_numpy(pts).to(self.device)
            mask = torch.from_numpy(msk).to(self.device)
            return self.device_forward(points, mask).cpu().numpy()
        rows = self.mesh.rows(pts.shape[0])
        logits, dropped = self._logits_dropped(
            torch.from_numpy(pts[rows]).to(self.device),
            torch.from_numpy(msk[rows]).to(self.device))
        logits = self.mesh.all_gather(logits)
        if dropped is not None:
            self._check_capacity(self.mesh.all_reduce_(
                dropped.sum().reshape(1)).cpu().numpy())
        return logits.cpu().numpy()

    def logits(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, C) float32 logits for one event."""
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        bucket = pick_bucket(n, self.buckets)
        pts, _, msk = pad_events([(points, np.zeros(n, np.int64))], bucket,
                                 batch_size=self._n_data,
                                 feature_dim=self.input_dim)
        return self._forward(pts, msk)[0, :n]

    def predict(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N,) int per-point class (argmax)."""
        return np.argmax(self.logits(points), axis=-1)

    def predict_batch(self, events: Sequence[np.ndarray],
                      batch_size: int = 8) -> list[np.ndarray]:
        """Ragged events -> per-point predictions, ``batch_size`` events
        per forward, grouped by length so each group pads to one bucket;
        with a mesh, ``batch_size`` rounded up to a multiple of its data
        axis."""
        batch_size = -(-batch_size // self._n_data) * self._n_data
        return predict_in_buckets(
            self._forward, [np.asarray(e, np.float32) for e in events],
            batch_size, self.buckets, self.input_dim)


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
