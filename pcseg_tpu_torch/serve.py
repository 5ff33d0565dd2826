"""Exported serving artifacts: ``torch.export`` of the Predictor's forward
(counterpart of pcseg_tpu/serve.py).

``export_predictor`` writes the forward of a ``Predictor`` (any of the
three families, PointNetSeg folded or not) as one exported program per
served (batch, bucket) shape, beside its weights; ``ExportedPredictor``
replays those programs with no model code and no retracing: a serving
host loads the graphs and the tensors, and nothing of ``models``,
``infer`` or ``ops.fold`` is imported, so model code and weights cannot
drift apart. Unlike the JAX package's artifact it saves no start-up
time: eager PyTorch has no trace to skip, and ``torch.export.load``
imports ``torch._dynamo`` at the first program (seconds).

The programs take the weights as inputs (``torch.func.functional_call``
over the model's state dict, or the folded PointNet layers), so each
program file holds a graph and no copy of the weights (nor export's
``_assert_tensor_metadata`` checks: the replay checks its inputs once a
call). Every kernel the forward launches is a registered op
(``pcseg::conv3x3_gn_act``, ``down2x_gn_act``, ``up2x_gn_act``,
``head_grid2``, ``voxelize_contract``, ``trilinear_gather``,
``bias_ln_relu_mask``, ``block_conv``; defined in ``ops/``, which this
module imports to register them), so the graph holds each launch as one
node: on a CUDA tensor the node launches the hand-written kernel, on a
CPU tensor it runs the plain version.

Artifact layout (one directory):

- ``manifest.json``: version, classes, input width, batch sizes,
  buckets, whether the forward returns the sparse models' overflow count
  (and the words its warning uses), the platforms it replays on, the
  device it was exported on and the torch version;
- ``weights/weights.pt``: ``{"state_dict": name -> tensor, "num_classes"}``
  written by ``torch.save``, read with ``torch.load(weights_only=True)``;
- ``fwd_b{B}_m{M}.pt2``: ``torch.export.save`` of the forward at batch
  ``B`` x bucket ``M``.

Platforms: an exported graph bakes the exporting device into its
factory ops. ``platforms`` lists the devices the artifact replays on
("cuda", "cpu" or both); a replay on another device than the exporting
one moves the graph with ``torch.export.passes.move_to_device_pass`` at
load time, and the same op nodes then take that device's implementation.
So one artifact serves the card through the kernels and the CPU through
the plain versions, with no portable switch: the JAX package's
``force_xla_paths`` and ``portable`` exist because a Pallas kernel picks
compiled or interpreted at trace time, which a registered op does not.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from pcseg_tpu_torch.core.device import resolve_device
from pcseg_tpu_torch.data.batching import (
    pad_events,
    pick_bucket,
    predict_in_buckets,
)

# the modules that register the pcseg:: ops an exported graph calls
from pcseg_tpu_torch.ops import (  # noqa: F401
    block_conv,
    conv3d_block,
    fused_ln,
    voxel,
)

_MANIFEST_VERSION = 1
PLATFORMS = ("cuda", "cpu")
WEIGHTS = os.path.join("weights", "weights.pt")


def _program_file(b: int, m: int) -> str:
    return f"fwd_b{b}_m{m}.pt2"


class _Forward(torch.nn.Module):
    """(weights, points, mask) -> logits, or (logits, dropped) for a
    sparse model. ``fn`` is a plain function, so export lifts no weights
    out of a module: they are inputs of the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, weights: dict, points: torch.Tensor,
                mask: torch.Tensor):
        return self.fn(weights, points, mask)


def _forward_of(predictor):
    """The predictor's device forward as a function of its weights, and
    those weights as one flat name -> tensor dict."""
    if predictor._folded is not None:
        from pcseg_tpu_torch.models.pointnet import pointnet_apply_folded

        dtype = predictor._dtype
        weights = {f"{layer}.{k}": v for layer, group in
                   predictor._folded.items() for k, v in group.items()}

        def fn(w, points, mask):
            folded = {}
            for name, v in w.items():
                layer, k = name.split(".")
                folded.setdefault(layer, {})[k] = v
            return pointnet_apply_folded(folded, points, dtype,
                                         pool_mask=mask)

        return fn, weights
    model = predictor.model
    kw = {"return_overflow": True} if predictor._returns_overflow else {}

    def fn(w, points, mask):
        return torch.func.functional_call(model, w, (points, mask), kw)

    return fn, dict(model.state_dict())


def _drop_metadata_asserts(ep) -> None:
    """Erase export's ``aten._assert_tensor_metadata`` nodes, one a
    ``.to()`` of the traced code: each checks a dtype the exported shapes
    and the artifact's weights already fix, and costs a dispatch at every
    replay (~50 in the PointNet and sparse forwards)."""
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    ep.graph_module.recompile()


def export_predictor(predictor, out_dir: str,
                     batch_sizes: Sequence[int] = (1, 8),
                     buckets: Optional[Sequence[int]] = None,
                     platforms: Optional[Sequence[str]] = None) -> dict:
    """Export ``predictor``'s forward per (batch, bucket) into ``out_dir``;
    returns the manifest dict. ``buckets`` defaults to the predictor's pad
    buckets, ``platforms`` to the predictor's device type."""
    buckets = tuple(sorted(buckets or predictor.buckets))
    batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
    platforms = list(platforms or [predictor.device.type])
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}; options: {PLATFORMS}")
    fn, weights = _forward_of(predictor)

    os.makedirs(os.path.join(out_dir, "weights"), exist_ok=True)
    torch.save({"state_dict": {k: v.cpu() for k, v in weights.items()},
                "num_classes": int(predictor.num_classes)},
               os.path.join(out_dir, WEIGHTS))

    dev, dim = predictor.device, predictor.input_dim
    program = _Forward(fn)
    for b in batch_sizes:
        for m in buckets:
            points = torch.zeros((b, m, dim), dtype=torch.float32, device=dev)
            mask = torch.ones((b, m), dtype=torch.bool, device=dev)
            with torch.no_grad():
                ep = torch.export.export(program, (weights, points, mask))
            ep.example_inputs = None        # a graph, not a weights copy
            _drop_metadata_asserts(ep)
            torch.export.save(ep, os.path.join(out_dir, _program_file(b, m)))

    capacity = None
    if predictor._returns_overflow:
        from pcseg_tpu_torch.models.sparse_unet import capacity_words

        capacity = list(capacity_words(predictor.model.impl))
    manifest = {
        "version": _MANIFEST_VERSION,
        "num_classes": int(predictor.num_classes),
        "input_dim": int(dim),
        "batch_sizes": list(batch_sizes),
        "buckets": list(buckets),
        "returns_overflow": bool(predictor._returns_overflow),
        "platforms": platforms,
        "capacity": capacity,
        "exported_on": str(dev),
        "torch": torch.__version__,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedPredictor:
    """Predictor API replayed from an exported artifact: no model code.

    Mirrors ``infer.Predictor``'s ``logits`` / ``predict`` /
    ``predict_batch`` (per-point argmax, ragged events padded to the
    exported buckets), and the sparse models' capacity overflow: a warning,
    or RuntimeError with ``strict_capacity``. ``device``: None for CUDA,
    "cpu" for the plain versions; it must be one of the artifact's
    platforms (ValueError otherwise). Programs load at their first use.
    """

    def __init__(self, path: str, device=None,
                 strict_capacity: bool = False):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest["version"] != _MANIFEST_VERSION:
            raise ValueError(
                f"unsupported artifact version {self.manifest['version']}")
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"artifact was exported for {self.manifest['platforms']}, "
                f"this predictor runs on {self.device.type!r}: export with "
                f"platforms=(..., {self.device.type!r})")
        self.path = path
        self.weights = torch.load(os.path.join(path, WEIGHTS),
                                  map_location=self.device,
                                  weights_only=True)["state_dict"]
        self.num_classes = self.manifest["num_classes"]
        self.input_dim = self.manifest["input_dim"]
        self.buckets = tuple(self.manifest["buckets"])
        self.batch_sizes = tuple(self.manifest["batch_sizes"])
        self.strict_capacity = strict_capacity
        self._fns: dict = {}

    def _fn(self, b: int, m: int):
        if (b, m) not in self._fns:
            ep = torch.export.load(os.path.join(self.path,
                                                _program_file(b, m)))
            exported_on = torch.device(self.manifest["exported_on"])
            if exported_on.type != self.device.type:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, str(self.device))
            program = ep.module()
            # the inputs are the artifact's own weights and a batch that
            # device_forward checked: no check of every input a call
            program.validate_inputs = False
            self._fns[(b, m)] = program
        return self._fns[(b, m)]

    def _check_capacity(self, dropped: np.ndarray) -> None:
        """``infer.Predictor._check_capacity`` with the manifest's words."""
        n = int(dropped.sum())
        if n:
            what, knob = self.manifest["capacity"]
            msg = (f"capacity overflow: {n} occupied {what} beyond the "
                   f"model's static capacity; their points read zero "
                   f"logits (raise {knob})")
            if self.strict_capacity:
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=3)

    @torch.no_grad()
    def device_forward(self, points: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """(B, M, D) f32 points and (B, M) bool mask on the device, B and M
        an exported shape -> (B, M, C) f32 logits there."""
        b, m = mask.shape
        if b not in self.batch_sizes or m not in self.buckets or \
                points.shape != (b, m, self.input_dim) or \
                points.dtype != torch.float32 or mask.dtype != torch.bool \
                or points.device != mask.device or \
                points.device.type != self.device.type:
            raise ValueError(
                f"points {tuple(points.shape)} {points.dtype} and mask "
                f"{tuple(mask.shape)} {mask.dtype} on {points.device} / "
                f"{mask.device}: the exported programs take f32 (B, M, "
                f"{self.input_dim}) and bool (B, M) on {self.device}, B in "
                f"{self.batch_sizes}, M in {self.buckets}")
        out = self._fn(b, m)(self.weights, points, mask)
        if not self.manifest["returns_overflow"]:
            return out
        logits, dropped = out
        self._check_capacity(dropped.cpu().numpy())
        return logits

    def _run(self, pts: np.ndarray, msk: np.ndarray) -> np.ndarray:
        points = torch.from_numpy(pts).to(self.device)
        mask = torch.from_numpy(msk).to(self.device)
        return self.device_forward(points, mask).cpu().numpy()

    def logits(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, C) float32 logits for one event, at the smallest
        exported batch size."""
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        bucket = pick_bucket(n, self.buckets)
        pts, _, msk = pad_events([(points, np.zeros(n, np.int64))], bucket,
                                 batch_size=self.batch_sizes[0],
                                 feature_dim=self.input_dim)
        return self._run(pts, msk)[0, :n]

    def predict(self, points: np.ndarray) -> np.ndarray:
        """(N, D) -> (N,) int per-point class (argmax)."""
        return np.argmax(self.logits(points), axis=-1)

    def predict_batch(self, events: Sequence[np.ndarray],
                      batch_size: Optional[int] = None) -> list[np.ndarray]:
        """Ragged events -> per-point predictions through the exported
        programs, grouped by length at the largest exported batch size (or
        ``batch_size``, which must be an exported one)."""
        if batch_size is None:
            batch_size = self.batch_sizes[-1]
        elif batch_size not in self.batch_sizes:
            raise ValueError(f"batch_size {batch_size} not in exported "
                             f"{self.batch_sizes}")
        return predict_in_buckets(
            self._run, [np.asarray(e, np.float32) for e in events],
            batch_size, self.buckets, self.input_dim)


def load_exported(path: str, device=None,
                  strict_capacity: bool = False) -> ExportedPredictor:
    """Open an artifact written by :func:`export_predictor`."""
    return ExportedPredictor(path, device=device,
                             strict_capacity=strict_capacity)
