"""The reference's ``best_model.pth`` checkpoints (counterpart of
pcseg_tpu/ckpt/torch_import.py).

The reference saves ``{epoch, model_state_dict, optimizer_state_dict,
train_loss, val_loss, f1_class2, f1_per_class, num_classes}`` whose
``model_state_dict`` holds Conv1d weights ``(out, in, 1)`` and biases and
BatchNorm1d ``weight / bias / running_mean / running_var /
num_batches_tracked``, possibly under a ``module.`` DataParallel prefix.
Mapping, as in the JAX package:

- ``<conv>.weight (out, in, 1)`` -> ``params[<conv>]["kernel"] (in, out)``;
- ``<conv>.bias`` -> ``params[<conv>]["bias"]``;
- ``<bn>.weight / .bias`` -> ``params[<bn>]["scale" / "bias"]``;
- ``<bn>.running_mean / .running_var`` -> ``batch_stats[<bn>]["mean" /
  "var"]``; ``num_batches_tracked`` is dropped.

The nested numpy form is the JAX package's variables;
``ckpt.convert.from_jax_variables`` turns it into the port's PointNetSeg
state_dict. ``export_torch_state_dict`` is the inverse.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.models.pointnet import BN_FOR

CONV_NAMES = tuple(BN_FOR) + ("seg_conv4",)


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _strip_module_prefix(sd: Mapping[str, Any]) -> dict[str, Any]:
    if any(k.startswith("module.") for k in sd):
        return {k.removeprefix("module."): v for k, v in sd.items()}
    return dict(sd)


def import_torch_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """Reference state_dict (tensors or arrays) -> ``{"params",
    "batch_stats"}`` of numpy arrays."""
    sd = _strip_module_prefix(state_dict)
    params: dict[str, Any] = {}
    batch_stats: dict[str, Any] = {}
    for conv in CONV_NAMES:
        w = _np(sd[f"{conv}.weight"])
        if w.ndim != 3 or w.shape[-1] != 1:
            raise ValueError(f"{conv}.weight has shape {w.shape}, want "
                             f"(out, in, 1)")
        params[conv] = {"kernel": np.ascontiguousarray(w[:, :, 0].T),
                        "bias": _np(sd[f"{conv}.bias"])}
        bn = BN_FOR.get(conv)
        if bn is not None:
            params[bn] = {"scale": _np(sd[f"{bn}.weight"]),
                          "bias": _np(sd[f"{bn}.bias"])}
            batch_stats[bn] = {"mean": _np(sd[f"{bn}.running_mean"]),
                               "var": _np(sd[f"{bn}.running_var"])}
    return {"params": params, "batch_stats": batch_stats}


def export_torch_state_dict(variables: Mapping[str, Any]
                            ) -> dict[str, np.ndarray]:
    """``{"params", "batch_stats"}`` (arrays or tensors) -> reference-layout
    state_dict of numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, np.ndarray] = {}
    for conv in CONV_NAMES:
        out[f"{conv}.weight"] = np.ascontiguousarray(
            _np(params[conv]["kernel"]).T)[:, :, None]
        out[f"{conv}.bias"] = _np(params[conv]["bias"])
        bn = BN_FOR.get(conv)
        if bn is not None:
            out[f"{bn}.weight"] = _np(params[bn]["scale"])
            out[f"{bn}.bias"] = _np(params[bn]["bias"])
            out[f"{bn}.running_mean"] = _np(stats[bn]["mean"])
            out[f"{bn}.running_var"] = _np(stats[bn]["var"])
            out[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def load_best_model_pth(path: str) -> tuple[dict, dict]:
    """Load a reference ``best_model.pth``: (the port's PointNetSeg
    state_dict, metadata without the state dicts). ``weights_only=True``:
    the file holds tensors and plain values only, and a full unpickling
    would run whatever code an untrusted file carries."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = from_jax_variables(import_torch_state_dict(
        ckpt["model_state_dict"]))
    meta = {k: v for k, v in ckpt.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}
    return state, meta
