"""``api.evaluate`` in the port: a checkpoint on labelled events ->
{loss, accuracy, f1_macro, f1_weighted, f1_per_class, dropped,
confusion}, against the JAX package's ``api.evaluate`` on the same
weights and events, and against the validation pass of the run that
wrote the checkpoint.

The JAX side reads a checkpoint directory of its own format
(``pcseg_tpu.ckpt.checkpoint.save_checkpoint``) holding the numpy
weights; the port reads its one-file checkpoint of the same weights,
carried over with ``ckpt.convert.from_jax_variables``. Both models run in
f32 (PointNetSeg, and the voxel U-Net on its plain core: the JAX fused
core's interpret mode does not run under the evaluation's shard_map), so
the loss is held to 1e-5 relative and the counts exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcseg_tpu import api as jax_api
from pcseg_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import save_checkpoint
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.train.loop import split_indices
from tests import test_torch_pointnet as pn
from tests import test_torch_voxel_train as vt

torch.set_num_threads(1)

C = 4
KEYS = {"loss", "accuracy", "f1_macro", "f1_weighted", "f1_per_class",
        "dropped", "confusion"}
VOXEL = dict(name="voxel_unet3d", grid_size=8, unet_width=8, levels=2,
             compute_dtype="float32", impl="xla", voxelize_impl="scatter",
             devox_impl="gather")


def _pointnet_vars():
    return pn._numpy_vars(3)


def _voxel_vars():
    return vt._numpy_vars(JaxVoxelUNet3d(**vt.XLA_F32), 4)


@pytest.mark.parametrize("fields, variables", [
    (dict(name="pointnet_seg"), _pointnet_vars),
    (VOXEL, _voxel_vars),
], ids=["pointnet_f32", "voxel_unet3d_f32"])
def test_evaluate_matches_jax(tmp_path, fields, variables):
    variables = variables()
    events = list(synthetic_events(12, num_classes=C, min_points=40,
                                   max_points=300, seed=21))
    cw = [0.5, 1.0, 2.0, 1.5]
    jdir = str(tmp_path / "jax_ckpt")
    jax_save_checkpoint(jdir, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"]},
                        {"num_classes": C, "class_weights": cw, "config": {
                            "model": dataclasses.asdict(
                                JaxModelConfig(**fields))}})
    path = save_checkpoint(str(tmp_path / "port.pt"),
                           from_jax_variables(variables), C,
                           ModelConfig(**fields),
                           metadata={"class_weights": cw})

    ref = jax_api.evaluate(jdir, events, batch_size=8, buckets=(128, 512))
    got = api.evaluate(path, events, batch_size=8, buckets=(128, 512),
                       device="cpu")
    assert got.keys() == KEYS and ref.keys() == KEYS
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["confusion"] == ref["confusion"]
    assert got["dropped"] == ref["dropped"] == 0
    for k in ("accuracy", "f1_macro", "f1_weighted"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(got["f1_per_class"], ref["f1_per_class"],
                               rtol=1e-12)


@pytest.mark.parametrize("family", ["sparse_voxelnet", "voxel_unet3d"])
def test_evaluate_repeats_the_validation_pass(tmp_path, family):
    """The best checkpoint of a one-epoch run on its own validation
    events, batched as the run batched them: the run's val loss and
    accuracy bit for bit, and the sparse family's dropped tiles."""
    if family == "sparse_voxelnet":
        from tests.test_torch_sparse_train import FIT, _events

        events = _events(10, 256, 2)
        overrides = FIT + ["model.max_tiles=12"]
        batch_size, buckets = 4, (256,)
    else:
        events = list(synthetic_events(10, min_points=30, max_points=100,
                                       seed=11))
        overrides = ["model.name=voxel_unet3d", "model.grid_size=8",
                     "model.unet_width=16", "model.levels=2",
                     "model.compute_dtype=bfloat16", "model.remat=true",
                     "data.batch_size=4", "data.buckets=64,128"]
        batch_size, buckets = 4, (64, 128)
    res = api.fit(events, device="cpu", log=lambda *a: None,
                  overrides=overrides + [
                      "train.num_epochs=1", "train.log_every_steps=0",
                      f"train.checkpoint_dir={tmp_path}"])
    assert res.best_epoch == 0
    _, val_idx = split_indices(len(events), 0.2, 0)
    got = api.evaluate(res.checkpoint_path, [events[i] for i in val_idx],
                       batch_size=batch_size, buckets=buckets, device="cpu")
    h = res.history[0]
    assert got["loss"] == h["val_loss"]
    assert got["accuracy"] == h["val_acc"]
    assert got["dropped"] == h["dropped_val"]
    assert got["f1_per_class"] == h["f1_per_class"]
    if family == "sparse_voxelnet":
        assert got["dropped"] > 0


def test_evaluate_needs_the_card_unless_cpu(tmp_path, monkeypatch):
    path = save_checkpoint(str(tmp_path / "p.pt"),
                           from_jax_variables(_pointnet_vars()), C,
                           ModelConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    events = list(synthetic_events(2, min_points=10, max_points=20, seed=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.evaluate(path, events)
    out = api.evaluate(path, events, batch_size=2, device="cpu")
    # no class weights stored: ones
    assert out.keys() == KEYS and np.isfinite(out["loss"])
