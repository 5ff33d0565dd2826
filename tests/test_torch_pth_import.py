"""The reference's ``best_model.pth`` in the port: ckpt/torch_import.py
against the JAX package's importer and exporter, a file written from the
reference architecture (tests/torch_ref.py) served by
``Predictor.from_checkpoint``, and a PointNetSeg checkpoint that the
port's ``api.fit`` wrote, served.

Tolerance: the reference model runs in f32 eval mode (Conv1d + BN) and
the port serves BN-folded f32, the same function up to reassociation:
1e-4 of max |logit|.
"""

import numpy as np
import pytest
import torch

from pcseg_tpu.ckpt.torch_import import (
    export_torch_state_dict as jax_export,
    import_torch_state_dict as jax_import,
)
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt import torch_import as ti
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.infer import Predictor, inference_example
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from tests.torch_ref import RefPointNetSeg

torch.set_num_threads(1)


def reference_model(num_classes=4, seed=0) -> RefPointNetSeg:
    """The reference architecture with torch's init and random BN terms
    and running statistics, in eval mode."""
    torch.manual_seed(seed)
    model = RefPointNetSeg(num_classes=num_classes)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return model.eval()


def write_best_model_pth(path, model, num_classes=4, prefix="module."):
    """A checkpoint in the reference's layout (its training loop saves
    the DataParallel model's state_dict, keys under ``module.``)."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.save({
        "epoch": 7,
        "model_state_dict": {prefix + k: v for k, v in
                             model.state_dict().items()},
        "optimizer_state_dict": opt.state_dict(),
        "train_loss": 0.5, "val_loss": 0.6, "f1_class2": 0.3,
        "f1_per_class": [0.9, 0.8, 0.3, 0.7],
        "num_classes": num_classes,
    }, path)
    return path


@pytest.mark.parametrize("prefix", ["", "module."])
def test_import_and_export_match_jax(prefix):
    sd = {prefix + k: v for k, v in reference_model().state_dict().items()}
    got = ti.import_torch_state_dict(sd)
    want = jax_import(sd)
    for coll in ("params", "batch_stats"):
        assert got[coll].keys() == want[coll].keys()
        for name, group in want[coll].items():
            assert got[coll][name].keys() == group.keys()
            for leaf, arr in group.items():
                np.testing.assert_array_equal(got[coll][name][leaf], arr)
    out, ref = ti.export_torch_state_dict(got), jax_export(want)
    assert out.keys() == ref.keys()
    for k, arr in ref.items():
        assert out[k].dtype == arr.dtype, k
        np.testing.assert_array_equal(out[k], arr)


def test_best_model_pth_served_matches_reference(tmp_path):
    model = reference_model()
    path = write_best_model_pth(str(tmp_path / "best_model.pth"), model)
    state, meta = ti.load_best_model_pth(path)
    assert meta["num_classes"] == 4 and meta["epoch"] == 7
    assert "model_state_dict" not in meta
    assert "optimizer_state_dict" not in meta
    pred = Predictor.from_checkpoint(path, device="cpu")
    rng = np.random.default_rng(0)
    for n in (50, 300):
        pts = rng.normal(size=(n, 4)).astype(np.float32)
        with torch.no_grad():
            ref = model(torch.from_numpy(pts)[None])[0].numpy()
        got = pred.logits(pts)
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), err
        np.testing.assert_array_equal(
            api.predict(path, pts, device="cpu"), got.argmax(-1))
    preds = inference_example(path, [(pts, ref.argmax(-1))], 0,
                              log=lambda _: None, device="cpu")
    np.testing.assert_array_equal(preds, got.argmax(-1))


def test_fit_checkpoint_served(tmp_path):
    """A PointNetSeg checkpoint of the port's api.fit, served folded and
    unfolded, and through inference_example."""
    events = list(synthetic_events(10, min_points=30, max_points=100,
                                   seed=12))
    res = api.fit(events, device="cpu", log=lambda _: None,
                  overrides=["model.compute_dtype=bfloat16",
                             "data.batch_size=4", "data.buckets=64,128",
                             "train.num_epochs=1", "train.log_every_steps=0",
                             f"train.checkpoint_dir={tmp_path}"])
    folded = Predictor.from_checkpoint(res.checkpoint_path, device="cpu")
    # the unfolded model in f32 (the trained one computes in bf16)
    plain = Predictor.from_checkpoint(res.checkpoint_path, device="cpu",
                                      fold=False,
                                      model=PointNetSeg(res.num_classes))
    pts, labels = events[3]
    ref = plain.logits(pts)
    got = folded.logits(pts)
    assert got.shape == (pts.shape[0], res.num_classes)
    assert float(np.abs(got - ref).max()) <= 1e-5 * float(
        np.abs(ref).max())
    logs = []
    preds = inference_example(res.checkpoint_path, events, 3,
                              log=logs.append, device="cpu")
    np.testing.assert_array_equal(preds, got.argmax(-1))
    assert logs and "accuracy" in logs[0]
