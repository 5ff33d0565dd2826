"""Resume and the 'latest' checkpoint in the port's training loop, on the
CPU: the JAX package's own tests of them (tests/test_checkpoint.py)
ported, and what a resume restores.

- a resumed run continues at the checkpoint's epoch + 1; 'latest' is
  written every epoch by default, after selection, with the JAX keys;
- the selection state survives a resume (a worse epoch after it leaves
  the best checkpoint alone; patience keeps counting);
- the parameters, Adam's moments and the step come back exactly;
- dropout seeds are a function of (seed, epoch, step), so a resumed
  epoch draws the uninterrupted run's.
"""

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import (
    latest_path,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
from pcseg_tpu_torch.core.config import Config
from pcseg_tpu_torch.train import loop
from pcseg_tpu_torch.train.loop import train_model
from pcseg_tpu_torch.train.steps import dropout_seeds

torch.set_num_threads(1)

QUIET = dict(device="cpu", log=lambda *a: None)


def _cfg(tmp_path, epochs, **train):
    cfg = Config()
    cfg.data.batch_size = 8
    cfg.data.buckets = (512,)
    cfg.train.num_epochs = epochs
    cfg.train.patience = 10
    cfg.train.log_every_steps = 0
    cfg.train.checkpoint_dir = str(tmp_path)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def test_resume_from_checkpoint(tmp_path, small_events):
    """tests/test_checkpoint.py::test_resume_from_checkpoint."""
    cfg = _cfg(tmp_path, 2)
    ds = api.ArrayDataset(small_events)
    res1 = train_model(cfg, ds, **QUIET)
    assert res1.history[-1]["epoch"] == 1

    cfg.train.num_epochs = 3
    res2 = train_model(cfg, ds, resume_from=res1.checkpoint_path, **QUIET)
    start = res2.history[0]["epoch"]
    assert start >= 1  # did not restart from scratch
    assert res2.history[-1]["epoch"] == 2
    assert res2.state.step > 0


def test_latest_checkpoint_written(tmp_path, small_events):
    """tests/test_checkpoint.py::test_latest_checkpoint_written, with the
    JAX metadata keys and the step."""
    cfg = _cfg(tmp_path, 1)
    res = train_model(cfg, api.ArrayDataset(small_events), **QUIET)
    _, meta = load_train_state(latest_path(str(tmp_path)))
    assert meta["epoch"] == 0
    assert {"epoch", "num_classes", "class_weights", "config",
            "best_f1_target", "best_val_loss", "best_epoch",
            "patience_counter", "step"} <= meta.keys()
    assert meta["step"] == res.state.step == res.history[0]["train_steps"]
    assert meta["num_classes"] == res.num_classes


@pytest.mark.parametrize("every, written", [(0, False), (2, False),
                                            (1, True)])
def test_latest_every(tmp_path, small_events, every, written):
    """'latest' every ``save_latest_every`` epochs (0: never)."""
    cfg = _cfg(tmp_path, 1, save_latest_every=every)
    train_model(cfg, api.ArrayDataset(small_events[:12]), **QUIET)
    assert (tmp_path / "latest.pt").exists() == written


def test_resume_restores_selection_state(tmp_path, small_events):
    """tests/test_checkpoint.py::test_resume_restores_selection_state."""
    cfg = _cfg(tmp_path, 1)
    ds = api.ArrayDataset(small_events)
    train_model(cfg, ds, **QUIET)

    latest = latest_path(str(tmp_path))
    sd, nc, mcfg = load_checkpoint(latest)
    opt, meta = load_train_state(latest)
    assert {"best_f1_target", "best_val_loss", "best_epoch",
            "patience_counter"} <= meta.keys()

    # an unbeatable best: the next epoch is "worse" and must leave
    # best_model alone
    meta["best_f1_target"] = 0.99
    meta["best_val_loss"] = 0.0
    meta["patience_counter"] = 2
    save_checkpoint(latest, sd, nc, mcfg, optimizer_state=opt, metadata=meta)
    best = str(tmp_path / cfg.train.checkpoint_name)
    _, best_meta_before = load_train_state(best)

    cfg.train.num_epochs = 2
    res = train_model(cfg, ds, resume_from=latest, **QUIET)
    assert res.best_f1_target == 0.99          # restored, not reset to 0
    assert res.best_epoch == 0                 # unchanged
    _, best_meta_after = load_train_state(best)
    assert best_meta_after == best_meta_before  # best NOT overwritten
    # patience kept counting: 2 restored + 1 non-improving epoch
    _, latest_meta = load_train_state(latest)
    assert latest_meta["patience_counter"] == 3


def test_resume_from_best_falls_back_to_its_metrics(tmp_path, small_events):
    """A best-model checkpoint carries no selection state: its own F1 and
    val loss stand in, with zero patience."""
    cfg = _cfg(tmp_path, 1)
    ds = api.ArrayDataset(small_events)
    res1 = train_model(cfg, ds, **QUIET)
    _, meta = load_train_state(res1.checkpoint_path)
    assert "best_f1_target" not in meta
    # no epoch left to run: the restored selection state comes back as is
    res2 = train_model(cfg, ds, resume_from=res1.checkpoint_path, **QUIET)
    assert res2.history == []
    assert res2.best_f1_target == meta["f1_class_target"]
    assert res2.best_val_loss == meta["val_loss"]
    assert res2.best_epoch == (meta["epoch"] if meta["f1_class_target"] > 0
                               else -1)


@pytest.mark.parametrize("overrides", [
    [],
    ["model.name=voxel_unet3d", "model.grid_size=8", "model.unet_width=16",
     "model.levels=2", "model.compute_dtype=bfloat16", "model.remat=true"],
], ids=["pointnet", "voxel_remat"])
def test_resume_restores_the_state_exactly(tmp_path, small_events,
                                           overrides):
    """Parameters, Adam's moments and step counts, and the train state's
    step, as the run left them."""
    cfg = _cfg(tmp_path, 1)
    from pcseg_tpu_torch.core.config import apply_overrides

    apply_overrides(cfg, overrides)
    ds = api.ArrayDataset(small_events[:16])
    res1 = train_model(cfg, ds, **QUIET)
    res2 = train_model(cfg, ds, resume_from=latest_path(str(tmp_path)),
                       **QUIET)
    assert res2.history == [] and res2.state.step == res1.state.step > 0
    sd1, sd2 = (r.state.model.state_dict() for r in (res1, res2))
    assert sd1.keys() == sd2.keys()
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    o1, o2 = (r.state.optimizer.state_dict() for r in (res1, res2))
    assert o1["param_groups"] == o2["param_groups"]
    assert o1["state"].keys() == o2["state"].keys() and o1["state"]
    for i in o1["state"]:
        for k, v in o1["state"][i].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(o2["state"][i][k])), (i, k)


def test_dropout_seeds_are_stateless():
    a = dropout_seeds(0, 3, 7)
    assert a == dropout_seeds(0, 3, 7)
    assert all(0 <= s < 2 ** 31 for s in a) and a[0] != a[1]
    others = {dropout_seeds(0, 3, 8), dropout_seeds(0, 4, 7),
              dropout_seeds(1, 3, 7)}
    assert a not in others and len(others) == 3


def test_resumed_epoch_draws_the_uninterrupted_runs_seeds(
        tmp_path, small_events, monkeypatch):
    """The dropout seeds of every step of epoch 1: a 2-epoch run against
    1 epoch + a run resumed from 'latest'."""
    drawn = []
    step = loop.train_step

    def recording(state, batch, lr, seeds, cw, **kw):
        drawn.append(seeds)
        return step(state, batch, lr, seeds, cw, **kw)

    monkeypatch.setattr(loop, "train_step", recording)
    ds = api.ArrayDataset(small_events[:24])
    train_model(_cfg(tmp_path / "a", 2), ds, **QUIET)
    whole = list(drawn)
    drawn.clear()
    train_model(_cfg(tmp_path / "b", 1), ds, **QUIET)
    first = list(drawn)
    drawn.clear()
    train_model(_cfg(tmp_path / "b", 2), ds,
                resume_from=latest_path(str(tmp_path / "b")), **QUIET)
    n = len(first)
    assert n and whole[:n] == first
    assert drawn == whole[n:]
    assert drawn == [dropout_seeds(0, 1, i) for i in range(n)]
    # the first epoch's seeds differ from the second's
    assert not set(first) & set(drawn)


def test_fit_resume_from(tmp_path):
    """api.fit(resume_from=) continues a run on the voxel U-Net."""
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(10, min_points=30, max_points=100,
                                   seed=11))
    common = ["model.name=voxel_unet3d", "model.grid_size=8",
              "model.unet_width=16", "model.levels=2",
              "model.compute_dtype=bfloat16", "data.batch_size=4",
              "data.buckets=64,128", "train.log_every_steps=0",
              f"train.checkpoint_dir={tmp_path}"]
    res1 = api.fit(events, overrides=common + ["train.num_epochs=1"],
                   **QUIET)
    res2 = api.fit(events, overrides=common + ["train.num_epochs=2"],
                   resume_from=latest_path(str(tmp_path)), **QUIET)
    assert [h["epoch"] for h in res2.history] == [1]
    assert res2.state.step == 2 * res1.state.step
    assert np.isfinite(res2.history[0]["train_loss"])
