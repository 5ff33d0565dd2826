"""Observability in the port: the JAX package's tests/test_observe.py
ported to ``pcseg_tpu_torch.utils.observe``, and the training loop's use
of it: the metrics log, the profiler trace of the first epoch (with the
voxel U-Net's stage names) and ``debug_nans``."""

import json
import os

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import latest_path
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.utils.observe import (
    TRACE_NAME,
    MetricsLogger,
    StepTimer,
    named_scope,
    profile_trace,
)

torch.set_num_threads(1)

VOXEL = ["model.name=voxel_unet3d", "model.grid_size=8",
         "model.unet_width=16", "model.levels=2",
         "model.compute_dtype=bfloat16", "data.batch_size=4",
         "data.buckets=64,128", "train.log_every_steps=0"]


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    lg = MetricsLogger(path)
    lg.log(0, {"loss": 1.5, "acc": 10.0})
    lg.log(1, {"loss": 1.2, "acc": 20.0})
    lg.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert lines[1]["loss"] == 1.2 and "time" in lines[0]


def test_step_timer():
    t = StepTimer()
    assert t.ms is None
    t.tick()
    t.tick()
    assert t.ms is not None and t.ms >= 0


def test_profile_trace_noop_paths(tmp_path):
    # empty dir: no-op
    with profile_trace(""):
        pass
    # real dir: must not raise even if the backend lacks profiling
    with profile_trace(str(tmp_path / "trace")):
        pass


def test_profile_trace_writes_named_scopes(tmp_path):
    with profile_trace(str(tmp_path)):
        with named_scope("voxelize"):
            torch.ones(8).sum()
    trace = json.load(open(tmp_path / TRACE_NAME))
    assert any(ev.get("name") == "voxelize" for ev in trace["traceEvents"])


def _events(n=10, seed=11):
    return list(synthetic_events(n, min_points=30, max_points=100,
                                 seed=seed))


def test_fit_logs_metrics_and_traces_the_first_epoch(tmp_path):
    """``metrics_log``: one JSONL record an epoch, the history's; a
    resumed run appends. ``profile_dir``: a Chrome trace of the first
    epoch run that holds the voxel U-Net's four stages."""
    log = tmp_path / "metrics.jsonl"
    prof = tmp_path / "prof"
    common = VOXEL + [f"train.checkpoint_dir={tmp_path / 'ck'}",
                      f"train.metrics_log={log}"]
    res = api.fit(_events(), device="cpu", log=lambda *a: None,
                  overrides=common + ["train.num_epochs=2",
                                      f"train.profile_dir={prof}"])
    records = [json.loads(ln) for ln in open(log)]
    assert [r["step"] for r in records] == [0, 1]
    for rec, h in zip(records, res.history):
        assert {k: rec[k] for k in h} == json.loads(json.dumps(h))
    names = {ev.get("name") for ev in
             json.load(open(prof / TRACE_NAME))["traceEvents"]}
    assert {"voxelize", "core", "head", "devoxelize"} <= names

    api.fit(_events(), device="cpu", log=lambda *a: None,
            resume_from=latest_path(str(tmp_path / "ck")),
            overrides=common + ["train.num_epochs=3"])
    assert [json.loads(ln)["epoch"] for ln in open(log)] == [0, 1, 2]


def test_fit_without_observers_writes_nothing(tmp_path):
    api.fit(_events(), device="cpu", log=lambda *a: None,
            overrides=VOXEL + ["train.num_epochs=1",
                               f"train.checkpoint_dir={tmp_path}"])
    assert sorted(os.listdir(tmp_path)) == ["best_model.pt", "latest.pt"]


def _nan_events():
    events = list(synthetic_events(24, min_points=50, max_points=200,
                                   seed=5))
    pts, labels = events[3]
    pts = pts.copy()
    pts[7, 3] = np.nan
    events[3] = (pts, labels)
    return events


def test_debug_nans_raises_naming_epoch_and_step(tmp_path):
    """A NaN feature makes the loss and gradients NaN in the step whose
    batch holds it: FloatingPointError naming the epoch and step with
    ``debug_nans``; without it the run goes on and records a NaN loss."""
    common = ["data.batch_size=4", "data.buckets=256",
              "train.num_epochs=1", "train.log_every_steps=0",
              "model.dropout=0.0", f"train.checkpoint_dir={tmp_path}"]
    with pytest.raises(FloatingPointError,
                       match=r"epoch 0, step \d+: non-finite .*loss"):
        api.fit(_nan_events(), device="cpu", log=lambda *a: None,
                overrides=common + ["train.debug_nans=true"])
    res = api.fit(_nan_events(), device="cpu", log=lambda *a: None,
                  overrides=common)
    assert np.isnan(res.history[0]["train_loss"])
    # finite data: the flag stays silent
    res = api.fit(_events(24, 5), device="cpu", log=lambda *a: None,
                  overrides=common + ["train.debug_nans=true"])
    assert np.isfinite(res.history[0]["train_loss"])
