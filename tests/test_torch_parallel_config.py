"""train.parallelism in the port (the JAX tests/test_parallel_config.py):
``api.fit`` with ``train.parallelism=dp`` on two gloo ranks (a FileStore,
started once for the module by ``tests/torch_dp_worker.py``), ``cli
train`` joining a group of its own from ``train.coordinator_address``,
and the strategies that are not ported yet.

- both ranks of ``api.fit`` end with equal histories and equal
  parameters, rank 0 alone writes checkpoints, and
  ``Predictor.from_checkpoint`` serves the best one here;
- with sync-BN (the global statistics) the history equals one process's
  run of the same config: the losses to 1e-5 relative, the accuracies
  and F1 equal. The learning rate is 1e-6: Adam's first steps move a
  weight by about lr * sign(grad), so at 1e-3 a near-zero gradient whose
  sign the other summation order flips moves the runs apart by ~1e-3 a
  weight, which says nothing about the loop;
- ``cli train`` on two ranks: rank 0 alone prints its JSON line, both
  leave the group they joined;
- a batch size not divisible by the data axis raises ValueError; "sp",
  "tp" and "gp" raise NotImplementedError naming their ROADMAP item after
  the JAX family checks' ValueErrors; an unknown strategy raises "unknown
  train.parallelism"; a model axis above 1 raises NotImplementedError.
"""

import json
import os

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api
from pcseg_tpu_torch.data.hdf5 import write_event_files
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.parallel.mesh import Mesh
from tests.torch_dp_worker import run_ranks

torch.set_num_threads(1)

OVERRIDES = ["data.batch_size=4", "data.buckets=64,128",
             "train.num_epochs=2", "train.log_every_steps=0",
             "model.dropout=0.0", "train.sync_batchnorm=true",
             "data.prefetch_depth=0", "optim.lr=1e-6"]


def _events():
    return list(synthetic_events(14, min_points=30, max_points=100,
                                 seed=11))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dpfit"))
    events = _events()
    data, labels = (os.path.join(tmp, n) for n in ("d.h5", "l.h5"))
    write_event_files(data, labels, events)
    ckpt = os.path.join(tmp, "ck")
    inputs = {
        "fit/points": np.concatenate([e[0] for e in events]),
        "fit/labels": np.concatenate([e[1] for e in events]),
        "fit/sizes": np.asarray([e[0].shape[0] for e in events]),
        "fit/overrides": " ".join(OVERRIDES
                                  + [f"train.checkpoint_dir={ckpt}"]),
        "cli/data": data, "cli/labels": labels,
        "cli/store": os.path.join(tmp, "cli_store"),
        "cli/overrides": " ".join(
            OVERRIDES[:4] + ["train.num_epochs=1",
                             f"train.checkpoint_dir={tmp}/cli_ck"])}
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs)
    return run_ranks("cli,fit", path, tmp), ckpt


def test_dp_fit_ranks_agree_and_rank0_writes(ranks):
    (r0, r1), ckpt = ranks
    for k in r0:
        if k.startswith("fit/") and k != "fit/writes":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r1["fit/writes"]) == 0
    assert int(r0["fit/writes"]) >= 2     # the best and 'latest' at least
    pred = Predictor.from_checkpoint(os.path.join(ckpt, "best_model.pt"),
                                     device="cpu")
    points = _events()[0][0]
    assert pred.predict(points).shape == (points.shape[0],)


def test_dp_fit_matches_one_process(ranks, tmp_path):
    """Synced statistics make the 2-rank run the one-process run (the
    module docstring)."""
    (r0, _), _ = ranks
    res = api.fit(_events(), device="cpu", log=lambda _: None,
                  overrides=OVERRIDES + [f"train.checkpoint_dir={tmp_path}"])
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(r0[f"fit/history/{k}"],
                                   [h[k] for h in res.history], rtol=1e-5)
    for k in ("train_acc", "val_acc", "f1_target"):
        np.testing.assert_array_equal(r0[f"fit/history/{k}"],
                                      [h[k] for h in res.history])
    assert int(r0["fit/best_epoch"]) == res.best_epoch


def test_cli_train_on_two_ranks(ranks):
    (r0, r1), _ = ranks
    assert int(r0["cli/rc"]) == int(r1["cli/rc"]) == 0
    line = json.loads(str(r0["cli/stdout"]).strip().splitlines()[-1])
    assert line["checkpoint"].endswith("best_model.pt")
    assert str(r1["cli/stdout"]).strip() == ""
    assert bool(r0["cli/left_group"]) and bool(r1["cli/left_group"])


def test_batch_not_divisible_by_the_data_axis_raises(tmp_path):
    mesh = Mesh(2, 0, torch.device("cpu"), distributed=False)
    with pytest.raises(ValueError, match="divisible"):
        api.fit(_events(), device="cpu", log=lambda _: None, mesh=mesh,
                overrides=["data.batch_size=3", "data.buckets=128",
                           f"train.checkpoint_dir={tmp_path}"])


@pytest.mark.parametrize("strategy,family,error,match", [
    ("sp", "pointnet_seg", NotImplementedError, "A9d"),
    ("tp", "pointnet_seg", NotImplementedError, "A9c"),
    ("gp", "voxel_unet3d", NotImplementedError, "A9b"),
    ("sp", "voxel_unet3d", ValueError, "pointnet_seg"),
    ("tp", "sparse_voxelnet", ValueError, "pointnet_seg"),
    ("gp", "pointnet_seg", ValueError, "voxel_unet3d"),
    ("pp", "pointnet_seg", ValueError, "unknown train.parallelism")])
def test_strategies(tmp_path, strategy, family, error, match):
    with pytest.raises(error, match=match):
        api.fit(_events(), device="cpu", log=lambda _: None, overrides=[
            f"model.name={family}", "model.grid_size=8",
            "model.unet_width=8", "data.buckets=128",
            f"train.parallelism={strategy}",
            f"train.checkpoint_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_model_axis_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="model-axis"):
        api.fit(_events(), device="cpu", log=lambda _: None, overrides=[
            "train.model_parallel=2", f"train.checkpoint_dir={tmp_path}"])
