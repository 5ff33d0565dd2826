"""The port's CLI (``python -m pcseg_tpu_torch.cli``), in process on the
CPU: synth -> train -> infer -> eval -> convert (.pt -> .pth -> .pt), as
tests/test_cli.py drives the JAX one; ``--resume auto``; a JAX checkpoint
directory to a ``.pth``; and no start without a card unless
``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api
from pcseg_tpu_torch.cli import main
from pcseg_tpu_torch.data.hdf5 import PointCloudDataset
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.infer import Predictor, inference_example
from tests import test_torch_jax_checkpoint as jc

torch.set_num_threads(1)

TRAIN = ["data.batch_size=8", "data.buckets=256", "train.log_every_steps=0",
         "model.compute_dtype=float32"]


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_synth_train_infer_eval_convert(tmp_path, capsys):
    data, labels = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    assert main(["synth", "--data", data, "--labels", labels, "--events",
                 "32", "--min-points", "50", "--max-points", "200"]) == 0
    out = _last(capsys)
    assert out["events"] == 32 and out["write_seconds"] >= 0
    with PointCloudDataset(data, labels) as ds:
        want = list(synthetic_events(32, min_points=50, max_points=200))
        for i, (p, y) in enumerate(want):
            got_p, got_y = ds[i]
            assert got_p.tobytes() == p.tobytes()
            assert got_y.tobytes() == y.tobytes()

    ckdir = str(tmp_path / "ck")
    assert main(["train", "--data", data, "--labels", labels, *TRAIN,
                 "train.num_epochs=1", f"train.checkpoint_dir={ckdir}",
                 "--device", "cpu"]) == 0
    out = _last(capsys)
    assert out["best_epoch"] == 0
    ckpt = out["checkpoint"]
    ref = api.fit(data_path=data, label_path=labels, device="cpu",
                  log=lambda *a: None,
                  overrides=TRAIN + ["train.num_epochs=1",
                                     f"train.checkpoint_dir={tmp_path}/r"])
    assert out["best_val_loss"] == ref.best_val_loss

    assert main(["infer", "--checkpoint", ckpt, "--data", data, "--labels",
                 labels, "--event", "1", "--dump", "--device", "cpu"]) == 0
    out = _last(capsys)
    pred = Predictor.from_checkpoint(ckpt, device="cpu")
    with PointCloudDataset(data, labels) as ds:
        points, true = ds[1]
    assert out["num_points"] == points.shape[0]
    assert out["predictions"] == pred.predict(points).tolist()
    assert out["accuracy"] == float((pred.predict(points) == true).mean()) \
        * 100.0

    assert main(["eval", "--checkpoint", ckpt, "--data", data, "--labels",
                 labels, "--device", "cpu"]) == 0
    out = _last(capsys)
    want = api.evaluate(ckpt, data_path=data, label_path=labels,
                        device="cpu")
    want.pop("confusion")
    assert out == json.loads(json.dumps(want))

    # convert to .pth and back, and predict from both
    pth, back = str(tmp_path / "model.pth"), str(tmp_path / "back.pt")
    assert main(["convert", ckpt, pth]) == 0
    assert _last(capsys)["to"] == "pth"
    assert main(["convert", pth, back]) == 0
    assert _last(capsys)["num_classes"] == 4
    pts = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    pa, pb, pc = (Predictor.from_checkpoint(p, device="cpu")
                  for p in (ckpt, pth, back))
    np.testing.assert_allclose(pa.logits(pts), pb.logits(pts), atol=1e-5,
                               rtol=1e-5)
    assert pb.logits(pts).tobytes() == pc.logits(pts).tobytes()


def test_demo_and_inference_example_on_files(tmp_path, capsys):
    """``train --demo`` runs the reference's demo after training:
    ``inference_example`` on event 0 of the HDF5 files."""
    data, labels = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    main(["synth", "--data", data, "--labels", labels, "--events", "16",
          "--min-points", "50", "--max-points", "200"])
    assert main(["train", "--data", data, "--labels", labels, *TRAIN,
                 "train.num_epochs=1", f"train.checkpoint_dir={tmp_path}",
                 "--demo", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ckpt = json.loads(lines[-2])["checkpoint"]
    with PointCloudDataset(data, labels) as ds:
        preds = inference_example(ckpt, ds, 0, log=lambda *a: None,
                                  device="cpu")
        points, true = ds[0]
    want = Predictor.from_checkpoint(ckpt, device="cpu").predict(points)
    assert preds.tolist() == want.tolist()
    acc = float((want == true).mean()) * 100.0
    assert lines[-1] == (f"event 0: {points.shape[0]} points, accuracy "
                         f"{acc:.2f}%")


def test_cli_resume_auto(tmp_path, capsys):
    data, labels = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    main(["synth", "--data", data, "--labels", labels, "--events", "24",
          "--min-points", "50", "--max-points", "200"])
    ck = str(tmp_path / "ck")
    common = ["train", "--data", data, "--labels", labels, *TRAIN,
              f"train.checkpoint_dir={ck}", "train.patience=10",
              "--device", "cpu", "--resume", "auto"]
    # no latest.pt yet: a fresh run
    assert main(common + ["train.num_epochs=1"]) == 0
    capsys.readouterr()
    assert main(common + ["train.num_epochs=2"]) == 0
    resumed = capsys.readouterr().out
    assert f"resumed from {ck}/latest.pt at epoch 1" in resumed
    assert "epoch 2/2" in resumed and "epoch 1/2" not in resumed


def test_cli_converts_a_jax_directory(tmp_path, capsys):
    variables = jc._variables("pointnet_seg")
    path = jc._jax_dir(str(tmp_path / "jax"), "pointnet_seg", variables)
    pth = str(tmp_path / "m.pth")
    assert main(["convert", path, pth]) == 0
    assert _last(capsys) == {"converted": pth, "to": "pth"}
    saved = torch.load(pth, weights_only=True)
    assert saved["epoch"] == 3 and saved["num_classes"] == 4
    pts = np.random.default_rng(1).normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        Predictor.from_checkpoint(pth, device="cpu").logits(pts),
        Predictor.from_checkpoint(path, device="cpu").logits(pts),
        atol=1e-5, rtol=1e-5)
    voxel = jc._jax_dir(str(tmp_path / "vox"), "voxel_unet3d",
                        jc._variables("voxel_unet3d"))
    with pytest.raises(ValueError, match="PointNetSeg only"):
        main(["convert", voxel, str(tmp_path / "v.pth")])


def test_cli_needs_a_card_unless_cpu(tmp_path, monkeypatch, capsys):
    data, labels = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    main(["synth", "--data", data, "--labels", labels, "--events", "8"])
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--data", data, "--labels", labels],
                 ["infer", "--checkpoint", "x.pt", "--data", data,
                  "--labels", labels],
                 ["eval", "--checkpoint", "x.pt", "--data", data,
                  "--labels", labels]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit(data_path=data, label_path=labels)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.evaluate("x.pt", data_path=data, label_path=labels)
