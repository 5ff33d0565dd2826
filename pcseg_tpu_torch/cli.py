"""CLI (counterpart of pcseg_tpu/cli.py):
``python -m pcseg_tpu_torch.cli {synth,train,infer,eval,convert} [...]``.

- ``synth``: synthetic event files in the reference schema, written by
  the port's HDF5 writer (``data/hdf5.py``);
- ``train``: ``api.fit`` on HDF5 event files, with ``section.field=value``
  overrides and ``--resume PATH|auto`` (``auto``: the run's
  ``<checkpoint_dir>/latest.pt`` where it exists);
- ``infer``: one event of the files through ``Predictor``;
- ``eval``: ``api.evaluate`` of a checkpoint on the files;
- ``convert``: a reference ``best_model.pth`` to the port's checkpoint
  file, or the port's checkpoint or a JAX checkpoint directory (a
  PointNetSeg) to a ``.pth``.

Each prints one JSON line last, as the JAX commands do. ``train``,
``infer`` and ``eval`` run on CUDA unless given ``--device cpu`` (the
plain versions), and refuse to start without a card otherwise. The JAX
package's ``export`` and ``bench`` are not ported (ROADMAP A7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from pcseg_tpu_torch.core.config import Config, apply_overrides
from pcseg_tpu_torch.core.device import resolve_device


def _device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions (default: CUDA)")


def cmd_train(args) -> int:
    from pcseg_tpu_torch.api import fit
    from pcseg_tpu_torch.ckpt.checkpoint import latest_path
    from pcseg_tpu_torch.data.hdf5 import PointCloudDataset
    from pcseg_tpu_torch.infer import inference_example

    cfg = Config()
    if args.data:
        cfg.data.data_path = args.data
    if args.labels:
        cfg.data.label_path = args.labels
    apply_overrides(cfg, args.overrides)
    resume_from = args.resume
    if resume_from == "auto":
        candidate = latest_path(cfg.train.checkpoint_dir)
        resume_from = candidate if os.path.isfile(candidate) else None
    result = fit(config=cfg, resume_from=resume_from, device=args.device)
    print(json.dumps({"best_epoch": result.best_epoch,
                      "best_f1_target": result.best_f1_target,
                      "best_val_loss": result.best_val_loss,
                      "checkpoint": result.checkpoint_path}))
    if args.demo:
        # the reference's __main__: the inference demo after training,
        # whose failure is reported and does not fail the run
        try:
            with PointCloudDataset(cfg.data.data_path, cfg.data.label_path,
                                   feature_dim=cfg.model.input_dim) as ds:
                inference_example(result.checkpoint_path, ds, event_idx=0,
                                  device=args.device)
        except Exception as e:  # noqa: BLE001 (reported, as pcs.py:473-477)
            print(f"inference demo failed: {e!r}", file=sys.stderr)
    return 0


def cmd_infer(args) -> int:
    from pcseg_tpu_torch.data.hdf5 import PointCloudDataset
    from pcseg_tpu_torch.infer import Predictor

    predictor = Predictor.from_checkpoint(args.checkpoint, device=args.device)
    with PointCloudDataset(args.data, args.labels,
                           feature_dim=predictor.input_dim) as ds:
        points, true_labels = ds[args.event]
    preds = predictor.predict(points)
    print(json.dumps({
        "event": args.event, "num_points": int(points.shape[0]),
        "accuracy": float((preds == true_labels).mean()) * 100.0,
        "predictions": preds.tolist() if args.dump else None}))
    return 0


def cmd_eval(args) -> int:
    from pcseg_tpu_torch.api import evaluate

    m = evaluate(args.checkpoint, data_path=args.data,
                 label_path=args.labels, device=args.device)
    m.pop("confusion")
    print(json.dumps(m))
    return 0


def cmd_synth(args) -> int:
    from pcseg_tpu_torch.data.hdf5 import write_event_files
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(
        args.events, num_classes=args.classes, min_points=args.min_points,
        max_points=args.max_points, seed=args.seed))
    t0 = time.perf_counter()
    n = write_event_files(args.data, args.labels, events)
    print(json.dumps({"events": n, "data": args.data, "labels": args.labels,
                      "write_seconds": time.perf_counter() - t0}))
    return 0


def cmd_convert(args) -> int:
    import numpy as np
    import torch

    from pcseg_tpu_torch.ckpt.checkpoint import (
        load_checkpoint,
        load_train_state,
        save_checkpoint,
    )
    from pcseg_tpu_torch.ckpt.torch_import import (
        export_torch_state_dict,
        load_best_model_pth,
    )
    from pcseg_tpu_torch.core.config import ModelConfig
    from pcseg_tpu_torch.models.factory import build_model

    if args.src.endswith(".pth"):
        state, meta = load_best_model_pth(args.src)
        save_checkpoint(args.dst, state, int(meta["num_classes"]),
                        ModelConfig(), metadata=meta)
        print(json.dumps({"converted": args.dst, "from": "pth", **{
            k: meta[k] for k in ("num_classes", "epoch") if k in meta}}))
        return 0
    state, num_classes, cfg = load_checkpoint(args.src)
    if cfg.name != "pointnet_seg":
        raise ValueError(f"{args.src} holds a {cfg.name}; the reference's "
                         ".pth holds a PointNetSeg only")
    _, meta = load_train_state(args.src)
    model = build_model(cfg, num_classes)
    model.load_state_dict(state)
    sd = export_torch_state_dict({"params": model.params(),
                                  "batch_stats": model.batch_stats()})
    torch.save({
        "epoch": meta.get("epoch", 0),
        "model_state_dict": {k: torch.from_numpy(np.asarray(v))
                             for k, v in sd.items()},
        "optimizer_state_dict": {},
        "train_loss": meta.get("train_loss", 0.0),
        "val_loss": meta.get("val_loss", 0.0),
        "f1_class2": meta.get("f1_class_target", 0.0),
        "f1_per_class": meta.get("f1_per_class", []),
        "num_classes": num_classes,
    }, args.dst)
    print(json.dumps({"converted": args.dst, "to": "pth"}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pcseg_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model on HDF5 event files")
    p.add_argument("--data", help="HDF5 points file")
    p.add_argument("--labels", help="HDF5 labels file")
    p.add_argument("--demo", action="store_true",
                   help="run the inference demo after training")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from; 'auto' resumes from "
                   "<checkpoint_dir>/latest.pt when present")
    p.add_argument("overrides", nargs="*",
                   help="config overrides, e.g. optim.lr=3e-4 "
                   "data.batch_size=32")
    _device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("infer", help="predict one event from a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--event", type=int, default=0)
    p.add_argument("--dump", action="store_true", help="print predictions")
    _device(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("eval", help="evaluate a checkpoint on event files")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--labels", required=True)
    _device(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("synth", help="write synthetic event files")
    p.add_argument("--data", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--events", type=int, default=1000)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--min-points", type=int, default=100)
    p.add_argument("--max-points", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser(
        "convert", help="best_model.pth -> the port's checkpoint, or the "
        "port's checkpoint / a JAX checkpoint directory -> .pth (direction "
        "from the .pth extension of src)")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_convert)

    # overrides may also come after options (parse_args takes one run of
    # positionals)
    args, extra = parser.parse_known_args(argv)
    if args.cmd == "train":
        args.overrides += [x for x in extra if not x.startswith("-")]
        extra = [x for x in extra if x.startswith("-")]
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if "device" in args:
        resolve_device(args.device)     # no card: refuse before any work
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
