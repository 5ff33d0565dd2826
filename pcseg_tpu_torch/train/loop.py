"""Epoch loop (counterpart of pcseg_tpu/train/loop.py), on one device or
data-parallel, one process per device.

- class scan + weighting on the first <= ``class_scan_events`` events;
- seeded train/val split (train = int((1 - val_fraction) * n));
- per epoch: train pass, val pass, per-class F1 from the val pass's
  confusion matrix, StepLR; the sparse family's dropped tiles (block
  impl) or sites (gather impl) summed over each pass, a warning in the log
  where any was dropped (their points read zero logits), or an error with
  ``model.strict_capacity``;
- train/val loss = mean of the per-batch weighted-CE values;
- best model: higher target-class F1, or equal F1 and lower val loss; the
  best checkpoint is written on improvement (the port's format,
  ckpt/checkpoint.py); early stop after ``patience`` epochs without one.

- the 'latest' checkpoint (ckpt/checkpoint.py ``latest_path``) every
  ``save_latest_every`` epochs, written after selection so that it holds
  this epoch's selection state; ``resume_from`` (a 'latest' or a best
  checkpoint) restores the model, Adam's state and step, and the
  selection state, and continues at the checkpoint's epoch + 1 (a best
  checkpoint falls back to its own metrics and zero patience); a JAX
  checkpoint directory resumes the same way, its optax Adam state mapped
  onto ``torch.optim.Adam``'s (``ckpt.checkpoint.jax_adam_state``);
- one ``MetricsLogger`` record an epoch (``metrics_log``,
  ``tensorboard_dir``), the first epoch run under ``profile_trace`` when
  ``profile_dir`` is set, and ``debug_nans``: FloatingPointError at the
  first non-finite loss or gradient, naming the epoch and step.

Metrics stay on the device during a pass and are read once at its end.
Randomness comes from ``train.seed``: a generator for the parameters, and
dropout seeds per (seed, epoch, step) (``steps.dropout_seeds``). As in
the JAX package, a resumed run's batchers count epochs from 0 again, so
its shuffle orders are those of the first epochs, not the ones an
uninterrupted run would reach.

The dataset is any map-style one (``api.ArrayDataset``, the HDF5
``data.hdf5.PointCloudDataset``). With ``data.prefetch_depth`` above 0
both batchers run in prefetch threads (``data/prefetch.py``) that read,
pack and copy each batch to the device ahead of the step, as the JAX
loop does; the batches and their order do not change.

Parallelism (``train.parallelism``, the JAX ``_make_strategy_*_step``):
"dp" runs the data-parallel steps of train/steps.py over a
``parallel.mesh.Mesh`` (``train.data_parallel`` ranks, the whole process
group by default); "sp", "tp" and "gp" raise NotImplementedError (ROADMAP
A9b-A9d), after the JAX family checks. ``train_model`` first calls
``initialize_distributed`` (``train.coordinator_address``, or ``env://``
under ``torchrun``), then builds the mesh. Every rank builds the same
batchers from the same seeds and reads, packs and copies only its rows of
each batch, at the whole batch's bucket (``BucketBatcher``'s ``shard``);
the metrics it reads are the all-reduced ones, so every rank takes the
same best-model and early-stopping decisions and ends with the same
history and parameters. Rank 0 alone logs and writes checkpoints, the
metrics log and the trace, and the ranks meet at a barrier after each
write; a resume loads on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.checkpoint import (
    latest_path,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
from pcseg_tpu_torch.core.config import Config
from pcseg_tpu_torch.parallel.mesh import (
    MeshSpec,
    init_from_config,
    make_mesh,
)
from pcseg_tpu_torch.data.batching import BucketBatcher
from pcseg_tpu_torch.data.class_stats import scan_classes
from pcseg_tpu_torch.data.prefetch import (
    DevicePlace,
    Prefetcher,
    device_batch,
    prefetch,
)
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.models.sparse_unet import capacity_words
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops.metrics import f1_from_confusion
from pcseg_tpu_torch.train.optim import step_lr
from pcseg_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    dropout_seeds,
    eval_step,
    train_step,
)
from pcseg_tpu_torch.utils.observe import MetricsLogger, profile_trace

_PURPOSES = {"params": 0, "dropout": 1}


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    num_classes: int
    class_weights: np.ndarray
    best_f1_target: float
    best_val_loss: float
    best_epoch: int
    history: list[dict]
    checkpoint_path: str


def purpose_generator(seed: int, purpose: str) -> torch.Generator:
    """A CPU generator per (seed, purpose), so adding a consumer never
    moves the stream of another."""
    return torch.Generator().manual_seed(seed * len(_PURPOSES)
                                         + _PURPOSES[purpose])


def split_indices(n: int, val_fraction: float, seed: int):
    """Seeded split: train = int((1 - val_fraction) * n), val = the rest."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    return perm[:n_train], perm[n_train:]


# the ROADMAP items of the strategies not ported yet
_NOT_PORTED = {"gp": "A9b", "tp": "A9c", "sp": "A9d"}


def _not_ported(strategy, model):
    """The JAX family checks (pcseg_tpu/train/loop.py:73-140), then
    NotImplementedError for a strategy not ported yet; ValueError for an
    unknown one."""
    if strategy in ("sp", "tp") and not isinstance(model, PointNetSeg):
        what = ("shards the point axis" if strategy == "sp"
                else "shards the wide PointNet layers")
        raise ValueError(f"train.parallelism={strategy!r} {what} and needs "
                         f"model.name='pointnet_seg', got "
                         f"{type(model).__name__}")
    if strategy == "gp" and not isinstance(model, VoxelUNet3d):
        raise ValueError("train.parallelism='gp' depth-shards the voxel "
                         "grid and needs model.name='voxel_unet3d', got "
                         f"{type(model).__name__}")
    if strategy in _NOT_PORTED:
        raise NotImplementedError(
            f"train.parallelism={strategy!r} (parallel/{strategy}.py) is "
            f"not ported yet (ROADMAP {_NOT_PORTED[strategy]}); "
            "'dp' runs")
    raise ValueError(f"unknown train.parallelism {strategy!r}; expected "
                     "one of 'dp', 'sp', 'tp', 'gp'")


def _make_strategy_train_step(strategy, model, mesh, sync_bn):
    """The train step of ``train.parallelism``: ``step(state, batch, lr,
    seeds, class_weights, debug_nans=) -> (state, metrics)``."""
    if strategy != "dp":
        _not_ported(strategy, model)
    return functools.partial(train_step, mesh=mesh, sync_batchnorm=sync_bn)


def _make_strategy_eval_step(strategy, model, mesh):
    """The eval step matching ``train.parallelism``: ``step(state, batch,
    class_weights, num_classes) -> metrics``."""
    if strategy != "dp":
        _not_ported(strategy, model)
    return functools.partial(eval_step, mesh=mesh)


def _run_epoch_train(state, batcher, lr, cw, seed, epoch, device, log,
                     log_every=0, debug_nans=False, step=train_step):
    metrics = []
    for i, batch in enumerate(batcher):
        try:
            state, m = step(state, device_batch(batch, device), lr,
                            dropout_seeds(seed, epoch, i), cw,
                            debug_nans=debug_nans)
        except FloatingPointError as e:
            raise FloatingPointError(f"epoch {epoch}, step {i}: {e}") \
                from None
        metrics.append(m)
        if log_every and (i + 1) % log_every == 0:
            log(f"  step {i + 1}: loss {float(m['loss']):.4f}")
    losses = [float(m["loss"]) for m in metrics]
    correct = sum(float(m["correct"]) for m in metrics)
    total = sum(float(m["total"]) for m in metrics)
    loss = float(np.mean(losses)) if losses else 0.0
    acc = 100.0 * correct / total if total > 0 else 0.0
    return loss, acc, len(metrics), _dropped(metrics)


def _dropped(metrics) -> int:
    return sum(int(m["dropped"]) for m in metrics if "dropped" in m)


def _run_epoch_eval(state, batcher, cw, num_classes, device, step=eval_step):
    metrics = [step(state, device_batch(b, device), cw, num_classes)
               for b in batcher]
    losses = [float(m["loss"]) for m in metrics]
    correct = sum(float(m["correct"]) for m in metrics)
    total = sum(float(m["total"]) for m in metrics)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for m in metrics:
        cm += m["confusion"].cpu().numpy()
    loss = float(np.mean(losses)) if losses else 0.0
    acc = 100.0 * correct / total if total > 0 else 0.0
    return loss, acc, cm, _dropped(metrics)


def _selection_state(meta: dict):
    """(best_f1_target, best_val_loss, best_epoch, patience_counter) of a
    resumed run: a 'latest' checkpoint's own, a best checkpoint's metrics
    and zero patience, or a fresh run's start (JAX
    pcseg_tpu/train/loop.py:322-339)."""
    best_f1 = float(meta.get("best_f1_target",
                             meta.get("f1_class_target", 0.0)))
    best_loss = float(meta.get("best_val_loss",
                               meta.get("val_loss", float("inf"))))
    best_epoch = int(meta.get("best_epoch", meta.get("epoch", -1))
                     if best_f1 > 0.0 or "best_epoch" in meta else -1)
    return best_f1, best_loss, best_epoch, int(meta.get("patience_counter",
                                                        0))


def train_model(cfg: Config, dataset, *, device=None, resume_from=None,
                log=print, mesh=None) -> TrainResult:
    """Full training run on a map-style dataset of (points, labels)
    events. ``device``: None for CUDA (this rank's card), ``"cpu"`` for
    the plain versions. ``resume_from``: a checkpoint this function wrote
    (usually ``<checkpoint_dir>/latest.pt``) or a JAX checkpoint directory
    of a TrainState to continue from. ``mesh``: the data axis to train
    over (None: ``make_mesh`` from ``train.data_parallel`` /
    ``model_parallel`` over the process group, after
    ``initialize_distributed``)."""
    t_cfg, d_cfg, m_cfg = cfg.train, cfg.data, cfg.model
    # the rendezvous before the first device query (a no-op without an
    # address, the single-process default)
    init_from_config(t_cfg, device)
    if mesh is None:
        mesh = make_mesh(MeshSpec(data=t_cfg.data_parallel,
                                  model=t_cfg.model_parallel), device=device)
    dev = mesh.device
    lead = mesh.rank == 0
    if not lead:
        log = lambda *_: None  # noqa: E731

    stats = scan_classes(dataset, scan_events=d_cfg.class_scan_events,
                         target_class=t_cfg.target_class,
                         target_boost=t_cfg.target_class_weight_boost)
    num_classes = m_cfg.num_classes or stats.num_classes
    class_weights = stats.weights
    if len(class_weights) != num_classes:
        w = np.ones(num_classes, np.float32)
        w[: len(class_weights)] = class_weights
        class_weights = w
    log(f"classes: {num_classes}, counts: {stats.counts}")
    log(f"class weights: {np.round(class_weights, 3).tolist()}")

    train_idx, val_idx = split_indices(len(dataset), d_cfg.val_fraction,
                                       d_cfg.split_seed)
    train_batcher = BucketBatcher(
        dataset, d_cfg.batch_size, buckets=d_cfg.buckets, indices=train_idx,
        shuffle=True, seed=d_cfg.shuffle_seed, feature_dim=m_cfg.input_dim,
        shard=(mesh.rank, mesh.data))
    val_batcher = BucketBatcher(
        dataset, d_cfg.batch_size, buckets=d_cfg.buckets, indices=val_idx,
        shuffle=False, feature_dim=m_cfg.input_dim,
        shard=(mesh.rank, mesh.data))
    log(f"train events: {len(train_idx)}, val events: {len(val_idx)}")

    model = build_model(m_cfg, num_classes,
                        generator=purpose_generator(t_cfg.seed, "params"))
    step_fn = _make_strategy_train_step(t_cfg.parallelism, model, mesh,
                                        t_cfg.sync_batchnorm)
    eval_fn = _make_strategy_eval_step(t_cfg.parallelism, model, mesh)
    start_epoch, resume_meta = 0, {}
    if resume_from:
        sd, _, _ = load_checkpoint(resume_from)
        model.load_state_dict(sd)
    state = create_train_state(model.to(dev), cfg.optim)
    if resume_from:
        opt_state, resume_meta = load_train_state(
            resume_from, state.model, state.optimizer)
        if opt_state is not None:
            state.optimizer.load_state_dict(opt_state)
        state.step = int(resume_meta.get("step", 0))
        start_epoch = int(resume_meta.get("epoch", -1)) + 1
        log(f"resumed from {resume_from} at epoch {start_epoch}")
    cw = torch.from_numpy(class_weights).to(dev)
    ckpt_path = os.path.join(t_cfg.checkpoint_dir, t_cfg.checkpoint_name)
    metrics_logger = MetricsLogger(
        (t_cfg.metrics_log or None) if lead else None,
        t_cfg.tensorboard_dir if lead else "")

    best_f1_target, best_val_loss, best_epoch, patience_counter = \
        _selection_state(resume_meta)
    history: list[dict] = []
    o_cfg = cfg.optim
    # prefetch threads read, pack and copy ahead of the step (JAX
    # pcseg_tpu/train/loop.py:298-306)
    if d_cfg.prefetch_depth > 0:
        place = DevicePlace(dev)
        train_iter = prefetch(train_batcher, d_cfg.prefetch_depth, place)
        val_iter = prefetch(val_batcher, d_cfg.prefetch_depth, place)
    else:
        train_iter, val_iter = train_batcher, val_batcher
    try:
        for epoch in range(start_epoch, t_cfg.num_epochs):
            lr = step_lr(o_cfg.lr, epoch, o_cfg.lr_step_epochs, o_cfg.lr_gamma)
            t0 = time.perf_counter()
            state.model.train()
            trace = (profile_trace(t_cfg.profile_dir)
                     if t_cfg.profile_dir and epoch == start_epoch and lead
                     else contextlib.nullcontext())
            with trace:
                train_loss, train_acc, steps, train_dropped = _run_epoch_train(
                    state, train_iter, lr, cw, t_cfg.seed, epoch, dev, log,
                    t_cfg.log_every_steps, t_cfg.debug_nans, step_fn)
            t_train = time.perf_counter() - t0
            state.model.eval()
            val_loss, val_acc, cm, val_dropped = _run_epoch_eval(
                state, val_iter, cw, num_classes, dev, eval_fn)
            if train_dropped or val_dropped:
                what, knob = capacity_words(m_cfg.impl)
                msg = (f"capacity overflow: {train_dropped} train / "
                       f"{val_dropped} val occupied {what} beyond the static "
                       f"capacity this epoch (raise model.{knob})")
                if m_cfg.strict_capacity:
                    raise RuntimeError(msg)
                log(f"WARNING: {msg}")
            f1 = f1_from_confusion(cm)
            f1_target = (float(f1.per_class[t_cfg.target_class])
                         if len(f1.per_class) > t_cfg.target_class else 0.0)
            dt = time.perf_counter() - t0
            record = {
                "epoch": epoch, "lr": lr, "train_loss": train_loss,
                "train_acc": train_acc, "val_loss": val_loss,
                "val_acc": val_acc,
                "f1_macro": f1.macro, "f1_weighted": f1.weighted,
                "f1_per_class": f1.per_class.tolist(), "f1_target": f1_target,
                "dropped_train": train_dropped, "dropped_val": val_dropped,
                "train_steps": steps, "train_seconds": t_train, "seconds": dt,
            }
            history.append(record)
            metrics_logger.log(epoch, record)
            log(f"epoch {epoch + 1}/{t_cfg.num_epochs}: "
                f"train {train_loss:.4f}/{train_acc:.2f}% "
                f"val {val_loss:.4f}/{val_acc:.2f}% "
                f"f1[c{t_cfg.target_class}] {f1_target:.4f} "
                f"macro {f1.macro:.4f} lr {lr:.6f} ({dt:.1f}s)")

            improved = False
            if f1_target > best_f1_target:
                best_f1_target, best_val_loss = f1_target, val_loss
                improved = True
            elif f1_target == best_f1_target and val_loss < best_val_loss:
                best_val_loss, improved = val_loss, True
            if improved:
                patience_counter = 0
                best_epoch = epoch
            if improved and lead:
                save_checkpoint(
                    ckpt_path, state.model.state_dict(), num_classes, m_cfg,
                    optimizer_state=state.optimizer.state_dict(),
                    metadata={
                        "epoch": epoch, "step": state.step,
                        "train_loss": train_loss, "val_loss": val_loss,
                        "f1_class_target": f1_target,
                        "f1_per_class": f1.per_class.tolist(),
                        "class_weights": class_weights.tolist(),
                        "config": cfg.to_dict(),
                    })
                log(f"saved best checkpoint (f1={f1_target:.4f}) -> "
                    f"{ckpt_path}")
            elif not improved:
                patience_counter += 1
                log(f"no improvement for {patience_counter}/{t_cfg.patience} "
                    "epochs")
            # the resume target, after selection so that it holds this
            # epoch's selection state
            if lead and t_cfg.save_latest_every > 0 and \
                    (epoch + 1) % t_cfg.save_latest_every == 0:
                save_checkpoint(
                    latest_path(t_cfg.checkpoint_dir),
                    state.model.state_dict(),
                    num_classes, m_cfg,
                    optimizer_state=state.optimizer.state_dict(),
                    metadata={
                        "epoch": epoch, "step": state.step,
                        "num_classes": num_classes,
                        "class_weights": class_weights.tolist(),
                        "config": cfg.to_dict(),
                        "best_f1_target": best_f1_target,
                        "best_val_loss": best_val_loss,
                        "best_epoch": best_epoch,
                        "patience_counter": patience_counter,
                    })
            # no rank runs ahead of rank 0's writes
            mesh.barrier()
            if patience_counter >= t_cfg.patience:
                log("early stopping")
                break
    finally:
        for it in (train_iter, val_iter):
            if isinstance(it, Prefetcher):
                it.close()
        metrics_logger.close()
    return TrainResult(
        state=state, num_classes=num_classes, class_weights=class_weights,
        best_f1_target=best_f1_target, best_val_loss=best_val_loss,
        best_epoch=best_epoch, history=history, checkpoint_path=ckpt_path)
