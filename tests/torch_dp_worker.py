"""One rank of the port's CPU data-parallel tests.

    python -m tests.torch_dp_worker CASES INPUTS OUT STORE RANK WORLD

joins a gloo process group through the ``FileStore`` at STORE (no port
is opened), builds ``parallel.mesh.make_mesh(device="cpu")``, runs each
of the comma-separated CASES on this rank's rows of the arrays in
INPUTS (an ``.npz`` the test wrote, nested keys joined by "/"), saves
what they return to OUT (an ``.npz``) and leaves the group. It imports
torch and the port only, never JAX, so a rank starts in seconds.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

C = 4
SGD_LR = 1e-3
# the sparse block model of the tests: a few tiles per event and tile
# capacities small enough that some occupied tiles drop
SPARSE = ["model.name=sparse_voxelnet", "model.grid_size=16",
          "model.tile=4", "model.unet_width=8", "model.depth=2",
          "model.levels=2", "model.compute_dtype=bfloat16",
          "model.max_tiles=6", "model.max_tiles_schedule=6,3"]


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": x}} -> {"a/b": x}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The subtree of ``flatten``'s keys under ``prefix/``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def sparse_model():
    """The sparse model of the tests, seeded: the same weights in every
    process."""
    from pcseg_tpu_torch.core.config import Config, apply_overrides
    from pcseg_tpu_torch.models.factory import build_model

    cfg = apply_overrides(Config(), SPARSE).model
    return build_model(cfg, C, generator=torch.Generator().manual_seed(0))


def sparse_batch(b: int = 4, m: int = 96):
    """(points, labels, masks, class weights) of short tracks, seeded."""
    rng = np.random.default_rng(5)
    pts = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        start = rng.uniform(-8, 8, 3)
        direction = rng.normal(size=3)
        t = np.linspace(0, 1, m)[:, None]
        pts[i, :, :3] = start + 12.0 * t * direction / np.linalg.norm(
            direction) + rng.normal(size=(m, 3)) * 0.3
        pts[i, :, 3] = rng.gamma(2.0, 1.0, m)
    masks = rng.random((b, m)) < 0.9
    labels = np.where(masks, rng.integers(0, C, (b, m)), -1)
    return (pts, labels.astype(np.int64), masks,
            rng.uniform(0.5, 2.0, C).astype(np.float32))


def sgd_state(model):
    from pcseg_tpu_torch.train.steps import TrainState

    return TrainState(model=model,
                      optimizer=torch.optim.SGD(model.parameters(), SGD_LR))


def _rows(mesh, d, prefix):
    from pcseg_tpu_torch.parallel.mesh import shard_batch

    batch = tuple(torch.from_numpy(d[f"{prefix}/{k}"])
                  for k in ("points", "labels", "masks"))
    return shard_batch(mesh, batch), torch.from_numpy(d[f"{prefix}/cw"])


def _step_result(tag, model, metrics):
    out = {f"{tag}/{k}": v.detach().numpy() for k, v in metrics.items()}
    out.update({f"{tag}/sd/{k}": v.detach().numpy()
                for k, v in model.state_dict().items()})
    return out


def _pointnet_step(mesh, d, tag, bn_stats="exact", sync_batchnorm=False):
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables
    from pcseg_tpu_torch.models.pointnet import PointNetSeg
    from pcseg_tpu_torch.train.steps import train_step

    model = PointNetSeg(C, dropout=0.0, bn_stats=bn_stats)
    model.load_state_dict(from_jax_variables(unflatten(d, "pn")))
    batch, cw = _rows(mesh, d, "pn_batch")
    _, metrics = train_step(sgd_state(model), batch, SGD_LR, (0, 0), cw,
                            mesh=mesh, sync_batchnorm=sync_batchnorm)
    return _step_result(tag, model, metrics)


def case_pn_sync(mesh, d):
    return _pointnet_step(mesh, d, "pn_sync", sync_batchnorm=True)


def case_pn_replica(mesh, d):
    return _pointnet_step(mesh, d, "pn_replica")


def case_pn_fused(mesh, d):
    """The fused chain (its kernels' plain versions on the CPU), per-replica
    BN: each rank's classifier + CE takes the global den."""
    return _pointnet_step(mesh, d, "pn_fused", bn_stats="fused")


def case_eval(mesh, d):
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables
    from pcseg_tpu_torch.models.pointnet import PointNetSeg
    from pcseg_tpu_torch.train.steps import TrainState, eval_step

    model = PointNetSeg(C, dropout=0.0)
    model.load_state_dict(from_jax_variables(unflatten(d, "pn")))
    batch, cw = _rows(mesh, d, "pn_batch")
    m = eval_step(TrainState(model.eval(), None), batch, cw, C, mesh=mesh)
    return {f"eval/{k}": v.numpy() for k, v in m.items()}


def case_voxel(mesh, d):
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
    from pcseg_tpu_torch.train.steps import train_step

    model = VoxelUNet3d(
        num_classes=C, grid_size=16, width=8, levels=2,
        compute_dtype="float32", conv_impl="xla", voxelize_impl="scatter",
        devox_impl="gather")
    model.load_state_dict(from_jax_variables(unflatten(d, "vox")))
    batch, cw = _rows(mesh, d, "vox_batch")
    _, metrics = train_step(sgd_state(model), batch, SGD_LR, (0, 0), cw,
                            mesh=mesh)
    return _step_result("vox", model, metrics)


def case_sparse(mesh, d):
    from pcseg_tpu_torch.parallel.mesh import shard_batch
    from pcseg_tpu_torch.train.steps import train_step

    model = sparse_model()
    pts, labels, masks, cw = sparse_batch()
    batch = shard_batch(mesh, tuple(torch.from_numpy(a)
                                    for a in (pts, labels, masks)))
    _, metrics = train_step(sgd_state(model), batch, SGD_LR, (3, 4),
                            torch.from_numpy(cw), mesh=mesh)
    return _step_result("sparse", model, metrics)


def case_predict(mesh, d):
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.models.pointnet import PointNetSeg

    model = PointNetSeg(C, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model.state_dict(), C, buckets=(64, 128), mesh=mesh)
    events = np.split(d["pred/points"], np.cumsum(d["pred/sizes"])[:-1])
    preds = pred.predict_batch(events, batch_size=3)
    return {"pred/preds": np.concatenate(preds),
            "pred/single": pred.logits(events[0])}


def case_fit(mesh, d):
    """api.fit on this rank (train.parallelism=dp), counting the
    checkpoints it writes."""
    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.train import loop

    writes = []
    real = loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **k: writes.append(a[0]) or real(
        *a, **k)
    sizes = d["fit/sizes"]
    events = list(zip(np.split(d["fit/points"], np.cumsum(sizes)[:-1]),
                      np.split(d["fit/labels"], np.cumsum(sizes)[:-1])))
    res = api.fit(events, device="cpu", log=lambda _: None, overrides=[
        *str(d["fit/overrides"]).split(), "train.parallelism=dp"])
    hist = {f"fit/history/{k}": np.asarray([h[k] for h in res.history])
            for k in ("train_loss", "val_loss", "train_acc", "val_acc",
                      "f1_target")}
    return {**hist, "fit/writes": np.asarray(len(writes)),
            "fit/best_epoch": np.asarray(res.best_epoch),
            **{f"fit/sd/{k}": v.numpy()
               for k, v in res.state.model.state_dict().items()}}


def case_cli(rank, world, d):
    """cli train with train.coordinator_address (a FileStore URL): the
    command joins its group itself, leaves it at the end, and rank 0
    alone prints. Runs before the worker makes a group of its own."""
    import contextlib
    import io

    from pcseg_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["train", "--data", str(d["cli/data"]), "--labels",
                       str(d["cli/labels"]), "--device", "cpu",
                       *str(d["cli/overrides"]).split(),
                       f"train.coordinator_address=file://"
                       f"{d['cli/store']}",
                       f"train.num_processes={world}",
                       f"train.process_id={rank}"])
    return {"cli/rc": np.asarray(rc),
            "cli/stdout": np.asarray(out.getvalue()),
            "cli/left_group": np.asarray(not dist.is_initialized())}


CASES = {"pn_sync": case_pn_sync, "pn_replica": case_pn_replica,
         "pn_fused": case_pn_fused,
         "eval": case_eval, "voxel": case_voxel, "sparse": case_sparse,
         "predict": case_predict, "fit": case_fit}


def main() -> int:
    cases, inputs, out, store, rank, world = sys.argv[1:7]
    rank, world, cases = int(rank), int(world), cases.split(",")
    torch.set_num_threads(1)
    d = dict(np.load(inputs))
    res = case_cli(rank, world, d) if "cli" in cases else {}
    cases = [c for c in cases if c != "cli"]
    if cases:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        try:
            from pcseg_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(device="cpu")
            for case in cases:
                res.update(CASES[case](mesh, d))
        finally:
            dist.destroy_process_group()
    np.savez(out, **res)
    return 0


def run_ranks(cases: str, inputs: str, tmp: str, world: int = 2,
              timeout: float = 300) -> list[dict]:
    """Run ``cases`` on ``world`` ranks in subprocesses (from the repo
    root); every rank's results, in rank order. A rank that fails or
    outlives ``timeout`` raises with its output."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = os.path.join(tmp, f"store_{cases.replace(',', '_')}")
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", cases, inputs,
         outs[r], store, str(r), str(world)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{logs[r][-4000:]}")
    return [dict(np.load(o)) for o in outs]


if __name__ == "__main__":
    sys.exit(main())
