"""Data parallelism in the port (pcseg_tpu_torch/parallel/mesh.py and the
mesh steps of train/steps.py) against the JAX package's mesh.

The port runs one process per device: two gloo ranks over a FileStore,
started once for the module (``tests/torch_dp_worker.py``), each holding
rows [r·B/2, (r+1)·B/2) of a global batch of B. The JAX side runs here on
a 2-device mesh of conftest's 8 CPU devices, where device r holds the
same rows. Parameters are made with numpy and carried across by
``ckpt.convert.from_jax_variables``; the optimizer is plain SGD (JAX:
``optax.identity()`` and params - lr * grads), so each parameter's change
is the summed gradient.

- MeshSpec.resolve and shard_batch against JAX's; initialize_distributed's
  plumbing (test_parallel.py's, init_process_group patched);
- PointNetSeg(4) "exact", f32, dropout 0, one step on test_parallel.py's
  uneven batch (8 conftest events of 50-300 points at bucket 512): with
  sync-BN and per-replica BN (running stats replica 0's) against
  ``make_train_step`` on the mesh. Loss rtol 1e-5, correct and total
  equal, running stats atol 1e-6 + rtol 1e-5 (test_parallel.py's own);
  per-replica, the new parameters atol 1e-6 + rtol 1e-5 too;
- the eval step: loss rtol 1e-5, the confusion matrix equal;
- the voxel U-Net (f32, grid 16, width 8, 2 levels, the XLA core) one
  step against the JAX mesh step: loss rtol 1e-5;
- the new parameters of the synced PointNet step and the voxel step in
  two parts. (a) The data parallelism adds nothing: the 2-rank step
  equals the port's step on the whole batch in one process, atol 1e-6 +
  rtol 1e-5, as test_parallel.py holds JAX's 8 devices to its 1. (b)
  Against the JAX mesh step, each tensor is as close as the port's
  one-process step is to JAX's one-device step, plus 1e-6: the two
  packages sum in other orders, and where a ReLU input sits within ~1e-6
  of 0 it flips, at a padded point for every identical padded point of
  the row; on this data that moves some one-device gradients by up to
  20 % of their largest element (bn_seg2.bias, PointNet) and 3 %
  (enc0_a.kernel, the voxel U-Net) on both sides of the mesh alike;
- the sparse block family (bf16; tile capacities that drop tiles) on 2
  ranks against the port's own step on the whole batch in one process
  (the JAX sparse model in interpret mode costs ~37 s a forward):
  ``dropped`` summed and equal, the loss to 1e-5 relative, new
  parameters atol 1e-6 + rtol 1e-5 (LayerNorm is per sample, so only the
  order of the sums differs);
- Predictor(mesh=...) equal to single-process serving, with a batch size
  that rounds up;
- both ranks end with equal parameters; scan_train_steps equals K calls
  of train_step; fused + sync-BN takes the plain path with a warning.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcseg_tpu.models.pointnet import PointNetSeg as JaxPointNetSeg
from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu.parallel import mesh as jax_mesh
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu.train.steps import make_eval_step, make_train_step
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.pointnet import BN_FOR, PointNetSeg, _stages
from pcseg_tpu_torch.parallel import mesh as port_mesh
from pcseg_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    replica_seeds,
    scan_train_steps,
    train_step,
)
from tests.torch_dp_worker import (
    C,
    SGD_LR,
    flatten,
    run_ranks,
    sgd_state,
    sparse_batch,
    sparse_model,
)

torch.set_num_threads(1)

VOXEL = dict(num_classes=C, grid_size=16, width=8, levels=2,
             compute_dtype="float32", conv_impl="xla",
             voxelize_impl="scatter", devox_impl="gather")
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _pointnet_vars(seed):
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, din, dout in _stages(C, 4):
        bound = 1.0 / np.sqrt(din)
        params[name] = {"kernel": rng.uniform(-bound, bound, (din, dout)),
                        "bias": rng.uniform(-bound, bound, dout)}
        bn = BN_FOR.get(name)
        if bn is not None:
            params[bn] = {"scale": rng.uniform(0.5, 1.5, dout),
                          "bias": rng.normal(size=dout) * 0.1}
            stats[bn] = {"mean": rng.normal(size=dout) * 0.1,
                         "var": rng.uniform(0.5, 2.0, dout)}
    cast = lambda t: {k: {n: np.asarray(a, np.float32) for n, a in g.items()}  # noqa: E731
                      for k, g in t.items()}
    return {"params": cast(params), "batch_stats": cast(stats)}


def _voxel_vars(seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxVoxelUNet3d(**VOXEL).init,
                            jax.random.key(0))["params"]
    params = {}
    for name, group in shapes.items():
        if "kernel" in group:
            k = group["kernel"].shape
            bound = np.sqrt(6.0 / np.prod(k[:-1]))
            params[name] = {
                "kernel": rng.uniform(-bound, bound, k).astype(np.float32),
                "bias": (rng.normal(size=k[-1:]) * 0.1).astype(np.float32)}
        else:
            c = group["scale"].shape
            params[name] = {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}
    return {"params": params, "batch_stats": {}}


def _batch(seed, b, m, valid):
    """Padded rows as data/batching.pad_events makes them: row i has
    valid[i] points (0: an all-masked dummy row)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, m, 4), np.float32)
    labels = np.full((b, m), -1, np.int64)
    masks = np.zeros((b, m), bool)
    for i, n in enumerate(valid):
        pts[i, :n, :3] = rng.normal(size=(n, 3)) * 5.0
        pts[i, :n, 3] = rng.gamma(2.0, 1.0, n)
        labels[i, :n] = rng.integers(0, C, n)
        masks[i, :n] = True
    return {"points": pts, "labels": labels, "masks": masks,
            "cw": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def _pred_events():
    rng = np.random.default_rng(9)
    return [rng.normal(size=(n, 4)).astype(np.float32) * 3.0
            for n in (20, 64, 33, 100, 7, 90, 41)]


@pytest.fixture(scope="module")
def inputs(small_events):
    from pcseg_tpu.data.batching import pad_events

    # tests/test_parallel.py's _uneven_batch and class weights
    points, labels, masks = pad_events(small_events[:8], 512, 8)
    return {"pn": _pointnet_vars(0), "vox": _voxel_vars(1),
            "pn_batch": {"points": points, "labels": labels,
                         "masks": masks,
                         "cw": np.float32([0.3, 0.3, 2.8, 0.6])},
            "vox_batch": _batch(3, 4, 128, [128, 90, 60, 110])}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results of every case, one launch for the module."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    events = _pred_events()
    flat = {**flatten(inputs),
            "pred/points": np.concatenate(events),
            "pred/sizes": np.asarray([e.shape[0] for e in events])}
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **flat)
    return run_ranks("pn_sync,pn_replica,pn_fused,eval,voxel,sparse,predict",
                     path, tmp)


def _jax_state(variables):
    tx = optax.identity()
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray,
                                                  variables["batch_stats"]),
                         opt_state=tx.init(params)), tx


def _jax_batch(b):
    return (jnp.asarray(b["points"]), jnp.asarray(b["labels"]),
            jnp.asarray(b["masks"]))


@pytest.fixture(scope="module")
def mesh2():
    return jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2),
                              devices=jax.devices()[:2])


def _jax_step(model, variables, batch, mesh2, sync):
    state, tx = _jax_state(variables)
    step = make_train_step(model, tx, mesh2, sync_batchnorm=sync,
                           donate=False)
    return step(state, _jax_batch(batch), jnp.float32(SGD_LR),
                jax.random.key(0), jnp.asarray(batch["cw"]))


def _held_params(got: dict, ref_params: dict, tag: str):
    for name, group in ref_params.items():
        for leaf, r in group.items():
            np.testing.assert_allclose(
                got[f"{tag}/sd/{name}.{leaf}"], np.asarray(r),
                atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=f"{name}.{leaf}")


def _held_two_ways(got: dict, tag: str, one: dict, ref: dict, ref_one: dict):
    """(a) and (b) of the module docstring: ``one``, the port's state_dict
    after the step in one process; ``ref`` / ``ref_one``, the JAX mesh
    step's and one-device step's new parameters."""
    for name, group in ref.items():
        for leaf, r in group.items():
            key = f"{name}.{leaf}"
            mine = got[f"{tag}/sd/{key}"]
            np.testing.assert_allclose(mine, one[key].numpy(),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=key)
            gap = np.abs(one[key].numpy() - np.asarray(ref_one[name][leaf]))
            err = np.abs(mine - np.asarray(r)).max()
            assert err <= gap.max() + PARAM_ATOL, (key, err, gap.max())


def _one_process(model, batch):
    """The port's SGD step on the whole batch here: its state_dict."""
    train_step(sgd_state(model), tuple(
        torch.from_numpy(batch[k]) for k in ("points", "labels", "masks")),
        SGD_LR, (0, 0), torch.from_numpy(batch["cw"]))
    return model.state_dict()


@pytest.fixture(scope="module")
def mesh1():
    return jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1),
                              devices=jax.devices()[:1])


def _held_metrics(got: dict, ref: dict, tag: str):
    np.testing.assert_allclose(got[f"{tag}/loss"], float(ref["loss"]),
                               rtol=1e-5)
    assert float(got[f"{tag}/correct"]) == float(ref["correct"])
    assert float(got[f"{tag}/total"]) == float(ref["total"])


@pytest.mark.parametrize("spec,n", [
    ((0, 1), 8), ((2, 1), 8), ((0, 2), 8), ((4, 2), 8), ((3, 1), 4),
    ((0, 3), 8), ((5, 2), 8), ((0, 1), 1), ((2, 1), 1)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    def resolve(cls):
        try:
            return cls(*spec).resolve(n)
        except ValueError as e:
            return str(e)

    assert resolve(port_mesh.MeshSpec) == resolve(jax_mesh.MeshSpec)


def test_shard_batch_matches_jax(inputs, mesh2):
    """Each rank's rows are the addressable shard of JAX's shard_batch on
    the device of the same index; 5 rows on 2 ranks raise."""
    b = inputs["pn_batch"]
    arrays = (b["points"], b["labels"], b["masks"])
    placed = jax_mesh.shard_batch(mesh2, tuple(map(jnp.asarray, arrays)))
    for r in range(2):
        mesh = port_mesh.Mesh(2, r, torch.device("cpu"), distributed=False)
        mine = port_mesh.shard_batch(mesh, tuple(map(torch.from_numpy,
                                                     arrays)))
        for got, arr in zip(mine, placed):
            shard = next(s for s in arr.addressable_shards
                         if s.device == mesh2.devices[r, 0])
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="divisible"):
        port_mesh.shard_batch(mesh, (np.zeros((5, 3)),))


def test_initialize_distributed_plumbing(monkeypatch):
    """tests/test_parallel.py's plumbing test: no address is a no-op, the
    arguments reach init_process_group (gloo on the CPU, tcp:// for
    host:port), a repeat is a no-op and another topology raises."""
    from pcseg_tpu_torch.core.config import Config, apply_overrides

    monkeypatch.setattr(port_mesh, "_distributed_initialized", False)
    assert port_mesh.initialize_distributed(None) is False
    assert port_mesh.initialize_distributed("") is False
    calls = []
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert port_mesh.initialize_distributed("10.0.0.1:8476", 2, 1,
                                            device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:8476",
                          world_size=2, rank=1)]
    assert port_mesh.initialize_distributed("10.0.0.1:8476", 2, 1,
                                            device="cpu") is False
    assert len(calls) == 1
    with pytest.raises(RuntimeError, match="already initialized"):
        port_mesh.initialize_distributed("10.0.0.9:9999", 4, 2,
                                         device="cpu")
    # a tcp address without a world size outside a launcher
    monkeypatch.setattr(port_mesh, "_distributed_initialized", False)
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        port_mesh.initialize_distributed("10.0.0.1:8476", device="cpu")
    # torchrun's variables: env:// and the launcher's world size and rank
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    assert port_mesh.launcher_address() == "env://"
    assert port_mesh.initialize_distributed("env://", device="cpu") is True
    assert calls[-1] == dict(backend="gloo", init_method="env://",
                             world_size=2, rank=1)
    # shutdown_distributed destroys the group it made and forgets it, so
    # another topology may follow; the config's fields reach the call
    destroyed = []
    monkeypatch.setattr(port_mesh.dist, "destroy_process_group",
                        lambda: destroyed.append(1))
    port_mesh.shutdown_distributed()
    port_mesh.shutdown_distributed()
    assert destroyed == [1]
    cfg = apply_overrides(Config(), [
        "train.coordinator_address=10.0.0.1:8476", "train.num_processes=2",
        "train.process_id=0"])
    assert cfg.train.coordinator_address == "10.0.0.1:8476"
    assert cfg.train.num_processes == 2 and cfg.train.process_id == 0
    assert port_mesh.init_from_config(cfg.train, device="cpu") is True
    assert calls[-1] == dict(backend="gloo", init_method="tcp://10.0.0.1:8476",
                             world_size=2, rank=0)


def test_make_mesh_without_a_group():
    """One rank without a process group; the model axis is not ported;
    the data axis spans every rank; no card raises unless asked for the
    CPU."""
    mesh = port_mesh.make_mesh(device="cpu")
    assert (mesh.data, mesh.rank, mesh.distributed) == (1, 0, False)
    t = torch.arange(3.0)
    assert mesh.psum(t) is t and mesh.all_gather(t) is t
    with pytest.raises(NotImplementedError, match="A9b"):
        port_mesh.make_mesh(port_mesh.MeshSpec(model=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        port_mesh.make_mesh(port_mesh.MeshSpec(data=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_mesh.make_mesh()


def test_pointnet_sync_bn_step_matches_jax_mesh(ranks, inputs, mesh1,
                                                 mesh2):
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables

    jm_model = JaxPointNetSeg(num_classes=C, dropout=0.0, bn_stats="exact")
    jstate, jm = _jax_step(jm_model, inputs["pn"], inputs["pn_batch"],
                           mesh2, True)
    j1, _ = _jax_step(jm_model, inputs["pn"], inputs["pn_batch"], mesh1,
                      True)
    model = PointNetSeg(C, dropout=0.0, bn_stats="exact")
    model.load_state_dict(from_jax_variables(inputs["pn"]))
    one = _one_process(model, inputs["pn_batch"])
    for got in ranks:
        _held_metrics(got, jm, "pn_sync")
        _held_two_ways(got, "pn_sync", one, jstate.params, j1.params)
        _held_params(got, jstate.batch_stats, "pn_sync")


def test_pointnet_per_replica_bn_keeps_replica0_stats(ranks, inputs, mesh1,
                                                      mesh2):
    """Per-replica BN: the step against the JAX mesh step, and the running
    stats kept on both ranks are those of rank 0's rows alone."""
    jm_model = JaxPointNetSeg(num_classes=C, dropout=0.0, bn_stats="exact")
    jstate, jm = _jax_step(jm_model, inputs["pn"], inputs["pn_batch"],
                           mesh2, False)
    half = {k: v[:4] if k != "cw" else v
            for k, v in inputs["pn_batch"].items()}
    r0_state, _ = _jax_step(jm_model, inputs["pn"], half, mesh1, False)
    for got in ranks:
        _held_metrics(got, jm, "pn_replica")
        _held_params(got, jstate.params, "pn_replica")
        _held_params(got, jstate.batch_stats, "pn_replica")
        _held_params(got, r0_state.batch_stats, "pn_replica")


def _fused_by_hand(inputs):
    """JAX's mesh rule worked by hand in one process on the port's own
    fused chain: each half of the batch on its own copy of the model,
    num_r / (den_0 + den_1) back-propagated on each, the two gradients
    summed, one SGD step on copy 0, copy 0's running stats kept. The
    arithmetic of two ranks but for the order of each two-term sum.
    Returns (state_dict, loss, correct)."""
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables

    b = inputs["pn_batch"]
    models, outs = [], []
    for r in range(2):
        model = PointNetSeg(C, dropout=0.0, bn_stats="fused")
        model.load_state_dict(from_jax_variables(inputs["pn"]))
        rows = slice(4 * r, 4 * r + 4)
        outs.append(model.fused_train_loss(
            torch.from_numpy(b["points"][rows]),
            torch.from_numpy(b["labels"][rows]), torch.from_numpy(b["cw"]),
            seeds=replica_seeds((0, 0), r)))
        models.append(model)
    den = sum(o[0][1].detach() for o in outs)
    for (num, _, _), _ in outs:
        (num / den).backward()
    state = sgd_state(models[0])
    for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
        p0.grad = p0.grad + p1.grad
    state.optimizer.step()
    models[0].load_batch_stats(outs[0][1])
    loss = sum(o[0][0].detach() for o in outs) / den
    return (models[0].state_dict(), float(loss),
            float(sum(o[0][2] for o in outs)))


def test_pointnet_fused_step_matches_jax_mesh(ranks, inputs, mesh1, mesh2):
    """The fused chain, per-replica BN, on 2 ranks (its kernels' plain
    versions, bf16), where each rank's classifier + CE back-propagates
    against the GLOBAL den and the kept running stats are rank 0's.

    (a) Against ``_fused_by_hand``, the same arithmetic in one process:
    every new parameter and running stat atol 1e-6 + rtol 1e-5, the loss
    rtol 1e-5, correct equal. A gradient averaged over the ranks, or
    divided by a rank's own den, is off by about half and fails.
    (b) Against JAX's mesh step of bn_stats="fused", which on the CPU is
    the XLA path with the chain's statistics (padded points counted) in
    f32: the running stats within 2^-7 of max|ref| of JAX's replica-0
    stats (test_torch_pointnet.py's rule), total equal, and the loss and
    correct within 3 x the bf16 chain's own gap on this batch, the port's
    one-process fused step against JAX's one-device step (here 0.55 % of
    the loss and 13 of 1544 points, near-tied logits of random weights
    rounding apart). The parameters are held only in (a): the bf16 chain
    moves this step's gradients by 25-50 % of their norm from f32's, on
    either package."""
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables

    jm_model = JaxPointNetSeg(num_classes=C, dropout=0.0, bn_stats="fused")
    _, jm = _jax_step(jm_model, inputs["pn"], inputs["pn_batch"], mesh2,
                      False)
    _, j1 = _jax_step(jm_model, inputs["pn"], inputs["pn_batch"], mesh1,
                      False)
    half = {k: v[:4] if k != "cw" else v
            for k, v in inputs["pn_batch"].items()}
    r0_state, _ = _jax_step(jm_model, inputs["pn"], half, mesh1, False)
    b = inputs["pn_batch"]
    model = PointNetSeg(C, dropout=0.0, bn_stats="fused")
    model.load_state_dict(from_jax_variables(inputs["pn"]))
    _, m1 = train_step(sgd_state(model), tuple(
        torch.from_numpy(b[k]) for k in ("points", "labels", "masks")),
        SGD_LR, (0, 0), torch.from_numpy(b["cw"]))
    own_loss = abs(float(m1["loss"]) - float(j1["loss"]))
    own_correct = abs(float(m1["correct"]) - float(j1["correct"]))
    hand, hand_loss, hand_correct = _fused_by_hand(inputs)
    for got in ranks:
        for key, ref in hand.items():
            np.testing.assert_allclose(got[f"pn_fused/sd/{key}"],
                                       ref.numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=key)
        np.testing.assert_allclose(got["pn_fused/loss"], hand_loss,
                                   rtol=1e-5)
        assert float(got["pn_fused/correct"]) == hand_correct
        for name, group in r0_state.batch_stats.items():
            for leaf, r in group.items():
                r = np.asarray(r)
                err = np.abs(got[f"pn_fused/sd/{name}.{leaf}"] - r).max()
                assert err <= 2.0 ** -7 * np.abs(r).max(), (name, leaf, err)
        assert float(got["pn_fused/total"]) == float(jm["total"])
        assert abs(float(got["pn_fused/loss"]) - float(jm["loss"])) \
            <= 3.0 * own_loss
        assert abs(float(got["pn_fused/correct"]) - float(jm["correct"])) \
            <= 3.0 * own_correct


def test_eval_step_matches_jax_mesh(ranks, inputs, mesh2):
    state, _ = _jax_state(inputs["pn"])
    b = inputs["pn_batch"]
    jm = make_eval_step(JaxPointNetSeg(num_classes=C), mesh2, C)(
        state, _jax_batch(b), jnp.asarray(b["cw"]))
    for got in ranks:
        _held_metrics(got, jm, "eval")
        np.testing.assert_array_equal(got["eval/confusion"],
                                      np.asarray(jm["confusion"]))


def test_voxel_step_matches_jax_mesh(ranks, inputs, mesh1, mesh2):
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

    jm_model = JaxVoxelUNet3d(**VOXEL)
    jstate, jm = _jax_step(jm_model, inputs["vox"], inputs["vox_batch"],
                           mesh2, False)
    j1, _ = _jax_step(jm_model, inputs["vox"], inputs["vox_batch"], mesh1,
                      False)
    model = VoxelUNet3d(**VOXEL)
    model.load_state_dict(from_jax_variables(inputs["vox"]))
    one = _one_process(model, inputs["vox_batch"])
    for got in ranks:
        np.testing.assert_allclose(got["vox/loss"], float(jm["loss"]),
                                   rtol=1e-5)
        assert float(got["vox/correct"]) == float(jm["correct"])
        _held_two_ways(got, "vox", one, jstate.params, j1.params)


def test_sparse_step_matches_one_process(ranks):
    """Two ranks against the port's step on the whole batch here."""
    model = sparse_model()
    pts, labels, masks, cw = sparse_batch()
    _, m = train_step(sgd_state(model), tuple(
        torch.from_numpy(a) for a in (pts, labels, masks)), SGD_LR, (3, 4),
        torch.from_numpy(cw))
    assert int(m["dropped"]) > 0
    ref = model.state_dict()
    for got in ranks:
        assert int(got["sparse/dropped"]) == int(m["dropped"])
        np.testing.assert_allclose(got["sparse/loss"], float(m["loss"]),
                                   rtol=1e-5)
        for k, v in ref.items():
            np.testing.assert_allclose(got[f"sparse/sd/{k}"], v.numpy(),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=k)


def test_ranks_end_equal(ranks):
    """Every rank holds the same parameters and metrics after a step."""
    a, b = ranks
    assert a.keys() == b.keys()
    for k in a:
        if k.startswith(("pn_", "vox/", "sparse/", "eval/")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_predictor_mesh_equals_one_process(ranks):
    """Predictions from 2 ranks (batch 3 rounds up to 4) equal the same
    weights served in one process; the single event too."""
    events = _pred_events()
    model = PointNetSeg(C, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model.state_dict(), C, buckets=(64, 128), device="cpu")
    want = np.concatenate(pred.predict_batch(events, batch_size=4))
    for got in ranks:
        np.testing.assert_array_equal(got["pred/preds"], want)
        np.testing.assert_allclose(got["pred/single"],
                                   pred.logits(events[0]), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(NotImplementedError, match="A9b"):
        Predictor(model.state_dict(), C, device="cpu", gp_mesh=object())


def test_scan_train_steps_equals_steps(inputs):
    """K steps over one bucket's stacked batches equal K calls of
    train_step, metrics stacked (the JAX make_scan_train_steps test),
    here with dropout on (seeds per step) and on a one-rank mesh."""
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables

    b = inputs["pn_batch"]
    batch = tuple(torch.from_numpy(b[k][:2, :128]) for k in (
        "points", "labels", "masks"))
    seeds = [(1, 2), (3, 4), (5, 6)]
    mesh = port_mesh.make_mesh(device="cpu")

    def model():
        m = PointNetSeg(C, dropout=0.3)
        m.load_state_dict(from_jax_variables(inputs["pn"]))
        return m

    s1 = create_train_state(model())
    losses = []
    for sd in seeds:
        s1, m1 = train_step(s1, batch, 1e-3, sd, torch.from_numpy(b["cw"]),
                            mesh=mesh)
        losses.append(float(m1["loss"]))
    s2 = create_train_state(model())
    s2, ms = scan_train_steps(s2, tuple(torch.stack([t] * 3) for t in batch),
                              1e-3, seeds, torch.from_numpy(b["cw"]),
                              mesh=mesh)
    assert s2.step == 3 and ms["loss"].shape == (3,)
    np.testing.assert_array_equal(ms["loss"].numpy(), np.float32(losses))
    for (k, v), w in zip(s1.model.state_dict().items(),
                         s2.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_fused_with_sync_bn_takes_the_plain_path(inputs, monkeypatch):
    """bn_stats="fused" with sync-BN: a warning, the plain path (no fused
    kernel) with the synced two-pass moments; sync-BN needs a mesh; rank
    0's dropout seeds are the step's, another rank's its own."""
    import pcseg_tpu_torch.models.pointnet_fused as pf
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables

    monkeypatch.setattr(pf, "pointnet_fused_train_loss",
                        lambda *a, **k: pytest.fail("fused loss ran"))
    monkeypatch.setattr(pf, "pointnet_apply_fused",
                        lambda *a, **k: pytest.fail("fused chain ran"))
    model = PointNetSeg(C, dropout=0.0, bn_stats="fused")
    model.load_state_dict(from_jax_variables(inputs["pn"]))
    b = inputs["pn_batch"]
    batch = tuple(torch.from_numpy(b[k]) for k in ("points", "labels",
                                                    "masks"))
    state = create_train_state(model)
    with pytest.raises(ValueError, match="mesh"):
        train_step(state, batch, 1e-3, (0, 0), torch.from_numpy(b["cw"]),
                   sync_batchnorm=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, m = train_step(state, batch, 1e-3, (0, 0),
                          torch.from_numpy(b["cw"]),
                          mesh=port_mesh.make_mesh(device="cpu"),
                          sync_batchnorm=True)
    assert any("falls back to the plain path" in str(w.message)
               for w in caught)
    assert np.isfinite(float(m["loss"]))
    assert replica_seeds((7, 8), 0) == (7, 8)
    assert replica_seeds((7, 8), 1) != replica_seeds((7, 8), 2) != (7, 8)


def test_eval_state_without_optimizer_on_a_one_rank_mesh(inputs):
    """eval_step on a one-rank mesh is the one-device eval step."""
    from pcseg_tpu_torch.ckpt.convert import from_jax_variables
    from pcseg_tpu_torch.train.steps import eval_step

    model = PointNetSeg(C)
    model.load_state_dict(from_jax_variables(inputs["pn"]))
    b = inputs["pn_batch"]
    batch = tuple(torch.from_numpy(b[k]) for k in ("points", "labels",
                                                    "masks"))
    state = TrainState(model.eval(), None)
    one = eval_step(state, batch, torch.from_numpy(b["cw"]), C)
    meshed = eval_step(state, batch, torch.from_numpy(b["cw"]), C,
                       mesh=port_mesh.make_mesh(device="cpu"))
    for k, v in one.items():
        assert torch.equal(v, meshed[k]), k
