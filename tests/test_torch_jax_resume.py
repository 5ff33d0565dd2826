"""Resuming training from a JAX checkpoint directory
(``train_model(resume_from=<directory>)``, ``ckpt.checkpoint.
jax_adam_state``): the port's step from the resumed state against the JAX
package's step from the same directory, and the resumed run's epochs and
step counter, for PointNetSeg and the sparse gather impl.

Each directory is a JAX run's own: two JAX train steps (PointNetSeg
f32, ``bn_stats="exact"``, dropout 0; SparseVoxelNet's gather impl f32
at grid 16, width 16, depth 2, 2 levels) on a one-device CPU mesh, saved
with the JAX ``save_checkpoint`` as the JAX ``train_model`` saves its
'latest' checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ckpt.checkpoint import load_checkpoint as jax_load
from pcseg_tpu.ckpt.checkpoint import save_checkpoint as jax_save
from pcseg_tpu.models.pointnet import PointNetSeg as JaxPointNetSeg
from pcseg_tpu.parallel.mesh import MeshSpec, make_mesh
from pcseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu.train.steps import make_train_step
from pcseg_tpu_torch import api
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.train.steps import dropout_seeds, train_step
from tests.test_torch_pointnet import _batch, _numpy_vars, _tensors

torch.set_num_threads(1)

C = 4
LR = 1e-3
OVERRIDES = ["model.num_classes=4", "model.dropout=0.0",
             "model.bn_stats=exact"]
META = {"epoch": 4, "num_classes": C, "class_weights": [1.0] * C,
        "best_f1_target": 0.25, "best_val_loss": 1.75, "best_epoch": 3,
        "patience_counter": 1}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX 'latest' directory after two steps, and the third JAX step
    from that directory on another batch."""
    variables = _numpy_vars(6)
    jm = JaxPointNetSeg(num_classes=C, dropout=0.0, bn_stats="exact")
    tx = jax_make_optimizer()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(
                              jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params))
    step = make_train_step(jm, tx, make_mesh(MeshSpec(data=1)),
                           donate=False)
    batches = [_batch(s, 2, 64, [64, 50]) for s in (7, 8, 9)]

    def jstep(st, b):
        pts, labels, masks, cw = b
        return step(st, (jnp.asarray(pts), jnp.asarray(labels),
                         jnp.asarray(masks)), LR, jax.random.key(0),
                    jnp.asarray(cw))

    for b in batches[:2]:
        state, _ = jstep(state, b)
    path = str(tmp_path_factory.mktemp("jax") / "latest")
    jax_save(path, state, META)
    restored, _ = jax_load(path, target=state)
    new_state, metrics = jstep(restored, batches[2])
    return path, batches[2], new_state, metrics


def _resume(path, epochs=5, events=None):
    events = events or list(synthetic_events(8, min_points=20,
                                             max_points=64, seed=4))
    return api.fit(events, overrides=OVERRIDES + [
        f"train.num_epochs={epochs}", "data.batch_size=2",
        "data.buckets=64"], resume_from=path, device="cpu",
        log=lambda *a: None)


def test_resumed_step_matches_the_jax_step(jax_run):
    """One port step (Adam, lr 1e-3) from the resumed state against the
    JAX step from the same directory on the same batch, held as the port's
    PointNet step-parity test holds a first step: the loss to 1e-5
    relative, every new parameter within 2 lr of JAX's and 99.9 % of them
    within 1e-6; the step counters agree."""
    path, (pts, labels, masks, cw), jstate, jm = jax_run
    res = _resume(path)                    # epoch 4 of 5: restores only
    state = res.state
    assert state.step == 2 and res.history == []
    state.model.train()
    state, metrics = train_step(state, _tensors(pts, labels, masks), LR,
                                dropout_seeds(0, 0, 0), torch.from_numpy(cw))
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    close = total = 0
    params = state.model.params()
    for name, group in jstate.params.items():
        for leaf, want in group.items():
            d = np.abs(params[name][leaf].detach().numpy() - np.asarray(want))
            assert float(d.max()) <= 2 * LR * (1 + 1e-3), f"{name}.{leaf}"
            close += int((d <= 1e-6).sum())
            total += d.size
    assert close / total >= 0.999, close / total
    # Adam's moments after the step track optax's: 0.1 (1 - beta1) and
    # 0.001 (1 - beta2) of the step's gradients, which the exact PointNet
    # test holds to 1e-4 of max|ref| + 1e-6 (the biases ahead of a
    # train-mode BN have a gradient of rounding size)
    named = dict(state.model.named_parameters())
    opt = jstate.opt_state[1]
    for name, p in named.items():
        group, leaf = name.split(".")
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(opt.count) == 3
        for key, tree, floor in (("exp_avg", opt.mu, 1e-7),
                                 ("exp_avg_sq", opt.nu, 1e-12)):
            want = np.asarray(tree[group][leaf])
            err = float(np.abs(st[key].numpy() - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()) + floor, (
                name, key, err)


def test_resumed_run_continues_at_the_next_epoch(jax_run):
    """A resumed run trains from epoch 5 (meta.json's epoch + 1), counts
    steps on from the TrainState's and keeps the selection state's best
    F1 unless an epoch beats it."""
    path = jax_run[0]
    res = _resume(path, epochs=6)
    assert [h["epoch"] for h in res.history] == [5]
    steps = res.history[0]["train_steps"]
    assert steps > 0 and res.state.step == 2 + steps
    assert np.isfinite(res.history[0]["train_loss"])
    assert res.best_f1_target >= 0.25


def test_test_writer_matches_flax(tmp_path):
    """tests/jax_format.py (the card's JAX-free writer) writes the bytes
    the JAX ``save_checkpoint`` writes for the same TrainState, and the
    port resumes from either."""
    from tests.jax_format import write_jax_checkpoint

    variables = _numpy_vars(2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer()
    opt = tx.init(params)
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                            jnp.float32), params)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0, 1e-4, a.shape),
                                            jnp.float32), params)
    opt = (opt[0], opt[1]._replace(count=jnp.asarray(3, jnp.int32), mu=mu,
                                   nu=nu))
    bstats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                          batch_stats=bstats, opt_state=opt)
    jax_save(str(tmp_path / "flax"), state, META)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    write_jax_checkpoint(str(tmp_path / "mine"), 3, as_np(params),
                         as_np(bstats), 3, as_np(mu), as_np(nu), META)
    for name in ("state.msgpack", "meta.json"):
        a = (tmp_path / "flax" / name).read_bytes()
        b = (tmp_path / "mine" / name).read_bytes()
        assert a == b, name
    res = _resume(str(tmp_path / "mine"))
    assert res.state.step == 3


# -- the sparse gather impl

SPARSE = dict(num_classes=C, grid_size=16, width=16, depth=2, levels=2,
              impl="gather", compute_dtype="float32", max_active=2048)


def _sparse_batch(seed):
    from tests.test_torch_sparse_unet import _points

    pts, mask = _points(seed)
    labels = np.random.default_rng(seed).integers(0, C, mask.shape)
    return (pts, np.where(mask, labels, -1), mask,
            np.array([1.0, 2.0, 0.5, 1.5], np.float32))


@pytest.fixture(scope="module")
def jax_gather_run(tmp_path_factory):
    """A JAX 'latest' directory of the gather impl after two steps, and
    the third JAX step from that directory."""
    import dataclasses

    from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
    from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparse
    from tests.test_torch_sparse_unet import _numpy_vars as sparse_vars

    jm = JaxSparse(**SPARSE)
    tx = jax_make_optimizer()
    params = jax.tree.map(jnp.asarray, sparse_vars(jm, 3)["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats={}, opt_state=tx.init(params))
    step = make_train_step(jm, tx, make_mesh(MeshSpec(data=1)),
                           donate=False)
    batches = [_sparse_batch(s) for s in (1, 2, 3)]

    def jstep(st, b):
        pts, labels, masks, cw = b
        return step(st, (jnp.asarray(pts), jnp.asarray(labels),
                         jnp.asarray(masks)), LR, jax.random.key(0),
                    jnp.asarray(cw))

    for b in batches[:2]:
        state, _ = jstep(state, b)
    cfg = JaxModelConfig(name="sparse_voxelnet", num_classes=C,
                         grid_size=16, unet_width=16, depth=2, levels=2,
                         impl="gather", max_active=2048,
                         compute_dtype="float32")
    path = str(tmp_path_factory.mktemp("jax_gather") / "latest")
    jax_save(path, state, dict(META, config={
        "model": dataclasses.asdict(cfg)}))
    restored, _ = jax_load(path, target=state)
    new_state, metrics = jstep(restored, batches[2])
    return path, batches[2], restored, new_state, metrics


def test_resumed_gather_step_matches_the_jax_step(jax_gather_run):
    """The gather impl resumed from a JAX directory: Adam's state equals
    optax's bit for bit; one port step on the next batch against the JAX
    step from the same directory: the loss to 1e-5 relative, every new
    parameter within 1e-6 of JAX's (both Adam updates of f32 gradients
    that agree to 1e-4 of their scale, test_torch_sparse_impls.py); then
    a resumed run trains on at the next epoch."""
    path, (pts, labels, masks, cw), jold, jstate, jm = jax_gather_run
    overrides = ["model.name=sparse_voxelnet", "model.num_classes=4",
                 "model.grid_size=16", "model.unet_width=16",
                 "model.depth=2", "model.levels=2", "model.impl=gather",
                 "model.max_active=2048", "model.compute_dtype=float32",
                 "data.batch_size=2", "data.buckets=512"]
    events = [(p[:150], np.zeros(150, np.int64))
              for p in _sparse_batch(4)[0]] * 2
    res = api.fit(events, overrides=overrides + ["train.num_epochs=5"],
                  resume_from=path, device="cpu", log=lambda *a: None)
    state = res.state
    assert res.history == [] and state.step == 2
    assert state.model.impl == "gather"
    opt = jold.opt_state[1]
    for name, p in state.model.named_parameters():
        group, leaf = name.split(".")
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(opt.count) == 2
        for key, tree in (("exp_avg", opt.mu), ("exp_avg_sq", opt.nu)):
            want = np.asarray(tree[group][leaf])
            assert st[key].numpy().tobytes() == want.tobytes(), (name, key)
    state.model.train()
    state, metrics = train_step(state, _tensors(pts, labels, masks), LR,
                                dropout_seeds(0, 0, 0), torch.from_numpy(cw))
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    params = dict(state.model.named_parameters())
    for name, group in jstate.params.items():
        for leaf, want in group.items():
            d = np.abs(params[f"{name}.{leaf}"].detach().numpy()
                       - np.asarray(want))
            assert float(d.max()) <= 1e-6, (f"{name}.{leaf}", float(d.max()))
    more = api.fit(events, overrides=overrides + ["train.num_epochs=6"],
                   resume_from=path, device="cpu", log=lambda *a: None)
    assert [h["epoch"] for h in more.history] == [5]
    assert more.state.step == 2 + more.history[0]["train_steps"]
    assert np.isfinite(more.history[0]["train_loss"])
