"""Training the port's voxel U-Net against the JAX package's.

- One train step's loss and gradients, fused core in bf16: the port's
  autograd through the kernels' plain versions against
  ``jax.value_and_grad`` of the JAX model's loss, its Pallas blocks in
  interpret mode, on the same weights (numpy, carried over with
  ``ckpt.convert.from_jax_variables``) and batch.
- One Adam step on the plain cores in f32 (``conv_impl="xla"``): the
  port's ``train_step`` against the JAX ``make_train_step`` on a
  one-device mesh.
- ``api.fit`` on the CPU trains the voxel family and ``Predictor`` serves
  the checkpoint it wrote; its Adam state loads into a fresh optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu.parallel.mesh import MeshSpec, make_mesh
from pcseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu.train.steps import make_train_step
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint, load_train_state
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from pcseg_tpu_torch.train.steps import (
    create_train_state,
    dropout_seeds,
    train_step,
)

torch.set_num_threads(1)

C = 4
FUSED = dict(num_classes=C, grid_size=8, width=16, levels=2,
             compute_dtype="bfloat16", conv_impl="fused",
             voxelize_impl="scatter", devox_impl="gather")
XLA_F32 = dict(num_classes=C, grid_size=8, width=8, levels=2,
               compute_dtype="float32", conv_impl="xla",
               voxelize_impl="scatter", devox_impl="gather")


def _numpy_vars(model, seed):
    """Random parameters in the JAX model's structure, made with numpy:
    He-uniform kernels, non-trivial biases and GroupNorm affines."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0))["params"]
    params = {}
    for name, group in shapes.items():
        if "kernel" in group:
            k = group["kernel"].shape
            bound = np.sqrt(6.0 / np.prod(k[:-1]))
            params[name] = {
                "kernel": rng.uniform(-bound, bound, k).astype(np.float32),
                "bias": (rng.normal(size=k[-1:]) * 0.1).astype(np.float32),
            }
        else:
            c = group["scale"].shape
            params[name] = {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32),
            }
    return {"params": params, "batch_stats": {}}


def _batch(seed, b, m):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(b, m, 3)) * 5.0,
                          rng.gamma(2.0, 1.0, size=(b, m, 1))],
                         axis=-1).astype(np.float32)
    mask = rng.random((b, m)) < 0.9
    labels = np.where(mask, rng.integers(0, C, (b, m)), -1).astype(np.int64)
    cw = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return pts, labels, mask, cw


def _port(kw, variables):
    model = VoxelUNet3d(**kw)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _flat(tree_or_model, names):
    if isinstance(tree_or_model, torch.nn.Module):
        g = {n: p.grad for n, p in tree_or_model.named_parameters()}
        return [g[n].numpy().ravel() for n in names]
    return [np.asarray(tree_or_model[a][b], np.float32).ravel()
            for a, b in (n.split(".") for n in names)]


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_fused_train_step_gradients_match_jax():
    """The whole bf16 step: voxelize, the fused core's autograd Functions
    (dgrad, wgrad, down/up backward, the accum and stem variants),
    head, devoxelize VJP, weighted CE. Held as the JAX package holds its
    fused core to its XLA core (tests/test_conv3d_block.py): a one-ulp
    bf16 flip travels through the GroupNorm backwards, so the gradient
    vector is held by cosine (> 0.98 overall, > 0.998 over the conv
    kernels) and the kernels' relative L2 (< 0.06); the loss to 1e-3."""
    jm = JaxVoxelUNet3d(**FUSED)
    variables = _numpy_vars(jm, 0)
    pts, labels, mask, cw = _batch(1, 2, 256)

    def jloss(params):
        logits, _ = jm.apply({"params": params, "batch_stats": {}},
                             jnp.asarray(pts), train=True,
                             mask=jnp.asarray(mask))
        num, den = jax_ce_sums(logits, jnp.asarray(labels), jnp.asarray(cw))
        return num / den

    params = jax.tree.map(jnp.asarray, variables["params"])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)

    model = _port(FUSED, variables)
    assert model.resolve_conv_impl() == "fused"
    assert all(p.requires_grad for p in model.parameters())
    logits, new_bn = model.apply(torch.from_numpy(pts), train=True,
                                 mask=torch.from_numpy(mask))
    assert new_bn == {}
    num, den = cross_entropy_sums(logits, torch.from_numpy(labels),
                                  torch.from_numpy(cw))
    (num / den).backward()

    np.testing.assert_allclose(float((num / den).detach()), float(jl),
                               rtol=1e-3)
    names = [n for n, _ in model.named_parameters()]
    got, ref = _flat(model, names), _flat(jg, names)
    for n, g in zip(names, got):
        assert np.isfinite(g).all(), n
    assert _cos(np.concatenate(got), np.concatenate(ref)) > 0.98
    kern = [i for i, n in enumerate(names) if n.endswith(".kernel")]
    kg = np.concatenate([got[i] for i in kern])
    kr = np.concatenate([ref[i] for i in kern])
    assert _cos(kg, kr) > 0.998
    assert np.linalg.norm(kg - kr) / np.linalg.norm(kr) < 0.06


def test_f32_adam_step_matches_jax():
    """One Adam step (coupled L2, lr 1e-3) on the plain cores in f32: the
    loss to 1e-5 relative, and every new parameter within 1e-4 of JAX's
    (the first Adam step moves a weight by about lr * sign(grad), so this
    holds the gradients' signs and the update's arithmetic)."""
    jm = JaxVoxelUNet3d(**XLA_F32)
    variables = _numpy_vars(jm, 2)
    pts, labels, mask, cw = _batch(3, 2, 200)
    tx = jax_make_optimizer()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats={}, opt_state=tx.init(params))
    step = make_train_step(jm, tx, make_mesh(MeshSpec(data=1)),
                           donate=False)
    jb = (jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mask))
    jstate, jmetrics = step(state, jb, 1e-3, jax.random.key(0),
                            jnp.asarray(cw))

    model = _port(XLA_F32, variables)
    tstate = create_train_state(model)
    batch = tuple(torch.from_numpy(a) for a in (pts, labels, mask))
    tstate, metrics = train_step(tstate, batch, 1e-3,
                                 dropout_seeds(0, 0, 0),
                                 torch.from_numpy(cw))
    assert tstate.step == 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    assert float(metrics["correct"]) == float(jmetrics["correct"])
    sd = model.state_dict()
    for name, group in jstate.params.items():
        for leaf, r in group.items():
            # a conv bias that a GroupNorm follows has a gradient of 0 up
            # to rounding, whose sign decides Adam's first step: within
            # 2 lr, as the sign may differ
            loose = leaf == "bias" and f"{name}_gn" in group.keys() | \
                jstate.params.keys()
            np.testing.assert_allclose(sd[f"{name}.{leaf}"].numpy(),
                                       np.asarray(r), rtol=0,
                                       atol=2e-3 if loose else 1e-4,
                                       err_msg=f"{name}.{leaf}")


def test_fit_trains_and_predictor_serves_the_checkpoint(tmp_path):
    """api.fit on the CPU (fused core through the plain versions, two
    epochs): finite losses, a checkpoint with Adam state and metadata
    that rebuilds the model, resumes into a fresh optimizer, and that
    Predictor serves."""
    events = list(synthetic_events(10, min_points=30, max_points=100,
                                   seed=11))
    res = api.fit(events, device="cpu", log=lambda _: None, overrides=[
        "model.name=voxel_unet3d", "model.grid_size=8",
        "model.unet_width=16", "model.levels=2",
        "model.compute_dtype=bfloat16", "model.impl=fused",
        "data.batch_size=4", "data.buckets=64,128", "train.num_epochs=2",
        "train.log_every_steps=0", f"train.checkpoint_dir={tmp_path}"])
    assert len(res.history) == 2 and res.history[0]["train_steps"] == 2
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in res.history)
    assert res.history[1]["train_loss"] != res.history[0]["train_loss"]

    sd, nc, mcfg = load_checkpoint(res.checkpoint_path)
    opt, meta = load_train_state(res.checkpoint_path)
    assert nc == res.num_classes and mcfg.name == "voxel_unet3d"
    assert meta["epoch"] == res.best_epoch and opt["state"]
    model = build_model(mcfg, nc)
    model.load_state_dict(sd)
    state = create_train_state(model)
    state.optimizer.load_state_dict(opt)
    pts, labels, mask, cw = _batch(4, 2, 64)
    state, m = train_step(state, tuple(torch.from_numpy(a) for a in
                                       (pts, labels, mask)),
                          1e-3, dropout_seeds(0, 0, 0),
                          torch.from_numpy(cw))
    assert np.isfinite(float(m["loss"]))

    pred = Predictor.from_checkpoint(res.checkpoint_path, device="cpu",
                                     buckets=(64, 128))
    served = pred.predict_batch([p for p, _ in events[:3]], batch_size=4)
    assert [s.shape for s in served] == [(p.shape[0],) for p, _ in
                                         events[:3]]
    if res.best_epoch == len(res.history) - 1:
        direct = Predictor(res.state.model.state_dict(), nc,
                           model=build_model(mcfg, nc), device="cpu",
                           buckets=(64, 128))
        np.testing.assert_array_equal(pred.logits(events[0][0]),
                                      direct.logits(events[0][0]))
