"""Slice 2 as a whole: the port's PointNetSeg training against the JAX
package's, on the same weights (made with numpy, carried over with
ckpt.convert.from_jax_variables, batch_stats included) and the same
points, at the model's full widths and a small N.

- the fused chain: ``PointNetSeg.fused_train_loss`` (the kernels' plain
  versions on the CPU) against JAX ``pointnet_fused_train_loss`` (Pallas
  in interpret mode): loss, every parameter's gradient, new batch_stats;
- the ``bn_stats="exact"`` path against JAX ``pointnet_apply(train=True,
  mask=...)`` with ``cross_entropy_sums``, f32;
- one ``train_step`` (Adam, lr 1e-3) and one ``eval_step`` against the
  JAX ``make_train_step`` / ``make_eval_step`` on a one-device CPU mesh;
- ``api.fit`` on tiny synthetic events writes a checkpoint that loads.

Dropout is 0 against JAX (the TPU's PRNG has no CPU counterpart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.pointnet import PointNetSeg as JaxPointNetSeg
from pcseg_tpu.models.pointnet import pointnet_apply as jax_apply
from pcseg_tpu.models.pointnet_fused import (
    pointnet_fused_train_loss as jax_fused_loss,
)
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu.parallel.mesh import MeshSpec, make_mesh
from pcseg_tpu.train.optim import make_optimizer as jax_make_optimizer
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu.train.steps import make_eval_step, make_train_step
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint, load_train_state
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import Config, ModelConfig
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import BN_FOR, PointNetSeg, _stages
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from pcseg_tpu_torch.train.steps import (
    create_train_state,
    dropout_seeds,
    eval_step,
    train_step,
)

torch.set_num_threads(1)

C = 4


def _numpy_vars(seed):
    """JAX variables with numpy leaves: torch-default dense init,
    non-trivial BN affines (some negative gamma_global, so the fused
    pool's sign matters) and running stats."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, din, dout in _stages(C, 4):
        bound = 1.0 / np.sqrt(din)
        params[name] = {
            "kernel": rng.uniform(-bound, bound, (din, dout)),
            "bias": rng.uniform(-bound, bound, dout)}
        bn = BN_FOR.get(name)
        if bn is not None:
            scale = rng.uniform(0.5, 1.5, dout)
            if bn == "bn_global":
                scale *= np.where(rng.random(dout) < 0.3, -1.0, 1.0)
            params[bn] = {"scale": scale, "bias": rng.normal(size=dout) * 0.1}
            stats[bn] = {"mean": rng.normal(size=dout) * 0.1,
                         "var": rng.uniform(0.5, 2.0, dout)}
    cast = lambda t: {k: {n: np.asarray(a, np.float32) for n, a in g.items()}  # noqa: E731
                      for k, g in t.items()}
    return {"params": cast(params), "batch_stats": cast(stats)}


def _batch(seed, b, m, valid, dummy_rows=0):
    """Padded points/labels/masks like data/batching.pad_events: event i
    has valid[i] points, the last ``dummy_rows`` rows are all padding."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, m, 4), np.float32)
    labels = np.full((b, m), -1, np.int64)
    masks = np.zeros((b, m), bool)
    for i in range(b - dummy_rows):
        n = valid[i]
        pts[i, :n, :3] = rng.normal(size=(n, 3)) * 5.0
        pts[i, :n, 3] = rng.gamma(2.0, 1.0, n)
        labels[i, :n] = rng.integers(0, C, n)
        masks[i, :n] = True
    cw = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return pts, labels, masks, cw


def _port(variables, **kw):
    model = PointNetSeg(C, **kw)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_tree_close(got: dict, ref: dict, rel: float, what: str,
                       floor: float = 0.0):
    """Per tensor: max|got - ref| <= rel * max|ref| + floor."""
    for name, group in ref.items():
        for leaf, r in group.items():
            r = np.asarray(r, np.float32)
            g = got[name][leaf].detach().float().numpy()
            err = float(np.abs(g - r).max())
            tol = rel * float(np.abs(r).max()) + floor
            assert err <= tol, f"{what} {name}.{leaf}: {err} > {tol}"


def _grads(model):
    return {name: {k: p.grad for k, p in group.items()}
            for name, group in model.params().items()}


def test_fused_train_loss_matches_jax():
    """Loss, all 40 gradients and the new batch_stats of the fused chain.

    Both sides keep bf16 activations and bf16 cotangents with the same
    rounding points (each op is held to its JAX op at one bf16 ulp in
    test_torch_fused_*.py). Through the chain, f32 sums in another order
    flip single bf16 values, and the train-mode BN backward, which
    subtracts each channel's mean and x_hat component from the cotangent,
    amplifies such flips: at N = 128 rows either fused chain's gradients
    are 10-70 % (of the tensor's norm) away from the same model in f32,
    the JAX one as much as the port's. So each gradient is held to the
    JAX chain's own error: ||g_port - g_jax|| <= 3 ||g_jax - g_f32||,
    with g_f32 the JAX package's XLA path with the fused chain's
    semantics (single-pass stats over all rows) in f32 (measured ratios
    0.5-1.9 on three seeds). The loss is held to one bf16 ulp (2^-8
    relative), the accuracy count to 3 of the 104 valid rows (argmax
    near-ties), the new batch_stats to two bf16 ulps (2^-7) of max|ref|.
    """
    variables = _numpy_vars(0)
    pts, labels, _, cw = _batch(1, 2, 64, [64, 40])
    jpts, jlab, jcw = jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(cw)

    def loss_fn(params):
        (num, den, cor), new_bn = jax_fused_loss(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jpts, jlab, jcw, dropout_key=None, dropout_rate=0.0)
        return num / den, (cor, new_bn)

    def f32_loss(params):
        logits, _ = jax_apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jpts, train=True, mask=None, dropout_rate=0.0,
            fast_bn_stats=True)
        num, den = jax_ce_sums(logits, jlab, jcw)
        return num / den

    (jloss, (jcor, jbn)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    fgrads = jax.jit(jax.grad(f32_loss))(variables["params"])

    model = _port(variables, dropout=0.0, bn_stats="fused",
                  compute_dtype="bfloat16")
    assert model.supports_fused_loss()
    tp, tl, tc = _tensors(pts, labels, cw)
    (num, den, cor), new_bn = model.fused_train_loss(tp, tl, tc,
                                                     seeds=(0, 0))
    loss = num / den
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=2.0 ** -8)
    assert abs(float(cor) - float(jcor)) <= 3
    grads = _grads(model)
    for name, group in jgrads.items():
        for leaf, r in group.items():
            r = np.asarray(r)
            own = np.linalg.norm(r - np.asarray(fgrads[name][leaf]))
            err = np.linalg.norm(grads[name][leaf].numpy() - r)
            assert err <= 3.0 * own, f"grad {name}.{leaf}: {err} > 3 x {own}"
    _assert_tree_close(new_bn, jbn, 2.0 ** -7, "batch_stats")


def test_exact_train_path_matches_jax():
    """bn_stats="exact", f32: logits, loss, gradients and new
    batch_stats, with one all-masked dummy row that the statistics must
    skip. f32 on both sides, the matmuls sum in another order: logits
    and loss within 1e-4, gradients within 1e-4 of max|ref| + 1e-6 (the
    biases of layers that a train-mode BN follows have a gradient of 0
    up to rounding, ~1e-8), batch_stats within 1e-5 of max|ref|."""
    variables = _numpy_vars(2)
    pts, labels, masks, cw = _batch(3, 3, 48, [48, 30], dummy_rows=1)

    def loss_fn(params):
        logits, new_bn = jax_apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pts), train=True, mask=jnp.asarray(masks),
            dropout_rate=0.0)
        num, den = jax_ce_sums(logits, jnp.asarray(labels), jnp.asarray(cw))
        return num / den, (logits, new_bn)

    (jloss, (jlogits, jbn)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    model = _port(variables, dropout=0.0, bn_stats="exact")
    tp, tl, tm, tc = _tensors(pts, labels, masks, cw)
    logits, new_bn = model.apply(tp, train=True, mask=tm)
    num, den = cross_entropy_sums(logits, tl, tc)
    (num / den).backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float((num / den).detach()), float(jloss),
                               rtol=1e-4)
    _assert_tree_close(_grads(model), jgrads, 1e-4, "grad", floor=1e-6)
    _assert_tree_close(new_bn, jbn, 1e-5, "batch_stats")


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step and one eval step (XLA path, one-device mesh)."""
    variables = _numpy_vars(4)
    batch = _batch(5, 2, 64, [64, 50])
    pts, labels, masks, cw = batch
    jm = JaxPointNetSeg(num_classes=C, dropout=0.0, bn_stats="exact")
    tx = jax_make_optimizer()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(
                              jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params))
    mesh = make_mesh(MeshSpec(data=1))
    jb = (jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(masks))
    step = make_train_step(jm, tx, mesh, donate=False)
    new_state, metrics = step(state, jb, 1e-3, jax.random.key(0),
                              jnp.asarray(cw))
    ev = make_eval_step(jm, mesh, C)(new_state, jb, jnp.asarray(cw))
    return variables, batch, new_state, metrics, ev


def test_train_step_matches_jax(jax_step):
    """One Adam step (coupled L2, lr 1e-3). The loss and metrics hold to
    1e-5 relative, the new batch_stats to 1e-5 of max|ref|. Adam's first
    step moves each weight by about lr * sign(grad), so an element whose
    tiny gradient changes sign between the two f32 computations moves the
    other way: every new parameter is within 2 lr of JAX's, and at least
    99.9 % within 1e-6."""
    variables, (pts, labels, masks, cw), jstate, jm, _ = jax_step
    model = _port(variables, dropout=0.0, bn_stats="exact")
    state = create_train_state(model)
    batch = _tensors(pts, labels, masks)
    state, metrics = train_step(state, batch, 1e-3,
                                dropout_seeds(0, 0, 0),
                                torch.from_numpy(cw))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(metrics["correct"]) == float(jm["correct"])
    assert float(metrics["total"]) == float(jm["total"])
    _assert_tree_close(model.batch_stats(), jstate.batch_stats, 1e-5,
                       "batch_stats")
    close = total = 0
    for name, group in jstate.params.items():
        for leaf, r in group.items():
            d = np.abs(model.params()[name][leaf].detach().numpy()
                       - np.asarray(r))
            assert float(d.max()) <= 2e-3 * (1 + 1e-3), f"{name}.{leaf}"
            close += int((d <= 1e-6).sum())
            total += d.size
    assert close / total >= 0.999, close / total


def test_eval_step_matches_jax(jax_step):
    """eval_step on the stepped JAX state: loss within 1e-5 relative,
    accuracy counts and confusion matrix equal."""
    _, (pts, labels, masks, cw), jstate, _, jev = jax_step
    model = PointNetSeg(C, dropout=0.0)
    model.load_state_dict(from_jax_variables(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}))
    state = create_train_state(model.eval())
    ev = eval_step(state, _tensors(pts, labels, masks), torch.from_numpy(cw),
                   C)
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]),
                               rtol=1e-5)
    assert float(ev["correct"]) == float(jev["correct"])
    assert float(ev["total"]) == float(jev["total"])
    np.testing.assert_array_equal(ev["confusion"].numpy(),
                                  np.asarray(jev["confusion"]))


@pytest.mark.parametrize("bn_stats", ["fused", "exact"])
def test_fit_writes_a_checkpoint_that_loads(tmp_path, bn_stats):
    """api.fit, two epochs on the CPU, at dropout 0.3 (the masks of
    ops/dropout.py): finite losses, and the best checkpoint rebuilds the
    model with the trained weights and running stats."""
    events = list(synthetic_events(10, min_points=30, max_points=100,
                                   seed=11))
    cfg = Config()
    res = api.fit(events, config=cfg, device="cpu", log=lambda _: None,
                  overrides=[f"model.bn_stats={bn_stats}",
                             "model.compute_dtype=bfloat16",
                             "data.batch_size=4", "data.buckets=64,128",
                             "train.num_epochs=2", "train.log_every_steps=0",
                             f"train.checkpoint_dir={tmp_path}"])
    assert len(res.history) == 2
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in res.history)
    assert res.history[0]["train_steps"] == 2
    sd, nc, mcfg = load_checkpoint(res.checkpoint_path)
    opt, meta = load_train_state(res.checkpoint_path)
    assert nc == res.num_classes and mcfg.bn_stats == bn_stats
    assert meta["epoch"] == res.best_epoch and opt["state"]
    assert {"bn_global.mean", "bn_global.var", "conv1.kernel"} <= set(sd)
    model = build_model(mcfg, nc)
    model.load_state_dict(sd)
    if res.best_epoch == len(res.history) - 1:
        for k, v in res.state.model.state_dict().items():
            assert torch.equal(sd[k], v), k


def test_fused_apply_logits_match_the_fused_loss():
    """Train-mode ``apply`` on the fused chain (its f32 logits layer) and
    the classifier + CE op see the same chain, dropout masks included:
    cross_entropy_sums of the logits equals the op's num/den (the same f32
    operations, 1e-6 relative), the argmax count and batch_stats agree."""
    variables = _numpy_vars(8)
    pts, labels, _, cw = _batch(9, 2, 64, [64, 50])
    model = _port(variables, dropout=0.3, bn_stats="fused")
    tp, tl, tc = _tensors(pts, labels, cw)
    with torch.no_grad():
        logits, bn_a = model.apply(tp, train=True, seeds=(5, 6))
        (num, den, cor), bn_b = model.fused_train_loss(tp, tl, tc,
                                                       seeds=(5, 6))
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, C)
    ref_num, ref_den = cross_entropy_sums(logits, tl, tc)
    np.testing.assert_allclose(float(num), float(ref_num), rtol=1e-6)
    np.testing.assert_allclose(float(den), float(ref_den), rtol=1e-6)
    hits = (logits.argmax(-1) == tl) & (tl >= 0)
    assert float(cor) == float(hits.sum())
    for name, st in bn_a.items():
        for k, v in st.items():
            assert torch.equal(v, bn_b[name][k]), (name, k)


def test_point_counts_off_the_fused_tiling_take_the_plain_path(monkeypatch):
    """M % 8 != 0 trains on the plain layers with single-pass statistics,
    as the JAX train step routes such buckets off its fused kernels."""
    import pcseg_tpu_torch.models.pointnet_fused as pf

    calls = []
    real = pf.pointnet_fused_train_loss
    monkeypatch.setattr(pf, "pointnet_fused_train_loss",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = PointNetSeg(C, bn_stats="fused", dropout=0.0,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    for m, fused in ((36, False), (40, True)):
        pts, labels, masks, cw = _batch(6, 2, m, [m, m - 5])
        calls.clear()
        _, metrics = train_step(state, _tensors(pts, labels, masks), 1e-3,
                                dropout_seeds(0, 0, 0),
                                torch.from_numpy(cw))
        assert bool(calls) == fused and np.isfinite(float(metrics["loss"]))


def test_bucket_batcher_matches_jax():
    """The port's BucketBatcher yields the JAX package's batches, equal
    array for array: 70 ragged events at batch 2 span two length-sorting
    windows (32 batches each) and a short final batch; two shuffled
    epochs, and the unshuffled validation order."""
    from pcseg_tpu.data.batching import BucketBatcher as JaxBatcher
    from pcseg_tpu_torch.data.batching import BucketBatcher

    rng = np.random.default_rng(12)
    events = []
    for n in rng.integers(1, 90, 70):
        events.append((rng.normal(size=(n, 4)).astype(np.float32),
                       rng.integers(0, C, n).astype(np.int64)))
    idx = rng.permutation(70)[:65]
    for kw in ({"shuffle": True, "seed": 3}, {"shuffle": False}):
        port = BucketBatcher(events, 2, buckets=(16, 32, 64, 128),
                             indices=idx, **kw)
        ref = JaxBatcher(events, 2, buckets=(16, 32, 64, 128), indices=idx,
                         **kw)
        assert len(port) == len(ref) == 33
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 33
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_factory_builds_pointnet_from_config():
    cfg = ModelConfig(bn_stats="fused", compute_dtype="bfloat16")
    model = build_model(cfg, 5, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, PointNetSeg) and model.supports_fused_loss()
    assert model.seg_conv4.kernel.shape == (128, 5)
    assert model.bn_global.var.shape == (1024,)
    with pytest.raises(ValueError, match="mask_norm_and_pool"):
        PointNetSeg(4, bn_stats="fused", mask_norm_and_pool=True)
