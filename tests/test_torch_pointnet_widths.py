"""The fused PointNet chain at the widths the JAX package trains beyond
the bench's 4 classes and 4 input features: 40 classes (the classifier +
CE and the logits layer past 32 classes) and 20 input features (conv1 on
K chunks).

- ``PointNetSeg.fused_train_loss`` (the kernels' plain versions on the
  CPU) against JAX ``pointnet_fused_train_loss`` (Pallas in interpret
  mode): loss, accuracy count, every parameter's gradient, the new
  batch_stats, held as ``tests/test_torch_pointnet.py`` holds the 4-class
  chain;
- the card routes: ``fused_block.route_of`` and ``fused_ce.check_widths``
  take 1..128 classes at Cin 128 and any Cin for conv1, so such a model's
  every layer has a kernel on the card (the kernels themselves are held
  to the plain versions by ``tests/test_torch_cuda_pointnet.py``).

Dropout is 0 against JAX (the TPU's PRNG has no CPU counterpart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.pointnet import pointnet_apply as jax_apply
from pcseg_tpu.models.pointnet_fused import (
    pointnet_fused_train_loss as jax_fused_loss,
)
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.models.pointnet import BN_FOR, PointNetSeg, _stages
from pcseg_tpu_torch.ops import fused_block as fb
from pcseg_tpu_torch.ops import fused_ce as fc

torch.set_num_threads(1)


def _numpy_vars(seed, classes, input_dim):
    """JAX variables with numpy leaves (torch-default dense init, BN
    affines with some negative gamma_global, running stats)."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, din, dout in _stages(classes, input_dim):
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


def _batch(seed, b, m, valid, classes, input_dim):
    """Padded points (xyz, a charge, then normal features), labels and
    class weights; event i has valid[i] points."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, m, input_dim), np.float32)
    labels = np.full((b, m), -1, np.int64)
    for i in range(b):
        n = valid[i]
        pts[i, :n, :3] = rng.normal(size=(n, 3)) * 5.0
        pts[i, :n, 3] = rng.gamma(2.0, 1.0, n)
        pts[i, :n, 4:] = rng.normal(size=(n, input_dim - 4))
        labels[i, :n] = rng.integers(0, classes, n)
    cw = rng.uniform(0.5, 2.0, classes).astype(np.float32)
    return pts, labels, cw


@pytest.mark.parametrize("classes, input_dim", [(40, 4), (4, 20)])
def test_fused_train_loss_matches_jax_at_new_widths(classes, input_dim):
    """Loss to one bf16 ulp (2^-8 relative), the accuracy count to 3 of
    the 104 valid rows (argmax near-ties), each gradient within 3x the JAX
    chain's own distance from the same model in f32 (the train-mode BN
    backward amplifies one-ulp bf16 flips; test_torch_pointnet.py states
    the reasoning), the new batch_stats to two bf16 ulps of max|ref|."""
    variables = _numpy_vars(5, classes, input_dim)
    pts, labels, cw = _batch(6, 2, 64, [64, 40], classes, input_dim)
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

    model = PointNetSeg(classes, input_dim=input_dim, dropout=0.0,
                        bn_stats="fused", compute_dtype="bfloat16")
    model.load_state_dict(from_jax_variables(variables))
    assert model.supports_fused_loss()
    tp, tl, tc = (torch.from_numpy(a) for a in (pts, labels, cw))
    (num, den, cor), new_bn = model.fused_train_loss(tp, tl, tc,
                                                     seeds=(0, 0))
    loss = num / den
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=2.0 ** -8)
    assert abs(float(cor) - float(jcor)) <= 3
    grads = {name: {k: p.grad for k, p in group.items()}
             for name, group in model.params().items()}
    for name, group in jgrads.items():
        for leaf, r in group.items():
            r = np.asarray(r)
            own = np.linalg.norm(r - np.asarray(fgrads[name][leaf]))
            err = np.linalg.norm(grads[name][leaf].numpy() - r)
            assert err <= 3.0 * own, f"grad {name}.{leaf}: {err} > 3 x {own}"
    for name, group in jbn.items():
        for leaf, r in group.items():
            r = np.asarray(r, np.float32)
            err = float(np.abs(new_bn[name][leaf].detach().numpy() - r).max())
            assert err <= 2.0 ** -7 * float(np.abs(r).max()), (name, leaf)


@pytest.mark.parametrize("classes", [1, 4, 32, 33, 40, 64, 100, 127, 128])
def test_every_class_count_of_the_jax_kernel_has_a_card_route(classes):
    """The classifier + CE takes 1..128 classes; the logits layer takes
    them on the narrow route, or on wgmma at 64 and 128."""
    fc.check_widths(128, classes)
    assert fb.route_of(128, classes) == (
        "wgmma" if classes % 64 == 0 else "narrow")


@pytest.mark.parametrize("input_dim", [1, 3, 4, 5, 16, 17, 20, 33, 100, 200])
def test_conv1_takes_any_input_dim(input_dim):
    """conv1 (Cout 64) takes any Cin on the simt route (K chunks of 16)."""
    assert fb.route_of(input_dim, 64) == "simt"
