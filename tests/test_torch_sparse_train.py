"""Training the port's SparseVoxelNet (block impl): one train step's loss,
every parameter gradient and the capacity overflow against the JAX
package's, and ``api.fit`` on the sparse family on the CPU.

The JAX model runs its fused TPU forms in interpret mode
(``fused_ln="interpret"``, ``conv_impl="interpret"``): the Pallas block
conv and fused bias + LN kernels, with their custom VJPs. Small size:
grid 16, tile 4, width 16, depth 2, 2 levels, bf16, B2 x 512 track events
with masked points, at capacities (16, 6) that drop tiles at both levels.
The parameters come from numpy and are carried over with
``ckpt.convert.from_jax_variables``.

Tolerances: the loss within 1e-3 relative; each gradient within 2^-6 of
its norm (relative L2). The JAX model on the CPU differentiates its
readout by autodiff, which sums the f32 point cotangents, while the port
takes the TPU's form, ``rowcol_scatter`` of the bf16-rounded cotangents
(``_readout_bwd``); that one rounding (2^-9 relative a point) and the bf16
chain's roundings after it move the gradients by 1.7e-3 (median) to
4.9e-3 (worst) of their norm. tests/test_torch_sparse_train_tpu_form.py
routes the JAX readout through its TPU form instead and holds the
gradients far tighter. The overflow counts are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from test_torch_sparse_unet import SMALL, _numpy_vars, _points

torch.set_num_threads(1)

C = 4
DROPPING = dict(SMALL, max_tiles=16, max_tiles_schedule=(16, 6))
LOSS_REL, GRAD_REL = 1e-3, 2.0 ** -6


def _labels(mask):
    labels = np.random.default_rng(11).integers(0, C, mask.shape)
    return np.where(mask, labels, -1)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX interpret-mode model's loss, gradients and overflow."""
    jm = JaxSparseVoxelNet(**DROPPING, fused_ln="interpret",
                           conv_impl="interpret")
    variables = _numpy_vars(jm, 0)
    pts, mask = _points()
    labels = _labels(mask)

    def loss_fn(params):
        logits, aux = jm.apply({"params": params, "batch_stats": {}},
                               jnp.asarray(pts), train=True,
                               mask=jnp.asarray(mask))
        num, den = jax_ce(logits, jnp.asarray(labels), jnp.ones(C))
        return num / den, aux

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    grads = {f"{g}.{k}": np.asarray(v) for g, leaves in grads.items()
             for k, v in leaves.items()}
    return (variables, (pts, mask, labels), float(loss),
            np.asarray(aux["__overflow__"]), grads)


def test_train_step_matches_jax_value_and_grad(jax_step):
    variables, (pts, mask, labels), want_loss, want_drop, want = jax_step
    model = SparseVoxelNet(**DROPPING)
    model.load_state_dict(from_jax_variables(variables))
    logits, aux = model.apply(torch.from_numpy(pts), train=True,
                              mask=torch.from_numpy(mask))
    num, den = cross_entropy_sums(logits, torch.from_numpy(labels),
                                  torch.ones(C))
    loss = num / den
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(aux["__overflow__"].numpy(), want_drop)
    assert want_drop.sum() > 0
    loss_rel = abs(float(loss.detach()) - want_loss) / abs(want_loss)
    rel = {n: float(np.linalg.norm(got[n] - want[n])
                    / max(np.linalg.norm(want[n]), 1e-30)) for n in want}
    worst = max(rel, key=rel.get)
    print(f"sparse train step vs JAX: loss rel {loss_rel:.2e}; gradient "
          f"rel L2 worst {rel[worst]:.3e} at {worst}, median "
          f"{float(np.median(list(rel.values()))):.3e}")
    assert loss_rel <= LOSS_REL, loss_rel
    assert rel[worst] <= GRAD_REL, (worst, rel)


def test_train_step_through_plain_path_is_differentiable(jax_step):
    """``plain=True`` takes the same backward: identical gradients on the
    CPU, where both are the plain versions."""
    variables, (pts, mask, labels), _, _, _ = jax_step
    grads = []
    for plain in (False, True):
        model = SparseVoxelNet(**DROPPING)
        model.load_state_dict(from_jax_variables(variables))
        logits, _ = model.apply(torch.from_numpy(pts), train=True,
                                mask=torch.from_numpy(mask), plain=plain)
        num, den = cross_entropy_sums(logits, torch.from_numpy(labels),
                                      torch.ones(C))
        (num / den).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=0)


def _events(n, m, seed):
    rng = np.random.default_rng(seed)
    out = []
    for p in track_events(n, m, rng):
        out.append((p, rng.integers(0, C, p.shape[0])))
    return out


FIT = ["model.name=sparse_voxelnet", f"model.num_classes={C}",
       "model.grid_size=16", "model.unet_width=8", "model.depth=2",
       "model.levels=2", "model.tile=4", "model.compute_dtype=bfloat16",
       "data.batch_size=4", "data.buckets=256", "train.num_epochs=2"]


def test_fit_counts_dropped_tiles_and_serves(tmp_path):
    """api.fit on the CPU: the dropped tiles of each epoch land in the
    history and warn in the log at a capacity that drops them; the best
    checkpoint serves through Predictor; none at a roomy capacity."""
    events = _events(10, 256, 1)
    lines = []
    res = api.fit(events, overrides=FIT + [
        "model.max_tiles=12", f"train.checkpoint_dir={tmp_path / 'a'}"],
        device="cpu", log=lines.append)
    assert all(h["dropped_train"] > 0 for h in res.history)
    assert all("dropped_val" in h for h in res.history)
    assert sum("WARNING: capacity overflow" in ln for ln in lines) == 2
    assert all(np.isfinite(h["train_loss"]) for h in res.history)
    pred = api.predictor(res.checkpoint_path, device="cpu")
    with pytest.warns(UserWarning, match="capacity overflow"):
        assert pred.predict(events[0][0]).shape == (256,)

    lines = []
    res = api.fit(events, overrides=FIT + [
        "model.max_tiles=64", f"train.checkpoint_dir={tmp_path / 'b'}"],
        device="cpu", log=lines.append)
    assert [h["dropped_train"] + h["dropped_val"] for h in res.history] == \
        [0, 0]
    assert not any("capacity overflow" in ln for ln in lines)
    assert api.predict(res.checkpoint_path, events[1][0],
                       device="cpu").shape == (256,)


def test_fit_strict_capacity_raises(tmp_path):
    with pytest.raises(RuntimeError, match="capacity overflow"):
        api.fit(_events(10, 256, 1), overrides=FIT + [
            "model.max_tiles=12", "model.strict_capacity=true",
            f"train.checkpoint_dir={tmp_path}"], device="cpu",
            log=lambda _: None)
