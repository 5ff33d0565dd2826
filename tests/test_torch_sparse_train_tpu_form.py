"""One train step of the port's SparseVoxelNet against the JAX model with
its readout in the form the TPU runs: the ``_readout`` custom VJP, whose
backward is the Pallas ``rowcol_scatter`` (interpret mode) of the
bf16-rounded point cotangents. On the CPU the JAX package takes the
readout's autodiff transpose instead (``tpu_kernels_enabled()`` is False,
pcseg_tpu/ops/block_sparse.py ``block_gather_point_logits``); this test
swaps in the TPU branch of that function, so that the two backwards round
at the same points. Everything else is as in test_torch_sparse_train.py:
grid 16, tile 4, width 16, depth 2, 2 levels, bf16, B2 x 512 track events
with masked points, capacities (16, 6) that drop tiles at both levels,
the Pallas block conv and fused bias + LN kernels in interpret mode.

Tolerances: the loss within 1e-6 relative; each gradient within 1e-5
of its norm (relative L2): the same rounding points, f32 sums in another
order (1.7e-6 at worst, printed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu.ops import block_sparse as jbs
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from test_torch_sparse_train import C, DROPPING, _labels
from test_torch_sparse_unet import _numpy_vars, _points

torch.set_num_threads(1)

LOSS_REL, GRAD_REL = 1e-6, 1e-5


def _tpu_readout(site_values, bs, points, mask):
    """The TPU branch of the JAX ``block_gather_point_logits``."""
    slot, intra = jbs._point_cells(bs, points, mask)
    b, nt = site_values.shape[:2]
    out = jbs._readout(site_values.reshape(b, nt, bs.tile ** 3, -1), slot,
                       intra)
    return jnp.where(mask[..., None], out, 0.0)


@pytest.fixture(scope="module")
def jax_step():
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbs, "block_gather_point_logits", _tpu_readout)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
    grads = {f"{g}.{k}": np.asarray(v) for g, leaves in grads.items()
             for k, v in leaves.items()}
    return (variables, (pts, mask, labels), float(loss),
            np.asarray(aux["__overflow__"]), grads)


def test_train_step_matches_jax_tpu_readout_form(jax_step):
    variables, (pts, mask, labels), want_loss, want_drop, want = jax_step
    model = SparseVoxelNet(**DROPPING)
    model.load_state_dict(from_jax_variables(variables))
    logits, aux = model.apply(torch.from_numpy(pts), train=True,
                              mask=torch.from_numpy(mask))
    num, den = cross_entropy_sums(logits, torch.from_numpy(labels),
                                  torch.ones(C))
    loss = num / den
    loss.backward()
    np.testing.assert_array_equal(aux["__overflow__"].numpy(), want_drop)
    loss_rel = abs(float(loss.detach()) - want_loss) / abs(want_loss)
    rel = {n: float(np.linalg.norm(p.grad.numpy() - want[n])
                    / max(np.linalg.norm(want[n]), 1e-30))
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"sparse train step vs the JAX TPU readout form: loss rel "
          f"{loss_rel:.2e}; gradient rel L2 worst {rel[worst]:.3e} at "
          f"{worst}")
    assert set(rel) == set(want)
    assert loss_rel <= LOSS_REL, loss_rel
    assert rel[worst] <= GRAD_REL, (worst, rel)
