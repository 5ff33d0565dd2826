"""The voxel U-Net's ``remat`` in the port: the core recomputed in the
backward (``torch.utils.checkpoint``) against the core kept, and against
the JAX ``VoxelUNet3d(remat=True)`` (``jax.checkpoint``), whose fused
core runs its Pallas blocks in interpret mode on the CPU.

- remat=True against remat=False on the plain versions: the loss and
  every gradient bit for bit (the CPU's plain versions repeat their
  bits, so the recomputed forward is the first one);
- remat=True against JAX remat=True: the tolerances of
  ``test_torch_voxel_train.py``'s fused-step test;
- the step saves for the backward far less with remat; serving takes no
  graph, with or without it; the factory passes ``model.remat`` on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig, apply_overrides, Config
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from tests.test_torch_voxel_train import FUSED, XLA_F32, _batch, _numpy_vars

torch.set_num_threads(1)


def _loss_and_grads(kw, variables, batch, remat):
    model = VoxelUNet3d(**kw, remat=remat)
    model.load_state_dict(from_jax_variables(variables))
    pts, labels, mask, cw = (torch.from_numpy(a) for a in batch)
    logits, _ = model.apply(pts, train=True, mask=mask)
    num, den = cross_entropy_sums(logits, labels, cw)
    loss = num / den
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [FUSED, XLA_F32], ids=["fused_bf16",
                                                      "xla_f32"])
def test_remat_step_equals_the_kept_core(kw):
    """Loss and every gradient identical with and without remat."""
    variables = _numpy_vars(JaxVoxelUNet3d(**kw), 5)
    batch = _batch(6, 2, 200)
    loss0, g0 = _loss_and_grads(kw, variables, batch, remat=False)
    loss1, g1 = _loss_and_grads(kw, variables, batch, remat=True)
    assert loss1 == loss0
    assert g1.keys() == g0.keys()
    for n in g0:
        assert torch.isfinite(g0[n]).all(), n
        assert torch.equal(g1[n], g0[n]), n


def test_remat_step_matches_jax_remat():
    """The port's remat step against ``jax.value_and_grad`` of the JAX
    remat model on the same weights and batch, held as
    ``test_fused_train_step_gradients_match_jax`` holds the step without
    remat: the loss to 1e-3 relative, the gradient vector by cosine
    (> 0.98 overall, > 0.998 over the conv kernels) and the kernels'
    relative L2 (< 0.06)."""
    jm = JaxVoxelUNet3d(**FUSED, remat=True)
    variables = _numpy_vars(jm, 7)
    batch = _batch(8, 2, 256)
    pts, labels, mask, cw = batch

    def jloss(params):
        logits, _ = jm.apply({"params": params, "batch_stats": {}},
                             jnp.asarray(pts), train=True,
                             mask=jnp.asarray(mask))
        num, den = jax_ce_sums(logits, jnp.asarray(labels), jnp.asarray(cw))
        return num / den

    params = jax.tree.map(jnp.asarray, variables["params"])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss, grads = _loss_and_grads(FUSED, variables, batch, remat=True)

    np.testing.assert_allclose(loss, float(jl), rtol=1e-3)
    names = list(grads)
    got = [grads[n].numpy().ravel() for n in names]
    ref = [np.asarray(jg[a][b], np.float32).ravel()
           for a, b in (n.split(".") for n in names)]
    cos = lambda a, b: float(np.dot(a, b) / (np.linalg.norm(a)  # noqa: E731
                                             * np.linalg.norm(b)))
    assert cos(np.concatenate(got), np.concatenate(ref)) > 0.98
    kern = [i for i, n in enumerate(names) if n.endswith(".kernel")]
    kg = np.concatenate([got[i] for i in kern])
    kr = np.concatenate([ref[i] for i in kern])
    assert cos(kg, kr) > 0.998
    assert np.linalg.norm(kg - kr) / np.linalg.norm(kr) < 0.06


def _saved_bytes(model, batch):
    """Bytes of the tensors autograd keeps for the backward of one
    forward (the saved-tensor hooks see every tensor a node saves, a
    checkpointed region's only at its boundary)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    pts, labels, mask, cw = (torch.from_numpy(a) for a in batch)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = model.apply(pts, train=True, mask=mask)
    return total[0]


def test_remat_keeps_only_the_core_boundary():
    """With remat the forward saves less than a third of the bytes that
    the kept core saves (the voxelize and devoxelize tensors and the
    core's input stay); the recompute needs every tensor of the core's
    autograd Functions through ``save_for_backward``."""
    variables = _numpy_vars(JaxVoxelUNet3d(**FUSED), 9)
    batch = _batch(10, 2, 200)
    sizes = {}
    for remat in (False, True):
        model = VoxelUNet3d(**FUSED, remat=remat)
        model.load_state_dict(from_jax_variables(variables))
        sizes[remat] = _saved_bytes(model, batch)
    assert sizes[True] * 3 < sizes[False], sizes


def test_remat_serving_takes_no_graph_and_the_factory_passes_it():
    cfg = Config()
    apply_overrides(cfg, ["model.name=voxel_unet3d", "model.grid_size=8",
                          "model.unet_width=16", "model.levels=2",
                          "model.compute_dtype=bfloat16", "model.remat=true"])
    assert cfg.model.remat is True and cfg.to_dict()["model"]["remat"]
    model = build_model(cfg.model, 4,
                        generator=torch.Generator().manual_seed(0))
    assert model.remat and model.resolve_conv_impl() == "fused"
    plain = build_model(ModelConfig(**{**cfg.model.to_dict(),
                                       "remat": False}), 4)
    plain.load_state_dict(model.state_dict())
    pts, _, mask, _ = _batch(11, 2, 64)
    out = model(torch.from_numpy(pts), torch.from_numpy(mask))
    assert out.grad_fn is None and not out.requires_grad
    ref = plain(torch.from_numpy(pts), torch.from_numpy(mask))
    assert torch.equal(out, ref)
    # an old checkpoint's config, without the field, loads as remat=False
    old = cfg.model.to_dict()
    del old["remat"]
    assert ModelConfig(**old).remat is False
