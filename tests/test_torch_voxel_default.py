"""The voxel U-Net's default configuration, every ``*_impl`` left at
"auto", in the port against the JAX package, on the same weights (numpy,
carried over with ``ckpt.convert.from_jax_variables``) and points.

At grid 8, width 16, 2 levels, bf16 the defaults resolve to the fused
core, the one-hot "matmul" voxelize and devoxelize and the grid2 head in
both packages. On the CPU the JAX package takes its XLA forms of the
one-hot contractions (``_use_plane_kernels`` asks for a TPU); the bf16
tests patch that gate so that the JAX model reaches its Pallas kernels in
interpret mode, as it does on a TPU at R <= 64 (the patch changes no file
of the JAX package), and jit freshly inside the patch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu.ops import voxel as jv
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops.losses import cross_entropy_sums

torch.set_num_threads(1)

C = 4
DEFAULT = dict(num_classes=C, grid_size=8, width=16, levels=2,
               compute_dtype="bfloat16")
F32 = dict(num_classes=C, grid_size=8, width=8, levels=2,
           compute_dtype="float32")


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
    """Points with many per voxel (a clump), masked rows and an all-masked
    dummy event, labels and class weights."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(b, m, 3)) * 5.0,
                          rng.gamma(2.0, 1.0, size=(b, m, 1))],
                         axis=-1).astype(np.float32)
    pts[0, :30, :3] = pts[0, :1, :3] + rng.normal(size=(30, 3)) * 0.01
    mask = rng.random((b, m)) < 0.9
    mask[-1] = False
    labels = np.where(mask, rng.integers(0, C, (b, m)), -1).astype(np.int64)
    cw = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return pts, labels, mask, cw


def _port(kw, variables):
    model = VoxelUNet3d(**kw)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _plane_kernels(dt, r):
    return jnp.dtype(dt) == jnp.bfloat16 and r <= 64


@pytest.fixture(scope="module")
def jax_default():
    """One JAX run for the file: the default bf16 model's loss, gradients
    and logits, its one-hot kernels in interpret mode (~60 s)."""
    jm = JaxVoxelUNet3d(**DEFAULT)
    variables = _numpy_vars(jm, 0)
    pts, labels, mask, cw = _batch(1, 3, 256)

    def jloss(params):
        logits, _ = jm.apply({"params": params, "batch_stats": {}},
                             jnp.asarray(pts), train=True,
                             mask=jnp.asarray(mask))
        num, den = jax_ce_sums(logits, jnp.asarray(labels), jnp.asarray(cw))
        return num / den, logits

    params = jax.tree.map(jnp.asarray, variables["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "_use_plane_kernels", _plane_kernels)
        (loss, logits), grads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(params)
    return (variables, (pts, labels, mask, cw), float(loss),
            np.asarray(logits), grads)


def test_model_config_voxel_defaults_match_jax():
    port, ref = ModelConfig(), JaxModelConfig()
    for name in ("voxelize_impl", "devox_impl", "grid_size", "unet_width",
                 "levels", "compute_dtype"):
        assert getattr(port, name) == getattr(ref, name), name
    m = VoxelUNet3d(C, generator=torch.Generator().manual_seed(0))
    jm = JaxVoxelUNet3d(C)
    for name in ("voxelize_impl", "devox_impl", "conv_impl", "grid_size",
                 "width", "levels", "compute_dtype"):
        assert getattr(m, name) == getattr(jm, name), name


@pytest.mark.parametrize("grid,width,levels,dtype", [
    (8, 16, 2, "bfloat16"), (64, 16, 3, "bfloat16"), (128, 16, 3, "bfloat16"),
    (8, 8, 2, "float32")])
def test_default_forms_resolve_as_in_jax(grid, width, levels, dtype):
    m = VoxelUNet3d(C, grid_size=grid, width=width, levels=levels,
                    compute_dtype=dtype)
    forms = m.resolve_forms()
    jm = JaxVoxelUNet3d(C, grid_size=grid, width=width, levels=levels,
                        compute_dtype=dtype)
    assert forms["voxelize"] == jv.resolve_voxelize_impl(
        jm.voxelize_impl, grid, jm.in_channels)
    assert forms["devoxelize"] == jv.resolve_devoxelize_impl(
        jm.devox_impl, grid, C)
    assert forms["conv"] == ("fused" if dtype == "bfloat16" and jm._fused_ok()
                             else "xla")
    if grid <= 64:
        expect = {"conv": "fused" if dtype == "bfloat16" else "xla",
                  "voxelize": "matmul", "devoxelize": "matmul",
                  "head": "grid2" if dtype == "bfloat16" else "1x1"}
        assert forms == expect
    else:
        assert forms["voxelize"] == "scatter"
        assert forms["devoxelize"] == "gather" and forms["head"] == "1x1"


def test_default_model_logits_match_jax(jax_default):
    """Serving: the port's default model (the kernels' plain versions) vs
    the JAX default model. A bf16 value may flip by one ulp and propagate,
    so the logits are held to one bf16 ulp of their scale; masked rows are
    exactly 0."""
    variables, (pts, _, mask, _), _, ref, _ = jax_default
    model = _port(DEFAULT, variables).eval()
    assert model.resolve_forms() == {"conv": "fused", "voxelize": "matmul",
                                     "devoxelize": "matmul", "head": "grid2"}
    got = model(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -8 * scale)
    np.testing.assert_array_equal(got[~mask], 0.0)


def test_default_train_step_matches_jax(jax_default):
    """Training: one bf16 step's loss to 1e-3, the conv kernels' gradient
    vector at cosine > 0.998 (a one-ulp flip travels through the GroupNorm
    backwards), the head's dW and dbias to 1e-2 of their scale."""
    variables, (pts, labels, mask, cw), jl, _, jg = jax_default
    model = _port(DEFAULT, variables)
    logits, new_bn = model.apply(torch.from_numpy(pts), train=True,
                                 mask=torch.from_numpy(mask))
    assert new_bn == {}
    num, den = cross_entropy_sums(logits, torch.from_numpy(labels),
                                  torch.from_numpy(cw))
    (num / den).backward()
    np.testing.assert_allclose(float((num / den).detach()), jl, rtol=1e-3)

    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for n, g in grads.items():
        assert np.isfinite(g).all(), n
    kern = [n for n in grads if n.endswith(".kernel")]
    got = np.concatenate([grads[n].ravel() for n in kern])
    ref = np.concatenate([np.asarray(jg[n.split(".")[0]]["kernel"]).ravel()
                          for n in kern])
    assert float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))) \
        > 0.998
    for leaf in ("kernel", "bias"):
        r = np.asarray(jg["head"][leaf])
        np.testing.assert_allclose(grads[f"head.{leaf}"].reshape(r.shape), r,
                                   rtol=0, atol=1e-2 * np.abs(r).max(),
                                   err_msg=f"head.{leaf}")


def test_default_logits_near_scatter_gather():
    """The default forms round where the scatter/gather forms do not (the
    point features before their sums, the voxel logits, the zy weights):
    on the same weights and points their logits differ by a few bf16 ulps
    of the logits' scale, held to 4 * 2^-8 of it."""
    default = VoxelUNet3d(**DEFAULT,
                          generator=torch.Generator().manual_seed(5)).eval()
    sg = VoxelUNet3d(**DEFAULT, voxelize_impl="scatter",
                     devox_impl="gather").eval()
    sg.load_state_dict(default.state_dict())
    pts, _, mask, _ = _batch(6, 2, 256)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    got, ref = default(pts, mask), sg(pts, mask)
    assert not torch.equal(got, ref)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 4 * 2.0 ** -8 * scale


def test_default_f32_model_matches_jax():
    """The f32 defaults: the plain core with the one-hot forms in f32 (the
    JAX XLA forms) on both sides, f32 throughout."""
    jm = JaxVoxelUNet3d(**F32)
    variables = _numpy_vars(jm, 2)
    pts, _, mask, _ = _batch(3, 2, 200)
    ref = np.asarray(jax.jit(lambda v, p, m: jm.apply(v, p, mask=m))(
        variables, pts, mask))
    model = _port(F32, variables).eval()
    assert model.resolve_forms()["devoxelize"] == "matmul"
    got = model(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
