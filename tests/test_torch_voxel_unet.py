"""The port's VoxelUNet3d and Predictor against the JAX package's, on the
same weights (carried over with ckpt.convert.from_jax_variables) and the
same points."""

import jax
import numpy as np
import pytest
import torch

from pcseg_tpu.infer import Predictor as JaxPredictor
from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import save_checkpoint
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

torch.set_num_threads(1)

FUSED = dict(num_classes=4, grid_size=8, width=16, levels=2,
             compute_dtype="bfloat16", voxelize_impl="scatter",
             devox_impl="gather")
XLA_F32 = dict(num_classes=4, grid_size=8, width=8, levels=2,
               compute_dtype="float32", conv_impl="xla",
               voxelize_impl="scatter", devox_impl="gather")


def _apply(jm, variables, pts, mask):
    fwd = jax.jit(lambda v, p, m: jm.apply(v, p, mask=m))
    return np.asarray(fwd(variables, pts, mask))


def _numpy_vars(model, seed):
    """Random parameters in the JAX model's structure, made with numpy
    (shapes from jax.eval_shape, which compiles nothing): He-uniform
    kernels, and non-trivial biases and GroupNorm affines."""
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


def _port(kw, variables_np):
    m = VoxelUNet3d(**kw)
    m.load_state_dict(from_jax_variables(variables_np))
    return m.eval()


def _points(seed, b, m):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(b, m, 3)) * 5.0,
                          rng.gamma(2.0, 1.0, size=(b, m, 1))],
                         axis=-1).astype(np.float32)
    mask = rng.random((b, m)) < 0.9
    return pts, mask


@pytest.fixture(scope="module")
def fused_case():
    """The JAX fused core (Pallas kernels in interpret mode, ~20 s) run
    once for the file."""
    jm = JaxVoxelUNet3d(**FUSED, conv_impl="fused")
    variables = _numpy_vars(jm, 0)
    pts, mask = _points(1, 1, 256)
    ref = _apply(jm, variables, pts, mask)
    return variables, pts, mask, ref


def test_xla_core_matches_jax_f32():
    jm = JaxVoxelUNet3d(**XLA_F32)
    variables = _numpy_vars(jm, 2)
    pts, mask = _points(3, 2, 256)
    ref = _apply(jm, variables, pts, mask)
    got = _port(XLA_F32, variables)(torch.from_numpy(pts),
                                    torch.from_numpy(mask))
    # f32 throughout; the convs sum in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fused_core_matches_jax_fused(fused_case):
    """The slice end to end: the port's fused core (the kernels' plain
    versions, which share their rounding points) against the JAX fused
    core with its Pallas kernels, bf16."""
    variables, pts, mask, ref = fused_case
    model = _port(dict(FUSED, conv_impl="fused"), variables)
    assert model.resolve_conv_impl() == "fused"
    got = model(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    # same rounding points, f32 sums in another order: a bf16 value may
    # flip by one ulp (2^-8 relative) and propagate, so the logits are held
    # to one bf16 ulp of their scale (measured: 2.3e-4 at scale 3.8)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -8 * scale)
    np.testing.assert_array_equal(got[~mask], 0.0)


def test_predictor_matches_jax_predictor():
    jm = JaxVoxelUNet3d(**XLA_F32)
    variables = _numpy_vars(jm, 4)
    events = [p for p, _ in synthetic_events(5, min_points=50,
                                             max_points=300, seed=5)]
    buckets = (128, 256, 512)
    jp = JaxPredictor(variables, 4, model=jm, buckets=buckets)
    tp = Predictor(from_jax_variables(variables), 4,
                   model=VoxelUNet3d(**XLA_F32), buckets=buckets,
                   device="cpu")
    # f32 on both sides, the convs sum in another order
    for e in events[:2]:
        np.testing.assert_allclose(tp.logits(e), np.asarray(jp.logits(e)),
                                   rtol=1e-4, atol=1e-4)
    got = tp.predict_batch(events, batch_size=4)
    ref = jp.predict_batch(events, batch_size=4)
    for g, r, e in zip(got, ref, events):
        logits = np.sort(np.asarray(jp.logits(e)), axis=-1)
        clear = logits[:, -1] - logits[:, -2] > 1e-3   # not a near-tie
        np.testing.assert_array_equal(g[clear], r[clear])
        assert clear.mean() > 0.99


def test_checkpoint_roundtrip_and_api(tmp_path):
    cfg = ModelConfig(name="voxel_unet3d", grid_size=8, unet_width=8,
                      levels=2, compute_dtype="float32", impl="xla")
    model = build_model(cfg, 4, generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path / "model.pt"), model.state_dict(), 4,
                           cfg)
    points = next(iter(synthetic_events(1, min_points=90, max_points=90)))[0]
    direct = Predictor(model.state_dict(), 4, model=model, device="cpu")
    loaded = api.predictor(path, device="cpu")
    np.testing.assert_array_equal(loaded.logits(points),
                                  direct.logits(points))
    np.testing.assert_array_equal(api.predict(path, points, device="cpu"),
                                  direct.predict(points))
