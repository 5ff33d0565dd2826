"""The port's voxelize (scatter) and devoxelize (gather) against the JAX
package's, in f32 on the same points; voxelize's ``feature_dim`` on the
scatter and the matmul forms (f32, and bf16 through row 10's plain
version).

Tolerance 1e-5: both sides compute the voxel ids with the same f32
elementwise math, so only the order of the scatter sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops import voxel as jv
from pcseg_tpu_torch.ops import voxel as tv

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _points(rng, b=3, m=200):
    pts = np.concatenate(
        [rng.normal(size=(b, m, 3)) * 10.0,
         rng.gamma(2.0, 1.0, size=(b, m, 2))], axis=-1).astype(np.float32)
    mask = rng.random((b, m)) < 0.8
    mask[-1] = False                    # an all-masked dummy row
    pts[-1] = 0.0
    return pts, mask


def test_voxelize_scatter_matches_jax():
    rng = np.random.default_rng(0)
    pts, mask = _points(rng)
    r = 8
    ref = jv.voxelize(jnp.asarray(pts), jnp.asarray(mask), r, impl="scatter")
    got = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r)
    for name in ("features", "counts", "lo", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    # the dummy row voxelizes to an empty grid over the unit box
    assert float(got.counts[-1].sum()) == 0.0
    np.testing.assert_array_equal(got.lo[-1].numpy(), np.zeros(3))


def test_voxel_indices_spill_masked_points():
    rng = np.random.default_rng(1)
    pts, mask = _points(rng)
    r = 8
    ref, _, _ = jv.voxel_indices(jnp.asarray(pts[..., :3]),
                                 jnp.asarray(mask), r)
    got, _, _ = tv.voxel_indices(torch.from_numpy(pts[..., :3]),
                                 torch.from_numpy(mask), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[~mask] == r ** 3).all()


def test_devoxelize_gather_matches_jax():
    rng = np.random.default_rng(2)
    pts, mask = _points(rng)
    r, c = 8, 4
    grid = rng.normal(size=(pts.shape[0], r, r, r, c)).astype(np.float32)
    jg = jv.voxelize(jnp.asarray(pts), jnp.asarray(mask), r, impl="scatter")
    ref = jv.devoxelize_trilinear(
        jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(mask), jg.lo,
        jg.scale, bwd_dtype=jnp.float32, impl="gather")
    tg = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r)
    got = tv.devoxelize_trilinear(
        torch.from_numpy(grid), torch.from_numpy(pts),
        torch.from_numpy(mask), tg.lo, tg.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (got.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("impl, dtype", [("scatter", "float32"),
                                         ("matmul", "float32"),
                                         ("matmul", "bfloat16")],
                         ids=["scatter", "matmul_f32", "matmul_bf16"])
@pytest.mark.parametrize("feature_dim", [None, 0, 1])
def test_voxelize_feature_dim_matches_jax(feature_dim, impl, dtype):
    """Only the first ``feature_dim`` feature columns are voxelized (C =
    feature_dim + 1 with the occupancy channel), as in JAX."""
    rng = np.random.default_rng(5)
    pts, mask = _points(rng)
    r = 8
    ref = jv.voxelize(jnp.asarray(pts), jnp.asarray(mask), r, feature_dim,
                      impl=impl, matmul_dtype=jnp.dtype(dtype))
    got = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r,
                      feature_dim, impl=impl,
                      matmul_dtype=getattr(torch, dtype))
    c = 3 if feature_dim is None else feature_dim + 1
    assert got.features.shape == (pts.shape[0], r, r, r, c)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    for name in ("features", "lo", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    # the occupancy channel: 1 in every occupied voxel, as without a cut
    full = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r,
                       impl=impl, matmul_dtype=getattr(torch, dtype))
    torch.testing.assert_close(got.features[..., -1],
                               full.features[..., -1], rtol=0, atol=0)
