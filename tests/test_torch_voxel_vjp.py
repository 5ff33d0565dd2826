"""The port's devoxelize backward against the JAX package's.

- ``trilinear_scatter`` (plain version, CPU) against the JAX Pallas
  kernel ``onehot_contract.trilinear_scatter`` in interpret mode: the
  same taps and bf16 rounding points, f32 sums in another order.
- The VJP of ``devoxelize_trilinear`` against ``jax.vjp`` of the JAX one
  on the CPU, in f32 and in bf16. On the CPU the JAX VJP does not reach
  its Pallas kernel: it takes ``_devox_contract``, which rounds the z and
  y weights to bf16 separately and multiplies them in bf16, where the
  kernel (and the port) round the f32 product once. So in bf16 the two
  differ by up to ~3 bf16 roundings (3 * 2^-9 relative) of each term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops import voxel as jv
from pcseg_tpu.ops.pallas.onehot_contract import (
    trilinear_scatter as jax_trilinear_scatter,
)
from pcseg_tpu_torch.ops import voxel as tv

torch.set_num_threads(1)


def test_trilinear_scatter_matches_jax_kernel():
    rng = np.random.default_rng(7)
    b, m, r, c = 2, 600, 6, 4
    # coords spanning outside [0, R-1] exercise the clipped duplicate taps
    u = (rng.random((b, m, 3)) * (r + 1) - 1).astype(np.float32)
    u[0, :20] = np.floor(u[0, :20])           # integral coords: frac == 0
    go = rng.normal(size=(b, m, c)).astype(np.float32)
    go[1, ::7] = 0.0                          # masked rows carry zeros
    ref = np.asarray(jax_trilinear_scatter(jnp.asarray(u), jnp.asarray(go),
                                           r, interpret=True))
    got = tv.trilinear_scatter(torch.from_numpy(u), torch.from_numpy(go), r)
    assert got.shape == (b, r ** 3, c)
    # grid2 (B, R^2, R*C) and (B, R^3, C) are the same row-major order
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _case(seed, b=3, m=300, r=8, c=4):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(b, m, 3)) * 10.0,
                          rng.gamma(2.0, 1.0, size=(b, m, 1))],
                         axis=-1).astype(np.float32)
    mask = rng.random((b, m)) < 0.8
    mask[-1] = False                          # an all-masked dummy row
    grid = rng.normal(size=(b, r, r, r, c)).astype(np.float32)
    go = rng.normal(size=(b, m, c)).astype(np.float32)   # masked rows too
    tg = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r)
    return pts, mask, grid, go, tg.lo.numpy(), tg.scale.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_devoxelize_vjp_matches_jax(dtype):
    pts, mask, grid, go, lo, scale = _case(3)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(
        lambda g: jv.devoxelize_trilinear(
            g, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(lo),
            jnp.asarray(scale), bwd_dtype=jdt, impl="gather"),
        jnp.asarray(grid))
    (ref,) = vjp(jnp.asarray(go))
    ref = np.asarray(ref)

    tgrid = torch.from_numpy(grid).requires_grad_(True)
    got_out = tv.devoxelize_trilinear(
        tgrid, torch.from_numpy(pts), torch.from_numpy(mask),
        torch.from_numpy(lo), torch.from_numpy(scale),
        bwd_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    (got,) = torch.autograd.grad(got_out, tgrid, torch.from_numpy(go))
    assert got.shape == grid.shape and got.dtype == torch.float32
    got = got.numpy()
    big = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * big)
    else:
        # weights rounded at other points (module docstring); each voxel
        # sums ~10-40 terms of either sign
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6 * big)
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


def test_devoxelize_vjp_ignores_masked_points():
    """Masked rows of the point cotangent are zeroed before the scatter,
    and the all-masked dummy row gets no gradient at all."""
    pts, mask, grid, go, lo, scale = _case(4)
    go_masked = np.where(mask[..., None], go, 0.0).astype(np.float32)

    def vjp(g):
        tgrid = torch.from_numpy(grid).requires_grad_(True)
        out = tv.devoxelize_trilinear(
            tgrid, torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(lo), torch.from_numpy(scale))
        return torch.autograd.grad(out, tgrid, torch.from_numpy(g))[0]

    a, b = vjp(go), vjp(go_masked)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not a[-1].any()
