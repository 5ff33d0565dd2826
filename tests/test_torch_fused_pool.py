"""The port's fused global pool (ops/fused_pool.py, its plain version on
the CPU) against the JAX package's Pallas op (interpret mode on the CPU),
forward and backward, with all-negative channels and ties.

Tolerances: both sides round z = ((y - mu) * inv) * gamma + beta at the
same points in f32 and take an exact max, so g is held to 1e-6 relative
(room for a contracted multiply-add in the compiled JAX form) and idx
exactly; the backward's (B, C) glue is the same arithmetic, so every
gradient is held to 1e-5 of its tensor's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas.fused_pool import _fwd_pallas, fused_global_pool
from pcseg_tpu_torch.ops import fused_pool as fp

torch.set_num_threads(1)

B, M, C = 4, 256, 64
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, dtype, b=B, m=M, c=C, ties=False, negative=False):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, m, c))
    gamma = rng.normal(size=c)
    if ties:
        # row 4 holds every channel's max, and rows 5-8 and the row m - 3
        # (another row tile of the Pallas kernel) repeat it
        y[:, 4] += 20.0
        y[:, 5:9] = y[:, 4:5]
        y[:, m - 3] = y[:, 4]
        gamma = np.abs(gamma) + 0.1
    jdt, _ = DTYPES[dtype]
    y = np.asarray(jnp.asarray(y.reshape(b * m, c), jdt).astype(jnp.float32))
    mu = rng.normal(size=c) * 0.1
    inv = rng.uniform(0.5, 2.0, size=c)
    beta = rng.normal(size=c) * 0.1
    if negative:
        beta[::3] = -100.0
    return [y] + [a.astype(np.float32) for a in (mu, inv, gamma, beta)]


def _jax(args, dtype):
    jdt, _ = DTYPES[dtype]
    return [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]


def _torch(args, dtype, grad=False):
    _, tdt = DTYPES[dtype]
    out = [torch.tensor(args[0]).to(tdt)] + [torch.tensor(a)
                                             for a in args[1:]]
    return [t.requires_grad_() for t in out] if grad else out


def _close(got, ref, name, rel=1e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = rel * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{name}: max err {err} > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas(dtype):
    args = _inputs(0, dtype, negative=True)
    jg, jidx = _fwd_pallas(*_jax(args, dtype), M)
    jg_op = fused_global_pool(*_jax(args, dtype), M)
    g, idx = fp.fused_pool_fwd_plain(*_torch(args, dtype), M)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg, "g", rel=1e-6)
    _close(fp.fused_global_pool(*_torch(args, dtype), M).detach(), jg_op,
           "fused_global_pool", rel=1e-6)
    assert bool((g[:, ::3] == 0).all()) and bool((idx[:, ::3] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_pallas(dtype):
    args = _inputs(1, dtype, negative=True)
    dg = np.random.default_rng(2).normal(size=(B, C)).astype(np.float32)
    jout, vjp = jax.vjp(lambda *a: fused_global_pool(*a, M),
                        *_jax(args, dtype))
    jgrads = vjp(jnp.asarray(dg))
    leaves = _torch(args, dtype, grad=True)
    out = fp.fused_global_pool(*leaves, M)
    out.backward(torch.tensor(dg))
    _close(out.detach(), jout, "g", rel=1e-6)
    for name, leaf, jgr in zip(("dy", "dmu", "dinv", "dgamma", "dbeta"),
                               leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad.float(), jnp.asarray(jgr, jnp.float32), name)
    # the all-negative channels pass no gradient to y
    assert float(leaves[0].grad.float()[:, ::3].abs().sum()) == 0.0


def test_ties_go_to_the_first_row():
    """Across the Pallas kernel's row tiles (1024 rows, 256 a tile at C
    1024) the first of the tied rows wins, in both packages."""
    m, c = 1024, 1024
    args = _inputs(3, "bfloat16", b=2, m=m, c=c, ties=True)
    jg, jidx = _fwd_pallas(*_jax(args, "bfloat16"), m)
    g, idx = fp.fused_pool_fwd_plain(*_torch(args, "bfloat16"), m)
    np.testing.assert_array_equal(np.asarray(jidx), 4)
    np.testing.assert_array_equal(idx.numpy(), 4)
    _close(g, jg, "g", rel=1e-6)
    leaves = _torch(args, "bfloat16", grad=True)
    fp.fused_global_pool(*leaves, m).sum().backward()
    dy = leaves[0].grad.float().reshape(2, m, c)
    assert bool((dy[:, 4] != 0).all())
    assert float(dy[:, 5:].abs().sum()) == 0.0 and float(
        dy[:, :4].abs().sum()) == 0.0
