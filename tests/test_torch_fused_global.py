"""The port's fused_global_pool_block (ops/fused_global.py, its plain
version on the CPU) against the JAX package's Pallas op (interpret mode
on the CPU), forward and backward, with ties.

Ties by construction: rows 1-3 of each batch row repeat row 0, so their
y are equal and the FIRST row must win; every 5th channel has sign 0
(gamma_global == 0), so all its rows tie at 0 and row 0 must win.

Tolerances: the same rounding points on both sides, f32 sums in another
order, so every float output is held to atol = 2^-8 * max|ref| of its
tensor (one bf16 ulp of its scale). The winners' rows are compared
exactly wherever the best value beats the runner-up by more than one
bf16 ulp, and must all agree on the constructed ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pcseg_tpu.ops.pallas.fused_global import (
    fused_global_pool_block as jax_pool_block,
)
from pcseg_tpu_torch.ops import fused_global as fg

torch.set_num_threads(1)

B, M, CIN, COUT = 2, 64, 128, 256
N = B * M


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, CIN)) * 2.0
    x[:, 1:4] = x[:, :1]                      # tied rows
    x = _bf16(x.reshape(N, CIN))
    bn = [rng.normal(size=CIN) * 0.3, rng.uniform(0.5, 1.5, CIN),
          rng.normal(size=CIN), rng.normal(size=CIN) * 0.3]
    bn = [a.astype(np.float32) for a in bn]
    w = (rng.uniform(-1, 1, (CIN, COUT)) / np.sqrt(CIN)).astype(np.float32)
    b = (rng.normal(size=COUT) * 0.1).astype(np.float32)
    sign = np.sign(rng.normal(size=COUT)).astype(np.float32)
    sign[::5] = 0.0                          # gamma_global == 0 channels
    return x, bn, w, b, sign


def _assert_close(got, ref, name):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    atol = 2.0 ** -8 * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= atol, f"{name}: max err {err} > {atol}"


def test_fused_global_pool_block_matches_jax():
    x, bn, w, b, sign = _inputs(0)
    rng = np.random.default_rng(1)
    ds1 = (rng.normal(size=COUT) * 0.01).astype(np.float32)
    ds2 = (rng.normal(size=COUT) * 0.001).astype(np.float32)
    dbest = rng.normal(size=(B, COUT)).astype(np.float32)

    def jf(x_, bn_, w_, b_):
        return jax_pool_block(x_, *bn_, w_.astype(jnp.bfloat16), b_,
                              jnp.asarray(sign), M, 64)

    (js1, js2, jbest, jidx), vjp = jax.vjp(
        jf, jnp.asarray(x, jnp.bfloat16), [jnp.asarray(a) for a in bn],
        jnp.asarray(w), jnp.asarray(b))
    jdx, jdbn, jdw, jdb = vjp((jnp.asarray(ds1), jnp.asarray(ds2),
                               jnp.asarray(dbest),
                               np.zeros((B, COUT), jax.dtypes.float0)))

    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    tbn = [torch.tensor(a).requires_grad_() for a in bn]
    tw = torch.tensor(w).requires_grad_()
    tb = torch.tensor(b).requires_grad_()
    s1, s2, best, idx = fg.fused_global_pool_block(
        tx, *tbn, tw, tb, torch.tensor(sign), M)
    assert idx.dtype == torch.int32 and best.shape == (B, COUT)
    ((s1 * torch.tensor(ds1)).sum() + (s2 * torch.tensor(ds2)).sum()
     + (best * torch.tensor(dbest)).sum()).backward()

    _assert_close(s1.detach(), js1, "s1")
    _assert_close(s2.detach(), js2, "s2")
    _assert_close(best.detach(), jbest, "best")
    jidx = np.asarray(jidx)
    got_idx = idx.numpy()
    # the constructed ties: sign-0 channels pick row 0; elsewhere the tied
    # rows 0-3 never beat row 0
    assert (got_idx[:, ::5] == 0).all() and (jidx[:, ::5] == 0).all()
    assert not np.isin(got_idx, [1, 2, 3]).any()
    # the winners agree wherever the best is clear of the runner-up
    y = fg.global_pool_fwd_plain(tx.detach(), *[t.detach() for t in tbn],
                                 tw.detach(), tb.detach(),
                                 torch.tensor(sign), M)[0]
    sm = (y.float() * torch.tensor(sign)).reshape(B, M, COUT)
    top2 = sm.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > 2.0 ** -7 * top2[:, 0].abs()).numpy()
    np.testing.assert_array_equal(got_idx[clear], jidx[clear])
    assert clear[:, sign != 0].mean() > 0.9

    _assert_close(tx.grad.float(), np.asarray(jdx, np.float32), "dx")
    _assert_close(tw.grad, jdw, "dw")
    _assert_close(tb.grad, jdb, "db")
    for name, t, r in zip(("dmu", "dinv", "dgamma", "dbeta"), tbn, jdbn):
        _assert_close(t.grad, r, name)


def test_pool_gradient_goes_to_the_first_tied_row():
    """With every row of a batch row tied, the whole pool cotangent lands
    on row 0 (torch.max's index rule), not spread over the ties."""
    x, bn, w, b, _ = _inputs(2)
    x = np.repeat(x.reshape(B, M, CIN)[:, :1], M, axis=1).reshape(N, CIN)
    sign = np.ones(COUT, np.float32)
    tx = torch.tensor(x).to(torch.bfloat16)
    args = [torch.tensor(a) for a in bn]
    y, _, _, best, idx = fg.global_pool_fwd_plain(
        tx, *args, torch.tensor(w), torch.tensor(b), torch.tensor(sign), M)
    assert bool((idx == 0).all())
    pval = torch.ones((B, COUT))
    zero = torch.zeros(COUT)
    dx = fg.global_pool_bwd_plain(tx, *args, torch.tensor(w), y, zero, zero,
                                  pval, idx, M)[0]
    dx = dx.float().reshape(B, M, CIN)
    assert bool((dx[:, 1:] == 0).all()) and float(dx[:, 0].abs().sum()) > 0
