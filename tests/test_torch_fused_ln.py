"""The fused conv-bias + LayerNorm + ReLU + mask of the port
(``ops/fused_ln.py`` ``bias_ln_relu_mask_plain``, the CPU form of
csrc/fused_ln.cu) against the JAX package's Pallas kernel in interpret
mode (``ops/pallas/fused_ln.py``), on the same rows (numpy).

Row counts are not a multiple of the Pallas row tile. Tolerances: f32
output within 1e-5 of its scale (single-pass moments summed in another
order); bf16 output within one bf16 ulp at its scale. Inactive rows are
exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas.fused_ln import bias_ln_relu_mask as jax_blrm
from pcseg_tpu.ops.pallas.fused_ln import ln_relu_mask as jax_lrm
from pcseg_tpu_torch.ops import fused_ln as fl

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rows(n, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * 3 + 1).astype(np.float32)
    pre = rng.normal(size=c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    active = rng.random(n) < 0.7
    return x, pre, scale, bias, active


def _tol(ref, dtype):
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("n,c,x_dt,out_dt", [
    (1037, 16, "bfloat16", "bfloat16"),
    (1037, 64, "bfloat16", "float32"),
    (300, 128, "float32", "bfloat16"),
    (77, 32, "float32", "float32"),
])
def test_bias_ln_relu_mask_plain_matches_pallas_kernel(n, c, x_dt, out_dt):
    x, pre, scale, bias, active = _rows(n, c, seed=n + c)
    want = np.asarray(jax_blrm(
        jnp.asarray(x, JDT[x_dt]), jnp.asarray(pre), jnp.asarray(scale),
        jnp.asarray(bias), jnp.asarray(active), 1e-5, JDT[out_dt], 1024,
        True), np.float32)
    got = fl.bias_ln_relu_mask(
        torch.from_numpy(x).to(TDT[x_dt]), torch.from_numpy(pre),
        torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(active), 1e-5, TDT[out_dt])
    assert got.dtype == TDT[out_dt]
    got = got.float().numpy()
    err = float(np.abs(got - want).max())
    print(f"bias_ln_relu_mask {n}x{c} {x_dt}->{out_dt}: max|err| {err:.3e}")
    assert err <= _tol(want, out_dt), err
    assert not got[~active].any()


def test_ln_relu_mask_has_no_pre_bias():
    x, _, scale, bias, active = _rows(500, 16, seed=3)
    want = np.asarray(jax_lrm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(active), 1e-5, jnp.bfloat16, interpret=True), np.float32)
    got = fl.ln_relu_mask(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(scale), torch.from_numpy(bias),
                          torch.from_numpy(active)).float().numpy()
    assert float(np.abs(got - want).max()) <= _tol(want, "bfloat16")


def _col_tol(terms):
    """Column sums of the same f32 terms in another order: 1e-5 of the sum
    of the terms' magnitudes (and a floor at f32 resolution)."""
    return 1e-5 * np.abs(terms).sum(0) + 1e-6


@pytest.mark.parametrize("n,c,x_dt", [
    (1037, 64, "bfloat16"),      # a partial last Pallas row block
    (700, 24, "bfloat16"),
    (300, 256, "bfloat16"),
    (513, 48, "float32"),
])
def test_bias_ln_relu_mask_bwd_plain_matches_jax_vjp(n, c, x_dt):
    """The port's backward (the plain version of csrc/fused_ln.cu's) against
    ``jax.vjp`` of the Pallas op in interpret mode: dx within one ulp of
    x's dtype at its scale (and exactly zero on inactive rows); dpre_bias,
    dscale, dbias as column sums (``_col_tol``)."""
    import jax

    x, pre, scale, bias, active = _rows(n, c, seed=2 * n + c)
    g = np.random.default_rng(n).normal(size=(n, c)).astype(np.float32)
    jdt = JDT[x_dt]
    jx = jnp.asarray(x, jdt)
    jg = jnp.asarray(g, jdt)

    def f(xx, pp, ss, bb):
        return jax_blrm(xx, pp, ss, bb, jnp.asarray(active), 1e-5, jdt, 1024,
                        True)

    _, vjp = jax.vjp(f, jx, jnp.asarray(pre), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = [np.asarray(w, np.float32) for w in vjp(jg)]
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[x_dt])
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(TDT[x_dt])
    got = fl.bias_ln_relu_mask_bwd(
        tx, torch.from_numpy(pre), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(active), tg, 1e-5)
    dx, dpre, dscale, dbias = (t.float().numpy() for t in got)
    assert got[0].dtype == TDT[x_dt]
    err = float(np.abs(dx - want[0]).max())
    print(f"bias_ln_relu_mask bwd {n}x{c} {x_dt}: dx max|err| {err:.3e}")
    assert err <= _tol(want[0], x_dt), err
    assert not dx[~active].any()
    # the column sums' terms, from the JAX result's dx and the plain dz
    xf = np.asarray(jx, np.float32) + pre
    mean = xf.mean(-1, keepdims=True)
    xh = (xf - mean) / np.sqrt((xf * xf).mean(-1, keepdims=True)
                               - mean * mean + 1e-5)
    dz = np.where(active[:, None] & (xh * scale + bias > 0),
                  np.asarray(jg, np.float32), 0.0)
    for name, got_v, want_v, terms in (
            ("dpre_bias", dpre, want[1], want[0]),
            ("dscale", dscale, want[2], dz * xh),
            ("dbias", dbias, want[3], dz)):
        assert (np.abs(got_v - want_v) <= _col_tol(terms)).all(), name


def test_bias_ln_relu_mask_is_differentiable():
    """Autograd through ``bias_ln_relu_mask`` reaches the plain backward:
    its gradients equal ``bias_ln_relu_mask_bwd``'s, and the active mask
    gets none."""
    x, pre, scale, bias, active = _rows(200, 32, seed=9)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(200, 32)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, pre, scale,
                                                             bias)]
    out = fl.bias_ln_relu_mask(*leaves, torch.from_numpy(active), 1e-5,
                               torch.float32)
    out.backward(g)
    want = fl.bias_ln_relu_mask_bwd(*(t.detach() for t in leaves),
                                    torch.from_numpy(active), g, 1e-5)
    for leaf, w in zip(leaves, (want[0], want[1], want[2], want[3])):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
