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
