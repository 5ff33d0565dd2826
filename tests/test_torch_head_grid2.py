"""The port's fused head (``conv3d_block.fused_head_grid2``, through its
plain versions on the CPU) against the JAX package's Pallas head in
interpret mode: relu(x * scale + shift) -> 1x1 head -> bf16 logits in the
(B, R*R, R*NC) grid2 layout, and its backward through ``jax.vjp``.

The JAX head takes lane-tiled (B, 128) scale/shift, so its dscale/dshift
are summed over the lane copies of a channel.

Tolerances: both sides round the activation and the weights to bf16 at
the same points and sum in f32 in another order, so a bf16 output (y, dx)
may land on the neighbouring bf16 value, rtol 2^-7 (plus 1e-4 of its
scale for values near zero); the f32 sums (dW, dbias, dscale, dshift)
agree to 1e-3 of their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas import conv3d_block as jcb
from pcseg_tpu_torch.ops import conv3d_block as tcb

torch.set_num_threads(1)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _lanes(v, c):
    return jnp.asarray(np.tile(v, (1, 128 // c)))


def _fold_lanes(v, c):
    v = np.asarray(v)
    return v.reshape(v.shape[0], 128 // c, c).sum(axis=1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True)


def _bf16_close(got, ref, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _sum_close(got, ref, name):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max(), err_msg=name)


# (16, 20), (16, 40) and (128, 8): widths the JAX fused head takes past
# the bench's (20 and 40 classes, as at 32^3; C 128)
@pytest.mark.parametrize("c,nc", [(16, 4), (32, 5), (16, 20), (128, 8),
                                  (16, 40)])
def test_head_grid2_fwd_and_vjp_match_jax(c, nc):
    rng = np.random.default_rng(30 + c)
    b, r = 2, 8
    x = _bf16(rng.normal(size=(b, r, r, r, c)))
    w = rng.uniform(-0.5, 0.5, size=(1, 1, 1, c, nc)).astype(np.float32)
    bias = (rng.normal(size=nc) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, c)).astype(np.float32)
    shift = (rng.normal(size=(b, c)) * 0.3).astype(np.float32)
    gy = _bf16(rng.normal(size=(b, r * r, r * nc)))

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    ref, vjp = jax.vjp(
        lambda *a: jcb.fused_head_grid2(*a, meta, nc, True), xp,
        jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
        _lanes(shift, c))
    dxp, dw, db, dsc, dsh = vjp(jnp.asarray(gy, jnp.bfloat16))

    ins = [_t(x, torch.bfloat16), _t(w), _t(bias), _t(scale), _t(shift)]
    y = tcb.fused_head_grid2(*ins, nc)
    assert y.shape == (b, r * r, r * nc) and y.dtype == torch.bfloat16
    assert ref.shape == y.shape
    _bf16_close(y, ref, "y")
    gx, gw, gb, gsc, gsh = torch.autograd.grad(y, ins,
                                               _t(gy, torch.bfloat16))
    assert gx.dtype == torch.bfloat16 and gw.shape == w.shape
    _bf16_close(gx, jcb.unpack_grid(dxp, r, r, c), "dx")
    _sum_close(gw, dw, "dW")
    _sum_close(gb, db, "dbias")
    _sum_close(gsc, _fold_lanes(dsc, c), "dscale")
    _sum_close(gsh, _fold_lanes(dsh, c), "dshift")


def test_head_grid2_is_the_activated_head1x1():
    """The fused head's values are head1x1 on the activated grid, rounded
    to bf16 once, in the NDHWC memory order viewed as grid2."""
    rng = np.random.default_rng(33)
    b, r, c, nc = 1, 4, 8, 3
    x = torch.from_numpy(np.array(_bf16(rng.normal(size=(b, r, r, r, c))))
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(1, 1, 1, c, nc)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=nc).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (b, c)).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))
    y = tcb.fused_head_grid2(x, w, bias, scale, shift, nc)
    ref = tcb.head1x1(tcb.act(x, scale, shift), w, bias).to(torch.bfloat16)
    assert torch.equal(y, ref.reshape(b, r * r, r * nc))
    with pytest.raises(ValueError):
        tcb.fused_head_grid2(x, w, bias, scale, shift, nc + 1)
