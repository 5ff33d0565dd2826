"""The backward of the port's fused conv blocks (autograd through the
plain versions, CPU) against ``jax.vjp`` of the JAX package's Pallas
blocks in interpret mode, on the same inputs and cotangents.

The JAX blocks take lane-tiled (B, 128) scale/shift and return lane
stats, so their stats cotangent is the per-channel one tiled to the lanes
and their dscale/dshift are summed over the lane copies of a channel.

Tolerances: both sides round g' = gy + gs1 + 2 gs2 y, the activated input
and the weights to bf16 at the same points and sum in f32 in another
order. So a bf16 output (dx, the accum gradient) may land on the
neighbouring bf16 value, rtol 2^-7 (plus 1e-4 of its scale for values
near zero), and every f32 sum (dW, dbias, dscale, dshift) agrees to 1e-3
of its largest value.
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
    """(B, C) or (B, 2, C) per channel -> the TPU kernels' lane tiling."""
    return jnp.asarray(np.tile(v, (1,) * (v.ndim - 1) + (128 // c,)))


def _fold_lanes(v, c):
    """(B, 128) lane values -> (B, C) sums over the lane copies."""
    v = np.asarray(v)
    return v.reshape(v.shape[0], 128 // c, c).sum(axis=1)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.array(a)).to(dtype).requires_grad_(grad)


def _inputs(rng, b, r, cin, cout, k):
    x = _bf16(rng.normal(size=(b, r, r, r, cin)))
    bound = np.sqrt(6.0 / (k ** 3 * cin))
    w = rng.uniform(-bound, bound, size=(k, k, k, cin, cout)).astype(
        np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, cin)).astype(np.float32)
    shift = (rng.normal(size=(b, cin)) * 0.3).astype(np.float32)
    return x, w, bias, scale, shift


def _cotangents(rng, b, ro, cout):
    gy = _bf16(rng.normal(size=(b, ro, ro, ro, cout)))
    gstats = np.stack([rng.normal(size=(b, cout)) * 1e-2,
                       rng.normal(size=(b, cout)) * 1e-3],
                      axis=1).astype(np.float32)
    return gy, gstats


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


@pytest.mark.parametrize("case", ["act", "act+accum", "stem", "no-stats"])
def test_conv3x3_bwd_matches_jax_vjp(case):
    rng = np.random.default_rng(10)
    b, r, c = 2, 8, 16
    x, w, bias, scale, shift = _inputs(rng, b, r, c, c, 3)
    gy, gstats = _cotangents(rng, b, r, c)
    activate = case != "stem"
    want_stats = case != "no-stats"
    need_dx = case != "stem"
    accum = _bf16(rng.normal(size=(b, r, r, r, c))) if case == "act+accum" \
        else None

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))
    jargs = [xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
             _lanes(shift, c)]
    if accum is not None:
        ap, _ = jcb.pack_grid(jnp.asarray(accum, jnp.bfloat16))
        _, vjp = jax.vjp(
            lambda xp_, ap_, *rest: jcb.fused_conv3x3_add_p(
                xp_, ap_, *rest, meta, True, True), xp, ap, *jargs[1:])
        dxp, dap, dw, db, dsc, dsh = vjp((gyp, _lanes(gstats, c)))
    else:
        _, vjp = jax.vjp(
            lambda *a: jcb.fused_conv3x3_p(*a, meta, activate, want_stats,
                                           True, False, need_dx), *jargs)
        ct = (gyp, _lanes(gstats, c)) if want_stats else gyp
        dxp, dw, db, dsc, dsh = vjp(ct)

    tx = _t(x, torch.bfloat16, grad=need_dx)
    tw, tb = _t(w, grad=True), _t(bias, grad=True)
    tsc, tsh = _t(scale, grad=activate), _t(shift, grad=activate)
    tacc = None if accum is None else _t(accum, torch.bfloat16, grad=True)
    y, st = tcb.conv3x3_gn_act(tx, tw, tb, tsc if activate else None,
                               tsh if activate else None, tacc,
                               activate=activate, want_stats=want_stats,
                               need_dx=need_dx)
    inputs = [t for t in (tx, tacc, tw, tb, tsc, tsh)
              if t is not None and t.requires_grad]
    outs, cts = [y], [_t(gy, torch.bfloat16)]
    if want_stats:
        outs.append(st)
        cts.append(_t(gstats))
    grads = dict(zip(map(id, inputs), torch.autograd.grad(outs, inputs,
                                                          cts)))

    _sum_close(grads[id(tw)], dw, "dW")
    _sum_close(grads[id(tb)], db, "dbias")
    if need_dx:
        _bf16_close(grads[id(tx)], jcb.unpack_grid(dxp, r, r, c), "dx")
    else:
        assert not np.asarray(dxp.astype(jnp.float32)).any()
    if activate:
        _sum_close(grads[id(tsc)], _fold_lanes(dsc, c), "dscale")
        _sum_close(grads[id(tsh)], _fold_lanes(dsh, c), "dshift")
    else:
        assert not np.asarray(dsc).any() and not np.asarray(dsh).any()
    if accum is not None:
        _bf16_close(grads[id(tacc)], jcb.unpack_grid(dap, r, r, c), "daccum")


@pytest.mark.parametrize("kind", ["down", "up"])
def test_resample_bwd_matches_jax_vjp(kind):
    rng = np.random.default_rng(11)
    b = 2
    if kind == "down":
        r, cin, cout, ro = 8, 16, 32, 4
        jfn, tfn = jcb.fused_down2x_p, tcb.down2x_gn_act
    else:
        r, cin, cout, ro = 4, 32, 16, 8
        jfn, tfn = jcb.fused_up2x_p, tcb.up2x_gn_act
    x, w, bias, scale, shift = _inputs(rng, b, r, cin, cout, 2)
    gy, gstats = _cotangents(rng, b, ro, cout)

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))

    def f(*a):
        yp, _, stats = jfn(*a, meta, True)
        return yp, stats

    _, vjp = jax.vjp(f, xp, jnp.asarray(w), jnp.asarray(bias),
                     _lanes(scale, cin), _lanes(shift, cin))
    dxp, dw, db, dsc, dsh = vjp((gyp, _lanes(gstats, cout)))

    inputs = [_t(x, torch.bfloat16, grad=True), _t(w, grad=True),
              _t(bias, grad=True), _t(scale, grad=True), _t(shift, grad=True)]
    y, st = tfn(*inputs)
    gx, gw, gb, gsc, gsh = torch.autograd.grad(
        [y, st], inputs, [_t(gy, torch.bfloat16), _t(gstats)])

    _bf16_close(gx, jcb.unpack_grid(dxp, r, r, cin), "dx")
    _sum_close(gw, dw, "dW")
    _sum_close(gb, db, "dbias")
    _sum_close(gsc, _fold_lanes(dsc, cin), "dscale")
    _sum_close(gsh, _fold_lanes(dsh, cin), "dshift")


def test_missing_stats_cotangent_is_zero():
    """A stats output the loss never reads (gstats None) backpropagates as
    a zero cotangent: the same gradients as explicit zeros."""
    rng = np.random.default_rng(12)
    b, r, c = 1, 4, 8
    x, w, bias, scale, shift = _inputs(rng, b, r, c, c, 3)
    gy, _ = _cotangents(rng, b, r, c)

    def grads(with_zeros):
        ins = [_t(x, torch.bfloat16, grad=True), _t(w, grad=True),
               _t(bias, grad=True), _t(scale, grad=True),
               _t(shift, grad=True)]
        y, st = tcb.conv3x3_gn_act(*ins)
        outs, cts = [y], [_t(gy, torch.bfloat16)]
        if with_zeros:
            outs.append(st)
            cts.append(torch.zeros_like(st))
        return torch.autograd.grad(outs, ins, cts)

    for a, z in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, z, rtol=0, atol=0)
