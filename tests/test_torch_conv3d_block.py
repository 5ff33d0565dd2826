"""The port's fused conv blocks (plain versions, CPU) against the JAX
package's Pallas kernels run in interpret mode on the same inputs.

Tolerances: both sides use the same rounding points (bf16 activated input
and weights, f32 sums, bf16 y, stats from the f32 value) and differ only
in the order of the f32 sums. So y may land on the neighbouring bf16
value (one bf16 ulp, <= 2^-7 |y|), and the stats agree to f32 sum error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas import conv3d_block as jcb
from pcseg_tpu_torch.ops import conv3d_block as tcb

torch.set_num_threads(1)

Y_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
STATS_TOL = dict(rtol=1e-4, atol=1e-3)


def _bf16(a):
    """numpy f32 array of bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(rng, b, r, cin, cout, k):
    x = _bf16(rng.normal(size=(b, r, r, r, cin)))
    bound = np.sqrt(6.0 / (k ** 3 * cin))
    w = rng.uniform(-bound, bound, size=(k, k, k, cin, cout)).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    scale = (rng.uniform(0.7, 1.3, size=(b, cin))).astype(np.float32)
    # shift > 0: relu(shift) != 0, so a zero padding applied BEFORE the
    # activation (instead of after it) would change every border voxel
    shift = (0.5 + rng.normal(size=(b, cin)) * 0.1).astype(np.float32)
    return x, w, bias, scale, shift


def _lanes(v, c):
    """(B, C) per-channel -> the TPU kernels' (B, 128) lane tiling."""
    return jnp.asarray(np.tile(v, (1, 128 // c)))


def _fold_lanes(stats, c):
    """(B, 2, 128) lane stats -> (B, 2, C)."""
    s = np.asarray(stats)
    return s.reshape(s.shape[0], 2, 128 // c, c).sum(axis=2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("case", ["act", "act+accum", "stem", "no-stats"])
def test_conv3x3_matches_jax_kernel(case):
    rng = np.random.default_rng(0)
    b, r, c = 2, 8, 16
    x, w, bias, scale, shift = _inputs(rng, b, r, c, c, 3)
    activate = case != "stem"
    want_stats = case != "no-stats"
    accum = _bf16(rng.normal(size=(b, r, r, r, c))) if case == "act+accum" \
        else None

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    if accum is not None:
        ap, _ = jcb.pack_grid(jnp.asarray(accum, jnp.bfloat16))
        yp, st = jcb.fused_conv3x3_add_p(
            xp, ap, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
            _lanes(shift, c), meta, True, True)
    else:
        out = jcb.fused_conv3x3_p(
            xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
            _lanes(shift, c), meta, activate, want_stats, True)
        yp, st = out if want_stats else (out, None)
    y_ref = np.asarray(jcb.unpack_grid(yp, r, r, c).astype(jnp.float32))

    y, stats = tcb.conv3x3_gn_act(
        _t(x, torch.bfloat16), _t(w), _t(bias), _t(scale), _t(shift),
        None if accum is None else _t(accum, torch.bfloat16),
        activate=activate, want_stats=want_stats)
    assert y.dtype == torch.bfloat16 and y.shape == (b, r, r, r, c)
    np.testing.assert_allclose(y.float().numpy(), y_ref, **Y_TOL)
    if want_stats:
        np.testing.assert_allclose(stats.numpy(), _fold_lanes(st, c),
                                   **STATS_TOL)
    else:
        assert stats is None


def test_down2x_matches_jax_kernel():
    rng = np.random.default_rng(1)
    b, r, c = 2, 8, 16
    x, w, bias, scale, shift = _inputs(rng, b, r, c, 2 * c, 2)
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    yp, (h2, _, c2), st = jcb.fused_down2x_p(
        xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
        _lanes(shift, c), meta, interpret=True)
    y_ref = np.asarray(
        jcb.unpack_grid(yp, h2, r // 2, c2).astype(jnp.float32))

    y, stats = tcb.down2x_gn_act(_t(x, torch.bfloat16), _t(w), _t(bias),
                                 _t(scale), _t(shift))
    assert y.shape == (b, r // 2, r // 2, r // 2, 2 * c)
    np.testing.assert_allclose(y.float().numpy(), y_ref, **Y_TOL)
    np.testing.assert_allclose(stats.numpy(), _fold_lanes(st, 2 * c),
                               **STATS_TOL)


def test_up2x_matches_jax_kernel():
    rng = np.random.default_rng(2)
    b, r, c = 2, 4, 16
    x, w, bias, scale, shift = _inputs(rng, b, r, 2 * c, c, 2)
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    yp, (h2, _, c1), st = jcb.fused_up2x_p(
        xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, 2 * c),
        _lanes(shift, 2 * c), meta, interpret=True)
    y_ref = np.asarray(
        jcb.unpack_grid(yp, h2, 2 * r, c1).astype(jnp.float32))

    y, stats = tcb.up2x_gn_act(_t(x, torch.bfloat16), _t(w), _t(bias),
                               _t(scale), _t(shift))
    assert y.shape == (b, 2 * r, 2 * r, 2 * r, c)
    np.testing.assert_allclose(y.float().numpy(), y_ref, **Y_TOL)
    np.testing.assert_allclose(stats.numpy(), _fold_lanes(st, c),
                               **STATS_TOL)


@pytest.mark.parametrize("c,groups", [(16, 8), (32, 8), (12, 8)])
def test_stats_scale_shift_matches_jax(c, groups):
    """Per-channel stats fold to the same GroupNorm scale/shift as the
    JAX lane form (f32 elementwise math; the group sums differ only in
    order)."""
    rng = np.random.default_rng(3)
    b, nvox = 2, 512
    y = rng.normal(size=(b, nvox, c)) * 2.0 + 0.3
    stats = np.stack([y.sum(1), (y * y).sum(1)], axis=1).astype(np.float32)
    gs = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    gb = rng.normal(size=c).astype(np.float32)

    sc, sh = tcb.stats_scale_shift(_t(stats), _t(gs), _t(gb), groups, nvox)
    if 128 % c == 0:
        lanes = np.zeros((b, 2, 128), np.float32)
        lanes[:, :, :c] = stats
        jsc, jsh = jcb.stats_scale_shift(jnp.asarray(lanes), jnp.asarray(gs),
                                         jnp.asarray(gb), groups, nvox)
        jsc, jsh = np.asarray(jsc)[:, :c], np.asarray(jsh)[:, :c]
    else:
        # C not dividing 128 has no lane form: fold_gn on the group stats
        g = tcb.num_groups(c, groups)
        s = stats.reshape(b, 2, g, c // g).sum(-1)
        n = nvox * (c // g)
        mean = s[:, 0] / n
        var = s[:, 1] / n - mean ** 2
        jsc, jsh = jcb.fold_gn(jnp.asarray(mean), jnp.asarray(var),
                               jnp.asarray(gs), jnp.asarray(gb), g)
        jsc, jsh = np.asarray(jsc)[:, :c], np.asarray(jsh)[:, :c]
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sh.numpy(), jsh, rtol=1e-5, atol=1e-5)


def test_act_and_head_match_jax():
    rng = np.random.default_rng(4)
    b, r, c, nc = 2, 8, 16, 4
    x = _bf16(rng.normal(size=(b, r, r, r, c)))
    scale = rng.uniform(0.7, 1.3, size=(b, c)).astype(np.float32)
    shift = (rng.normal(size=(b, c)) * 0.3).astype(np.float32)
    w = rng.normal(size=(1, 1, 1, c, nc)).astype(np.float32)
    bias = rng.normal(size=nc).astype(np.float32)

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    ap = jcb.act_packed(xp, _lanes(scale, c), _lanes(shift, c))
    ref = np.asarray(jcb.head1x1_packed(ap, jnp.asarray(w), jnp.asarray(bias),
                                        meta, nc))
    a = tcb.act(_t(x, torch.bfloat16), _t(scale), _t(shift))
    np.testing.assert_array_equal(
        a.float().numpy(),
        np.asarray(jcb.unpack_grid(ap, r, r, c).astype(jnp.float32)))
    got = tcb.head1x1(a, _t(w), _t(bias))
    # exact bf16 products, f32 sums of 16 terms in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
