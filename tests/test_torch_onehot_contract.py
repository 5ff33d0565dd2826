"""The matmul voxelize / devoxelize forms of the port against the JAX
package's.

- ``voxelize_contract`` and ``trilinear_gather`` (plain versions, CPU)
  against the JAX Pallas kernels of ``onehot_contract`` in interpret mode:
  the same taps and bf16 rounding points, f32 sums in another order.
- ``resolve_voxelize_impl`` / ``resolve_devoxelize_impl`` against the JAX
  ones over a grid of sizes, channel counts and impl strings.
- ``voxelize(impl="matmul")`` and ``devoxelize_trilinear(_grid2)(impl=
  "matmul")`` with its VJP against the JAX functions, in f32 and in bf16.
  On the CPU the JAX package takes its XLA forms, not its kernels
  (``_use_plane_kernels``), and its bf16 devoxelize form rounds the z and y
  weights separately; the bf16 cases patch ``_use_plane_kernels`` so that
  the JAX functions reach their kernels in interpret mode, as they do on a
  TPU at R <= 64 (the patch changes no file of the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops import voxel as jv
from pcseg_tpu.ops.pallas import onehot_contract as joc
from pcseg_tpu_torch.ops import voxel as tv

torch.set_num_threads(1)


def test_voxelize_contract_matches_jax_kernel():
    rng = np.random.default_rng(20)
    b, m, r, c1 = 2, 600, 6, 3
    r3 = r ** 3
    flat = rng.integers(0, r3, (b, m)).astype(np.int32)
    flat[0, :150] = 17                        # one voxel hit by many points
    masked = rng.random((b, m)) < 0.2
    masked[1, -50:] = True
    flat[masked] = r3                         # the sentinel of masked points
    ext = np.concatenate([rng.gamma(2.0, 1.0, (b, m, 1)),
                          np.ones((b, m, 2))], axis=-1).astype(np.float32)
    ext[masked] = 0.0
    ref = np.asarray(joc.voxelize_contract(jnp.asarray(flat),
                                           jnp.asarray(ext), r,
                                           interpret=True))
    got = tv.voxelize_contract(torch.from_numpy(flat), torch.from_numpy(ext),
                               r).numpy()
    assert got.shape == (b, r3, c1)
    # (B, R^2, R*C1) and (B, R^3, C1) are the same row-major order
    ref = ref.reshape(got.shape)
    np.testing.assert_array_equal(got[..., -1], ref[..., -1])     # counts
    assert got[0, 17, -1] >= 100
    # bf16 values summed in f32 in another order
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("r,c1", [(8, 2), (5, 5), (4, 40), (3, 1),
                                  (16, 3), (2, 4)])
def test_voxelize_contract_widths_match_jax_kernel(r, c1):
    """The sparse model's row width (C1 2), odd and wide rows, a grid of
    8 and of 4,096 voxels, against the JAX kernel in interpret mode:
    counts exact, sums as above, an all-masked event zero."""
    rng = np.random.default_rng(r * 100 + c1)
    b, m = 3, 400
    r3 = r ** 3
    flat = rng.integers(0, r3, (b, m)).astype(np.int32)
    flat[0, ::4] = r3 // 2                    # one voxel hit by 100 points
    masked = rng.random((b, m)) < 0.2
    masked[-1] = True
    flat[masked] = r3
    ext = np.concatenate([rng.normal(0, 2, (b, m, c1 - 1)),
                          np.ones((b, m, 1))], axis=-1).astype(np.float32)
    ext[masked] = 0.0
    ref = np.asarray(joc.voxelize_contract(jnp.asarray(flat),
                                           jnp.asarray(ext), r,
                                           interpret=True)).reshape(b, r3, c1)
    got = tv.voxelize_contract(torch.from_numpy(flat), torch.from_numpy(ext),
                               r).numpy()
    np.testing.assert_array_equal(got[..., -1], ref[..., -1])
    assert got[0, r3 // 2, -1] >= 75
    assert not got[-1].any()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _site_layout(layout, seed):
    """Ids and rows of B3 x 1000 points on 8^3 (M not a multiple of 32, so
    warp chunks straddle events): "hot", the default call site's shape at
    this size (event 0 has 250 consecutive points on one voxel, the last
    event is all masked), or "tracks", runs of 1-40 consecutive points on
    one voxel, as track events give the sparse call site."""
    rng = np.random.default_rng(seed)
    b, m, r, c1 = 3, 1000, 8, 3
    r3 = r ** 3
    if layout == "hot":
        flat = rng.integers(0, r3, (b, m))
        flat[0, 1:251] = flat[0, 0]
        masked = rng.random((b, m)) < 0.2
        masked[-1] = True
    else:
        runs = np.repeat(rng.integers(0, r3, b * m),
                         rng.integers(1, 41, b * m))[:b * m]
        flat = runs.reshape(b, m)
        masked = rng.random((b, m)) < 0.05
    flat = np.where(masked, r3, flat)
    ext = np.concatenate([rng.gamma(2.0, 1.0, (b, m, c1 - 2)),
                          np.ones((b, m, 2))], axis=-1).astype(np.float32)
    ext[masked] = 0.0
    return flat, ext, r


def _kernel_plan_sums(flat, ext, r, rng):
    """csrc/onehot_contract.cu voxelize_contract_kernel's summation plan:
    warp chunks of 32 consecutive points of the flattened (B, M) batch,
    each lane keyed by (event, voxel), masked points in no group; each
    group's bf16-rounded rows summed in f32 in lane order; then the
    groups' partials added in f32 into a zero table in a shuffled order
    (the atomics' order is the hardware's)."""
    b, m, c1 = ext.shape
    r3 = r ** 3
    vals = torch.from_numpy(ext).to(torch.bfloat16).float().numpy()
    vals = vals.reshape(-1, c1)
    ids = flat.reshape(-1).astype(np.int64)
    key = np.where((ids >= 0) & (ids < r3), np.arange(b * m) // m * r3 + ids,
                   -1)
    partials = []
    for c0 in range(0, b * m, 32):
        ks = key[c0:c0 + 32]
        for k in dict.fromkeys(ks[ks >= 0].tolist()):
            s = np.zeros(c1, np.float32)
            for lane in np.flatnonzero(ks == k):
                s = s + vals[c0 + lane]
            partials.append((k, s))
    out = np.zeros((b * r3, c1), np.float32)
    for i in rng.permutation(len(partials)):
        k, s = partials[i]
        out[k] = out[k] + s
    return out.reshape(b, r3, c1), len(partials)


@pytest.mark.parametrize("layout", ["hot", "tracks"])
def test_voxelize_kernel_plan_matches_jax_kernel(layout):
    """The card kernel's plan (warp groups summed in lane order, partials
    added in any order) against the JAX kernel in interpret mode: counts
    exact, sums to 1e-6 of the largest (bf16 values in f32, another
    order); the groups cut the hot voxel's adds about 32-fold."""
    flat, ext, r = _site_layout(layout, 7)
    b, m, c1 = ext.shape
    ref = np.asarray(joc.voxelize_contract(
        jnp.asarray(flat.astype(np.int32)), jnp.asarray(ext), r,
        interpret=True)).reshape(b, r ** 3, c1)
    got, n_partials = _kernel_plan_sums(flat, ext, r,
                                        np.random.default_rng(1))
    np.testing.assert_array_equal(got[..., -1], ref[..., -1])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    real = int((flat < r ** 3).sum())
    if layout == "hot":
        # points 1-250 of event 0 lie in 8 chunks: at most 8 partials
        hot = int((flat[0, 1:251] < r ** 3).sum())
        assert hot >= 150 and ref[0, ..., -1].max() >= hot
        assert not got[-1].any()
        assert n_partials <= real - hot + 8
    else:
        assert n_partials < real // 4


@pytest.mark.parametrize("layout", ["hot", "tracks"])
def test_voxelize_contract_int64_ids_match_jax_kernel(layout):
    """The port's voxelize_contract on int64 ids (the callers' dtype, which
    the card kernel now reads as it comes) against the JAX kernel on the
    same ids as int32."""
    flat, ext, r = _site_layout(layout, 11)
    b, m, c1 = ext.shape
    ref = np.asarray(joc.voxelize_contract(
        jnp.asarray(flat.astype(np.int32)), jnp.asarray(ext), r,
        interpret=True)).reshape(b, r ** 3, c1)
    ids = torch.from_numpy(flat.astype(np.int64))
    got = tv.voxelize_contract(ids, torch.from_numpy(ext), r).numpy()
    np.testing.assert_array_equal(got[..., -1], ref[..., -1])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("round_bf16", [True, False])
def test_voxelize_contract_plain_adds_nothing_for_the_sentinel(dtype,
                                                              round_bf16):
    """The plain version adds a row at its voxel id, rounded to bf16 or
    not, and adds nothing for the sentinel R^3 of masked points."""
    r, c1 = 3, 2
    flat = torch.tensor([[0, 26, 27, 26], [27, 27, 5, 0]], dtype=dtype)
    ext = torch.tensor([[[1.0, 1.0], [2.0, 1.0], [9.0, 1.0],
                         [1.0 + 2 ** -12, 1.0]],
                        [[7.0, 1.0], [7.0, 1.0], [3.0, 1.0], [4.0, 1.0]]])
    got = tv.voxelize_contract_plain(flat, ext, r, round_bf16=round_bf16)
    assert got.shape == (2, 27, c1)
    want = torch.zeros(2, 27, c1)
    want[0, 0] = torch.tensor([1.0, 1.0])
    want[0, 26] = torch.tensor([3.0 if round_bf16 else 3.0 + 2 ** -12,
                                2.0])
    want[1, 5] = torch.tensor([3.0, 1.0])
    want[1, 0] = torch.tensor([4.0, 1.0])
    assert torch.equal(got, want)


def test_voxelize_contract_plain_of_an_all_masked_batch_is_zero():
    flat = torch.full((2, 50), 4 ** 3)
    ext = torch.randn(2, 50, 3)
    assert not tv.voxelize_contract_plain(flat, ext, 4).any()


def test_trilinear_gather_matches_jax_kernel():
    rng = np.random.default_rng(21)
    b, m, r, c = 2, 600, 6, 4
    # coords spanning outside [0, R-1] exercise the clipped duplicate taps
    u = (rng.random((b, m, 3)) * (r + 1) - 1).astype(np.float32)
    u[0, :20] = np.floor(u[0, :20])           # integral coords: frac == 0
    mask = rng.random((b, m)) < 0.85
    g2 = rng.normal(size=(b, r * r, r * c)).astype(np.float32)
    ref = np.asarray(joc.trilinear_gather(jnp.asarray(u), jnp.asarray(mask),
                                          jnp.asarray(g2), interpret=True))
    got = tv.trilinear_gather(torch.from_numpy(u), torch.from_numpy(mask),
                              torch.from_numpy(g2)).numpy()
    assert got.shape == (b, m, c)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(got[~mask], 0.0)


@pytest.mark.parametrize("c", [33, 40])
def test_trilinear_pair_past_32_channels_matches_jax_kernels(c):
    """Rows 13 and 11 above 32 channels (the classes the matmul devoxelize
    takes at 32^3 reach 121): the port's plain gather and scatter against
    the JAX kernels in interpret mode, f32 sums of the same bf16 terms in
    another order, to 1e-5 of scale."""
    rng = np.random.default_rng(24 + c)
    b, m, r = 2, 300, 5
    u = (rng.random((b, m, 3)) * (r + 1) - 1).astype(np.float32)
    u[0, :20] = np.floor(u[0, :20])
    mask = rng.random((b, m)) < 0.85
    g2 = rng.normal(size=(b, r * r, r * c)).astype(np.float32)
    ref = np.asarray(joc.trilinear_gather(jnp.asarray(u), jnp.asarray(mask),
                                          jnp.asarray(g2), interpret=True))
    got = tv.trilinear_gather(torch.from_numpy(u), torch.from_numpy(mask),
                              torch.from_numpy(g2)).numpy()
    assert got.shape == (b, m, c)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(got[~mask], 0.0)

    go = np.where(mask[..., None], rng.normal(size=(b, m, c)), 0.0)
    go = go.astype(np.float32)
    ref = np.asarray(joc.trilinear_scatter(jnp.asarray(u), jnp.asarray(go),
                                           r, interpret=True))
    got = tv.trilinear_scatter(torch.from_numpy(u), torch.from_numpy(go),
                               r).numpy()
    assert got.shape == (b, r ** 3, c)
    # (B, R^2, R*C) and (B, R^3, C) are the same row-major order
    np.testing.assert_allclose(got, ref.reshape(got.shape), rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("r", [8, 64, 100, 128])
@pytest.mark.parametrize("impl", ["auto", "scatter", "gather", "matmul"])
def test_resolve_impls_match_jax(r, impl):
    for c in range(1, 7):
        assert tv.resolve_voxelize_impl(impl, r, c) == \
            jv.resolve_voxelize_impl(impl, r, c)
        assert tv.resolve_devoxelize_impl(impl, r, c) == \
            jv.resolve_devoxelize_impl(impl, r, c)


def _case(seed, b=3, m=300, r=8, c=4):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(b, m, 3)) * 10.0,
                          rng.gamma(2.0, 1.0, size=(b, m, 2))],
                         axis=-1).astype(np.float32)
    pts[0, :40, :3] = pts[0, :1, :3]          # one voxel hit by many points
    mask = rng.random((b, m)) < 0.8
    mask[0, :40] = True
    mask[-1] = False                          # an all-masked dummy row
    grid = rng.normal(size=(b, r, r, r, c)).astype(np.float32)
    go = rng.normal(size=(b, m, c)).astype(np.float32)   # masked rows too
    return pts, mask, grid, go


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxelize_matmul_matches_jax(dtype):
    pts, mask, _, _ = _case(22)
    r = 8
    ref = jv.voxelize(jnp.asarray(pts), jnp.asarray(mask), r, impl="matmul",
                      matmul_dtype=jnp.dtype(dtype))
    got = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r,
                      impl="matmul", matmul_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert float(got.counts.max()) >= 40
    # the same (rounded) feature values summed in f32 in another order
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(ref.features), rtol=1e-6,
                               atol=1e-6)
    for name in ("lo", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    if dtype == "bfloat16":
        # the features really were rounded: not the scatter's f32 means
        exact = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r)
        assert not torch.equal(exact.features, got.features)


def _plane_kernels(dt, r):
    return jnp.dtype(dt) == jnp.bfloat16 and r <= 64


@pytest.mark.parametrize("layout", ["ndhwc", "grid2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_devoxelize_matmul_and_vjp_match_jax(dtype, layout, monkeypatch):
    """Forward and grid cotangent. f32: the port's f32 form against the
    JAX XLA form, 1e-5 (the weights multiplied in another order). bf16: the
    port's plain kernel forms against the JAX kernels in interpret mode,
    forward to 1e-5 of scale (f32 order); the grid2 cotangent is bf16, as
    the JAX VJP casts it to grid2's dtype, so within one bf16 ulp."""
    if dtype == "bfloat16":
        monkeypatch.setattr(jv, "_use_plane_kernels", _plane_kernels)
    pts, mask, grid, go = _case(23)
    b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
    tg = tv.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), r)
    lo, scale = tg.lo.numpy(), tg.scale.numpy()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if layout == "grid2":
        grid = grid.reshape(b, r * r, r * c)
        jgrid = jnp.asarray(grid, jdt)
        tgrid = torch.from_numpy(grid).to(tdt)
        jfn, tfn = jv.devoxelize_trilinear_grid2, tv.devoxelize_trilinear_grid2
    else:
        jgrid, tgrid = jnp.asarray(grid), torch.from_numpy(grid)
        jfn, tfn = jv.devoxelize_trilinear, tv.devoxelize_trilinear
    out, vjp = jax.vjp(
        lambda g: jfn(g, jnp.asarray(pts), jnp.asarray(mask),
                      jnp.asarray(lo), jnp.asarray(scale), bwd_dtype=jdt,
                      impl="matmul"), jgrid)
    (ref,) = vjp(jnp.asarray(go))
    out = np.asarray(out)
    ref = np.asarray(ref.astype(jnp.float32))

    tgrid.requires_grad_(True)
    got_out = tfn(tgrid, torch.from_numpy(pts), torch.from_numpy(mask),
                  tg.lo, tg.scale, "matmul", bwd_dtype=tdt)
    np.testing.assert_allclose(got_out.detach().numpy(), out, rtol=0,
                               atol=1e-5 * np.abs(out).max())
    np.testing.assert_array_equal(got_out.detach().numpy()[~mask], 0.0)
    (got,) = torch.autograd.grad(got_out, tgrid, torch.from_numpy(go))
    assert got.shape == tgrid.shape and got.dtype == tgrid.dtype
    got = got.float().numpy()
    big = np.abs(ref).max()
    if tdt == torch.float32 or layout == "ndhwc":     # an f32 cotangent
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * big)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-5 * big)
    assert not got[-1].any()                  # the dummy row: no gradient
