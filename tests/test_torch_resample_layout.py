"""The operand layout of csrc/resample.cu's gathered tensor-core kernels
(both resampling blocks, forward and backward), on the CPU.

``gather_rows``, ``ungather_rows``, ``pack_down_w``, ``pack_up_w`` and
``pack_up_wt`` state the layout the kernels compute by index: each is
checked element by element, and the gathered GEMMs built from them (the
kernels' products, with the plain versions' rounding points) against the
plain versions and the JAX package's Pallas kernels (``fused_down2x_p``
and ``fused_up2x_p`` and their VJPs) in interpret mode, on the same
numpy-seeded inputs.

Tolerances: every side rounds the activated input, g' and the weights to
bf16 at the same points and sums the products in f32 in another order.
So a bf16 output (y, dx) may land on the neighbouring bf16 value, rtol
2^-7 plus 1e-4 of its largest value, and an f32 sum (stats, dW, dbias,
dscale, dshift) agrees to 1e-3 of its largest value (1e-4 relative for
the forward's stats, whose terms are all of one sign in sumsq).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas import conv3d_block as jcb
from pcseg_tpu_torch.ops import conv3d_block as tcb

torch.set_num_threads(1)

# (fine C, (D, H, W) of the fine grid): JAX's packing needs W a multiple
# of 128 / C on both sides of the conv
SHAPES = [(8, (4, 6, 16)), (16, (4, 8, 8)), (32, (6, 4, 8))]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _lanes(v, c):
    """(B, C) or (B, 2, C) per channel -> the TPU kernels' lane tiling."""
    return jnp.asarray(np.tile(v, (1,) * (v.ndim - 1) + (128 // c,)))


def _fold_lanes(v, c):
    """(B, ..., 128) lane values -> (B, ..., C) sums over the copies."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (128 // c, c)).sum(axis=-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.detach().float().numpy()


def _bf16_close(got, ref, name):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _sum_close(got, ref, name):
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * np.abs(ref).max() + 1e-12, (name, err)


def unpack_up_dw(dwt, c):
    """dW^T (8C, C2) = gather_rows(g')^T @ a -> the forward's (2, 2, 2,
    C2, C) tap order (the inverse of pack_up_wt's placement)."""
    return dwt.reshape(2, 2, 2, c, -1).flip(0, 1, 2).transpose(3, 4)


def down2x_gathered(x, w, bias, scale, shift):
    """The down block as the gathered GEMM resample.cu runs: (y bf16,
    stats (B, 2, N))."""
    a = tcb.gather_rows(tcb._prologue(x, scale, shift, True))
    yf = (a @ tcb._wq(tcb.pack_down_w(w))).permute(0, 4, 1, 2, 3)
    return tcb._finish(yf, bias, None, True)


def up2x_gathered(x, w, bias, scale, shift):
    """The up block as the gathered GEMM resample.cu runs: y =
    ungather_rows(act(x) @ pack_up_w(w)) + bias, (y bf16, stats (B, 2,
    C))."""
    a = tcb._prologue(x, scale, shift, True)
    yf = tcb.ungather_rows(a @ tcb._wq(tcb.pack_up_w(w)))
    return tcb._finish(yf.permute(0, 4, 1, 2, 3), bias, None, True)


def up2x_bwd_gathered(x, w, scale, shift, gy, y, gstats):
    """The up block's backward as the one-sweep kernel's GEMMs: da = G @
    Wd and dW^T = G^T @ a with G = gather_rows(bf16(g'))."""
    ge = tcb._gprime(gy, y, gstats, "updown")
    g = tcb.gather_rows(ge.to(torch.bfloat16).float())
    a = tcb._prologue(x, scale, shift, True)
    dx, dstats = tcb._act_grad(g @ tcb._wq(tcb.pack_up_wt(w)), x, scale,
                               shift, True)
    dwt = g.reshape(-1, g.shape[-1]).t() @ a.reshape(-1, a.shape[-1])
    return (dx, dstats, unpack_up_dw(dwt, gy.shape[-1]),
            ge.sum(dim=(0, 1, 2, 3)))


def down2x_bwd_gathered(x, w, scale, shift, gy, y, gstats):
    """The down block's backward as the one-sweep kernel's GEMMs, the
    transposed pair of the forward's: G = bf16(g') on the coarse grid, dx
    from ungather_rows(G @ Wd^T) and dW = gather_rows(a)^T @ G, with Wd =
    pack_down_w(w) and a = bf16(relu(x scale + shift))."""
    ge = tcb._gprime(gy, y, gstats, "updown")
    g = ge.to(torch.bfloat16).float()
    da = tcb.ungather_rows(g @ tcb._wq(tcb.pack_down_w(w)).t())
    dx, dstats = tcb._act_grad(da, x, scale, shift, True)
    a = tcb.gather_rows(tcb._prologue(x, scale, shift, True))
    dw = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
    return dx, dstats, dw.reshape(w.shape), ge.sum(dim=(0, 1, 2, 3))


def _grid_inputs(rng, b, dhw, cin, cout):
    x = _bf16(rng.normal(size=(b, *dhw, cin)))
    bound = np.sqrt(6.0 / (8 * cin))
    w = rng.uniform(-bound, bound, size=(2, 2, 2, cin, cout)).astype(
        np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, cin)).astype(np.float32)
    shift = (rng.normal(size=(b, cin)) * 0.3).astype(np.float32)
    return x, w, bias, scale, shift


@pytest.mark.parametrize("c", [8, 16, 32])
def test_layout_helpers_index_by_index(c):
    """The helpers' element placement, exactly: row k = ((dz * 2 + dy) * 2
    + dx) * C + c of a coarse voxel is child (dz, dy, dx)'s channel c;
    pack_up_wt's row (d, o) holds w[1 - d][:, o]; unpack_up_dw inverts
    it."""
    rng = np.random.default_rng(c)
    t = _t(rng.normal(size=(2, 4, 6, 8, c)))
    rows = tcb.gather_rows(t)
    assert rows.shape == (2, 2, 3, 4, 8 * c)
    w_down = _t(rng.normal(size=(2, 2, 2, c, 2 * c)))
    w_up = _t(rng.normal(size=(2, 2, 2, 2 * c, c)))
    wd, wt = tcb.pack_down_w(w_down), tcb.pack_up_wt(w_up)
    assert wd.shape == (8 * c, 2 * c) and wt.shape == (8 * c, 2 * c)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                tap = (dz * 2 + dy) * 2 + dx
                ks = slice(tap * c, (tap + 1) * c)
                assert torch.equal(rows[..., ks],
                                   t[:, dz::2, dy::2, dx::2, :])
                assert torch.equal(wd[ks], w_down[dz, dy, dx])
                assert torch.equal(wt[ks], w_up[1 - dz, 1 - dy, 1 - dx].t())
    assert torch.equal(unpack_up_dw(wt, c), w_up)
    # pack_up_w is pack_up_wt's transpose: Wu[i][(d, o)] = w[1 - d][i][o]
    wu = tcb.pack_up_w(w_up)
    assert wu.shape == (2 * c, 8 * c) and torch.equal(wu, wt.t())
    for tap, (dz, dy, dx) in enumerate(np.ndindex(2, 2, 2)):
        for i in range(2 * c):
            for o in range(c):
                assert wu[i, tap * c + o] == w_up[1 - dz, 1 - dy, 1 - dx, i,
                                                  o]
    # ungather_rows puts each row element back where gather_rows took it;
    # the backward's four column slices at C = 64 (resample.cu
    # down_bwd_slices) are the fine pairs (dz, dy), 2C columns each
    assert torch.equal(tcb.ungather_rows(rows), t)
    for z in range(4):
        dz, dy = divmod(z, 2)
        assert torch.equal(rows[..., 2 * c * z:2 * c * (z + 1)].reshape(
            2, 2, 3, 4, 2, c), t[:, dz::2, dy::2].reshape(2, 2, 3, 4, 2, c))


@pytest.mark.parametrize("c,dhw", SHAPES)
def test_gathered_down2x_matches_plain_and_jax(c, dhw):
    rng = np.random.default_rng(20 + c)
    b = 2
    x, w, bias, scale, shift = _grid_inputs(rng, b, dhw, c, 2 * c)
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    yp, (h2, _, c2), st = jcb.fused_down2x_p(
        xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, c),
        _lanes(shift, c), meta, interpret=True)
    d2, w2 = dhw[0] // 2, dhw[2] // 2
    y_jax = jcb.unpack_grid(yp, h2, w2, c2)
    st_jax = _fold_lanes(st, c2)

    args = (_t(x, torch.bfloat16), _t(w), _t(bias), _t(scale), _t(shift))
    y, stats = down2x_gathered(*args)
    y_p, stats_p = tcb.down2x_gn_act_plain(*args)
    assert y.dtype == torch.bfloat16 and y.shape == (b, d2, h2, w2, 2 * c)
    for ref, label in ((y_jax, "jax"), (y_p, "plain")):
        _bf16_close(y, ref, f"y vs {label}")
    for ref in (st_jax, stats_p):
        np.testing.assert_allclose(_np(stats), _np(ref), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("c,dhw", SHAPES)
def test_gathered_up2x_matches_plain_and_jax(c, dhw):
    """Row 6's product: the coarse rows times pack_up_w, back to the fine
    grid through the gather's inverse, + bias, with the stats of the f32
    value per (batch, channel) over the eight children."""
    rng = np.random.default_rng(80 + c)
    b = 2
    coarse = tuple(n // 2 for n in dhw)
    x, w, bias, scale, shift = _grid_inputs(rng, b, coarse, 2 * c, c)
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    yp, (h, _, c1), st = jcb.fused_up2x_p(
        xp, jnp.asarray(w), jnp.asarray(bias), _lanes(scale, 2 * c),
        _lanes(shift, 2 * c), meta, interpret=True)
    y_jax = jcb.unpack_grid(yp, h, dhw[2], c1)
    st_jax = _fold_lanes(st, c1)

    args = (_t(x, torch.bfloat16), _t(w), _t(bias), _t(scale), _t(shift))
    y, stats = up2x_gathered(*args)
    y_p, stats_p = tcb.up2x_gn_act_plain(*args)
    assert y.dtype == torch.bfloat16 and y.shape == (b, *dhw, c)
    for ref, label in ((y_jax, "jax"), (y_p, "plain")):
        _bf16_close(y, ref, f"y vs {label}")
    for ref in (st_jax, stats_p):
        np.testing.assert_allclose(_np(stats), _np(ref), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("c,dhw", SHAPES)
def test_gathered_up2x_bwd_matches_plain_and_jax_vjp(c, dhw):
    rng = np.random.default_rng(40 + c)
    b = 2
    coarse = tuple(n // 2 for n in dhw)
    x, w, bias, scale, shift = _grid_inputs(rng, b, coarse, 2 * c, c)
    gy = _bf16(rng.normal(size=(b, *dhw, c)))
    gstats = np.stack([rng.normal(size=(b, c)) * 1e-2,
                       rng.normal(size=(b, c)) * 1e-3],
                      axis=1).astype(np.float32)

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))

    def f(*a):
        yp, _, stats = jcb.fused_up2x_p(*a, meta, True)
        return yp, stats

    _, vjp = jax.vjp(f, xp, jnp.asarray(w), jnp.asarray(bias),
                     _lanes(scale, 2 * c), _lanes(shift, 2 * c))
    dxp, dw_j, db_j, dsc_j, dsh_j = vjp((gyp, _lanes(gstats, c)))
    jax_ref = (jcb.unpack_grid(dxp, *coarse[1:], 2 * c),
               np.stack([_fold_lanes(dsc_j, 2 * c),
                         _fold_lanes(dsh_j, 2 * c)], axis=1), dw_j, db_j)

    tx = _t(x, torch.bfloat16)
    y, _ = tcb.up2x_gn_act_plain(tx, _t(w), _t(bias), _t(scale), _t(shift))
    args = (tx, _t(w), _t(scale), _t(shift), _t(gy, torch.bfloat16), y,
            _t(gstats))
    got = up2x_bwd_gathered(*args)
    plain = tcb.up2x_bwd_plain(*args)
    names = ("dx", "dscale/dshift", "dW", "dbias")
    for ref, label in ((jax_ref, "jax"), (plain, "plain")):
        _bf16_close(got[0], ref[0], f"dx vs {label}")
        for name, a, r in zip(names[1:], got[1:], ref[1:]):
            _sum_close(a, r, f"{name} vs {label}")
    assert got[2].shape == (2, 2, 2, 2 * c, c)


@pytest.mark.parametrize("c,dhw", SHAPES)
@pytest.mark.parametrize("stats", [True, False])
def test_gathered_down2x_bwd_matches_plain_and_jax_vjp(c, dhw, stats):
    """Row 5's sweep: dx, dscale/dshift, dW and dbias of the down block,
    with and without the stats cotangent (y unread without it)."""
    rng = np.random.default_rng(60 + c)
    b = 2
    coarse = tuple(n // 2 for n in dhw)
    x, w, bias, scale, shift = _grid_inputs(rng, b, dhw, c, 2 * c)
    gy = _bf16(rng.normal(size=(b, *coarse, 2 * c)))
    gstats = np.stack([rng.normal(size=(b, 2 * c)) * 1e-2,
                       rng.normal(size=(b, 2 * c)) * 1e-3],
                      axis=1).astype(np.float32)
    if not stats:
        gstats[:] = 0.0

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))

    def f(*a):
        yp, _, st = jcb.fused_down2x_p(*a, meta, True)
        return yp, st

    _, vjp = jax.vjp(f, xp, jnp.asarray(w), jnp.asarray(bias),
                     _lanes(scale, c), _lanes(shift, c))
    dxp, dw_j, db_j, dsc_j, dsh_j = vjp((gyp, _lanes(gstats, 2 * c)))
    jax_ref = (jcb.unpack_grid(dxp, *dhw[1:], c),
               np.stack([_fold_lanes(dsc_j, c), _fold_lanes(dsh_j, c)],
                        axis=1), dw_j, db_j)

    tx = _t(x, torch.bfloat16)
    y, _ = tcb.down2x_gn_act_plain(tx, _t(w), _t(bias), _t(scale),
                                   _t(shift))
    args = (tx, _t(w), _t(scale), _t(shift), _t(gy, torch.bfloat16),
            y if stats else None, _t(gstats) if stats else None)
    got = down2x_bwd_gathered(*args)
    plain = tcb.down2x_bwd_plain(*args)
    names = ("dx", "dscale/dshift", "dW", "dbias")
    for ref, label in ((jax_ref, "jax"), (plain, "plain")):
        _bf16_close(got[0], ref[0], f"dx vs {label}")
        for name, a, r in zip(names[1:], got[1:], ref[1:]):
            _sum_close(a, r, f"{name} vs {label}")
    assert got[0].shape == x.shape and got[2].shape == (2, 2, 2, c, 2 * c)


@pytest.mark.parametrize("c,c2,route", [(4, 8, False), (8, 16, True),
                                        (16, 32, True), (32, 64, True),
                                        (64, 128, True), (128, 256, False),
                                        (16, 24, False), (16, 16, False)])
def test_mma_route_is_declared_by_shape(c, c2, route):
    """resample.cu takes C in 8..64 with 2C coarse channels; every other
    shape the wrappers accept stays on conv3d_block.cu's kernels."""
    x = torch.zeros(2, 4, 4, 8, c, dtype=torch.bfloat16)
    assert tcb._mma_route(c, c2, x) is route


def test_mma_route_needs_16_byte_aligned_grids():
    base = torch.zeros(2 * 4 * 4 * 8 * 16 + 8, dtype=torch.bfloat16)
    x = base[:-8].view(2, 4, 4, 8, 16)
    shifted = base[1:-7].view(2, 4, 4, 8, 16)
    assert tcb._mma_route(16, 32, x)
    assert not tcb._mma_route(16, 32, shifted)


class _FakeLibrary:
    """Records the entries a wrapper calls; every entry succeeds."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("c2,entry", [(32, "pcseg_down2x_bwd_mma"),
                                      (16, "pcseg_down2x_bwd")])
def test_down2x_bwd_launches_the_kernel_its_route_names(monkeypatch, c2,
                                                        entry):
    """down2x_bwd_cuda launches resample.cu's sweep exactly where
    ``_mma_route`` takes the shape (C 16 -> 32), else conv3d_block.cu's
    pair (16 -> 16), and counts the launch under its keys."""
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_mma_grid", lambda *a: 1)
    monkeypatch.setattr(tcb, "_down_bwd_slices", lambda c: 1)
    c = 16
    x = torch.zeros(2, 4, 4, 8, c, dtype=torch.bfloat16)
    w = torch.zeros(2, 2, 2, c, c2)
    vec = torch.ones(2, c)
    gy = torch.zeros(2, 2, 2, 4, c2, dtype=torch.bfloat16)
    gstats = torch.zeros(2, 2, c2)
    before = dict(tcb.LAUNCHES)
    tcb.down2x_bwd_cuda(x, w, vec, vec, gy, gy.clone(), gstats)
    assert calls == [entry]
    mma = int(entry.endswith("_mma"))
    assert tcb.LAUNCHES["down2x_bwd"] == before["down2x_bwd"] + 1
    assert tcb.LAUNCHES["down2x_bwd_mma"] == before["down2x_bwd_mma"] + mma


@pytest.mark.parametrize("cin,cout,entry", [(32, 16, "pcseg_up2x_mma"),
                                            (64, 32, "pcseg_up2x_mma"),
                                            (24, 16, "pcseg_up2x_gn_act"),
                                            (256, 128, "pcseg_up2x_gn_act")])
def test_up2x_launches_the_kernel_its_route_names(monkeypatch, cin, cout,
                                                  entry):
    """up2x_gn_act_cuda launches resample.cu's gathered GEMM exactly where
    ``_mma_route`` takes the shape (fine C 8..64 from 2C coarse), else
    conv3d_block.cu's up_kernel, and counts the launch under its keys."""
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_mma_grid", lambda *a: 1)
    x = torch.zeros(2, 2, 2, 4, cin, dtype=torch.bfloat16)
    w = torch.zeros(2, 2, 2, cin, cout)
    vec = torch.ones(2, cin)
    before = dict(tcb.LAUNCHES)
    y, stats = tcb.up2x_gn_act_cuda(x, w, torch.zeros(cout), vec, vec)
    assert calls == [entry]
    assert y.shape == (2, 4, 4, 8, cout) and stats.shape == (2, 2, cout)
    mma = int(entry.endswith("_mma"))
    assert tcb.LAUNCHES["up2x_gn_act"] == before["up2x_gn_act"] + 1
    assert tcb.LAUNCHES["up2x_mma"] == before["up2x_mma"] + mma
