"""The port's block-sparse voxels (``ops/block_sparse.py``) against the
JAX package's XLA forms (``pcseg_tpu/ops/block_sparse.py``) on the same
points and features (numpy): the tile layout, the neighbour and child slot
tables, the octant moves, the raw down / up convs and the readout.

Small size: grid 16, tile 4, B3 x 512 track events with masked points
(the last row all masked), at a capacity that keeps every tile and at one
that drops tiles. Index tables and masks must be equal; features within
f32 rounding (the same bf16-rounded terms summed in another order); the
raw convs within one bf16 ulp at their output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops import block_sparse as jbs
from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.ops import block_sparse as pbs

torch.set_num_threads(1)

R, T = 16, 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _points():
    pts = track_events(3, 512, 2)
    mask = np.random.default_rng(2).random((3, 512)) < 0.9
    mask[-1] = False
    return pts, mask


def _voxelize(cap, dtype):
    pts, mask = _points()
    jb, jlo, jsc = jbs.block_sparse_voxelize(
        jnp.asarray(pts), jnp.asarray(mask), R, cap, T,
        matmul_dtype=JDT[dtype])
    pb, plo, psc = pbs.block_sparse_voxelize(
        torch.from_numpy(pts), torch.from_numpy(mask), R, cap, T,
        matmul_dtype=TDT[dtype])
    return (jb, jlo, jsc), (pb, plo, psc), (pts, mask)


def _eq(port, ref, what):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


def _ulp_tol(ref):
    return 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cap", [48, 12])
def test_block_sparse_voxelize_matches_jax(cap, dtype):
    (jb, jlo, jsc), (pb, plo, psc), _ = _voxelize(cap, dtype)
    for name in ("tile_ijk", "tile_mask", "lookup", "dropped", "active"):
        _eq(getattr(pb, name), getattr(jb, name), name)
    if cap == 12:
        assert int(pb.dropped.sum()) > 0
    feats = np.asarray(jb.feats)
    err = float(np.abs(pb.feats.numpy() - feats).max())
    assert err <= 1e-5 * float(np.abs(feats).max()), err
    np.testing.assert_allclose(plo.numpy(), np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), rtol=1e-6)


@pytest.mark.parametrize("cap,cap1", [(48, 32), (12, 4)])
def test_slot_tables_and_pool_match_jax(cap, cap1):
    (jb, _, _), (pb, _, _), _ = _voxelize(cap, "bfloat16")
    for sign in (1, -1):
        _eq(pbs.neighbor_slots(pb, sign), jbs._neighbor_slots(jb, sign),
            f"neighbor slots {sign}")
    jc, jslots = jbs.block_pool(jb, cap1)
    pc, pslots = pbs.block_pool(pb, cap1)
    _eq(pslots, jslots, "child slots")
    for name in ("tile_ijk", "tile_mask", "lookup", "dropped", "active"):
        _eq(getattr(pc, name), getattr(jc, name), f"pooled {name}")
    assert pc.grid_size == jc.grid_size and pc.tile == jc.tile
    for p, j in zip(pbs.parent_rows(pc, pb), jbs._parent_rows(jc, jb)):
        _eq(p, j, "parent rows")


def test_octant_pack_unpack_match_jax():
    (jb, _, _), (pb, _, _), _ = _voxelize(48, "bfloat16")
    jc, jslots = jbs.block_pool(jb, 32)
    pc, pslots = pbs.block_pool(pb, 32)
    rng = np.random.default_rng(0)
    th, c = T // 2, 3
    ych = rng.normal(size=pb.feats.shape[:2] + (th, th, th, c)).astype(
        np.float32)
    prow, poct = pbs.parent_rows(pc, pb)
    jrow, joct = jbs._parent_rows(jc, jb)
    _eq(pbs.octant_pack(torch.from_numpy(ych), pslots, prow, poct),
        jbs._octant_pack_raw(jnp.asarray(ych), jslots, th), "pack")
    cf = rng.normal(size=pc.active.shape + (c,)).astype(np.float32)
    _eq(pbs.octant_unpack(torch.from_numpy(cf), prow, poct, pslots),
        jbs._octant_unpack_raw(jnp.asarray(cf), jrow, joct, th), "unpack")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_raw_down_up_and_readout_match_jax(dtype):
    (jb, _, _), (pb, _, _), (pts, mask) = _voxelize(48, dtype)
    jc, jslots = jbs.block_pool(jb, 32)
    pc, pslots = pbs.block_pool(pb, 32)
    rng = np.random.default_rng(1)
    cin, cout = 8, 16
    jdt, tdt = JDT[dtype], TDT[dtype]

    def params(ci, co):
        bound = np.sqrt(6.0 / (8 * ci))
        return {"kernel": rng.uniform(-bound, bound, (2, 2, 2, ci, co))
                .astype(np.float32),
                "bias": rng.normal(size=co).astype(np.float32)}

    def jp(p):
        return {k: jnp.asarray(v) for k, v in p.items()}

    def tp(p):
        return {k: torch.from_numpy(v) for k, v in p.items()}

    down = params(cin, cout)
    x = rng.normal(size=pb.active.shape + (cin,)).astype(np.float32)
    want = np.asarray(jbs.block_down2x(
        jp(down), jnp.asarray(x, jdt), jc, jslots, compute_dtype=jdt,
        bs_fine=jb, raw=True), np.float32)
    got = pbs.block_down2x(tp(down), torch.from_numpy(x).to(tdt), pc, pb,
                           pslots, tdt)
    assert got.dtype == tdt
    assert float(np.abs(got.float().numpy() - want).max()) <= _ulp_tol(want)

    up = params(cout, cin)
    h = rng.normal(size=pc.active.shape + (cout,)).astype(np.float32)
    want = np.asarray(jbs.block_up2x(
        jp(up), jnp.asarray(h, jdt), jc, jb, compute_dtype=jdt,
        child_slots=jslots, raw=True), np.float32)
    got = pbs.block_up2x(tp(up), torch.from_numpy(h).to(tdt), pc, pb,
                         pslots, tdt)
    assert got.dtype == tdt
    assert float(np.abs(got.float().numpy() - want).max()) <= _ulp_tol(want)

    site = rng.normal(size=pb.active.shape + (4,)).astype(np.float32)
    want = jbs.block_gather_point_logits(jnp.asarray(site), jb,
                                         jnp.asarray(pts), jnp.asarray(mask))
    got = pbs.block_gather_point_logits(torch.from_numpy(site), pb,
                                        torch.from_numpy(pts),
                                        torch.from_numpy(mask))
    _eq(got, want, "readout")
    assert not got[torch.from_numpy(~mask)].any()


def _sum_tol(terms_abs_sum):
    """f32 sums of the same (bf16-rounded) terms in another order."""
    return 1e-6 * terms_abs_sum + 1e-7


def test_rowcol_scatter_plain_matches_pallas_kernel():
    """The readout backward's scatter against the JAX Pallas kernel in
    interpret mode: a crowded cell, sentinel rows (>= nrows) adding
    nothing, zero cotangents."""
    from pcseg_tpu.ops.pallas.onehot_contract import rowcol_scatter

    rng = np.random.default_rng(3)
    b, m, nrows, ncols, c = 2, 700, 6, 64, 4
    rows = rng.integers(0, nrows + 1, (b, m)).astype(np.int32)
    cols = rng.integers(0, ncols, (b, m)).astype(np.int32)
    rows[0, :50], cols[0, :50] = 2, 7            # one crowded cell
    vals = rng.normal(size=(b, m, c)).astype(np.float32)
    vals[1, -20:] = 0.0
    want = np.asarray(rowcol_scatter(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(vals), nrows, ncols,
                                     interpret=True))
    got = pbs.rowcol_scatter(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(vals), nrows, ncols)
    mag = pbs.rowcol_scatter(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(np.abs(vals)), nrows, ncols)
    assert got.shape == want.shape == (b, nrows, ncols * c)
    assert (np.abs(got.numpy() - want) <= _sum_tol(mag.numpy())).all()


@pytest.mark.parametrize("cap", [48, 12])
def test_readout_vjp_matches_jax_custom_vjp(cap):
    """The port's readout backward (``rowcol_scatter`` of the
    bf16-rounded point cotangents, the form the TPU runs) against the JAX
    ``_readout`` custom VJP with its kernel in interpret mode, on the
    events' real point cells, at a capacity that keeps every tile and at
    one that drops tiles."""
    import jax

    (jb, _, _), (pb, _, _), (pts, mask) = _voxelize(cap, "bfloat16")
    slot, intra = pbs.point_cells(pb, torch.from_numpy(pts),
                                  torch.from_numpy(mask))
    jslot, jintra = jbs._point_cells(jb, jnp.asarray(pts), jnp.asarray(mask))
    _eq(slot, jslot, "slots")
    _eq(intra, jintra, "intra")
    rng = np.random.default_rng(4)
    b, nt = pb.tile_mask.shape
    site = rng.normal(size=(b, nt, T ** 3, 4)).astype(np.float32)
    ct = rng.normal(size=pts.shape[:2] + (4,)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jbs._readout(s, jslot, jintra),
                     jnp.asarray(site))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    ts = torch.from_numpy(site).requires_grad_()
    pbs.readout(ts, slot, intra).backward(torch.from_numpy(ct))
    mag = pbs.rowcol_scatter(slot, intra, torch.from_numpy(np.abs(ct)), nt,
                             T ** 3).reshape(want.shape)
    assert (np.abs(ts.grad.numpy() - want) <= _sum_tol(mag.numpy())).all()


def test_octant_adjoints_match_jax():
    """``octant_pack`` / ``octant_unpack`` with both tables backpropagate
    through each other's gathers, as the JAX ``_octant_pack`` /
    ``_octant_unpack`` custom VJPs do (equal gradients), and each backward
    is the exact adjoint of its forward, at a coarse capacity that drops
    parents."""
    import jax

    (jb, _, _), (pb, _, _), _ = _voxelize(48, "float32")
    jc, jslots = jbs.block_pool(jb, 4)
    pc, pslots = pbs.block_pool(pb, 4)
    assert int(pc.dropped.sum()) > 0
    prow, poct = pbs.parent_rows(pc, pb)
    jrow, joct = jbs._parent_rows(jc, jb)
    rng = np.random.default_rng(5)
    th, c = T // 2, 3
    ych = rng.normal(size=pb.feats.shape[:2] + (th, th, th, c)).astype(
        np.float32)
    gp = rng.normal(size=pc.active.shape + (c,)).astype(np.float32)
    cf = rng.normal(size=pc.active.shape + (c,)).astype(np.float32)
    gu = rng.normal(size=ych.shape).astype(np.float32)

    _, vjp = jax.vjp(lambda y: jbs._octant_pack(y, jslots, jrow, joct, th),
                     jnp.asarray(ych))
    want_pack = np.asarray(vjp(jnp.asarray(gp))[0])
    _, vjp = jax.vjp(lambda f: jbs._octant_unpack(f, jrow, joct, jslots, th),
                     jnp.asarray(cf))
    want_unpack = np.asarray(vjp(jnp.asarray(gu))[0])

    ty = torch.from_numpy(ych).requires_grad_()
    packed = pbs.octant_pack(ty, pslots, prow, poct)
    packed.backward(torch.from_numpy(gp))
    tc = torch.from_numpy(cf).requires_grad_()
    unpacked = pbs.octant_unpack(tc, prow, poct, pslots)
    unpacked.backward(torch.from_numpy(gu))
    _eq(ty.grad, want_pack, "pack backward")
    _eq(tc.grad, want_unpack, "unpack backward")
    # <pack(y), g> = <y, pack^T(g)> and <unpack(f), g> = <f, unpack^T(g)>
    for fwd, x, g, back in ((packed, ych, gp, ty.grad),
                            (unpacked, cf, gu, tc.grad)):
        lhs = float((fwd.detach().double() * torch.from_numpy(g).double())
                    .sum())
        rhs = float((torch.from_numpy(x).double() * back.double()).sum())
        assert abs(lhs - rhs) <= 1e-9 * (abs(lhs) + 1.0)
