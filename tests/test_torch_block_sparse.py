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
    _eq(pbs.octant_pack(torch.from_numpy(ych), pslots),
        jbs._octant_pack_raw(jnp.asarray(ych), jslots, th), "pack")
    cf = rng.normal(size=pc.active.shape + (c,)).astype(np.float32)
    prow, poct = pbs.parent_rows(pc, pb)
    jrow, joct = jbs._parent_rows(jc, jb)
    _eq(pbs.octant_unpack(torch.from_numpy(cf), prow, poct),
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
    got = pbs.block_down2x(tp(down), torch.from_numpy(x).to(tdt), pc,
                           pslots, tdt)
    assert got.dtype == tdt
    assert float(np.abs(got.float().numpy() - want).max()) <= _ulp_tol(want)

    up = params(cout, cin)
    h = rng.normal(size=pc.active.shape + (cout,)).astype(np.float32)
    want = np.asarray(jbs.block_up2x(
        jp(up), jnp.asarray(h, jdt), jc, jb, compute_dtype=jdt,
        child_slots=jslots, raw=True), np.float32)
    got = pbs.block_up2x(tp(up), torch.from_numpy(h).to(tdt), pc, pb, tdt)
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
