"""The tensor-core plan of csrc/block_conv.cu (row 21: the block conv's
forward body, which the dgrad shares, and its wgrad), on the CPU.

The constants of the plan (tile edge, planes a block, K chunk, weight
ring, wgrad warps, slab and ring, a block's tile list) are parsed out of
the ``.cu`` file, and the kernels' index math is restated here from them:

- ``hswz``, the swizzle of 16-byte units in shared memory, is a bijection
  on each row, and every ldmatrix the kernels issue (the forward's halo A
  operand at each of the 27 taps, its padded K-major weight rows, the
  dgrad's swizzled N-major ones, the wgrad's halo and cotangent operands)
  reads 8 rows a phase from 8 distinct 16-byte bank groups;
- each tap's row offset (dz 100 + dy 10 + dx from a lane's row) lands on
  the halo row of the voxel's neighbour, for every voxel and tap, in the
  forward's half-tile halo and in the wgrad's slab of one tap group;
- the wgrad's partition (tap group x Cin slice x Cout slice x tiles of
  rank r mod R) covers each (tap, input channel, output channel, real
  tile) exactly once, with R chosen as ``wgrad_plan`` chooses it and the
  partial table within the bytes of the features and the cotangent;
- the forward, the dgrad (reading the forward's taps flipped in place)
  and the wgrad are replayed stage by stage on those layouts, products in
  f32 on bf16-valued operands in the kernels' order, and held to
  ``block_conv_plain``, ``block_conv_dgrad_plain`` and
  ``block_conv_wgrad_plain`` (which tests/test_torch_block_conv.py holds
  to the JAX package's Pallas kernel) at small shapes: the stem's 2
  input channels, a partial K chunk (48 = 32 + 16), Cin not a multiple of
  8, and output widths 32, 64 and 96.

Tolerances: bf16 outputs from f32 sums taken in another order than the
plain version's may land on the neighbouring bf16 value, |d| <= 2^-7
|ref| + 1e-4 max|ref|; the wgrad's f32 sums within 1e-5 of the sum of
their terms' magnitudes, plus one bf16 rounding (2^-8 |ref|).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.ops import block_conv as bc
from pcseg_tpu_torch.ops.block_sparse import (
    block_sparse_voxelize,
    neighbor_slots,
)

torch.set_num_threads(1)

SRC = (Path(bc.__file__).resolve().parent.parent / "csrc" /
       "block_conv.cu").read_text()


def _constants() -> dict:
    """Every namespace-level ``constexpr int kName = expr;`` of the source,
    in order, each evaluated on the ones before it."""
    out: dict = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", SRC,
                                 re.M):
        expr = re.sub(r"\(int\)sizeof\(float\)", "4", expr)
        out[name] = int(eval(expr, {}, dict(out)))  # noqa: S307
    return out


C = _constants()
T, PZ, KC, NST, NMAX = C["kT"], C["kPZ"], C["kKC"], C["kNST"], C["kNMax"]
HU = C["kHU"]
WG_WARPS, SZ, WG_NST, WG_LIST = (C["kWgWarps"], C["kWgSZ"], C["kWgNST"],
                                 C["kWgList"])
HROWS = (PZ + 2) * 100
SMEM_MAX = 227 * 1024
TAPS = bc.TAPS


def test_plan_constants():
    """The plan the kernels are written for: half a tile of 4 planes a
    block, 8 warps of 4 m16 tiles each, K chunks of 32 channels (4 units
    a halo row), a ring of 4 weight stages, 128 outputs at most; the
    wgrad's 9 warps (one tap group's taps), slabs of 2 planes in a ring of
    3; and the shared memory that follows fits a block (two blocks an SM
    for the forward at up to 64 outputs)."""
    assert (T, PZ, KC, HU, NST, NMAX) == (8, 4, 32, 4, 4, 128)
    assert C["kMmaM"] == PZ * 64 == 256 and C["kThreads"] == 256
    assert C["kHRows"] == HROWS and C["kHaloBytes"] == HROWS * KC * 2
    assert (WG_WARPS, SZ, WG_NST, WG_LIST) == (9, 2, 3, 1024)
    assert C["kWgSlabs"] == T // SZ and C["kWgThreads"] == 9 * 32
    # wstage_bytes / conv_mma_smem / wg_mma_smem, as the source states them
    assert "return kKC * (2 * n + 16);" in SRC
    assert "return 2 * kHaloBytes + kNST * wstage_bytes(n);" in SRC
    for n in (32, 64, 96, 128):
        smem = 2 * C["kHaloBytes"] + NST * KC * (2 * n + 16)
        assert smem <= SMEM_MAX
        if n <= 64:
            assert 2 * (smem + 27 * 4) <= 228 * 1024
    for cs in (16, 32, 64):
        for ns in (32, 64):
            smem = WG_NST * (SZ * 100 * cs * 2 + SZ * 64 * ns * 2)
            assert smem + 4 * (WG_LIST + WG_WARPS) <= SMEM_MAX


def hswz(r, u, units):
    """csrc/block_conv.cu hswz: unit u of row r of rows of ``units``
    16-byte units."""
    r, u = np.asarray(r), np.asarray(u)
    bits = (r & 7) if units >= 8 else ((r * units >> 3) & (units - 1))
    return r * units + (u ^ bits)


def test_hswz_source():
    assert ("return r * U + (u ^ (U >= 8 ? (r & 7) : ((r * U >> 3) & "
            "(U - 1))));") in SRC


@pytest.mark.parametrize("units", [2, 4, 8, 16])
def test_swizzle_is_a_bijection(units):
    rows = np.arange(1000)[:, None]
    phys = hswz(rows, np.arange(units)[None, :], units)
    assert np.array_equal(np.sort(phys, axis=1) - rows * units,
                          np.broadcast_to(np.arange(units), phys.shape))
    assert len(np.unique(phys)) == phys.size


def _conflict_free(addr16):
    """addr16 (..., 32): the 16-byte unit each lane of an ldmatrix.x4
    reads; each phase of 8 lanes (one 8 x 8 matrix) must meet 8 distinct
    bank groups (unit index mod 8)."""
    a = np.asarray(addr16).reshape(-1, 4, 8) % 8
    return all(len(set(ph)) == 8 for ph in a.reshape(-1, 8).tolist())


LANE = np.arange(32)
LR = (LANE & 7) + ((LANE >> 3) & 1) * 8     # forward A / B(trans) row
TAP_OFF = [dz * 100 + dy * 10 + dx for dz, dy, dx in TAPS]


def _fwd_hb(pz):
    return ((pz + 1) * 10 + (LR >> 3) + 1) * 10 + (LR & 7) + 1


def test_forward_operand_loads_are_conflict_free():
    """The forward's A loads (every plane, m16 tile, tap and k16 step) and
    both B layouts (the forward's padded K-major rows of N by
    ldmatrix.trans, the dgrad's swizzled N-major rows of K) at every
    output width the route takes."""
    for pz in range(PZ):
        for j in range(4):
            for off in TAP_OFF:
                for ks in range(KC // 16):
                    rows = _fwd_hb(pz) + 20 * j + off
                    assert rows.min() >= 0 and rows.max() < HROWS
                    assert _conflict_free(
                        hswz(rows, 2 * ks + (LANE >> 4), HU))
    for n in (32, 64, 96, 128):
        for half in range(2):
            n0 = half * n // 2
            for ks in range(KC // 16):
                for np_ in range(n // 32):
                    fwd = ((16 * ks + LR) * (2 * n + 16)
                           + (n0 // 8 + 2 * np_ + (LANE >> 4)) * 16) // 16
                    assert _conflict_free(fwd)
                    dg = hswz(n0 + 16 * np_ + (LANE & 7) + (LANE >> 4) * 8,
                              2 * ks + ((LANE >> 3) & 1), HU)
                    assert _conflict_free(dg)


def _wg_lanes(w):
    dy, dx = w // 3 - 1, w % 3 - 1
    lh = (LANE >> 3) & 1
    lv = (LANE & 7) + (LANE >> 4) * 8
    bv = (LANE & 7) + lh * 8
    ha = ((lv >> 3) + 1 + dy) * 10 + (lv & 7) + 1 + dx
    return lh, lv, bv, ha


@pytest.mark.parametrize("cs,ns", [(16, 64), (32, 32), (64, 64), (64, 32)])
def test_wgrad_operand_loads_are_conflict_free(cs, ns):
    hu, gu = cs // 8, ns // 8
    for w in range(WG_WARPS):
        lh, _, bv, ha = _wg_lanes(w)
        for kq in range(SZ * 4):
            h0 = (kq // 4) * 100 + (kq % 4) * 20
            for m in range(cs // 16):
                rows = h0 + ha
                assert rows.min() >= 0 and rows.max() < SZ * 100
                assert _conflict_free(hswz(rows, 2 * m + lh, hu))
            for np_ in range(ns // 16):
                assert _conflict_free(hswz(kq * 16 + bv, 2 * np_ + (LANE >> 4),
                                           gu))


def _halo_coords(zh):
    """(hz, hy, hx) tile coordinates (-1..8) of the forward's halo rows of
    half tile zh."""
    h = np.arange(HROWS)
    return zh * PZ + h // 100 - 1, (h // 10) % 10 - 1, h % 10 - 1


def test_forward_tap_rows_address_the_neighbours():
    """Row m16 tile j, row r of plane pz under tap (dz, dy, dx) reads the
    halo row of voxel (z + dz, y + dy, x + dx)."""
    for zh in range(T // PZ):
        gz, gy, gx = _halo_coords(zh)
        for pz in range(PZ):
            for j in range(4):
                for d, (dz, dy, dx) in enumerate(TAPS):
                    rows = _fwd_hb(pz) + 20 * j + TAP_OFF[d]
                    z = zh * PZ + pz
                    y, x = 2 * j + (LR >> 3), LR & 7
                    assert np.array_equal(gz[rows], np.full(32, z + dz))
                    assert np.array_equal(gy[rows], y + dy)
                    assert np.array_equal(gx[rows], x + dx)


def test_wgrad_tap_rows_address_the_neighbours():
    """In a slab's halo (planes z0 + dz + i), warp (dy, dx)'s A row of
    voxel lv of K step kq is the neighbour of voxel kq 16 + lv."""
    for dz in (-1, 0, 1):
        for z0 in range(0, T, SZ):
            h = np.arange(SZ * 100)
            gz, gy, gx = z0 + dz + h // 100, (h // 10) % 10 - 1, h % 10 - 1
            for w in range(WG_WARPS):
                _, lv, _, ha = _wg_lanes(w)
                dy, dx = w // 3 - 1, w % 3 - 1
                for kq in range(SZ * 4):
                    rows = (kq // 4) * 100 + (kq % 4) * 20 + ha
                    v = kq * 16 + lv               # voxel of the slab
                    z, y, x = z0 + v // 64, (v // 8) % 8, v % 8
                    assert np.array_equal(gz[rows], z + dz)
                    assert np.array_equal(gy[rows], y + dy)
                    assert np.array_equal(gx[rows], x + dx)


# ------------------------------------------------------------- replays

def _tiles(r=32, cap=16, b=2, m=2048, seed=0):
    pts = torch.from_numpy(track_events(b, m, seed))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    bs, _, _ = block_sparse_voxelize(pts, mask, r, cap, T, plain=True)
    return bs.tile_mask.numpy(), neighbor_slots(bs).numpy()


@pytest.fixture(scope="module")
def tiles():
    tmask, slots = _tiles()
    assert tmask.any() and not tmask.all()
    return tmask, slots


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(tmask, k, n, seed):
    rng = np.random.default_rng(seed)
    b, nt = tmask.shape
    x = rng.normal(size=(b, nt, T ** 3, k)).astype(np.float32)
    x = _bf16(x * tmask[..., None, None])
    w = _bf16(rng.uniform(-0.3, 0.3, (27 * k, n)))
    return x, w


def _delta(g):
    return np.where(g < 0, -1, np.where(g >= T, 1, 0))


def _gather_rows(xe, sl, gz, gy, gx, c0, units, k):
    """Units [0, units) of 8 channels from c0 of the halo rows at tile
    coordinates (gz, gy, gx) of one tile (slot table ``sl``) of event
    features ``xe`` (NT, 512, k): (rows, units, 8), zeros for slot -1 and
    channels past k."""
    dz, dy, dx = _delta(gz), _delta(gy), _delta(gx)
    s = sl[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)]
    src = ((gz - dz * T) * T + (gy - dy * T)) * T + (gx - dx * T)
    ch = c0 + np.arange(units * 8).reshape(units, 8)
    vals = xe[np.maximum(s, 0)[:, None, None], src[:, None, None],
              np.minimum(ch, k - 1)[None]]
    keep = (s >= 0)[:, None, None] & (ch < k)[None]
    return np.where(keep, vals, 0.0)


def _stage(rows_units, units):
    """Swizzled shared memory of (rows, units, 8) values: (rows units, 8)
    16-byte units at hswz."""
    nr = rows_units.shape[0]
    phys = np.zeros((nr * units, 8), np.float32)
    r = np.arange(nr)[:, None]
    phys[hswz(r, np.arange(units)[None], units)] = rows_units
    return phys


def replay_conv(x, slots, w2, tmask, dgrad=False):
    """conv_mma_body stage by stage: x (B, NT, 512, K), w2 the forward's
    taps ((27 K, N), or (27 N, K) for the dgrad) -> (B, NT, 512, N) f32
    sums rounded to bf16; padding tiles zero."""
    b, nt, _, k = x.shape
    n = w2.shape[0] // 27 if dgrad else w2.shape[1]
    out = np.zeros((b, nt, T ** 3, n), np.float32)
    nchunks = -(-k // KC)
    v = np.arange(PZ * 64)
    pz, j, r = v // 64, (v % 64) // 16, v % 16
    hb = ((pz + 1) * 10 + (r >> 3) + 1) * 10 + (r & 7) + 1 + 20 * j
    for bi in range(b):
        for ti in range(nt):
            sl = slots[bi, ti]
            if sl[13] < 0:
                continue
            for zh in range(T // PZ):
                gz, gy, gx = _halo_coords(zh)
                acc = np.zeros((PZ * 64, n), np.float32)
                for c in range(nchunks):
                    c0, cc = c * KC, min(KC, k - c * KC)
                    ksn = -(-cc // 16)
                    # units past the chunk's k16 steps are not staged
                    # (nor read): zeros here
                    halo = _stage(_gather_rows(x[bi], sl, gz, gy, gx, c0,
                                               HU, min(k, c0 + 16 * ksn)),
                                  HU)
                    for d in range(27):
                        kr = np.arange(KC)
                        if not dgrad:     # K-major rows, padded
                            wst = np.where((kr < cc)[:, None],
                                           w2[d * k + c0 + np.minimum(
                                               kr, cc - 1)], 0.0)
                        else:             # W[26 - d]^T, N-major rows
                            cols = c0 + np.minimum(kr, cc - 1)
                            rowsn = w2[(26 - d) * n + np.arange(n)]
                            wt = np.where((kr < cc)[None], rowsn[:, cols],
                                          0.0)             # (n, KC)
                            ph = _stage(wt.reshape(n, HU, 8), HU)
                            wst = ph[hswz(np.arange(n)[None],
                                          (kr // 8)[:, None], HU),
                                     (kr % 8)[:, None]]
                        for ks in range(ksn):
                            kk = 16 * ks + np.arange(16)
                            a = halo[hswz((hb + TAP_OFF[d])[:, None],
                                          (kk // 8)[None], HU),
                                     (kk % 8)[None]]
                            acc += a @ wst[kk]
                out[bi, ti, zh * PZ * 64:(zh + 1) * PZ * 64] = acc
    return _bf16(out)


def wgrad_rows(tiles, chunks, t=T, cin=1, cout=1, per_sm=1, sms=132,
               mma=True):
    """wgrad_plan's rows of the partial table."""
    rows = per_sm * sms // chunks
    if mma:
        most = tiles * t ** 3 * (cin + cout) * 2 // (27 * cin * cout * 4)
        rows = min(rows, most)
        rows = max(rows, -(-tiles // WG_LIST))
    return max(1, min(rows, tiles))


def _wg_slices(cin, cout):
    cs = 16 if cin <= 16 else 32 if cin <= 32 else 64
    ns = 64 if cout % 64 == 0 else 32
    return cs, ns


def replay_wgrad(x, slots, g, tmask, rows):
    """block_wgrad_mma_kernel block by block, then the fixed-order sum of
    the partial table's rows: (27 cin, cout) f32."""
    b, nt, _, cin = x.shape
    cout = g.shape[-1]
    cs, ns = _wg_slices(cin, cout)
    nci = -(-cin // cs)
    real = np.flatnonzero(tmask.reshape(-1))
    table = np.zeros((rows, 27 * cin, cout), np.float32)
    xf, gf, sf = (x.reshape(b * nt, T ** 3, cin), g.reshape(-1, T ** 3, cout),
                  slots.reshape(-1, 27))
    for r in range(rows):
        mine = real[r::rows]
        assert len(mine) <= WG_LIST
        for y in range(3 * nci * (cout // ns)):
            dz = y % 3 - 1
            c0, o0 = (y // 3) % nci * cs, y // (3 * nci) * ns
            acc = np.zeros((9, cs, ns), np.float32)
            for tile in mine:
                ev = tile // nt
                xe = xf[ev * nt:(ev + 1) * nt]
                for z0 in range(0, T, SZ):
                    h = np.arange(SZ * 100)
                    rows_u = _gather_rows(xe, sf[tile], z0 + dz + h // 100,
                                          (h // 10) % 10 - 1, h % 10 - 1,
                                          c0, cs // 8, cin)
                    halo = _stage(rows_u, cs // 8)
                    gsl = gf[tile, z0 * 64:(z0 + SZ) * 64, o0:o0 + ns]
                    gst = _stage(gsl.reshape(SZ * 64, ns // 8, 8), ns // 8)
                    for kq in range(SZ * 4):
                        vox = np.arange(16)
                        nn = np.arange(ns)
                        bm = gst[hswz(kq * 16 + vox[:, None],
                                      (nn // 8)[None], ns // 8),
                                 (nn % 8)[None]]               # (16, ns)
                        mm = np.arange(cs)
                        for w in range(WG_WARPS):
                            dy, dx = w // 3 - 1, w % 3 - 1
                            ha = ((vox >> 3) + 1 + dy) * 10 + (vox & 7) \
                                + 1 + dx
                            rws = (kq // 4) * 100 + (kq % 4) * 20 + ha
                            am = halo[hswz(rws[None], (mm // 8)[:, None],
                                           cs // 8), (mm % 8)[:, None]]
                            acc[w] += am @ bm
            for w in range(WG_WARPS):
                d = (dz + 1) * 9 + w
                ci = c0 + np.arange(cs)
                keep = ci < cin
                table[r, d * cin + ci[keep], o0:o0 + ns] = acc[w][keep]
    out = np.zeros((27 * cin, cout), np.float32)
    for r in range(rows):
        out += table[r]
    return out


def _bf16_close(got, ref):
    err = np.abs(got - ref)
    assert (err <= 2.0 ** -7 * np.abs(ref)
            + 1e-4 * np.abs(ref).max()).all(), float(err.max())


@pytest.mark.parametrize("cin,cout", [(2, 32), (48, 96), (20, 32),
                                      (64, 32)])
def test_forward_replay_matches_plain(tiles, cin, cout):
    tmask, slots = tiles
    x, w2 = _inputs(tmask, cin, cout, seed=cin + cout)
    got = replay_conv(x, slots, w2, tmask)
    ref = bc.block_conv_plain(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(slots),
                              torch.from_numpy(w2).bfloat16()).float()
    _bf16_close(got, ref.numpy())
    assert not got[~tmask].any()


@pytest.mark.parametrize("cin,cout", [(32, 64), (96, 48), (32, 40)])
def test_dgrad_replay_matches_plain(tiles, cin, cout):
    """The dgrad's GEMM: K = the forward's Cout, N = its Cin, the taps
    read as W[26 - d]^T in place (no flip_w2)."""
    tmask, slots = tiles
    g, _ = _inputs(tmask, cout, cin, seed=cin * cout)
    _, w2 = _inputs(tmask, cin, cout, seed=cin + 7)
    got = replay_conv(g, slots, w2, tmask, dgrad=True)
    ref = bc.block_conv_dgrad_plain(torch.from_numpy(g).bfloat16(),
                                    torch.from_numpy(slots),
                                    torch.from_numpy(w2).bfloat16()).float()
    _bf16_close(got, ref.numpy())
    assert not got[~tmask].any()


@pytest.mark.parametrize("cin,cout,per_sm", [(2, 64, 2), (48, 96, 1),
                                             (20, 32, 1)])
def test_wgrad_replay_matches_plain(tiles, cin, cout, per_sm):
    tmask, slots = tiles
    x, _ = _inputs(tmask, cin, cout, seed=3 * cin + cout)
    g, _ = _inputs(tmask, cout, cin, seed=cin + 5 * cout)
    # the cotangent of padding tiles must add nothing
    g[~tmask] = 1.0
    cs, ns = _wg_slices(cin, cout)
    chunks = 3 * -(-cin // cs) * (cout // ns)
    rows = wgrad_rows(tmask.size, chunks, cin=cin, cout=cout, per_sm=per_sm,
                      sms=8)
    got = replay_wgrad(x, slots, g, tmask, rows)
    tx, tg, ts = (torch.from_numpy(x).bfloat16(), torch.from_numpy(g)
                  .bfloat16(), torch.from_numpy(slots))
    ref = bc.block_conv_wgrad_plain(tx, ts, tg, torch.float32).numpy()
    mag = bc.block_conv_wgrad_plain(tx.abs(), ts, tg.abs(),
                                    torch.float32).numpy()
    err = np.abs(got - ref)
    assert (err <= 1e-5 * mag + 2.0 ** -8 * np.abs(ref)).all(), \
        float(err.max())


@pytest.mark.parametrize("b,nt,cin,cout,per_sm", [
    (8, 64, 2, 64, 2), (8, 64, 64, 64, 1), (8, 32, 128, 128, 1),
    (8, 64, 48, 96, 1), (2, 16, 20, 32, 1), (64, 128, 64, 64, 1)])
def test_wgrad_partition_covers_each_product_once(b, nt, cin, cout, per_sm):
    """Every (tap, ci, co, real tile) falls in exactly one block's share,
    the partial table stays within the bytes of x and g, and a block's
    tile list within kWgList."""
    rng = np.random.default_rng(b * nt + cin)
    tmask = np.zeros((b, nt), bool)
    for e in range(b):
        tmask[e, :rng.integers(0, nt + 1)] = True
    cs, ns = _wg_slices(cin, cout)
    nci, nco = -(-cin // cs), cout // ns
    chunks = 3 * nci * nco
    rows = wgrad_rows(b * nt, chunks, cin=cin, cout=cout, per_sm=per_sm)
    assert rows * 27 * cin * cout * 4 <= b * nt * T ** 3 * (cin + cout) * 2
    real = np.flatnonzero(tmask.reshape(-1))
    count = np.zeros((27, cin, cout), np.int64)
    seen = np.zeros(b * nt, np.int64)
    for r in range(rows):
        mine = real[r::rows]
        assert len(mine) <= WG_LIST
        seen[mine] += 1
        for y in range(chunks):
            dz = y % 3 - 1
            c0, o0 = (y // 3) % nci * cs, y // (3 * nci) * ns
            taps = (dz + 1) * 9 + np.arange(9)
            count[taps[:, None, None], np.arange(c0, min(c0 + cs, cin))
                  [None, :, None], np.arange(o0, o0 + ns)[None, None]] += \
                len(mine)
    assert (seen[real] == 1).all() and not seen[~tmask.reshape(-1)].any()
    assert (count == len(real)).all()


# ------------------------------------------------- the warpgroup forms

TPS = C["kTPS"]
WG_T, WG_HALO, WG_G, WG_WNST = (C["kWgmmaWgThreads"], C["kWgmmaHalo"],
                                C["kWgmmaG"], C["kWgmmaWgNST"])


def test_wgmma_plan_constants():
    """Three taps a weight stage; 3 stages at 64 outputs (two blocks an
    SM fit), 4 at 128; the wgrad's three warpgroups, 64 x 64 slices and
    4 stages; every shared-memory plan fits."""
    assert TPS == 3 and WG_T == 384 and WG_WNST == 4
    assert "return n <= 64 ? 3 : 4;" in SRC
    assert WG_HALO == SZ * 100 * 64 * 2 and WG_G == SZ * 64 * 64 * 2
    for n, nst, blocks in ((64, 3, 2), (128, 4, 1)):
        smem = 1024 + nst * TPS * KC * n * 2 + 2 * C["kHaloBytes"]
        assert blocks * (smem + 27 * 4 + 1024) <= 228 * 1024
    assert 1024 + WG_WNST * (WG_G + WG_HALO) + 4 * (WG_LIST + 12) \
        <= SMEM_MAX


def _desc_read(mem, start, lbo, sbo, rows, cols, major, swizzle=False):
    """The (rows, cols) operand a wgmma reads through a shared-memory
    descriptor (CUTLASS's canonical GMMA layouts; ``mem`` holds one value
    a 2-byte element, byte offsets / 2). K-major without swizzle: element
    (mn, k) at (mn // 8) SBO + (mn % 8) 16 + (k // 8) LBO + (k % 8) 2;
    MN-major without swizzle: (mn // 8) SBO + (mn % 8) 2 + (k // 8) LBO +
    (k % 8) 16; MN-major with the 128-byte swizzle: (mn // 64) LBO + (k //
    8) SBO + (k % 8) 128 + (mn % 64) 2, 16-byte chunks XOR bits 7-9.
    ``rows`` is the M / N extent, ``cols`` K; returns (mn, k)."""
    mn = np.arange(rows)[:, None]
    k = np.arange(cols)[None, :]
    if major == "K":
        off = (mn // 8) * sbo + (mn % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    elif not swizzle:
        off = (mn // 8) * sbo + (mn % 8) * 2 + (k // 8) * lbo + (k % 8) * 16
    else:
        off = (mn // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 \
            + (mn % 64) * 2
        off = off ^ (((off >> 7) & 7) << 4)
    return mem[(start + off) // 2]


def replay_conv_wgmma(x, slots, w2, tmask, dgrad=False):
    """conv_wgmma_body stage by stage: the halo unit-major ([kHU][kHRows]),
    a step's three taps' weights (forward: [N / 64][kKC][64] swizzled;
    dgrad: W[26 - d]^T as [k units][N]), each product read through the
    kernel's descriptors."""
    b, nt, _, k = x.shape
    n = w2.shape[0] // 27 if dgrad else w2.shape[1]
    ks_n = 1 if k <= 16 else 2
    tap = KC * n * 2
    out = np.zeros((b, nt, T ** 3, n), np.float32)
    nchunks = -(-k // KC)
    for bi in range(b):
        for ti in range(nt):
            sl = slots[bi, ti]
            if sl[13] < 0:
                continue
            for zh in range(T // PZ):
                gz, gy, gx = _halo_coords(zh)
                acc = np.zeros((PZ, 64, n), np.float32)
                for c in range(nchunks):
                    c0, cc = c * KC, min(KC, k - c * KC)
                    rows_u = _gather_rows(x[bi], sl, gz, gy, gx, c0, HU,
                                          min(k, c0 + 16 * ks_n))
                    halo = np.zeros(HU * HROWS * 8, np.float32)
                    idx = (np.arange(HU)[None, :] * HROWS
                           + np.arange(HROWS)[:, None])
                    halo.reshape(-1, 8)[idx] = rows_u
                    for g3 in range(9):
                        dz, dy = g3 // 3 - 1, g3 % 3 - 1
                        wst = np.zeros(TPS * tap // 2, np.float32)
                        kr = np.arange(16 * ks_n)
                        for j in range(TPS):
                            d = 3 * g3 + j
                            if not dgrad:
                                rows = np.where((kr < cc)[:, None], w2[
                                    d * k + c0 + np.minimum(kr, cc - 1)],
                                    0.0)                       # (kr, n)
                                nn = np.arange(n)[None]
                                off = (nn // 64) * KC * 128 + kr[:, None] \
                                    * 128 + nn % 64 * 2
                                off = off ^ (((off >> 7) & 7) << 4)
                                wst[(j * tap + off) // 2] = rows
                            else:
                                cols = c0 + np.minimum(kr, cc - 1)
                                rowsn = w2[(26 - d) * n + np.arange(n)]
                                vals = np.where((kr < cc)[None],
                                                rowsn[:, cols], 0.0)
                                nn = np.arange(n)[:, None]
                                off = ((kr[None] // 8) * n + nn) * 16 \
                                    + kr[None] % 8 * 2
                                wst[(j * tap + off) // 2] = vals
                        for j in range(TPS):
                            for ks in range(ks_n):
                                if dgrad:
                                    bm = _desc_read(wst, j * tap + 2 * ks * n
                                                    * 16, n * 16, 128, n, 16,
                                                    "K")
                                else:
                                    bm = _desc_read(wst, j * tap + ks * 2048,
                                                    KC * 128, 1024, n, 16,
                                                    "MN", swizzle=True)
                                for pz in range(PZ):
                                    h0 = ((pz + 1 + dz) * 10 + 1 + dy) * 10 \
                                        + j
                                    am = _desc_read(halo, (2 * ks * HROWS
                                                           + h0) * 16,
                                                    HROWS * 16, 160, 64, 16,
                                                    "K")
                                    acc[pz] += am @ bm.T
                out[bi, ti, zh * PZ * 64:(zh + 1) * PZ * 64] = \
                    acc.reshape(PZ * 64, n)
    return _bf16(out)


@pytest.mark.parametrize("cin,cout", [(2, 64), (48, 128), (64, 64)])
def test_wgmma_forward_replay_matches_plain(tiles, cin, cout):
    tmask, slots = tiles
    x, w2 = _inputs(tmask, cin, cout, seed=cin * 3 + cout)
    got = replay_conv_wgmma(x, slots, w2, tmask)
    ref = bc.block_conv_plain(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(slots),
                              torch.from_numpy(w2).bfloat16()).float()
    _bf16_close(got, ref.numpy())
    assert not got[~tmask].any()


@pytest.mark.parametrize("cin,cout", [(64, 48), (128, 64)])
def test_wgmma_dgrad_replay_matches_plain(tiles, cin, cout):
    tmask, slots = tiles
    g, _ = _inputs(tmask, cout, cin, seed=cin + 11 * cout)
    _, w2 = _inputs(tmask, cin, cout, seed=cin + 9)
    got = replay_conv_wgmma(g, slots, w2, tmask, dgrad=True)
    ref = bc.block_conv_dgrad_plain(torch.from_numpy(g).bfloat16(),
                                    torch.from_numpy(slots),
                                    torch.from_numpy(w2).bfloat16()).float()
    _bf16_close(got, ref.numpy())


def replay_wgrad_wgmma(x, slots, g, tmask, rows):
    """block_wgrad_wgmma_kernel block by block (slab g rows [128][64]
    swizzled, halo [8 units][kWgSZ 100 rows]), products through its
    descriptors, then the fixed-order sum of the table's rows."""
    b, nt, _, cin = x.shape
    cout = g.shape[-1]
    nci = -(-cin // 64)
    real = np.flatnonzero(tmask.reshape(-1))
    table = np.zeros((rows, 27 * cin, cout), np.float32)
    xf, gf, sf = (x.reshape(b * nt, T ** 3, cin), g.reshape(-1, T ** 3, cout),
                  slots.reshape(-1, 27))
    hr = SZ * 100
    for r in range(rows):
        mine = real[r::rows]
        for y in range(3 * nci * (cout // 64)):
            dz = y % 3 - 1
            c0, o0 = (y // 3) % nci * 64, y // (3 * nci) * 64
            acc = np.zeros((9, 64, 64), np.float32)
            for tile in mine:
                ev = tile // nt
                xe = xf[ev * nt:(ev + 1) * nt]
                for z0 in range(0, T, SZ):
                    gmem = np.zeros(WG_G // 2, np.float32)
                    v = np.arange(SZ * 64)[:, None]
                    nn = np.arange(64)[None]
                    off = v * 128 + nn * 2
                    off = off ^ (((off >> 7) & 7) << 4)
                    gmem[off // 2] = gf[tile, z0 * 64:(z0 + SZ) * 64,
                                        o0:o0 + 64]
                    h = np.arange(hr)
                    rows_u = _gather_rows(xe, sf[tile], z0 + dz + h // 100,
                                          (h // 10) % 10 - 1, h % 10 - 1,
                                          c0, 8, cin)
                    hmem = np.zeros(8 * hr * 8, np.float32)
                    hmem.reshape(-1, 8)[np.arange(8)[None, :] * hr
                                        + h[:, None]] = rows_u
                    for kq in range(SZ * 4):
                        bm = _desc_read(gmem, kq * 2048, 8192, 1024, 64, 16,
                                        "MN", swizzle=True)   # (n, k)
                        for w in range(9):
                            dy, j = w // 3 - 1, w % 3
                            h0 = (kq // 4) * 100 + ((kq % 4) * 2 + 1 + dy) \
                                * 10 + j
                            am = _desc_read(hmem, h0 * 16, 160, hr * 16, 64,
                                            16, "MN")           # (m, k)
                            acc[w] += am @ bm.T
            for w in range(9):
                d = (dz + 1) * 9 + w
                ci = c0 + np.arange(64)
                keep = ci < cin
                table[r, d * cin + ci[keep], o0:o0 + 64] = acc[w][keep]
    out = np.zeros((27 * cin, cout), np.float32)
    for r in range(rows):
        out += table[r]
    return out


@pytest.mark.parametrize("cin,cout", [(64, 64), (48, 128), (128, 64)])
def test_wgmma_wgrad_replay_matches_plain(tiles, cin, cout):
    tmask, slots = tiles
    x, _ = _inputs(tmask, cin, cout, seed=7 * cin + cout)
    g, _ = _inputs(tmask, cout, cin, seed=cin + 13 * cout)
    g[~tmask] = 1.0
    assert _wg_slices(cin, cout) == (64, 64)
    chunks = 3 * -(-cin // 64) * (cout // 64)
    rows = wgrad_rows(tmask.size, chunks, cin=cin, cout=cout, sms=6)
    got = replay_wgrad_wgmma(x, slots, g, tmask, rows)
    tx, tg, ts = (torch.from_numpy(x).bfloat16(), torch.from_numpy(g)
                  .bfloat16(), torch.from_numpy(slots))
    ref = bc.block_conv_wgrad_plain(tx, ts, tg, torch.float32).numpy()
    mag = bc.block_conv_wgrad_plain(tx.abs(), ts, tg.abs(),
                                    torch.float32).numpy()
    err = np.abs(got - ref)
    assert (err <= 1e-5 * mag + 2.0 ** -8 * np.abs(ref)).all(), \
        float(err.max())


def test_route_rule_in_the_source():
    """The rule that picks the tensor-core kernels (block_route), which
    the wrappers ask through pcseg_block_route and the entries apply."""
    body = SRC[SRC.index("int block_route("):]
    body = body[:body.index("\n}\n")]
    for line in ("if (!is_bf16 || t != kT || !aligned || k < 1 || n < 1 || "
                 "n % 32)", "if (kind == kWgrad) return 1;",
                 "if (n > kNMax) return 0;",
                 "return kind == kFwd || k % 8 == 0;"):
        assert line in body
    assert "pcseg_block_route" in SRC and "flip_w2(" not in Path(
        bc.__file__).read_text().split("def block_conv_dgrad(")[1]
