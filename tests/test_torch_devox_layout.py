"""Row 11's owner-computes layout (csrc/onehot_contract.cu
``trilinear_scatter_bin_kernel`` and ``trilinear_scatter_tile_kernel``),
emulated on the CPU.

The plan's constants are read out of ``ScatterCfg`` in the source and its
rule (``scatter_plan``: the zy rows of a tile, its warps, the bin size,
the binning blocks, the entry size) is restated here. The emulation bins each
event's points as the binning blocks do (a stable sort of each block's
points with a nonzero cotangent row by the bin of their base zy row) and
walks, for every tile, the bin ranges of the binning blocks that the
kernel reads, keeping the taps that land in the tile's rows. Every tap of
every binned point must be kept exactly once, by the tile that owns its
row, and the sums must be the plain version's
(``trilinear_scatter_plain``, f32, another order of the same terms).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.ops import voxel as tv

torch.set_num_threads(1)

SRC = Path(tv.__file__).resolve().parents[1] / "csrc" / "onehot_contract.cu"


def _cfg():
    """ScatterCfg's constants and kChunkC, evaluated from the source."""
    src = SRC.read_text()
    env = {"kChunkC": int(re.search(r"constexpr int kChunkC = (\d+);",
                                    src)[1])}
    body = re.search(r"struct ScatterCfg \{(.*?)\n\};", src, re.S)[1]
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 body):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


CFG = _cfg()


def plan(b, m, r, c):
    """scatter_plan: None where the kernels take no such call. Above
    kChunkC channels the tiles go a column chunk at a time: ``full`` chunks
    of kChunkC, then one of ``tail``; a tile's shared row is one chunk
    (``cw``) wide."""
    if not (0 < b <= 65535 and m > 0 and r > 0 and c > 0
            and c // CFG["kChunkC"] <= 65535):
        return None
    cw = min(c, CFG["kChunkC"])
    rows, row_bytes = r * r, r * cw * 4
    band = min(max(CFG["kTileBytes"] // row_bytes, 1), rows)
    w = CFG["kWarps"]

    def smem(nw):   # nw copies of the tile, nw x 8 one-byte tags a cell
        return nw * band * (row_bytes + r * 8)

    while w > 1 and smem(w) > CFG["kSmemMax"]:
        w //= 2
    if smem(w) > CFG["kSmemMax"]:
        return None
    wl = CFG["kLongWarps"]
    while wl > 1 and smem(wl) > CFG["kSmemMax"]:
        wl //= 2
    h = -(-rows // CFG["kMaxBins"])
    return {"rows": rows, "cw": cw, "full": c // CFG["kChunkC"],
            "tail": c % CFG["kChunkC"], "band": band, "w": w,
            "bands": -(-rows // band),
            "h": h, "bins": -(-rows // h),
            "chunks": -(-m // CFG["kBinThreads"]), "ent": 1 + -(-c // 8),
            "smem": smem(w), "wl": wl, "smem_l": smem(wl)}


def test_plan_at_the_step_shape_and_its_limits():
    """B8 x 8192 at R64, C4: tiles of 4 rows (4 KB), 8 warps each with a
    tile and a tag a cell and tap (48 KB), 16 warps with a copy each for a
    long tile (96 KB), bins of 2 rows, 16 binning blocks an event, entries
    of 32 bytes; R128 x C32 a row a tile, 8 warps for a long one; a R512 x
    C32 row (64 KB) leaves 2 warps; past 32 channels (33, 40, 121: the
    classes the matmul devoxelize takes at 32^3) column chunks of 32 with
    the tiles of a 32-channel plan and whole entries; a row of one chunk
    past a block's shared memory refused, at any C."""
    assert plan(8, 8192, 64, 4) == {
        "rows": 4096, "cw": 4, "full": 0, "tail": 4, "band": 4, "w": 8,
        "bands": 1024, "h": 2, "bins": 2048, "chunks": 16, "ent": 2,
        "smem": 49152, "wl": 16, "smem_l": 98304}
    assert plan(2, 3000, 128, 32)["band"] == 1
    assert (plan(2, 3000, 128, 32)["w"], plan(2, 3000, 128, 32)["wl"]) \
        == (8, 8)
    assert (plan(1, 10, 512, 32)["w"], plan(1, 10, 512, 32)["wl"]) == (2, 2)
    at32 = plan(8, 8192, 32, 32)
    for c, full, tail in ((33, 1, 1), (40, 1, 8), (121, 3, 25)):
        p = plan(8, 8192, 32, c)
        assert (p["cw"], p["full"], p["tail"]) == (32, full, tail)
        assert p["ent"] == 1 + -(-c // 8)
        assert {k: p[k] for k in ("band", "w", "smem", "wl", "smem_l")} == \
            {k: at32[k] for k in ("band", "w", "smem", "wl", "smem_l")}
    assert plan(8, 8192, 64, 33)["smem"] == plan(8, 8192, 64, 32)["smem"]
    assert plan(1, 10, 2000, 32) is None
    assert plan(1, 10, 2000, 121) is None
    assert CFG["kMaxBins"] == 4 * CFG["kBinThreads"]
    assert CFG["kBinSmem"] <= CFG["kSmemMax"]


def _base_row(u, r):
    iz = np.clip(np.floor(u[..., 0]), 0, r - 1).astype(np.int64)
    iy = np.clip(np.floor(u[..., 1]), 0, r - 1).astype(np.int64)
    return iz * r + iy


def _bin(key, p, m):
    """One event's binning blocks: the binned point ids of each block in
    (bin, point) order and each block's bin starts (bins + 1)."""
    out = []
    for j in range(p["chunks"]):
        ids = np.arange(j * CFG["kBinThreads"],
                        min((j + 1) * CFG["kBinThreads"], m))
        ids = ids[key[ids] >= 0]
        ids = ids[np.argsort(key[ids], kind="stable")]
        starts = np.searchsorted(key[ids], np.arange(p["bins"] + 1))
        out.append((ids, starts))
    return out


def _bin_ranges(p, r, r0, r1):
    h = p["h"]
    lo_b, hi_b = max(r0 - 1, 0) // h, (r1 - 1) // h
    top = r1 - 1 - r
    if top < 0:
        return [(lo_b, hi_b)]
    lo_a, hi_a = max(r0 - r - 1, 0) // h, top // h
    if hi_a >= lo_b - 1:
        return [(lo_a, hi_b)]
    return [(lo_a, hi_a), (lo_b, hi_b)]


def own_taps(u, r):
    """(8, B*M): the taps (t, x) the kernel adds, zy_taps' first copy of
    each zy row times x_taps' distinct x taps (the others carry 0)."""
    zi, _, xs, _ = tv._tri_taps(torch.from_numpy(u), r, lambda t: t)
    zi = torch.stack(zi).numpy()
    first = [np.all([zi[s] != zi[t] for s in range(t)], axis=0) if t
             else np.ones(zi[0].shape, bool) for t in range(4)]
    two = (xs[0] != xs[1]).numpy()
    return np.stack([first[t] & two if x else first[t]
                     for t in range(4) for x in range(2)]).reshape(8, -1)


def emulate(u, go, r):
    """The grid the kernels sum and, for each of the 8 taps of each
    point, how often a tile kept it."""
    b, m, c = go.shape
    p = plan(b, m, r, c)
    rows, vals = tv.trilinear_scatter_taps(torch.from_numpy(u),
                                           torch.from_numpy(go), r)
    rows, vals = rows.numpy(), vals.numpy()
    zy = np.where(own_taps(u, r), rows % r ** 3 // r, -1)
    key = np.where((go != 0).any(-1), _base_row(u, r) // p["h"], -1)
    grid = np.zeros((b * r ** 3, c), np.float64)
    kept = np.zeros(rows.shape, np.int64)
    for e in range(b):
        blocks = _bin(key[e], p, m)
        # rows that some tap of the event lands on (the other tiles add
        # nothing, so the emulation skips them)
        hit = np.zeros(p["rows"] + 1, bool)
        hit[zy[:, e * m:(e + 1) * m].reshape(-1)] = True
        for tile in range(p["bands"]):
            r0 = tile * p["band"]
            r1 = min(r0 + p["band"], p["rows"])
            if not hit[r0:r1].any():
                continue
            lst = np.concatenate(
                [ids[starts[lo]:starts[hi + 1]]
                 for lo, hi in _bin_ranges(p, r, r0, r1)
                 for ids, starts in blocks]) + e * m
            for t in range(8):
                sel = lst[(zy[t, lst] >= r0) & (zy[t, lst] < r1)]
                np.add.at(grid, rows[t, sel], vals[t, sel])
                kept[t, sel] += 1
    return grid.reshape(b, r ** 3, c), kept


def _case(seed, b, m, r, c):
    """Coords past both faces (clipped duplicate taps), integral coords,
    points on the faces, one spot hit by 150 points, masked rows and an
    all-masked event."""
    rng = np.random.default_rng(seed)
    u = (rng.random((b, m, 3)) * (r + 1) - 1).astype(np.float32)
    u[0, :40] = np.floor(u[0, :40])
    u[0, 40:50] = [-0.5, r - 0.5, 0.0]
    u[0, 50:60] = [r - 0.5, -0.5, r - 0.5]
    u[0, 100:250] = u[0, 99]
    go = rng.normal(size=(b, m, c)).astype(np.float32)
    go[0, ::7] = 0.0
    go[-1] = 0.0
    return u, go


@pytest.mark.parametrize("r,c", [(1, 4), (2, 3), (6, 4), (16, 1), (16, 7),
                                 (64, 4), (64, 32), (96, 4)])
def test_binning_keeps_every_tap_once_and_sums_to_the_plain_version(r, c):
    """Two binning blocks an event (the second partial), at grids from
    one voxel (tiles of the whole grid) to R96 (bins of 5 rows, not
    dividing R, wider than a tile's row)."""
    b, m = 3, 700
    u, go = _case(r * 100 + c, b, m, r, c)
    grid, kept = emulate(u, go, r)
    want = own_taps(u, r) & (go != 0).any(-1).reshape(-1)
    assert np.array_equal(kept, want.astype(np.int64))
    ref = tv.trilinear_scatter_plain(torch.from_numpy(u),
                                     torch.from_numpy(go), r).numpy()
    np.testing.assert_allclose(grid, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert not grid[-1].any()


def test_a_voxel_hit_by_every_point_is_dealt_to_every_warp():
    """Every point of an event on one spot: the tile of its base row lists
    them all, in chunks of 32 dealt chunk k to warp k % w (each chunk
    once, each warp's in order), and the sums are the plain version's."""
    b, m, r, c = 1, 1024, 16, 4
    u = np.full((b, m, 3), 7.25, np.float32)
    go = np.ones((b, m, c), np.float32)
    p = plan(b, m, r, c)
    key = np.where((go != 0).any(-1), _base_row(u, r) // p["h"], -1)[0]
    blocks = _bin(key, p, m)
    r0 = int(_base_row(u, r)[0, 0]) // p["band"] * p["band"]
    n = sum(starts[hi + 1] - starts[lo]
            for lo, hi in _bin_ranges(p, r, r0, r0 + p["band"])
            for _, starts in blocks)
    assert n == m
    chunks = math.ceil(n / 32)
    dealt = [list(range(k, chunks, p["w"])) for k in range(p["w"])]
    assert sorted(sum(dealt, [])) == list(range(chunks))
    grid, _ = emulate(u, go, r)
    ref = tv.trilinear_scatter_plain(torch.from_numpy(u),
                                     torch.from_numpy(go), r).numpy()
    np.testing.assert_allclose(grid, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("round_bf16", [True, False])
def test_plain_scatter_bf16_output_is_the_f32_sums_rounded_once(round_bf16):
    u, go = _case(5, 2, 300, 8, 4)
    u, go = torch.from_numpy(u), torch.from_numpy(go)
    f32 = tv.trilinear_scatter_plain(u, go, 8, round_bf16)
    half = tv.trilinear_scatter_plain(u, go, 8, round_bf16,
                                      out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, f32.to(torch.bfloat16))
    if round_bf16:      # the wrapper's CPU form is the plain version's
        assert torch.equal(
            tv.trilinear_scatter(u, go, 8, out_dtype=torch.bfloat16), half)
