"""The plans of row 20's backward on its vector route (csrc/fused_ln.cu
``ln_bwd_vec_kernel`` + ``column_sum_kernel``) and of row 9, the voxel
head's backward (csrc/conv3d_block.cu ``head_bwd_kernel`` +
``head_bwd_sum_kernel``), emulated on the CPU.

The constants are read out of the sources and each plan's rule is
restated here (``vec_lanes`` / ``bwd_vec_ok``; ``head_bwd_plan``). The
emulations deal rows or voxels to blocks, warps, lane groups and lanes as
the kernels do and show that every (row, channel) or (voxel, channel) is
taken exactly once, at N not a multiple of a sweep or a tile, and that
the products' K steps of every tile are each taken once. They then sum
the kernels' terms in the kernels' fixed orders (each lane over its rows
in order, a butterfly over the warp's lane groups, the warps in order,
the blocks in the sum kernel's order) in f32 and hold the results to the
plain versions (``bias_ln_relu_mask_bwd_plain``, ``head_grid2_bwd_plain``)
within the tolerances of the card tests: f32 sums within 1e-5 of the sum
of their terms' magnitudes, bf16 outputs within 2^-7 of |ref| + 1e-4 of
max |ref|. (The mma's own order inside a 16-voxel K step is the
hardware's: a K step's 16 products are summed here in f64 and rounded
once.)
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.ops import conv3d_block as cb
from pcseg_tpu_torch.ops import fused_ln as fl

torch.set_num_threads(1)

CSRC = Path(fl.__file__).resolve().parents[1] / "csrc"


def _consts(name, *keys):
    """``constexpr int|size_t KEY = <expr>;`` of csrc/<name>.cu, evaluated
    in order (an expression may use the names before it)."""
    src = (CSRC / f"{name}.cu").read_text()
    env = {}
    for key, expr in re.findall(
            r"constexpr (?:int|size_t) (\w+) = ([^;]+);", src):
        try:
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))
        except (NameError, SyntaxError):   # a template's own expression
            continue
    return {k: env[k] for k in keys}


LN = _consts("fused_ln", "kVecThreads", "kVecWarps", "kVecMaxC")
HEAD = _consts("conv3d_block", "kHeadMaxC", "kHeadMaxNC", "kHeadThreads",
               "kHeadWarps", "kHeadMaxTile", "kHeadStages", "kHeadSmallNC",
               "kHeadSmemTarget", "kSmemMax")


def test_constants_are_the_designs():
    assert LN == {"kVecThreads": 256, "kVecWarps": 8, "kVecMaxC": 256}
    assert HEAD["kHeadWarps"] == HEAD["kHeadThreads"] // 32 == 8
    assert (HEAD["kHeadMaxC"], HEAD["kHeadMaxNC"]) == (128, 128)
    assert HEAD["kHeadStages"] >= 2 and HEAD["kHeadMaxTile"] % 16 == 0


def _lanes(c):
    """Lanes a row or voxel: the least power of two >= c / 8."""
    lanes = 1
    while lanes * 8 < c:
        lanes *= 2
    return lanes


def _butterfly(vals, axis, descending=False):
    """The kernels' shuffle sum over ``axis`` (size a power of two): each
    step adds the value whose index differs in one bit, the bits from the
    lowest up (across a warp's lane groups) or from the highest down
    (group_sum, across a row's lanes)."""
    size = vals.shape[axis]
    offs = []
    off = 1
    while off < size:
        offs.append(off)
        off *= 2
    for off in (offs[::-1] if descending else offs):
        perm = torch.arange(size) ^ off
        vals = vals + vals.index_select(axis, perm)
    return vals.select(axis, 0)


def _in_order(vals, axis):
    """0 + v0 + v1 + ... along ``axis``, in order."""
    acc = torch.zeros_like(vals.select(axis, 0))
    for i in range(vals.shape[axis]):
        acc = acc + vals.select(axis, i)
    return acc


def _column_sum(rows):
    """column_sum_kernel / head_bwd_sum_kernel: 32 row lanes each adding
    every 32nd row in order, then the lanes in order."""
    lanes = []
    for ty in range(32):
        acc = torch.zeros_like(rows[0])
        for r in range(ty, rows.shape[0], 32):
            acc = acc + rows[r]
        lanes.append(acc)
    return _in_order(torch.stack(lanes), 0)


# ---------------------------------------------------------------------------
# row 20's backward, vector route
# ---------------------------------------------------------------------------

def ln_rows(n, c, blocks):
    """(row, block, warp, group, lane) of every (row, channel chunk) the
    vector route takes: warp w of block i takes rows (i W + w) R + r + k S
    (S = blocks W R) by lane group r, a lane on 8 channels."""
    lanes, w = _lanes(c), LN["kVecWarps"]
    r = 32 // lanes
    step = blocks * w * r
    out = []
    for i in range(blocks):
        for wp in range(w):
            base = (i * w + wp) * r
            while base < n:
                for grp in range(r):
                    row = base + grp
                    for sl in range(lanes):
                        if row < n and 8 * sl < c:
                            out.append((row, i, wp, grp, sl))
                base += step
    return out


@pytest.mark.parametrize("c", [8, 16, 24, 64, 128, 256])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_ln_vector_route_takes_every_row_and_channel_once(c, blocks):
    n = 1000   # not a multiple of a sweep (8 warps x R rows)
    seen = np.zeros((n, c), np.int32)
    for row, *_, sl in ln_rows(n, c, blocks):
        seen[row, 8 * sl:8 * sl + 8] += 1
    assert (seen == 1).all()
    assert c % 8 == 0 and c <= LN["kVecMaxC"]


def ln_vec_emulated(x, pre, scale, bias, active, g, eps, blocks):
    """The vector route's arithmetic and sums in its orders, f32: (dx in
    x's dtype, dpre_bias, dscale, dbias)."""
    n, c = x.shape
    lanes = _lanes(c)
    r, w = 32 // lanes, LN["kVecWarps"]
    cp = 8 * lanes
    on = torch.arange(cp) < c

    def pad(t):
        out = torch.zeros(t.shape[:-1] + (cp,), dtype=torch.float32)
        out[..., :c] = t.float()
        return out

    xb = torch.where(on, pad(x) + pad(pre), 0.0).reshape(n, lanes, 8)
    pow2 = c & (c - 1) == 0
    rc = torch.tensor(1.0 / c, dtype=torch.float32)

    def mean_of(v):
        return v * rc if pow2 else v / torch.tensor(float(c))

    def lane_sum(t):   # a lane's 8 terms in order, then its row's lanes
        s = _in_order(t, 2)
        return _butterfly(s, 1, descending=True)

    s = lane_sum(xb)
    ss = lane_sum(xb * xb)
    mean = mean_of(s)
    var = torch.clamp(mean_of(ss) - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + torch.tensor(eps, dtype=torch.float32))
    xh = (xb - mean[:, None, None]) * rstd[:, None, None]
    z = xh * pad(scale).reshape(lanes, 8) + pad(bias).reshape(lanes, 8)
    act = active.reshape(n, 1, 1) & on.reshape(1, lanes, 8)
    dz = torch.where(act & (z > 0), pad(g).reshape(n, lanes, 8), 0.0)
    dxh = dz * pad(scale).reshape(lanes, 8)
    m1 = mean_of(lane_sum(dxh))
    m2 = mean_of(lane_sum(dxh * xh))
    d = rstd[:, None, None] * ((dxh - m1[:, None, None])
                               - xh * m2[:, None, None])
    terms = torch.stack([dz * xh, dz, d]).reshape(3, n, cp)
    # a lane over its rows in order (rows s, s + S, ... of slot s)
    step = blocks * w * r
    sweeps = -(-n // step)
    padded = torch.zeros(3, sweeps * step, cp)
    padded[:, :n] = terms
    lane_acc = _in_order(padded.reshape(3, sweeps, step, cp), 1)
    lane_acc = lane_acc.reshape(3, blocks, w, r, cp)
    per_warp = _butterfly(lane_acc, 3)             # (3, blocks, w, cp)
    per_block = _in_order(per_warp, 2)             # (3, blocks, cp)
    sums = _column_sum(per_block.permute(1, 0, 2))[:, :c]
    dx = d.reshape(n, cp)[:, :c].to(x.dtype)
    return dx, sums[2], sums[0], sums[1]


@pytest.mark.parametrize("c", [8, 16, 24, 64, 128, 256])
def test_ln_vector_route_sums_match_the_plain_version(c):
    rng = np.random.default_rng(200 + c)
    n = 700
    x = torch.from_numpy(rng.normal(1, 3, (n, c)).astype(np.float32)).to(
        torch.bfloat16)
    pre = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
    active = torch.from_numpy(rng.random(n) < 0.7)
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(
        torch.bfloat16)
    args = (x, pre, scale, bias, active, g, 1e-5)
    ref = fl.bias_ln_relu_mask_bwd_plain(*args)
    got = ln_vec_emulated(*args, blocks=5)
    dx, r0 = got[0].float(), ref[0].float()
    assert bool(((dx - r0).abs() <= 2.0 ** -7 * r0.abs()
                 + 1e-4 * r0.abs().max()).all())
    # the terms' magnitudes of dpre_bias, dscale, dbias
    xf = x.float() + pre
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + 1e-5)
    xh = (xf - mean) * rstd
    dz = torch.where(active[:, None] & (xh * scale + bias > 0), g.float(),
                     0.0)
    mags = [r0.abs().sum(0), (dz * xh).abs().sum(0), dz.abs().sum(0)]
    for k in range(1, 4):
        err = (got[k] - ref[k]).abs()
        assert bool((err <= 1e-5 * mags[k - 1] + 1e-12).all()), k


# ---------------------------------------------------------------------------
# row 9: the head's backward
# ---------------------------------------------------------------------------

def head_plan(c, nc):
    """head_bwd_plan restated: lanes, tile, mt, nt, pairs a warp, ksplit,
    the shared strides, small; None past the shared memory."""
    w, stages = HEAD["kHeadWarps"], HEAD["kHeadStages"]
    p = {"lanes": _lanes(c), "mt": (c + 16) // 16, "nt": (nc + 7) // 8}
    pairs = p["mt"] * p["nt"]
    p["pw"] = -(-pairs // w)
    p["ksplit"] = w // pairs if pairs < w else 1
    p["sp"] = 16 * p["mt"] + 8
    p["gp"] = 8 * (p["nt"] | 1)
    p["small"] = nc <= HEAD["kHeadSmallNC"]

    def nbytes(tv):
        raw = 8 * ((tv * nc + 14) // 8)
        ring = (2 * (stages * (tv * c + raw) + 2 * tv * (p["sp"] + p["gp"]))
                + (0 if p["small"] else 4 * nc * c))
        return max(ring, 4 * w * (2 * c + 128))

    tiles = [HEAD["kHeadMaxTile"] >> i for i in range(8)
             if HEAD["kHeadMaxTile"] >> i >= 16]
    fit = next((t for t in tiles if nbytes(t) <= HEAD["kHeadSmemTarget"]),
               None) or next((t for t in tiles
                              if nbytes(t) <= HEAD["kSmemMax"]), None)
    if fit is None:
        return None
    p["tile"], p["smem"] = fit, nbytes(fit)
    return p


def test_head_plan_at_the_step_and_the_repaired_widths():
    """64^3 x 16 -> 4: 2 lanes a voxel, 256-voxel tiles, the 16 channels
    and the ones row in 2 m16 tiles, 4 warps a pair; every width the head
    takes (C a multiple of 8 up to 128, 1 to 128 classes) has a plan, and
    its shared memory fits a block."""
    p = head_plan(16, 4)
    assert (p["lanes"], p["tile"], p["mt"], p["nt"], p["ksplit"]) == (
        2, 256, 2, 1, 4)
    assert p["small"] and p["sp"] % 16 == 8 and (p["gp"] // 8) % 2 == 1
    for c in range(8, HEAD["kHeadMaxC"] + 1, 8):
        for nc in (1, 4, 5, 8, 13, 20, 64, 121, 128):
            q = head_plan(c, nc)
            assert q is not None and q["smem"] <= HEAD["kSmemMax"], (c, nc)
            assert q["pw"] <= 18 and q["tile"] % 16 == 0


def head_voxels(nvox, c, tile, gb):
    """(voxel, block, warp, group, lane) of every (voxel, channel chunk)
    of one batch element: block i takes tiles i, i + gb, ...; in a tile,
    warp w's group r takes voxels w R + r + k W R."""
    lanes, w = _lanes(c), HEAD["kHeadWarps"]
    r = 32 // lanes
    out = []
    ntiles = -(-nvox // tile)
    for i in range(gb):
        for t in range(i, ntiles, gb):
            for wp in range(w):
                for vw in range(wp * r, tile, w * r):
                    for grp in range(r):
                        v = vw + grp
                        if v < tile and t * tile + v < nvox:
                            for sl in range(lanes):
                                if 8 * sl < c:
                                    out.append((t * tile + v, i, wp, grp,
                                                sl))
    return out


def head_k_steps(c, nc, tile):
    """(pair, K step) -> the warps that take it, over one tile."""
    p = head_plan(c, nc)
    pairs, ks_n, w = p["mt"] * p["nt"], p["ksplit"], HEAD["kHeadWarps"]
    taken = {}
    for wp in range(w):
        p0 = wp % pairs if ks_n > 1 else wp * p["pw"]
        kp = wp // pairs if ks_n > 1 else 0
        for i in range(p["pw"]):
            use = (i == 0 and kp < ks_n) if ks_n > 1 else p0 + i < pairs
            if use:
                for ks in range(kp, tile // 16, ks_n):
                    taken.setdefault((p0 + i, ks), []).append(wp)
    return taken, pairs


@pytest.mark.parametrize("c", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("nc", [4, 20])
def test_head_takes_every_voxel_channel_and_k_step_once(c, nc):
    p = head_plan(c, nc)
    nvox = 3 * p["tile"] + 77    # a partial last tile
    seen = np.zeros((nvox, c), np.int32)
    for v, *_, sl in head_voxels(nvox, c, p["tile"], gb=2):
        seen[v, 8 * sl:8 * sl + 8] += 1
    assert (seen == 1).all()
    taken, pairs = head_k_steps(c, nc, p["tile"])
    assert sorted(taken) == [(q, ks) for q in range(pairs)
                             for ks in range(p["tile"] // 16)]
    assert all(len(ws) == 1 for ws in taken.values())


def head_emulated(x, gy, w, scale, shift, gb):
    """The head backward's sums in the kernel's orders, f32: (dstats,
    dW, dbias); dx is each voxel's own (held by the plain comparison)."""
    b, r = x.shape[0], x.shape[1]
    c, nc = x.shape[-1], gy.shape[-1]
    p = head_plan(c, nc)
    tile, lanes = p["tile"], p["lanes"]
    rr, wn = 32 // lanes, HEAD["kHeadWarps"]
    nvox = r ** 3
    xs = x.float().reshape(b, nvox, c)
    g = gy.float().reshape(b, nvox, nc)
    wq = w.reshape(c, nc).to(torch.bfloat16).float()
    pre = xs * scale[:, None, :] + shift[:, None, :]
    s = torch.relu(pre).to(torch.bfloat16).float()
    da = g @ wq.t()
    dam = torch.where(pre > 0, da, torch.zeros_like(da))
    ds_t, dh_t = dam * xs, dam
    ntiles = -(-nvox // tile)
    dstats_rows, dw_rows = [], []
    for bi in range(b):
        for i in range(gb):
            # dscale / dshift: lane (warp, group) over its voxels in order
            acc = torch.zeros(2, wn, rr, c)
            # dW / dbias: a pair's K steps in order, the ksplit phases
            # apart, each step's 16 products summed once (f64)
            kacc = torch.zeros(p["ksplit"], c + 1, nc)
            for t in range(i, ntiles, gb):
                for wp in range(wn):
                    for vw in range(wp * rr, tile, wn * rr):
                        for grp in range(rr):
                            v = t * tile + vw + grp
                            if vw + grp < tile and v < nvox:
                                acc[0, wp, grp] += ds_t[bi, v]
                                acc[1, wp, grp] += dh_t[bi, v]
                v0 = t * tile
                sv = torch.zeros(tile, c + 1)
                gv = torch.zeros(tile, nc)
                cnt = min(tile, nvox - v0)
                sv[:cnt, :c] = s[bi, v0:v0 + cnt]
                sv[:, c] = 1.0   # the ones column (gy is 0 past cnt)
                gv[:cnt] = g[bi, v0:v0 + cnt]
                for ks in range(tile // 16):
                    blk = slice(16 * ks, 16 * ks + 16)
                    step = (sv[blk].double().t() @ gv[blk].double()).float()
                    kacc[ks % p["ksplit"]] += step
            per_warp = _in_order(_butterfly(acc, 2), 1)     # (2, c)
            dstats_rows.append(per_warp.reshape(-1))
            dw_rows.append(_in_order(kacc, 0).reshape(-1))
    dstats = torch.stack([
        _column_sum(torch.stack(dstats_rows[bi * gb:(bi + 1) * gb]))
        for bi in range(b)]).reshape(b, 2, c)
    dwb = _column_sum(torch.stack(dw_rows)).reshape(c + 1, nc)
    return dstats, dwb[:c], dwb[c]


@pytest.mark.parametrize("c,nc", [(16, 4), (16, 20), (24, 13)])
def test_head_sums_match_the_plain_version(c, nc):
    rng = np.random.default_rng(300 + c + nc)
    b, r = 2, 8
    x = torch.from_numpy(rng.normal(size=(b, r, r, r, c)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 1, 1, c, nc)).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (b, c)).astype(
        np.float32))
    shift = torch.from_numpy((rng.normal(size=(b, c)) * 0.3).astype(
        np.float32))
    gy = torch.from_numpy(rng.normal(size=(b, r, r, r, nc)).astype(
        np.float32)).to(torch.bfloat16)
    ref = cb.head_grid2_bwd_plain(x, gy, w, scale, shift)
    dstats, dw, db = head_emulated(x, gy, w, scale, shift, gb=2)
    xs = x.float().reshape(b, -1, c)
    pre = xs * scale[:, None] + shift[:, None]
    g = gy.float().reshape(b, -1, nc)
    dam = torch.where(pre > 0, g @ w.reshape(c, nc).to(
        torch.bfloat16).float().t(), 0.0)
    s = torch.relu(pre).to(torch.bfloat16).float()
    mags = {"dstats": torch.stack([(dam * xs).abs().sum(1),
                                   dam.abs().sum(1)], 1),
            "dW": s.reshape(-1, c).t().abs() @ g.reshape(-1, nc).abs(),
            "dbias": g.abs().sum((0, 1))}
    for name, got, want in (("dstats", dstats, ref[1]), ("dW", dw, ref[2]),
                            ("dbias", db, ref[3])):
        err = (got - want).abs()
        assert bool((err <= 1e-5 * mags[name] + 1e-12).all()), name
