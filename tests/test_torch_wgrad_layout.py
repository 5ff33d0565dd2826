"""The split-K order of csrc/conv3d_dgrad.cu's tensor-core 3^3 wgrad, on
the CPU.

The kernel keeps dW in its warps' accumulators: each warp of a tap group
(grid z) holds the fragments ``_fragments`` names, each block walks one
batch element's plane tiles over a depth range (a K range), reading the
forward's ring of activated planes (``ring_slot``) at every tap's shift
against the tile's own g' (``_plane_share``), and writes its taps' slice
of one row of a partial table (tap group 0 also dbias); a plane tile is
whole rows or, at W above kWmax, a column tile whose ring reads the
neighbouring tiles' columns as its halo;
``fixed_sum_kernel`` then adds the rows in a fixed order. That order is emulated here plane by
plane, row by row, and held against ``conv3x3_wgrad_plain`` and the VJP of
the JAX package's ``fused_conv3x3_p`` / ``fused_conv3x3_add_p`` in
interpret mode, on the same numpy-seeded inputs, for the variants a voxel
step launches: "act" (stats cotangent), "accum" (the add variant), "y1
no-stats" (g' = gy) and "stem" (no activation), at 8, 16, 32 and 64
channels. The shift is positive, so a ring padded before the activation
(relu(shift) at the border instead of zeros) would not agree.

Tolerances, as tests/test_torch_conv3d_block_bwd.py states them: every
side rounds g', the activated input and the weights to bf16 at the same
points and sums in f32 in another order, so dW and dbias agree to 1e-3 of
their largest value.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pcseg_tpu.ops.pallas import conv3d_block as jcb
from pcseg_tpu_torch.ops import conv3d_block as tcb

torch.set_num_threads(1)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _lanes(v, c):
    return jnp.asarray(np.tile(v, (1,) * (v.ndim - 1) + (128 // c,)))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _sum_err(got, ref):
    got, ref = _np(got), _np(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _sum_close(got, ref, name):
    err = _sum_err(got, ref)
    assert err <= 1e-3, (name, err)


# the wgrad's split (csrc/conv3d_dgrad.cu WgCfg<C>): fragments, fragments
# a warp, tap groups. A fragment is one tap's C x C block of dW, or at 8
# channels two taps' (2f, 2f + 1; tap 27 is none) stacked in one m16 tile;
# a block of 8 warps holds 8 x (fragments a warp) of them, so the grid has
# that many tap groups (grid z)
WGRAD_SPLIT = {8: (14, 2, 1), 16: (27, 4, 1), 32: (27, 4, 1),
               64: (27, 1, 4)}


def _fragments(c, z, warp):
    """The taps whose dW warp ``warp`` of tap group ``z`` keeps in its
    accumulators: fragments z FG + warp + 8 j (FG = 8 x fragments a
    warp), each one tap or, at 8 channels, two."""
    nf, tpw, _ = WGRAD_SPLIT[c]
    taps = []
    for j in range(tpw):
        f = z * 8 * tpw + warp + 8 * j
        if f < nf:
            taps += [t for t in ((2 * f, 2 * f + 1) if c == 8 else (f,))
                     if t < 27]
    return taps


def _plane_share(a, gp, b, d, h0, th, w0, tw):
    """One plane tile's share of the wgrad's GEMM, (27, Cin, Cout): for
    each tap t the ring slot of plane d + dz of the activated input ``a``
    (``ring_slot``) read at the tap's shift over the tile's rows h0 .. h0
    + th and columns w0 .. w0 + tw, transposed, times the tile's own g'
    (``gp`` (B, D, H, W, Cout))."""
    slots = {pd: tcb.ring_slot(a, b, pd, h0, th, w0, tw)
             for pd in (d - 1, d, d + 1)}
    own = gp[b, d, h0:h0 + th, w0:w0 + tw].reshape(-1, gp.shape[-1])
    r = torch.arange(th)[:, None]
    c = torch.arange(tw)[None, :]
    out = []
    for dz, dy, dx in tcb.ring_taps():
        v = ((r + 1 + dy) * (tw + 2) + (c + 1 + dx)).reshape(-1)
        out.append(slots[d + dz][v].t() @ own)
    return torch.stack(out)


def _fixed_sum(rows):
    """fixed_sum_kernel's order over the rows g: 8 running sums of the
    rows g = ty, ty + 8, ... (ty < 8), then those 8 in order."""
    red = []
    for ty in range(8):
        s = torch.zeros(rows.shape[1])
        for g in range(ty, rows.shape[0], 8):
            s = s + rows[g]
        red.append(s)
    out = red[0]
    for s in red[1:]:
        out = out + s
    return out


def _split_k_wgrad(a, gp, c, th, tw, dd):
    """The kernel's dW and dbias: a table row per (batch element, x block)
    with x block = (depth range of ``dd`` planes, row tile of ``th`` rows,
    column tile of ``tw`` columns) in the kernel's order (the tiles row by
    row, then the depth ranges; at tw = W the row tiles' order), each tap
    group writing its fragments' taps (each tap exactly once a row) and
    group 0 dbias, the rows summed in fixed_sum_kernel's order, the result
    viewed as the wrapper views it."""
    b, d, h, w, _ = a.shape
    cout = gp.shape[-1]
    nwt, groups = w // tw, WGRAD_SPLIT[c][2]
    tiles = h // th * nwt
    gx = tiles * -(-d // dd)
    n_dw = 27 * c * cout
    rows = torch.full((b * gx, n_dw + cout), float("nan"))
    for bi in range(b):
        for bx in range(gx):
            tile = bx % tiles
            h0, w0 = tile // nwt * th, tile % nwt * tw
            d0 = (bx // tiles) * dd
            d1 = min(d, d0 + dd)
            dw = 0.0
            for di in range(d0, d1):
                dw = dw + _plane_share(a, gp, bi, di, h0, th, w0, tw)
            row = rows[bi * gx + bx]
            for z in range(groups):
                for warp in range(8):
                    for t in _fragments(c, z, warp):
                        part = row[t * c * cout:(t + 1) * c * cout]
                        assert torch.isnan(part).all(), (z, warp, t)
                        part.copy_(dw[t].reshape(-1))
            row[n_dw:] = gp[bi, d0:d1, h0:h0 + th,
                            w0:w0 + tw].sum(dim=(0, 1, 2))
    assert not torch.isnan(rows).any()
    out = _fixed_sum(rows)
    return out[:n_dw].view(3, 3, 3, c, cout), out[n_dw:]


# (C, (D, H, W), rows a tile, planes a depth range): two or more row tiles
# and depth ranges each; JAX's packing needs W a multiple of 128 / C. A
# tile takes min(W, kWmax) columns: W 128 at 16 channels and W 64 at 64
# are two column tiles a row (B1, as tests/test_torch_conv_layout.py and
# test_torch_dgrad_layout.py take them), so the halo of an inner tile
# edge is the neighbouring tile's columns
SHAPES = [(8, (3, 4, 16), 2, 2), (16, (3, 4, 8), 2, 2),
          (32, (4, 4, 4), 2, 3), (64, (3, 4, 2), 2, 2),
          (16, (2, 8, 128), 4, 1), (64, (2, 8, 64), 4, 1)]


@pytest.mark.parametrize("c,dhw,th,dd", SHAPES)
@pytest.mark.parametrize("case", ["act", "accum", "y1 no-stats", "stem"])
def test_split_k_wgrad_matches_plain_and_jax_vjp(c, dhw, th, dd, case):
    rng = np.random.default_rng(50 + c)
    tw = min(dhw[2], tcb._RING_WMAX[c])
    b = 2 if tw == dhw[2] else 1
    x = _bf16(rng.normal(size=(b, *dhw, c)))
    bound = np.sqrt(6.0 / (27 * c))
    wt = rng.uniform(-bound, bound, size=(3, 3, 3, c, c)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, c)).astype(np.float32)
    shift = rng.uniform(0.1, 0.5, size=(b, c)).astype(np.float32)
    gy = _bf16(rng.normal(size=(b, *dhw, c)))
    gstats = np.stack([rng.normal(size=(b, c)) * 1e-2,
                       rng.normal(size=(b, c)) * 1e-3],
                      axis=1).astype(np.float32)
    activate = case != "stem"
    stats = case != "y1 no-stats"
    accum = _bf16(rng.normal(size=(b, *dhw, c))) if case == "accum" else None

    # JAX: dW and dbias of the VJP of the Pallas block
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))
    jargs = [jnp.asarray(wt), jnp.asarray(bias), _lanes(scale, c),
             _lanes(shift, c)]
    if accum is not None:
        ap, _ = jcb.pack_grid(jnp.asarray(accum, jnp.bfloat16))
        _, vjp = jax.vjp(lambda xp_, ap_, *rest: jcb.fused_conv3x3_add_p(
            xp_, ap_, *rest, meta, True, True), xp, ap, *jargs)
        _, _, jdw, jdb, _, _ = vjp((gyp, _lanes(gstats, c)))
    else:
        _, vjp = jax.vjp(lambda *a: jcb.fused_conv3x3_p(
            *a, meta, activate, stats, True, False, activate), xp, *jargs)
        _, jdw, jdb, _, _ = vjp((gyp, _lanes(gstats, c)) if stats else gyp)

    tx, tweights = _t(x, torch.bfloat16), _t(wt)
    tsc, tsh = (_t(scale), _t(shift)) if activate else (None, None)
    y, _ = tcb.conv3x3_gn_act_plain(
        tx, tweights, _t(bias), tsc, tsh,
        None if accum is None else _t(accum, torch.bfloat16),
        activate=activate)
    ty, tgs = (y, _t(gstats)) if stats else (None, None)
    tgy = _t(gy, torch.bfloat16)

    a = tcb._prologue(tx, tsc, tsh, activate)
    gp = tcb._gprime(tgy, ty, tgs, "3x3").to(torch.bfloat16).float()
    dw, db = _split_k_wgrad(a, gp, c, th, tw, dd)

    pdw, pdb = tcb.conv3x3_wgrad_plain(tx, tsc, tsh, tgy, ty, tgs, activate)
    for (rw, rb), label in (((jdw, jdb), "jax"), ((pdw, pdb), "plain")):
        _sum_close(dw, rw, f"dW vs {label}")
        _sum_close(db, rb, f"dbias vs {label}")
    if activate:
        # the same sums over a grid padded before the activation: the
        # border taps see relu(shift) > 0 instead of zeros
        pad = F.pad(tx.float().permute(0, 4, 1, 2, 3), (1,) * 6)
        a_bad = tcb.act(pad.permute(0, 2, 3, 4, 1), tsc, tsh).float()
        bad = torch.nn.grad.conv3d_weight(
            a_bad.permute(0, 4, 1, 2, 3), (c, c, 3, 3, 3),
            gp.permute(0, 4, 1, 2, 3)).permute(2, 3, 4, 1, 0)
        assert _sum_err(bad, pdw) > 1e-2


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_every_tap_has_one_warp(c):
    """Over the tap groups and the 8 warps of a block, the fragments name
    each of the 27 taps exactly once (at 8 channels two a fragment, the
    fourteenth's second tap none)."""
    _, _, groups = WGRAD_SPLIT[c]
    taps = [t for z in range(groups) for w in range(8)
            for t in _fragments(c, z, w)]
    assert sorted(taps) == list(range(27))


def _ternary(expr):
    """A C conditional expression (nested in its else branch) in Python."""
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if not m:
        return expr
    return f"(({m[2]}) if ({m[1]}) else ({_ternary(m[3])}))"


def _wgrad_cfg(c):
    """csrc/conv3d_dgrad.cu's launch constants, RingCfg<C> and WgCfg<C>,
    evaluated from the source (its ternaries and integer divisions)."""
    src = (Path(tcb.__file__).resolve().parents[1] / "csrc"
           / "conv3d_dgrad.cu").read_text()
    base = {"C": c}
    for name in ("kThreads", "kWarps", "kSmemMax"):
        base[name] = eval(re.search(rf"constexpr int {name} = ([^;]+);",
                                    src)[1].replace("/", "//"), {}, base)

    def struct(name, env):
        body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S)[1]
        keys = []
        for key, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                    body):
            expr = expr.replace("/", "//").replace("RingCfg<C>::", "ring_")
            env[key] = eval(_ternary(expr), {}, env)
            keys.append(key)
        return {k: env[k] for k in keys}

    ring = struct("RingCfg", dict(base))
    wg = struct("WgCfg", {**base, **{f"ring_{k}": v
                                     for k, v in ring.items()}})
    return base, ring, wg


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_wgrad_split_table_matches_the_kernel(c):
    """``WGRAD_SPLIT`` restates WgCfg<C>'s fragments, fragments a warp and
    tap groups; a warp keeps at most 128 f32 accumulators; a table row is
    the 27 C^2 + C floats the wrapper allocates; and the wgrad's shared
    memory (two g' tiles, the y tile, the vectors and the ring of a tile
    of ``ring_tile_width`` columns) fits at every W ``_conv_route`` takes,
    whole rows and column tiles (W up to 256)."""
    env, ring, wg = _wgrad_cfg(c)
    assert WGRAD_SPLIT[c] == (wg["NF"], wg["TPW"], wg["Z"])
    assert wg["TPW"] * wg["MT"] * wg["NT"] * 4 <= 128
    assert wg["FG"] == 8 * wg["TPW"] and wg["L"] == 27 * c * c + c
    assert wg["kG"] == ring["M"] * c * 2 == tcb._RING_TILE[c] * c * 2
    taken = []
    for w in range(16, 257, 16):
        if not tcb._conv_route(c, c, (1, 2, ring["M"], w, c)):
            continue
        tw = tcb.ring_tile_width(c, w)
        taken.append(w)
        slot = (ring["M"] // tw + 2) * (tw + 2) * c * 2
        smem = 3 * wg["kG"] + wg["kVec"] + 3 * slot
        assert smem <= env["kSmemMax"], (c, w, smem)
    assert {128, 256} <= set(taken), taken


class _FakeLibrary:
    """Records the entries a wrapper calls; every entry succeeds."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("h,w,entry", [(16, 16, "pcseg_conv3x3_wgrad_mma"),
                                       (16, 8, "pcseg_conv3x3_wgrad"),
                                       (8, 16, "pcseg_conv3x3_wgrad"),
                                       (16, 128, "pcseg_conv3x3_wgrad_mma")])
def test_wgrad_launches_the_kernel_its_route_names(monkeypatch, h, w, entry):
    """conv3x3_wgrad_cuda launches conv3d_dgrad.cu's split-K GEMM exactly
    where ``_conv_route`` takes the shape (W 16 with H a multiple of the
    plane tile's 16 rows; W 128 in column tiles of 64, H a multiple of 4),
    else conv3d_block.cu's wgrad_kernel (W 8, or H 8 at W 16), and counts
    the launch under its keys; the tensor-core route returns dW and dbias
    as views of one (27 C^2 + C) buffer."""
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_ring_grid", lambda *a: 1)
    c = 16
    x = torch.zeros(2, 4, h, w, c, dtype=torch.bfloat16)
    vec = torch.ones(2, c)
    before = dict(tcb.LAUNCHES)
    dw, db = tcb.conv3x3_wgrad_cuda(x, vec, vec, torch.zeros_like(x), None,
                                    None, True)
    assert calls == [entry]
    assert dw.shape == (3, 3, 3, c, c) and db.shape == (c,)
    mma = int(entry.endswith("_mma"))
    assert tcb.LAUNCHES["conv3x3_wgrad"] == before["conv3x3_wgrad"] + 1
    assert (tcb.LAUNCHES["conv3x3_wgrad_mma"]
            == before["conv3x3_wgrad_mma"] + mma)
    if mma:
        assert (dw.untyped_storage().data_ptr()
                == db.untyped_storage().data_ptr())
