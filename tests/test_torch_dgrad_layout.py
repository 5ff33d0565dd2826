"""The operand layout of csrc/conv3d_dgrad.cu's implicit-GEMM 3^3 dgrad,
on the CPU.

``ring_taps``, ``pack_dgrad_w``, ``ring_slot`` and ``ring_swizzle``
state the layout the kernel computes by index: each is checked element
by element, and the GEMM built from them plane by plane
(``ring_plane``, with the plain version's rounding points: g' and the
weights in bf16, f32 sums) against ``conv3x3_dgrad_plain`` and the VJP of
the JAX package's ``fused_conv3x3_p`` / ``fused_conv3x3_add_p`` in
interpret mode, on the same numpy-seeded inputs, for the variants the
voxel step launches: "act" (stats cotangent), "accum" (the add variant,
whose accum gradient is g') and "no-stats" (g' = gy).

Tolerances, as tests/test_torch_conv3d_block_bwd.py states them: every
side rounds g', the weights and dx at the same points and sums in f32 in
another order, so dx and the accum gradient may land on the neighbouring
bf16 value (rtol 2^-7 plus 1e-4 of the largest value) and dscale /
dshift agree to 1e-3 of their largest value; g' itself is exact.
"""

import re
from pathlib import Path

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
    return jnp.asarray(np.tile(v, (1,) * (v.ndim - 1) + (128 // c,)))


def _fold_lanes(v, c):
    v = np.asarray(v)
    return v.reshape(v.shape[0], 128 // c, c).sum(axis=1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bf16_close(got, ref, name):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _sum_close(got, ref, name):
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * np.abs(ref).max() + 1e-12, (name, err)


def test_taps_and_packed_weights_index_by_index():
    """Tap t = (kz 3 + ky) 3 + kx reads offset (kz - 1, ky - 1, kx - 1);
    its B row is the forward's tap (2 - kz, 2 - ky, 2 - kx), [ci][co]."""
    rng = np.random.default_rng(0)
    w = _t(rng.normal(size=(3, 3, 3, 8, 16)))
    wpk = tcb.pack_dgrad_w(w)
    assert wpk.shape == (27, 8, 16)
    for t, (dz, dy, dx) in enumerate(tcb.ring_taps()):
        kz, ky, kx = dz + 1, dy + 1, dx + 1
        assert t == (kz * 3 + ky) * 3 + kx
        assert torch.equal(wpk[t], w[2 - kz, 2 - ky, 2 - kx])
    # the flipped, IO-swapped weights of the direct kernel, transposed back
    wt = tcb._wt(w)
    for t, (dz, dy, dx) in enumerate(tcb.ring_taps()):
        assert torch.equal(tcb._wq(wpk[t]).t(), wt[dz + 1, dy + 1, dx + 1])


def test_ring_slot_index_map():
    """Position r (tw + 2) + c of the slot of plane pd is voxel (h0 - 1 +
    r, w0 - 1 + c) of that plane, zero outside the grid (and for planes
    outside): whole rows (tw = W), and column tiles whose halo at an inner
    edge holds the neighbouring tile's columns."""
    rng = np.random.default_rng(1)
    g = _t(rng.normal(size=(2, 3, 6, 8, 4)))
    _, d, h, w, c = g.shape
    for pd in (-1, 0, 2, 3):
        for h0, th in ((0, 2), (2, 2), (4, 2), (0, 6)):
            for w0, tw in ((0, w), (0, 4), (4, 4), (2, 2)):
                slot = tcb.ring_slot(g, 1, pd, h0, th, w0, tw)
                assert slot.shape == ((th + 2) * (tw + 2), c)
                for r in range(th + 2):
                    for cc in range(tw + 2):
                        hh, ww = h0 - 1 + r, w0 - 1 + cc
                        inside = (0 <= pd < d and 0 <= hh < h
                                  and 0 <= ww < w)
                        want = (g[1, pd, hh, ww] if inside
                                else torch.zeros(c))
                        assert torch.equal(slot[r * (tw + 2) + cc], want)


@pytest.mark.parametrize("units", [1, 2, 4, 8])
def test_ring_swizzle_is_conflict_free_at_every_shift(units):
    """The swizzle permutes the units within each voxel, and one unit of
    any 8 consecutive voxels (an ldmatrix matrix at any tap's shift) falls
    in 8 distinct 16-byte bank groups of a 128-byte line."""
    n = 64 * units
    phys = [tcb.ring_swizzle(u, units) for u in range(n)]
    for v in range(64):
        assert sorted(phys[v * units:(v + 1) * units]) == list(
            range(v * units, (v + 1) * units))
    for v0 in range(64 - 8):
        for j in range(units):
            groups = {phys[(v0 + i) * units + j] % 8 for i in range(8)}
            assert len(groups) == 8, (v0, j)


# (C, (D, H, W), rows a tile): JAX's packing needs W a multiple of 128 / C.
# A tile takes min(W, kWmax) columns: W 128 at 16 channels and W 64 at 64
# are two column tiles a row (B1), so the halo of an inner tile edge is
# read from the neighbouring tile's columns
SHAPES = [(8, (3, 4, 16), 2), (16, (3, 4, 16), 4), (32, (4, 4, 8), 2),
          (16, (2, 8, 128), 4), (64, (2, 8, 64), 4)]


@pytest.mark.parametrize("c,dhw,th", SHAPES)
@pytest.mark.parametrize("case", ["act", "accum", "no-stats"])
def test_implicit_gemm_matches_plain_and_jax_vjp(c, dhw, th, case):
    rng = np.random.default_rng(30 + c)
    d, h, w = dhw
    cols = min(w, tcb._RING_WMAX[c])
    b = 2 if cols == w else 1
    x = _bf16(rng.normal(size=(b, *dhw, c)))
    bound = np.sqrt(6.0 / (27 * c))
    wt = rng.uniform(-bound, bound, size=(3, 3, 3, c, c)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, c)).astype(np.float32)
    shift = (rng.normal(size=(b, c)) * 0.3).astype(np.float32)
    gy = _bf16(rng.normal(size=(b, *dhw, c)))
    gstats = np.stack([rng.normal(size=(b, c)) * 1e-2,
                       rng.normal(size=(b, c)) * 1e-3],
                      axis=1).astype(np.float32)
    stats = case != "no-stats"
    accum = _bf16(rng.normal(size=(b, *dhw, c))) if case == "accum" else None

    # JAX: the VJP of the Pallas block (the dgrad's part: dx, dscale,
    # dshift and the accum gradient)
    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    gyp, _ = jcb.pack_grid(jnp.asarray(gy, jnp.bfloat16))
    jargs = [jnp.asarray(wt), jnp.asarray(bias), _lanes(scale, c),
             _lanes(shift, c)]
    if accum is not None:
        ap, _ = jcb.pack_grid(jnp.asarray(accum, jnp.bfloat16))
        _, vjp = jax.vjp(lambda xp_, ap_, *rest: jcb.fused_conv3x3_add_p(
            xp_, ap_, *rest, meta, True, True), xp, ap, *jargs)
        dxp, dap, _, _, dsc, dsh = vjp((gyp, _lanes(gstats, c)))
        jax_gadj = jcb.unpack_grid(dap, h, w, c)
    else:
        _, vjp = jax.vjp(lambda *a: jcb.fused_conv3x3_p(
            *a, meta, True, stats, True, False, True), xp, *jargs)
        dxp, _, _, dsc, dsh = vjp((gyp, _lanes(gstats, c)) if stats else gyp)
    jax_dx = jcb.unpack_grid(dxp, h, w, c)
    jax_dstats = np.stack([_fold_lanes(dsc, c), _fold_lanes(dsh, c)], axis=1)

    tx, tw = _t(x, torch.bfloat16), _t(wt)
    tsc, tsh = _t(scale), _t(shift)
    y, _ = tcb.conv3x3_gn_act_plain(tx, tw, _t(bias), tsc, tsh,
                                    None if accum is None else
                                    _t(accum, torch.bfloat16))
    ty, tgs = (y, _t(gstats)) if stats else (None, None)
    tgy = _t(gy, torch.bfloat16)

    # the kernel's GEMM, plane by plane and tile by tile
    gp = tcb._gprime(tgy, ty, tgs, "3x3").to(torch.bfloat16)
    wpk = tcb.pack_dgrad_w(tcb._wq(tw))
    da = torch.stack([torch.stack([
        torch.cat([torch.cat([tcb.ring_plane(gp.float(), wpk, bi, di, h0, th,
                                             w0, cols)
                              for w0 in range(0, w, cols)], dim=1)
                   for h0 in range(0, h, th)]) for di in range(d)])
        for bi in range(b)])
    dx, dstats = tcb._act_grad(da, tx, tsc, tsh, True)

    plain = tcb.conv3x3_dgrad_plain(tgy, ty, tgs, tx, tw, tsc, tsh, True,
                                    accum is not None)
    for ref, label in (((jax_dx, jax_dstats), "jax"), (plain, "plain")):
        _bf16_close(dx, ref[0], f"dx vs {label}")
        _sum_close(dstats, ref[1], f"dscale/dshift vs {label}")
    if accum is not None:
        assert torch.equal(plain[2], gp)
        _bf16_close(gp, jax_gadj, "g' vs jax")


@pytest.mark.parametrize("cin,cout,dhw,route", [
    (16, 16, (64, 64, 64), True), (32, 32, (32, 32, 32), True),
    (64, 64, (16, 16, 16), True), (8, 8, (8, 16, 16), True),
    (64, 64, (8, 8, 64), True), (16, 32, (8, 8, 16), False),
    (24, 24, (8, 8, 16), False), (16, 16, (8, 8, 8), False),
    (16, 16, (8, 6, 64), False), (16, 16, (8, 16, 48), False),
    (16, 16, (4, 128, 128), True), (16, 16, (4, 256, 256), True),
    (32, 32, (4, 128, 128), True), (64, 64, (4, 64, 64), True),
    (8, 8, (4, 8, 192), True), (16, 16, (4, 6, 128), False),
    (16, 16, (4, 8, 96), False), (64, 64, (4, 8, 48), False)])
def test_dgrad_route_is_declared_by_shape(cin, cout, dhw, route):
    """conv3d_dgrad.cu takes Cin = Cout in 8..64 with W in 16, 32, 64 (16,
    32 at 64 channels) or any multiple of 64 (32 at 64 channels, in column
    tiles) and H a multiple of the plane tile's rows, for the dgrad and the
    forward alike (one kernel template, one rule: ``_conv_route``); every
    other shape the wrappers accept stays on conv3d_block.cu's kernel."""
    x = torch.zeros(1, *dhw, cin, dtype=torch.bfloat16)
    assert tcb._conv_route(cin, cout, x.shape, x) is route


@pytest.mark.parametrize("c,dhw,tw", [
    (16, (64, 64, 64), 64), (32, (32, 32, 32), 32),
    (64, (16, 16, 16), 16), (8, (8, 16, 64), 64),
    (16, (4, 128, 128), 64), (16, (4, 256, 256), 64),
    (32, (4, 128, 128), 64), (64, (4, 64, 64), 32)])
def test_wgrad_route_is_the_forwards(monkeypatch, c, dhw, tw):
    """The wgrad takes the forward's and the dgrad's rule: whole rows at W
    16, 32, 64 (16, 32 at 64 channels) and column tiles of kWmax at W 128
    and 256 (64 at 64 channels), where conv3x3_wgrad_cuda launches
    conv3d_dgrad.cu's split-K GEMM and not conv3d_block.cu's
    wgrad_kernel."""
    x = torch.zeros(1, *dhw, c, dtype=torch.bfloat16)
    assert tcb.ring_tile_width(c, dhw[2]) == tw
    assert tcb._conv_route(c, c, x.shape, x)
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_ring_grid", lambda *a: 1)
    vec = torch.ones(1, c)
    tcb.conv3x3_wgrad_cuda(x, vec, vec, torch.zeros_like(x), None, None,
                           True)
    assert calls == ["pcseg_conv3x3_wgrad_mma"]


def _dgrad_cfg(c):
    """csrc/conv3d_dgrad.cu's RingCfg<C> and launch constants, evaluated
    from the source (its ternaries and integer divisions)."""
    src = (Path(tcb.__file__).resolve().parents[1] / "csrc"
           / "conv3d_dgrad.cu").read_text()
    env = {"C": c}
    for name in ("kThreads", "kWarps", "kSmemMax"):
        env[name] = eval(re.search(rf"constexpr int {name} = ([^;]+);",
                                   src)[1].replace("/", "//"), {}, env)
    body = re.search(r"struct RingCfg \{(.*?)\n\};", src, re.S)[1]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        expr = expr.replace("/", "//")
        cond = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
        if cond:
            expr = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
        env[name] = eval(expr, {}, env)
    return env


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_dgrad_tile_table_matches_the_kernel(c):
    """``_RING_TILE``, ``_RING_WMAX`` and ``_conv_route``'s W set restate
    what conv3d_dgrad.cu's ring_plan takes (RingCfg<C>::M voxels a plane
    tile of TW columns: W a multiple of 16 up to kWmax that divides M, or
    kWmax where kWmax divides W, for the forward, the dgrad and the wgrad
    alike; the ring, W, the x tiles and the vectors within kSmemMax): the
    same at every W."""
    cfg = _dgrad_cfg(c)
    m, wmax = cfg["M"], cfg["kWmax"]
    assert tcb._RING_TILE[c] == m and tcb._RING_WMAX[c] == wmax
    for w in range(8, 257, 8):
        whole = w % 16 == 0 and w <= wmax and m % w == 0
        tw = w if whole else wmax if w % wmax == 0 else 0
        if tw:
            slot = (m // tw + 2) * (tw + 2) * c * 2
            smem = cfg["kW"] + cfg["kVec"] + 2 * cfg["kX"] + 3 * slot
            assert smem <= cfg["kSmemMax"], (c, w, smem)
        assert tcb.ring_tile_width(c, w) == tw, (c, w)
        assert tcb._conv_route(c, c, (1, 2, m, w, c)) is bool(tw), (c, w)


def test_dgrad_route_needs_16_byte_aligned_grids():
    base = torch.zeros(2 * 4 * 16 * 16 * 16 + 8, dtype=torch.bfloat16)
    x = base[:-8].view(2, 4, 16, 16, 16)
    shifted = base[1:-7].view(2, 4, 16, 16, 16)
    assert tcb._conv_route(16, 16, x.shape, x)
    assert not tcb._conv_route(16, 16, x.shape, shifted)
    # a second grid (the forward's accum, the dgrad's gy) is held alike
    assert not tcb._conv_route(16, 16, x.shape, x, shifted)


class _FakeLibrary:
    """Records the entries a wrapper calls; every entry succeeds."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("w,entry", [(16, "pcseg_conv3x3_dgrad_mma"),
                                     (8, "pcseg_conv3x3_dgrad"),
                                     (128, "pcseg_conv3x3_dgrad_mma")])
def test_dgrad_launches_the_kernel_its_route_names(monkeypatch, w, entry):
    """conv3x3_dgrad_cuda launches conv3d_dgrad.cu's implicit GEMM exactly
    where ``_conv_route`` takes the shape (W 16, and W 128 in column
    tiles), else conv3d_block.cu's direct kernel (W 8), and counts the
    launch under its keys."""
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_ring_grid", lambda *a: 1)
    c = 16
    x = torch.zeros(2, 4, 16, w, c, dtype=torch.bfloat16)
    wt = torch.zeros(3, 3, 3, c, c)
    vec = torch.ones(2, c)
    gy = torch.zeros_like(x)
    before = dict(tcb.LAUNCHES)
    tcb.conv3x3_dgrad_cuda(gy, gy.clone(), torch.zeros(2, 2, c), x, wt, vec,
                           vec, True, True)
    assert calls == [entry]
    mma = int(entry.endswith("_mma"))
    assert tcb.LAUNCHES["conv3x3_dgrad"] == before["conv3x3_dgrad"] + 1
    assert (tcb.LAUNCHES["conv3x3_dgrad_mma"]
            == before["conv3x3_dgrad_mma"] + mma)
