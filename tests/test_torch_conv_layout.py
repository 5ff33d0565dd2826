"""The operand layout of csrc/conv3d_dgrad.cu's implicit-GEMM 3^3 forward,
on the CPU.

``pack_conv_w`` states the B operand the kernel reads by index and is
checked element by element. ``conv_plane`` builds the forward plane by
plane and tile by tile from ring slots (``ring_slot``, ``ring_plane``) of
the activated input, with the kernel's rounding points: the activated
input and the weights in bf16, f32 sums, + bias and + accum in f32, y =
bf16(v) and the stats of the f32 v. It is held against
``conv3x3_gn_act_plain`` and the JAX package's ``fused_conv3x3_p`` /
``fused_conv3x3_add_p`` in interpret mode, on the same numpy-seeded
inputs, for the four variants a voxel forward launches: "act", "accum"
(the decoder's skip merge), "stem" (no activation) and "no-stats" (the
decoder's y1). The shift is positive, so a zero padding applied before
the activation (relu(shift) at the border) would fail.

Tolerances, as tests/test_torch_conv3d_block.py states them: every side
rounds at the same points and sums in f32 in another order, so y may land
on the neighbouring bf16 value (rtol 2^-7, atol 1e-3) and the stats agree
to f32 sum error (rtol 1e-4, atol 1e-3).
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
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _lanes(v, c):
    return jnp.asarray(np.tile(v, (1,) * (v.ndim - 1) + (128 // c,)))


def _fold_lanes(v, c):
    v = np.asarray(v)
    return v.reshape(v.shape[0], 2, 128 // c, c).sum(axis=2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def test_pack_conv_w_index_by_index():
    """Row t of the forward's B operand is tap t = (kz 3 + ky) 3 + kx,
    which reads the input at (kz - 1, ky - 1, kx - 1), as [co][ci]; it is
    the dgrad's row 26 - t transposed (a dgrad is the forward with the
    taps flipped and the axes swapped)."""
    rng = np.random.default_rng(0)
    w = _t(rng.normal(size=(3, 3, 3, 8, 16)))
    pk = tcb.pack_conv_w(w)
    assert pk.shape == (27, 16, 8)
    dg = tcb.pack_dgrad_w(w)
    for t, (dz, dy, dx) in enumerate(tcb.ring_taps()):
        for co in range(16):
            for ci in range(8):
                assert pk[t, co, ci] == w[dz + 1, dy + 1, dx + 1, ci, co]
        assert torch.equal(pk[t], dg[26 - t].t())


def conv_plane(x, w, bias, scale, shift, accum, b, d, h0, th, activate,
               w0=0, tw=None):
    """The forward's f32 value v (th, tw, Cout) of rows h0 .. h0 + th and
    columns w0 .. w0 + tw (tw = W: whole rows) of plane d, at the kernel's
    rounding points: the ring holds bf16(relu(x scale + shift)) (x without
    the activation, zeros outside the grid), the GEMM takes the bf16
    ``pack_conv_w``, then + bias and + accum in f32; y = bf16(v) and the
    stats are (sum v, sum v^2)."""
    tw = x.shape[3] if tw is None else tw
    a = tcb._prologue(x, scale, shift, activate)
    v = tcb.ring_plane(a, tcb._wq(tcb.pack_conv_w(w)), b, d, h0, th, w0, tw)
    v = v + bias.float()
    if accum is not None:
        v = v + accum[b, d, h0:h0 + th, w0:w0 + tw].float()
    return v


def _conv_by_planes(x, w, bias, scale, shift, accum, th, tw, activate):
    """(y bf16, stats (B, 2, C)) as the kernel forms them: every plane
    tile's f32 v from ``conv_plane``, th rows x tw columns."""
    b, d, h, wd = x.shape[:4]
    v = torch.stack([torch.stack([
        torch.cat([torch.cat([conv_plane(x, w, bias, scale, shift, accum, bi,
                                         di, h0, th, activate, w0, tw)
                              for w0 in range(0, wd, tw)], dim=1)
                   for h0 in range(0, h, th)]) for di in range(d)])
        for bi in range(b)])
    stats = torch.stack([v.sum(dim=(1, 2, 3)), v.square().sum(dim=(1, 2, 3))],
                        dim=1)
    return v.to(torch.bfloat16), stats


# (C, (D, H, W), rows a tile): JAX's packing needs W a multiple of 128 / C.
# A tile takes min(W, kWmax) columns: W 128 at 16 channels and W 64 at 64
# are two column tiles a row (B1), so the halo of an inner tile edge is
# read from the neighbouring tile's columns
SHAPES = [(8, (3, 4, 16), 2), (16, (3, 4, 16), 4), (32, (4, 4, 8), 2),
          (16, (2, 8, 128), 4), (64, (2, 8, 64), 4)]


@pytest.mark.parametrize("c,dhw,th", SHAPES)
@pytest.mark.parametrize("case", ["act", "accum", "stem", "no-stats"])
def test_implicit_gemm_forward_matches_plain_and_jax(c, dhw, th, case):
    rng = np.random.default_rng(70 + c)
    d, h, w = dhw
    tw = min(w, tcb._RING_WMAX[c])
    b = 2 if tw == w else 1
    x = _bf16(rng.normal(size=(b, *dhw, c)))
    bound = np.sqrt(6.0 / (27 * c))
    wt = rng.uniform(-bound, bound, size=(3, 3, 3, c, c)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, size=(b, c)).astype(np.float32)
    shift = (0.5 + rng.normal(size=(b, c)) * 0.1).astype(np.float32)
    accum = _bf16(rng.normal(size=(b, *dhw, c))) if case == "accum" else None
    activate = case != "stem"
    want_stats = case != "no-stats"

    xp, meta = jcb.pack_grid(jnp.asarray(x, jnp.bfloat16))
    jargs = (jnp.asarray(wt), jnp.asarray(bias), _lanes(scale, c),
             _lanes(shift, c), meta)
    if accum is not None:
        ap, _ = jcb.pack_grid(jnp.asarray(accum, jnp.bfloat16))
        yp, st = jcb.fused_conv3x3_add_p(xp, ap, *jargs, True, True)
    else:
        out = jcb.fused_conv3x3_p(xp, *jargs, activate, want_stats, True)
        yp, st = out if want_stats else (out, None)
    y_jax = np.asarray(jcb.unpack_grid(yp, h, w, c).astype(jnp.float32))

    targs = (_t(x, torch.bfloat16), _t(wt), _t(bias), _t(scale), _t(shift),
             None if accum is None else _t(accum, torch.bfloat16))
    y, stats = _conv_by_planes(*targs, th, tw, activate)
    y_p, stats_p = tcb.conv3x3_gn_act_plain(
        *targs, activate=activate, want_stats=want_stats)
    assert y.shape == y_p.shape == (b, *dhw, c)
    for ref, label in ((y_jax, "jax"), (y_p.float().numpy(), "plain")):
        np.testing.assert_allclose(y.float().numpy(), ref, err_msg=label,
                                   **Y_TOL)
    if want_stats:
        for ref in (_fold_lanes(st, c), stats_p.numpy()):
            np.testing.assert_allclose(stats.numpy(), ref, **STATS_TOL)
    else:
        assert stats_p is None


class _FakeLibrary:
    """Records the entries a wrapper calls; every entry succeeds."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("w,entry", [(16, "pcseg_conv3x3_mma"),
                                     (8, "pcseg_conv3x3_gn_act"),
                                     (128, "pcseg_conv3x3_mma")])
@pytest.mark.parametrize("case", ["act", "accum", "stem", "no-stats"])
def test_conv3x3_launches_the_kernel_its_route_names(monkeypatch, w, entry,
                                                     case):
    """conv3x3_gn_act_cuda launches conv3d_dgrad.cu's implicit GEMM exactly
    where ``_conv_route`` takes the shape (W 16, and W 128 in column
    tiles), else conv3d_block.cu's direct kernel (W 8), in every variant,
    and counts the launch under its keys."""
    calls = []
    monkeypatch.setattr(tcb, "load_library",
                        lambda name=None: _FakeLibrary(calls))
    monkeypatch.setattr(tcb, "stream_of", lambda t: 0)
    monkeypatch.setattr(tcb, "_ring_grid", lambda *a: 1)
    c = 16
    x = torch.zeros(2, 4, 16, w, c, dtype=torch.bfloat16)
    wt = torch.zeros(3, 3, 3, c, c)
    vec = torch.ones(2, c)
    accum = torch.zeros_like(x) if case == "accum" else None
    before = dict(tcb.LAUNCHES)
    y, stats = tcb.conv3x3_gn_act_cuda(
        x, wt, torch.zeros(c), vec, vec, accum, activate=case != "stem",
        want_stats=case != "no-stats")
    assert calls == [entry]
    assert y.shape == x.shape and (stats is None) == (case == "no-stats")
    mma = int(entry.endswith("_mma"))
    assert tcb.LAUNCHES["conv3x3_gn_act"] == before["conv3x3_gn_act"] + 1
    assert tcb.LAUNCHES["conv3x3_mma"] == before["conv3x3_mma"] + mma


def test_bench_forward_takes_the_tensor_core_routes(monkeypatch):
    """Every 3^3 launch of one forward of the bench configuration (64^3,
    w16, 3 levels, bf16: the stem on its input zero-padded to w0, the
    decoder's y1 half at Cin = Cout = wi) takes ``_conv_route``, and both
    up blocks take ``_mma_route``: 13 and 2 shapes, with the blocks'
    outputs stood in by zeros of their shapes."""
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

    seen = {"conv": [], "up": []}

    def conv(x, w, bias, scale, shift, accum=None, *, activate=True,
             want_stats=True, need_dx=True, plain=False):
        seen["conv"].append(tcb._conv_route(x.shape[-1], w.shape[-1],
                                            x.shape, x, accum))
        y = torch.zeros(x.shape[:4] + (w.shape[-1],), dtype=torch.bfloat16)
        st = torch.ones(x.shape[0], 2, w.shape[-1])
        return y, st if want_stats else None

    def resample(up):
        def run(x, w, bias, scale, shift, *, plain=False):
            c = w.shape[-1]
            if up:
                seen["up"].append(tcb._mma_route(c, x.shape[-1], x))
            f = 2 if up else 0.5
            shape = tuple(int(n * f) for n in x.shape[1:4])
            return (torch.zeros(x.shape[:1] + shape + (c,),
                                dtype=torch.bfloat16),
                    torch.ones(x.shape[0], 2, c))
        return run

    monkeypatch.setattr(tcb, "conv3x3_gn_act", conv)
    monkeypatch.setattr(tcb, "down2x_gn_act", resample(False))
    monkeypatch.setattr(tcb, "up2x_gn_act", resample(True))
    model = VoxelUNet3d(num_classes=4, grid_size=64, width=16, levels=3,
                        compute_dtype="bfloat16", conv_impl="fused",
                        voxelize_impl="scatter", devox_impl="gather",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    points = torch.from_numpy(rng.uniform(-1, 1, size=(1, 64, 4)).astype(
        np.float32))
    with torch.no_grad():
        model(points, torch.ones(1, 64, dtype=torch.bool))
    assert seen == {"conv": [True] * 13, "up": [True] * 2}
