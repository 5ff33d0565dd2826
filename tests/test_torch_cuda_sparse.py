"""The sparse family's kernels against their plain versions, on the card:
``block_conv`` with its dgrad and wgrad (ops/block_conv.py),
``bias_ln_relu_mask`` with its backward (ops/fused_ln.py) and
``rowcol_scatter`` (ops/block_sparse.py), at the training shapes of the
sparse bench configuration and at the shapes the kernels took only after
their repair (LN at 24 and 256 channels, the conv at Cout 8 and 24, t =
16, Cin 2); and the block-sparse model's launches per forward and per
train step, with one whole step against the plain versions.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sparse.py

Tolerances: both versions sum in f32 and round once, in another order, so
a bf16 output may land on the neighbouring bf16 value, |d| <= 2^-7 |ref|
+ 1e-4 max|ref|; f32 outputs within 1e-5 of max|ref|. Long f32 sums (the
wgrad over ~10^5 voxels, the LN column sums over the rows, the scatter's
cells) are held to 1e-5 of the sum of their terms' magnitudes, plus 2^-8
|ref| where they are rounded to bf16. Padding tiles and inactive rows are
exactly zero.
"""

import pytest
import torch

from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.ops import block_conv as bc
from pcseg_tpu_torch.ops import block_sparse as bsp
from pcseg_tpu_torch.ops import fused_ln as fl
from pcseg_tpu_torch.ops import voxel as vx
from pcseg_tpu_torch.ops.block_sparse import (
    block_sparse_voxelize,
    neighbor_slots,
)
from pcseg_tpu_torch.ops.losses import cross_entropy_sums

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, dtype):
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).all())
    else:
        ok = float(err.max()) <= 1e-5 * float(r.abs().max())
    assert ok, float(err.max())


def _tiles(b, m, r, t, cap):
    pts = torch.from_numpy(track_events(b, m, 0)).cuda()
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    bs, _, _ = block_sparse_voxelize(pts, mask, r, cap, t, plain=True)
    return bs


@pytest.mark.parametrize("dtype,r,t,cap,cin,cout", [
    (torch.bfloat16, 64, 8, 64, 2, 64),
    (torch.bfloat16, 64, 8, 64, 64, 64),
    (torch.bfloat16, 32, 8, 32, 128, 128),
    (torch.bfloat16, 64, 8, 16, 64, 16),      # a capacity that drops tiles
    (torch.bfloat16, 64, 8, 64, 24, 32),      # a partial channel pass
    (torch.bfloat16, 64, 8, 64, 12, 32),      # channels not a multiple of 8
    (torch.float32, 64, 8, 64, 16, 16),
    (torch.float32, 16, 4, 48, 2, 32),
    (torch.bfloat16, 16, 4, 48, 8, 16),
    (torch.bfloat16, 64, 8, 64, 16, 8),       # repaired: Cout 8
    (torch.bfloat16, 64, 8, 64, 64, 24),      # repaired: Cout 24
    (torch.float32, 64, 8, 64, 24, 4),        # repaired: Cout 4
    (torch.bfloat16, 64, 16, 16, 2, 16),      # repaired: t = 16, Cin 2
    (torch.bfloat16, 64, 16, 16, 16, 32),     # repaired: t = 16
    (torch.float32, 32, 16, 8, 8, 24),        # repaired: t = 16, Cout 24
])
def test_block_conv_kernel(gen, dtype, r, t, cap, cin, cout):
    bs = _tiles(2, 4096, r, t, cap)
    b, nt = bs.tile_mask.shape
    slots = neighbor_slots(bs)
    x = torch.randn((b, nt, t ** 3, cin), generator=gen, device="cuda")
    x = torch.where(bs.tile_mask[..., None, None], x, 0.0).to(dtype)
    w2 = (torch.rand((27 * cin, cout), generator=gen, device="cuda") - 0.5)
    before = bc.LAUNCHES["block_conv"]
    got = bc.block_conv(x, slots, w2)
    torch.cuda.synchronize()
    assert bc.LAUNCHES["block_conv"] == before + 1
    assert got.dtype == dtype and got.shape == (b, nt, t ** 3, cout)
    _close(got, bc.block_conv_plain(x, slots, w2), dtype)
    assert not got[~bs.tile_mask].any()


@pytest.mark.parametrize("n,c,in_dt,out_dt", [
    (1000, 64, torch.bfloat16, torch.bfloat16),
    (777, 128, torch.bfloat16, torch.bfloat16),
    (513, 16, torch.float32, torch.float32),
    (300, 48, torch.bfloat16, torch.float32),
    (65, 8, torch.float32, torch.bfloat16),
    (1000, 256, torch.bfloat16, torch.bfloat16),   # repaired: C > 128
    (1000, 24, torch.bfloat16, torch.bfloat16),
    (300, 520, torch.float32, torch.float32),      # chunked rows
])
def test_bias_ln_relu_mask_kernel(gen, n, c, in_dt, out_dt):
    x = (torch.randn((n, c), generator=gen, device="cuda") * 3 + 1).to(in_dt)
    pre = torch.randn((c,), generator=gen, device="cuda")
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    active = torch.rand((n,), generator=gen, device="cuda") < 0.7
    before = fl.LAUNCHES["bias_ln_relu_mask"]
    got = fl.bias_ln_relu_mask(x, pre, scale, bias, active, 1e-5, out_dt)
    torch.cuda.synchronize()
    assert fl.LAUNCHES["bias_ln_relu_mask"] == before + 1
    ref = fl.bias_ln_relu_mask_plain(x, pre, scale, bias, active, 1e-5,
                                     out_dt)
    assert got.dtype == out_dt
    _close(got, ref, out_dt)
    assert not got[~active].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sparse_model_launches_and_matches_plain(gen, dtype):
    """Two levels, depth 2: a forward launches block_conv 4 times,
    bias_ln_relu_mask 6 times (4 blocks, down, up) and the voxelizer once
    in bf16 (an f32 model sums the f32 features without it); the logits
    agree with the plain versions'."""
    model = SparseVoxelNet(4, grid_size=32, width=16, depth=2, levels=2,
                           tile=8, max_tiles=64, compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(0)).cuda()
    pts = torch.from_numpy(track_events(3, 2048, 1)).cuda()
    mask = torch.rand((3, 2048), generator=gen, device="cuda") < 0.9
    bc.reset_launches()
    fl.reset_launches()
    vx.reset_launches()
    out, dropped = model(pts, mask, return_overflow=True)
    torch.cuda.synchronize()
    # level 1's two convs (32 outputs) take the tensor cores in bf16
    mma = 2 if dtype == "bfloat16" else 0
    assert bc.LAUNCHES == {"block_conv": 4, "block_conv_dgrad": 0,
                           "block_conv_wgrad": 0, "block_conv_mma": mma,
                           "block_conv_dgrad_mma": 0,
                           "block_conv_wgrad_mma": 0}
    assert fl.LAUNCHES == {"bias_ln_relu_mask": 6,
                           "bias_ln_relu_mask_bwd": 0,
                           "bias_ln_relu_mask_bwd_vec": 0}
    assert vx.LAUNCHES["voxelize_contract"] == int(dtype == "bfloat16")
    assert not dropped.any()
    ref = model(pts, mask, plain=True)
    assert bool(torch.isfinite(out).all()) and not out[~mask].any()
    assert float((out - ref).abs().max()) <= 4 * 2.0 ** -8 * float(
        ref.abs().max())


def _sum_close(got, ref, abs_sum, bf16=False):
    """f32 sums of the same terms in another order: within 1e-5 of the
    sum of the terms' magnitudes (+ a bf16 rounding where rounded)."""
    g, r = got.float(), ref.float()
    tol = 1e-5 * abs_sum.float() + (2.0 ** -8 * r.abs() if bf16 else 0.0)
    err = (g - r).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("n,c,x_dt,g_dt", [
    (262144, 64, torch.bfloat16, torch.bfloat16),   # the sparse level 0
    (5000, 64, torch.bfloat16, torch.bfloat16),
    (3001, 128, torch.bfloat16, torch.bfloat16),
    (2000, 256, torch.bfloat16, torch.bfloat16),    # repaired: C > 128
    (1000, 24, torch.bfloat16, torch.bfloat16),     # repaired: C 24
    (777, 16, torch.float32, torch.float32),
    (300, 520, torch.float32, torch.bfloat16),      # chunked rows
    (9, 40, torch.float32, torch.float32),          # fewer rows than warps
])
def test_bias_ln_relu_mask_bwd_kernel(gen, n, c, x_dt, g_dt):
    x = (torch.randn((n, c), generator=gen, device="cuda") * 3 + 1).to(x_dt)
    pre = torch.randn((c,), generator=gen, device="cuda")
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    active = torch.rand((n,), generator=gen, device="cuda") < 0.7
    g = torch.randn((n, c), generator=gen, device="cuda").to(g_dt)
    args = (x, pre, scale, bias, active, g, 1e-5)
    before = dict(fl.LAUNCHES)
    got = fl.bias_ln_relu_mask_bwd(*args)
    torch.cuda.synchronize()
    assert fl.LAUNCHES["bias_ln_relu_mask_bwd"] == \
        before["bias_ln_relu_mask_bwd"] + 1
    # the vector route: C a multiple of 8 up to 256 (aligned tensors)
    vec = int(c % 8 == 0 and c <= 256)
    assert fl.LAUNCHES["bias_ln_relu_mask_bwd_vec"] == \
        before["bias_ln_relu_mask_bwd_vec"] + vec
    # fixed-order sums: a second call gives the same bits
    again = fl.bias_ln_relu_mask_bwd(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = fl.bias_ln_relu_mask_bwd_plain(*args)
    assert got[0].dtype == x_dt
    _close(got[0], ref[0], x_dt)
    assert not got[0][~active].any()
    # the column sums' term magnitudes, from the plain version's terms
    xf = x.float() + pre
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + 1e-5)
    xh = (xf - mean) * rstd
    keep = active[:, None] & (xh * scale + bias > 0)
    dz = torch.where(keep, g.float(), 0.0)
    mags = [ref[0].float().abs().sum(0), (dz * xh).abs().sum(0),
            dz.abs().sum(0)]
    for k in range(1, 4):
        _sum_close(got[k], ref[k], mags[k - 1])


def _conv_operands(gen, bs, t, cin, cout, dtype):
    b, nt = bs.tile_mask.shape
    x = torch.randn((b, nt, t ** 3, cin), generator=gen, device="cuda")
    x = torch.where(bs.tile_mask[..., None, None], x, 0.0).to(dtype)
    gy = torch.randn((b, nt, t ** 3, cout), generator=gen,
                     device="cuda").to(dtype)
    w2 = (torch.rand((27 * cin, cout), generator=gen, device="cuda")
          - 0.5).to(dtype)
    return x, gy, w2


@pytest.mark.parametrize("dtype,r,t,cap,cin,cout", [
    (torch.bfloat16, 64, 8, 64, 64, 64),      # level 0
    (torch.bfloat16, 32, 8, 32, 128, 128),    # level 1
    (torch.bfloat16, 64, 8, 16, 64, 64),      # a capacity that drops tiles
    (torch.bfloat16, 64, 8, 64, 24, 8),       # repaired: dgrad Cout 24
    (torch.float32, 64, 8, 64, 16, 16),
    (torch.bfloat16, 64, 16, 16, 16, 32),     # repaired: t = 16
])
def test_block_conv_dgrad_kernel(gen, dtype, r, t, cap, cin, cout):
    bs = _tiles(2, 4096, r, t, cap)
    slots = neighbor_slots(bs)
    _, gy, w2 = _conv_operands(gen, bs, t, cin, cout, dtype)
    before = bc.LAUNCHES["block_conv_dgrad"]
    got = bc.block_conv_dgrad(gy, slots, w2)
    torch.cuda.synchronize()
    assert bc.LAUNCHES["block_conv_dgrad"] == before + 1
    assert got.dtype == dtype and got.shape == gy.shape[:3] + (cin,)
    _close(got, bc.block_conv_dgrad_plain(gy, slots, w2), dtype)
    assert not got[~bs.tile_mask].any()


@pytest.mark.parametrize("dtype,r,t,cap,cin,cout", [
    (torch.bfloat16, 64, 8, 64, 2, 64),       # the stem
    (torch.bfloat16, 64, 8, 64, 64, 64),      # level 0
    (torch.bfloat16, 32, 8, 32, 128, 128),    # level 1
    (torch.bfloat16, 64, 8, 16, 64, 64),      # a capacity that drops tiles
    (torch.bfloat16, 64, 8, 64, 24, 8),       # repaired: Cout 8
    (torch.bfloat16, 64, 8, 64, 64, 24),      # repaired: Cout 24
    (torch.float32, 64, 8, 64, 16, 16),
    (torch.bfloat16, 64, 16, 16, 2, 16),      # repaired: t = 16, Cin 2
    (torch.float32, 32, 16, 8, 8, 24),        # repaired: t = 16, Cout 24
])
def test_block_conv_wgrad_kernel(gen, dtype, r, t, cap, cin, cout):
    bs = _tiles(2, 4096, r, t, cap)
    slots = neighbor_slots(bs)
    x, gy, _ = _conv_operands(gen, bs, t, cin, cout, dtype)
    # the cotangent of padding rows must add nothing
    gy[~bs.tile_mask] = 1.0
    before = bc.LAUNCHES["block_conv_wgrad"]
    got = bc.block_conv_wgrad(x, slots, gy)
    torch.cuda.synchronize()
    assert bc.LAUNCHES["block_conv_wgrad"] == before + 1
    assert got.dtype == dtype and got.shape == (27 * cin, cout)
    ref = bc.block_conv_wgrad_plain(x, slots, gy, torch.float32)
    mag = bc.block_conv_wgrad_plain(x.abs(), slots, gy.abs(), torch.float32)
    _sum_close(got, ref, mag, bf16=dtype == torch.bfloat16)
    if dtype == torch.float32:
        got32 = bc.block_conv_wgrad(x, slots, gy, torch.float32)
        _sum_close(got32, ref, mag)


# (B, M, NT, T^3, C, layout): random cells with a crowded slot; runs of
# 37 consecutive points in one cell (runs that cross warp boundaries, as
# consecutive track points share cells); the first 256 points of every
# event (a whole block) in one cell
ROWCOL_CASES = [(8, 8192, 64, 512, 4, "random"), (3, 1000, 5, 64, 3, "random")]
ROWCOL_CASES += [(3, 1000, 5, 64, c, layout) for layout in ("runs", "block")
                 for c in (1, 3, 4, 8)]


@pytest.mark.parametrize("b,m,nt,t3,c,layout", ROWCOL_CASES)
def test_rowcol_scatter_kernel(gen, b, m, nt, t3, c, layout):
    rows = torch.randint(0, nt + 1, (b, m), generator=gen, device="cuda")
    cols = torch.randint(0, t3, (b, m), generator=gen, device="cuda")
    rows[0, : m // 4] = 3                   # a crowded slot
    if layout == "runs":
        run = torch.arange(b * m, device="cuda").reshape(b, m) // 37
        rows, cols = run % (nt + 1), run * 7 % t3
    elif layout == "block":
        rows[:, :256], cols[:, :256] = 2, 5
    vals = torch.randn((b, m, c), generator=gen, device="cuda")
    vals[:, -10:] = 0.0                      # masked points' cotangents
    before = bsp.LAUNCHES["rowcol_scatter"]
    got = bsp.rowcol_scatter(rows, cols, vals, nt, t3)
    torch.cuda.synchronize()
    assert bsp.LAUNCHES["rowcol_scatter"] == before + 1
    ref = bsp.rowcol_scatter_plain(rows, cols, vals, nt, t3)
    mag = bsp.rowcol_scatter_plain(rows, cols, vals.abs(), nt, t3)
    assert got.shape == (b, nt, t3 * c)
    _sum_close(got, ref, mag)


def test_sparse_train_step_launches_and_matches_plain(gen):
    """Two levels, depth 2, bf16: one train step's forward and backward
    launch block_conv 4 / dgrad 3 (none for the stem) / wgrad 4, level
    1's two of each (32 channels) on the tensor-core routes,
    bias_ln_relu_mask 6 + 6, rowcol_scatter 1 and the voxelizer 1; the
    loss agrees with the plain versions' to 1e-3 relative and each
    gradient to 5 % of its norm (bf16 chain, one rounding moved
    propagates)."""
    model = SparseVoxelNet(4, grid_size=32, width=16, depth=2, levels=2,
                           tile=8, max_tiles=64, compute_dtype="bfloat16",
                           generator=torch.Generator().manual_seed(0)).cuda()
    pts = torch.from_numpy(track_events(3, 2048, 1)).cuda()
    mask = torch.rand((3, 2048), generator=gen, device="cuda") < 0.9
    labels = torch.randint(0, 4, (3, 2048), generator=gen, device="cuda")
    cw = torch.ones(4, device="cuda")

    def step(plain):
        model.zero_grad(set_to_none=True)
        logits, aux = model.apply(pts, train=True, mask=mask, plain=plain)
        num, den = cross_entropy_sums(logits, labels, cw)
        loss = num / den
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}

    for m in (bc, fl, vx, bsp):
        m.reset_launches()
    lk, gk = step(False)
    torch.cuda.synchronize()
    assert bc.LAUNCHES == {"block_conv": 4, "block_conv_dgrad": 3,
                           "block_conv_wgrad": 4, "block_conv_mma": 2,
                           "block_conv_dgrad_mma": 2,
                           "block_conv_wgrad_mma": 2}
    # widths 16 and 32: every LN backward on the vector route
    assert fl.LAUNCHES == {"bias_ln_relu_mask": 6,
                           "bias_ln_relu_mask_bwd": 6,
                           "bias_ln_relu_mask_bwd_vec": 6}
    assert bsp.LAUNCHES == {"rowcol_scatter": 1}
    assert vx.LAUNCHES["voxelize_contract"] == 1
    lp, gp = step(True)
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    for n in gp:
        assert bool(torch.isfinite(gk[n]).all()), n
        rel = float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
        assert rel <= 0.05, (n, rel)


# (kind, dtype, r, t, cap, cin, cout, tensor cores): the tensor-core
# routes of csrc/block_conv.cu (block_route: bf16, t = 8, an output width
# that is a multiple of 32, up to 128 for the forward and the dgrad, whose
# input width must also be a multiple of 8) at the sparse U-Net's stem,
# level 0 and level 1 and at a partial K chunk (48 = 32 + 16) and 96
# outputs, with padding tiles present; and shapes off them
ROUTE_CASES = [
    ("fwd", torch.bfloat16, 64, 8, 64, 2, 64, True),
    ("fwd", torch.bfloat16, 64, 8, 64, 64, 64, True),
    ("fwd", torch.bfloat16, 32, 8, 32, 128, 128, True),
    ("fwd", torch.bfloat16, 64, 8, 64, 48, 96, True),
    ("fwd", torch.bfloat16, 64, 8, 64, 20, 32, True),    # Cin % 8 != 0
    ("dgrad", torch.bfloat16, 64, 8, 64, 64, 64, True),
    ("dgrad", torch.bfloat16, 32, 8, 32, 128, 128, True),
    ("dgrad", torch.bfloat16, 64, 8, 64, 96, 48, True),
    ("wgrad", torch.bfloat16, 64, 8, 64, 2, 64, True),
    ("wgrad", torch.bfloat16, 64, 8, 64, 64, 64, True),
    ("wgrad", torch.bfloat16, 32, 8, 32, 128, 128, True),
    ("wgrad", torch.bfloat16, 64, 8, 64, 48, 96, True),
    ("fwd", torch.bfloat16, 64, 8, 64, 64, 256, False),  # Cout > 128
    ("fwd", torch.bfloat16, 64, 8, 64, 64, 16, False),
    ("dgrad", torch.bfloat16, 64, 8, 64, 48, 96, False),  # 48 outputs
    ("wgrad", torch.bfloat16, 64, 8, 64, 64, 16, False),
    ("fwd", torch.float32, 64, 8, 64, 64, 64, False),
    ("wgrad", torch.bfloat16, 64, 16, 16, 16, 32, False),  # t = 16
]


@pytest.mark.parametrize("kind,dtype,r,t,cap,cin,cout,mma", ROUTE_CASES)
def test_block_conv_routes(gen, kind, dtype, r, t, cap, cin, cout, mma):
    """Each launch takes the route the rule names (its "_mma" count moves
    or not), matches its plain version, writes zeros on padding tiles,
    and two calls give the same bits."""
    bs = _tiles(2, 4096, r, t, cap)
    assert not bs.tile_mask.all()           # padding tiles present
    slots = neighbor_slots(bs)
    x, gy, w2 = _conv_operands(gen, bs, t, cin, cout, dtype)
    name = {"fwd": "block_conv", "dgrad": "block_conv_dgrad",
            "wgrad": "block_conv_wgrad"}[kind]
    run = {"fwd": lambda: bc.block_conv_fwd(x, slots, w2),
           "dgrad": lambda: bc.block_conv_dgrad(gy, slots, w2),
           "wgrad": lambda: bc.block_conv_wgrad(x, slots, gy)}[kind]
    before = dict(bc.LAUNCHES)
    got = run()
    torch.cuda.synchronize()
    assert bc.LAUNCHES[name] == before[name] + 1
    assert bc.LAUNCHES[f"{name}_mma"] == before[f"{name}_mma"] + int(mma)
    assert torch.equal(got, run())
    if kind == "wgrad":
        ref = bc.block_conv_wgrad_plain(x, slots, gy, torch.float32)
        mag = bc.block_conv_wgrad_plain(x.abs(), slots, gy.abs(),
                                        torch.float32)
        _sum_close(got, ref, mag, bf16=dtype == torch.bfloat16)
        return
    ref = (bc.block_conv_plain(x, slots, w2) if kind == "fwd"
           else bc.block_conv_dgrad_plain(gy, slots, w2))
    _close(got, ref, dtype)
    assert not got[~bs.tile_mask].any()
