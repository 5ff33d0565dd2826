"""The voxel U-Net's backward kernels against their plain versions, on the
card, and one whole train step through them.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_voxel_train.py

Tolerances as in chip_smoke.py: the same rounding points, f32 sums in
another order (and with atomics), so a bf16 output may round to the
neighbouring value, |d| <= 2^-7 |ref| + 1e-4 max|ref|, and an f32 sum
agrees to 1e-3 of its largest value.
"""

import pytest
import torch

from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops import conv3d_block as cb
from pcseg_tpu_torch.ops import voxel as vx

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _inputs(gen, b, r, cin, cout, k):
    x = _rand(gen, b, r, r, r, cin).to(torch.bfloat16)
    w = (torch.rand((k, k, k, cin, cout), generator=gen, device="cuda")
         - 0.5) * (6.0 / (k ** 3 * cin)) ** 0.5
    bias = _rand(gen, cout, scale=0.1)
    scale = torch.rand((b, cin), generator=gen, device="cuda") + 0.5
    shift = _rand(gen, b, cin, scale=0.3)
    return x, w, bias, scale, shift


def _cotangents(gen, shape):
    gy = _rand(gen, *shape).to(torch.bfloat16)
    gstats = torch.stack([_rand(gen, shape[0], shape[-1], scale=1e-2),
                          _rand(gen, shape[0], shape[-1], scale=1e-3)], 1)
    return gy, gstats


def _bf16_close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= 2.0 ** -7 * r.abs()
                 + 1e-4 * r.abs().max()).all()), float((g - r).abs().max())


def _sum_close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()) + 1e-12, err


@pytest.mark.parametrize("case", ["act", "act+accum", "stem", "no-stats"])
@pytest.mark.parametrize("r,c", [(16, 16), (8, 32), (8, 64), (128, 16),
                                 (64, 64)])
def test_conv3x3_dgrad_wgrad_kernels(gen, case, r, c):
    """Rows 2 and 3 against their plain versions in each variant, B2; B1
    at the column-tiled shapes (128^3 x 16, the 128^3 step's level 0, and
    64^3 x 64), where both take the ring in column tiles; W 8 keeps
    conv3d_block.cu's direct kernels."""
    x, w, bias, scale, shift = _inputs(gen, 1 if r >= 64 else 2, r, c, c, 3)
    activate = case != "stem"
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift,
                                  activate=activate)
    gy, gstats = _cotangents(gen, y.shape)
    if case == "no-stats":
        y = gstats = None
    want_gadj = case == "act+accum"
    before = dict(cb.LAUNCHES)
    dk = cb.conv3x3_dgrad_cuda(gy, y, gstats, x, w, scale, shift, activate,
                               want_gadj)
    wk = cb.conv3x3_wgrad_cuda(x, scale, shift, gy, y, gstats, activate)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_dgrad"] == before["conv3x3_dgrad"] + 1
    assert cb.LAUNCHES["conv3x3_wgrad"] == before["conv3x3_wgrad"] + 1
    ring = int(r >= 16)
    assert (cb.LAUNCHES["conv3x3_dgrad_mma"]
            == before["conv3x3_dgrad_mma"] + ring)
    assert (cb.LAUNCHES["conv3x3_wgrad_mma"]
            == before["conv3x3_wgrad_mma"] + ring)
    dp = cb.conv3x3_dgrad_plain(gy, y, gstats, x, w, scale, shift, activate,
                                want_gadj)
    wp = cb.conv3x3_wgrad_plain(x, scale, shift, gy, y, gstats, activate)
    _bf16_close(dk[0], dp[0])
    if activate:
        _sum_close(dk[1], dp[1])
    else:
        assert dk[1] is None
    if want_gadj:
        assert torch.equal(dk[2], dp[2])
    _sum_close(wk[0], wp[0])
    _sum_close(wk[1], wp[1])


@pytest.mark.parametrize("kind,r,cin,cout", [("down", 16, 16, 32),
                                              ("down", 8, 32, 64),
                                              ("up", 4, 64, 32),
                                              ("up", 8, 32, 16)])
def test_resample_bwd_kernels(gen, kind, r, cin, cout):
    x, w, bias, scale, shift = _inputs(gen, 2, r, cin, cout, 2)
    fwd = cb.down2x_gn_act_cuda if kind == "down" else cb.up2x_gn_act_cuda
    y, _ = fwd(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    key = f"{kind}2x_bwd"
    before = cb.LAUNCHES[key]
    got = getattr(cb, f"{key}_cuda")(x, w, scale, shift, gy, y, gstats)
    torch.cuda.synchronize()
    assert cb.LAUNCHES[key] == before + 1
    ref = getattr(cb, f"{key}_plain")(x, w, scale, shift, gy, y, gstats)
    _bf16_close(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        _sum_close(a, b)


@pytest.mark.parametrize("b,dhw,c,stats", [
    (2, (4, 4, 4), 8, True), (2, (8, 8, 8), 16, True),
    (2, (4, 4, 8), 32, True), (2, (4, 4, 4), 64, True),
    (2, (8, 8, 8), 16, False), (1, (3, 5, 12), 16, True)])
def test_up2x_bwd_mma_kernel(gen, b, dhw, c, stats):
    """csrc/resample.cu's one-sweep up2x backward at every fine width it
    takes (C 64 in four 32-column slices; without the stats cotangent; B1
    3 x 5 x 12: 180 coarse voxels, a ragged last tile), against the plain
    version, and bit for bit the same in a second call."""
    x = _rand(gen, b, *dhw, 2 * c).to(torch.bfloat16)
    _, w, bias, scale, shift = _inputs(gen, b, 2, 2 * c, c, 2)
    y, _ = cb.up2x_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    if not stats:
        y = gstats = None
    before = dict(cb.LAUNCHES)
    got = cb.up2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    again = cb.up2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["up2x_bwd_mma"] == before["up2x_bwd_mma"] + 2
    assert cb.LAUNCHES["up2x_bwd"] == before["up2x_bwd"] + 2
    ref = cb.up2x_bwd_plain(x, w, scale, shift, gy, y, gstats)
    _bf16_close(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        _sum_close(a, r)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_up2x_bwd_other_widths_take_the_cuda_core_kernels(gen):
    """2C != C2 (here 24 coarse channels over 16 fine ones) keeps
    conv3d_block.cu's dgrad and wgrad kernels, a route declared by
    shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, 4, 24, 16, 2)
    y, _ = cb.up2x_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    before = dict(cb.LAUNCHES)
    got = cb.up2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["up2x_bwd_mma"] == before["up2x_bwd_mma"]
    assert cb.LAUNCHES["up2x_bwd"] == before["up2x_bwd"] + 1
    ref = cb.up2x_bwd_plain(x, w, scale, shift, gy, y, gstats)
    _bf16_close(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        _sum_close(a, r)


def _same_bits(got, again):
    return all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again))


# (B, grid, C, variant): row 2's shapes on the B8 x 8192 voxel step's path
# (the five variants' three kinds at 64^3 x 16 and 32^3 x 32, "act" at
# 16^3 x 64), C 8 (m16n8k8), the stem's variant without the activation,
# non-cubic grids (planes in ranges of unequal length; the other W of
# each width: 64 channels at W 32, 8 at W 64, 16 at W 32), and the
# column-tiled widths: the 128^3 step's level 0, the 256^3 step's three
# levels (W 256 at 16 channels, 128 at 32, 64 at 64) and three tiles a row
# (W 192 at 8 channels)
DGRAD_CASES = [
    (8, (64, 64, 64), 16, "act"), (8, (64, 64, 64), 16, "accum"),
    (8, (64, 64, 64), 16, "no-stats"), (8, (32, 32, 32), 32, "act"),
    (8, (32, 32, 32), 32, "accum"), (8, (32, 32, 32), 32, "no-stats"),
    (8, (16, 16, 16), 64, "act"), (2, (8, 16, 16), 8, "act"),
    (2, (16, 16, 16), 16, "stem"), (1, (7, 8, 32), 32, "accum"),
    (2, (6, 8, 32), 64, "accum"), (2, (5, 8, 64), 8, "no-stats"),
    (2, (9, 16, 32), 16, "act"),
    (1, (128, 128, 128), 16, "act"), (1, (128, 128, 128), 16, "accum"),
    (1, (4, 256, 256), 16, "no-stats"), (1, (8, 128, 128), 32, "act"),
    (1, (64, 64, 64), 64, "act"), (1, (6, 64, 64), 64, "accum"),
    (1, (4, 16, 192), 8, "stem"),
]


@pytest.mark.parametrize("b,dhw,c,case", DGRAD_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_conv3x3_dgrad_mma_kernel(gen, b, dhw, c, case):
    """csrc/conv3d_dgrad.cu's implicit GEMM against the plain version, and
    bit for bit the same in a second call (dx, dstats, g')."""
    x = _rand(gen, b, *dhw, c).to(torch.bfloat16)
    _, w, bias, scale, shift = _inputs(gen, b, 2, c, c, 3)
    activate = case != "stem"
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift,
                                  activate=activate)
    gy, gstats = _cotangents(gen, y.shape)
    if case == "no-stats":
        y = gstats = None
    want_gadj = case == "accum"
    args = (gy, y, gstats, x, w, scale, shift, activate, want_gadj)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_dgrad_cuda(*args)
    again = cb.conv3x3_dgrad_cuda(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_dgrad_mma"] == before["conv3x3_dgrad_mma"] + 2
    assert cb.LAUNCHES["conv3x3_dgrad"] == before["conv3x3_dgrad"] + 2
    ref = cb.conv3x3_dgrad_plain(*args)
    _bf16_close(got[0], ref[0])
    if activate:
        _sum_close(got[1], ref[1])
    else:
        assert got[1] is None
    if want_gadj:
        assert torch.equal(got[2], ref[2])
    assert _same_bits(got, again)


def test_conv3x3_dgrad_other_widths_take_the_direct_kernel(gen):
    """W = 8 (here 8^3 x 32, the 8^3 level of a 16^3 model) keeps
    conv3d_block.cu's conv_kernel, a route declared by shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, 8, 32, 32, 3)
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    args = (gy, y, gstats, x, w, scale, shift, True, True)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_dgrad_cuda(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_dgrad_mma"] == before["conv3x3_dgrad_mma"]
    assert cb.LAUNCHES["conv3x3_dgrad"] == before["conv3x3_dgrad"] + 1
    ref = cb.conv3x3_dgrad_plain(*args)
    _bf16_close(got[0], ref[0])
    _sum_close(got[1], ref[1])
    assert torch.equal(got[2], ref[2])


# (B, grid, C, variant): row 3's shapes on the voxel step's path (its
# four variants at 64^3 x 16, three at 32^3 x 32, "act" at 16^3 x 64), C 8
# (two taps an m16 tile), non-cubic grids (depth ranges of unequal length;
# the other W of each width), a batch of 3 at 64 channels (four tap
# groups), and the column-tiled widths at B1 and a few planes: the 128^3
# step's level 0 (also with accum), the 256^3 step's three levels (W 256 at
# 16 channels, 128 at 32, 64 at 64) and three tiles a row (W 192 at 8)
WGRAD_CASES = [
    (8, (64, 64, 64), 16, "act"), (8, (64, 64, 64), 16, "accum"),
    (8, (64, 64, 64), 16, "no-stats"), (8, (64, 64, 64), 16, "stem"),
    (8, (32, 32, 32), 32, "act"), (8, (32, 32, 32), 32, "accum"),
    (8, (32, 32, 32), 32, "no-stats"), (8, (16, 16, 16), 64, "act"),
    (2, (8, 16, 16), 8, "act"), (2, (5, 8, 64), 8, "stem"),
    (1, (7, 8, 32), 32, "accum"), (2, (6, 8, 32), 64, "no-stats"),
    (2, (9, 16, 32), 16, "act"), (3, (5, 32, 16), 64, "act"),
    (1, (8, 128, 128), 16, "act"), (1, (8, 128, 128), 16, "accum"),
    (1, (4, 256, 256), 16, "act"), (1, (8, 128, 128), 32, "act"),
    (1, (8, 64, 64), 64, "act"), (1, (8, 64, 64), 64, "no-stats"),
    (1, (4, 8, 192), 8, "stem"),
]


@pytest.mark.parametrize("b,dhw,c,case", WGRAD_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_conv3x3_wgrad_mma_kernel(gen, b, dhw, c, case):
    """csrc/conv3d_dgrad.cu's split-K wgrad against the plain version, and
    bit for bit the same in a second call (dW, dbias)."""
    x = _rand(gen, b, *dhw, c).to(torch.bfloat16)
    _, w, bias, scale, shift = _inputs(gen, b, 2, c, c, 3)
    activate = case != "stem"
    accum = (_rand(gen, b, *dhw, c).to(torch.bfloat16) if case == "accum"
             else None)
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift, accum,
                                  activate=activate)
    gy, gstats = _cotangents(gen, y.shape)
    if case == "no-stats":
        y = gstats = None
    args = (x, scale, shift, gy, y, gstats, activate)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_wgrad_cuda(*args)
    again = cb.conv3x3_wgrad_cuda(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_wgrad_mma"] == before["conv3x3_wgrad_mma"] + 2
    assert cb.LAUNCHES["conv3x3_wgrad"] == before["conv3x3_wgrad"] + 2
    ref = cb.conv3x3_wgrad_plain(*args)
    _sum_close(got[0], ref[0])
    _sum_close(got[1], ref[1])
    assert _same_bits(got, again)


def test_conv3x3_wgrad_other_widths_take_the_cuda_core_kernel(gen):
    """W = 8 (here 8^3 x 32) keeps conv3d_block.cu's wgrad_kernel<kConv3>,
    a route declared by shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, 8, 32, 32, 3)
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    args = (x, scale, shift, gy, y, gstats, True)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_wgrad_cuda(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_wgrad_mma"] == before["conv3x3_wgrad_mma"]
    assert cb.LAUNCHES["conv3x3_wgrad"] == before["conv3x3_wgrad"] + 1
    ref = cb.conv3x3_wgrad_plain(*args)
    _sum_close(got[0], ref[0])
    _sum_close(got[1], ref[1])


@pytest.mark.parametrize("b,r,c", [(8, 64, 16), (8, 32, 32), (8, 16, 64),
                                   (1, 128, 16), (1, 256, 16), (1, 128, 32),
                                   (1, 64, 64)])
def test_wgrad_partial_table_stays_within_its_operands(gen, b, r, c):
    """At the voxel steps' shapes (B8 at 64^3, whole rows; B1 at 128^3 and
    256^3, column tiles) the wgrad's partial table (a row of 27 C^2 + C
    floats a (batch element, x block)) is no larger than the x and gy it
    reduces, unless a block already takes all the planes of its tile."""
    gx = cb._ring_grid(2, b, c, r, r, r, torch.cuda.current_device())
    tw = cb.ring_tile_width(c, r)
    tiles = r // (cb._RING_TILE[c] // tw) * (r // tw)
    table = b * gx * (27 * c * c + c) * 4
    assert table <= 2 * b * r ** 3 * c * 2 or gx == tiles, (gx, table)


# (B, fine grid, C, stats): row 5's two shapes on the voxel step's path
# (64^3 x 16 -> 32^3 x 32, 32^3 x 32 -> 16^3 x 64), C 8 and C 64 (four
# column slices), without the stats cotangent, and a ragged last tile
DOWN_CASES = [
    (8, (64, 64, 64), 16, True), (8, (32, 32, 32), 32, True),
    (2, (8, 8, 16), 8, True), (2, (8, 8, 8), 64, True),
    (2, (16, 16, 16), 16, False), (1, (6, 10, 24), 16, True),
]


@pytest.mark.parametrize("b,dhw,c,stats", DOWN_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_down2x_bwd_mma_kernel(gen, b, dhw, c, stats):
    """csrc/resample.cu's one-sweep down2x backward against the plain
    version, and bit for bit the same in a second call."""
    x = _rand(gen, b, *dhw, c).to(torch.bfloat16)
    _, w, bias, scale, shift = _inputs(gen, b, 2, c, 2 * c, 2)
    y, _ = cb.down2x_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    if not stats:
        y = gstats = None
    before = dict(cb.LAUNCHES)
    got = cb.down2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    again = cb.down2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["down2x_bwd_mma"] == before["down2x_bwd_mma"] + 2
    assert cb.LAUNCHES["down2x_bwd"] == before["down2x_bwd"] + 2
    ref = cb.down2x_bwd_plain(x, w, scale, shift, gy, y, gstats)
    _bf16_close(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        _sum_close(a, r)
    assert _same_bits(got, again)


def test_down2x_bwd_other_widths_take_the_cuda_core_kernels(gen):
    """C2 != 2C (here 16 fine channels to 16 coarse ones) keeps
    conv3d_block.cu's dgrad and wgrad kernels, a route declared by
    shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, 8, 16, 16, 2)
    y, _ = cb.down2x_gn_act_cuda(x, w, bias, scale, shift)
    gy, gstats = _cotangents(gen, y.shape)
    before = dict(cb.LAUNCHES)
    got = cb.down2x_bwd_cuda(x, w, scale, shift, gy, y, gstats)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["down2x_bwd_mma"] == before["down2x_bwd_mma"]
    assert cb.LAUNCHES["down2x_bwd"] == before["down2x_bwd"] + 1
    ref = cb.down2x_bwd_plain(x, w, scale, shift, gy, y, gstats)
    _bf16_close(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        _sum_close(a, r)


def _devox_edge_inputs(gen, r, c, m=3000):
    """Three events: event 0 with every point on one spot (one voxel hit
    by all of them), event 1 with coords past both faces (clipped
    duplicate taps), integral coords (frac == 0) and points on the faces,
    event 2 all masked."""
    u = torch.rand((3, m, 3), generator=gen, device="cuda") * (r + 1) - 1
    u[0] = u[0, :1]
    u[1, :50] = u[1, :50].floor()
    u[1, 50:70] = torch.tensor([-0.5, r - 0.5, 0.0], device="cuda")
    u[1, 70:90] = torch.tensor([r - 0.5, -0.5, r - 0.5], device="cuda")
    mask = torch.ones((3, m), dtype=torch.bool, device="cuda")
    mask[1, ::5] = False
    mask[2] = False
    return u, mask


# every instantiated width at every grid size, and two widths that take
# the next instantiation with masked lanes
DEVOX_CASES = [(r, c) for r in (6, 16, 64, 128)
               for c in (1, 3, 4, 7, 16, 32)] + [(16, 12), (16, 20)]


@pytest.mark.parametrize("r,c", DEVOX_CASES)
def test_trilinear_scatter_kernel(gen, r, c):
    """The owner-computes scatter against its plain version, each event
    to 1e-3 of its own largest sum (event 0's one voxel sums 3000
    points), f32 and bf16 out: one launch count an op, two calls bit for
    bit, bf16 the f32 sums rounded once, nothing for masked points."""
    u, mask = _devox_edge_inputs(gen, r, c)
    go = torch.where(mask[..., None], _rand(gen, 3, u.shape[1], c), 0.0)
    before = vx.LAUNCHES["trilinear_scatter"]
    got = vx.trilinear_scatter(u, go, r)
    again = vx.trilinear_scatter(u, go, r)
    half = vx.trilinear_scatter(u, go, r, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["trilinear_scatter"] == before + 3
    assert got.dtype == torch.float32 and half.dtype == torch.bfloat16
    ref = vx.trilinear_scatter_plain(u, go, r)
    for event in range(2):
        _sum_close(got[event], ref[event])
    assert torch.equal(got, again)
    assert torch.equal(half, got.to(torch.bfloat16))
    assert not got[2].any()


@pytest.mark.parametrize("c", [33, 40, 64, 121])
def test_trilinear_scatter_kernel_past_32_channels(gen, c):
    """Above 32 channels (121: the most classes the matmul devoxelize
    takes at 32^3) the tiles go 32 columns at a time: against the plain
    version as below 32, two calls bit for bit, and each column chunk's
    bits those of the same channels scattered as a 32-channel input (the
    same plan: each channel's sums keep their order); a row of one chunk
    past a block's shared memory,
    or another output dtype, refused before any launch."""
    r = 16
    u, mask = _devox_edge_inputs(gen, r, c)
    go = torch.where(mask[..., None], _rand(gen, 3, u.shape[1], c), 0.0)
    before = vx.LAUNCHES["trilinear_scatter"]
    got = vx.trilinear_scatter(u, go, r)
    half = vx.trilinear_scatter(u, go, r, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["trilinear_scatter"] == before + 2
    ref = vx.trilinear_scatter_plain(u, go, r)
    for event in range(2):
        _sum_close(got[event], ref[event])
    assert torch.equal(got, vx.trilinear_scatter(u, go, r))
    assert torch.equal(half, got.to(torch.bfloat16))
    assert not got[2].any()
    for k0 in range(0, c, 32):
        # a 32-channel input has the same plan (tiles, lists, orders)
        part = torch.zeros_like(go[..., :32])
        part[..., :min(32, c - k0)] = go[..., k0:k0 + 32]
        assert torch.equal(got[..., k0:k0 + 32],
                           vx.trilinear_scatter(u, part, r)[..., :c - k0])
    before = vx.LAUNCHES["trilinear_scatter"]
    with pytest.raises(ValueError, match="shared memory"):
        vx.trilinear_scatter(u[:, :64] * 100, go[:, :64], 2000)
    with pytest.raises(ValueError, match="f32 or bf16"):
        vx.trilinear_scatter(u, go, r, out_dtype=torch.float16)
    assert vx.LAUNCHES["trilinear_scatter"] == before


def test_train_step_through_the_kernels(gen):
    """Full depth (3 levels) at grid 16: one forward + backward launches
    every kernel as often as the JAX structure does, and its gradients
    point where the plain versions' do."""
    model = VoxelUNet3d(4, grid_size=16, width=16, levels=3,
                        compute_dtype="bfloat16", conv_impl="fused",
                        voxelize_impl="scatter", devox_impl="gather",
                        generator=torch.Generator().manual_seed(0)).cuda()
    pts = torch.cat([_rand(gen, 2, 1024, 3, scale=5.0),
                     torch.rand((2, 1024, 1), generator=gen,
                                device="cuda")], -1)
    mask = torch.rand((2, 1024), generator=gen, device="cuda") < 0.9
    target = _rand(gen, 2, 1024, 4)

    def grads(plain):
        model.zero_grad(set_to_none=True)
        out = model.apply(pts, train=True, mask=mask, plain=plain)[0]
        ((out - target).square() * mask[..., None]).mean().backward()
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    cb.reset_launches()
    vx.reset_launches()
    gk = grads(False)
    torch.cuda.synchronize()
    # grid 16: the six level-0 forwards, five level-0 dgrads and six
    # level-0 wgrads take the implicit GEMMs (W 16), the 8^3 and 4^3 ones
    # the direct kernels
    assert cb.LAUNCHES == {"conv3x3_gn_act": 13, "down2x_gn_act": 2,
                           "up2x_gn_act": 2, "conv3x3_dgrad": 12,
                           "conv3x3_wgrad": 13, "down2x_bwd": 2,
                           "up2x_bwd": 2, "head_grid2": 0,
                           "head_grid2_bwd": 0, "conv3x3_mma": 6,
                           "down2x_mma": 2, "up2x_mma": 2,
                           "up2x_bwd_mma": 2, "down2x_bwd_mma": 2,
                           "conv3x3_dgrad_mma": 5, "conv3x3_wgrad_mma": 6}
    assert vx.LAUNCHES == {"voxelize_contract": 0, "trilinear_gather": 0,
                           "trilinear_scatter": 1}
    gp = grads(True)
    assert bool(torch.isfinite(gk).all())
    cos = float(gk @ gp / (gk.norm() * gp.norm()))
    assert cos > 0.99, cos
