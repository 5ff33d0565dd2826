"""The voxel U-Net's tensor-core forward kernels against their plain
versions, on the card: the 3^3 conv's implicit GEMM (csrc/conv3d_dgrad.cu,
``conv3x3_mma``) and the up block's gathered GEMM (csrc/resample.cu,
``up2x_mma``), and the launch counts of one forward and one train step of
the bench configuration.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_voxel_fwd.py

Tolerances as in chip_smoke.py: the same rounding points, f32 sums in
another order, so y may round to the neighbouring bf16 value, |d| <=
2^-7 |ref| + 1e-4 max|ref|, and the stats agree to 1e-3 of the largest
|s| of their (batch, sum|sumsq) row. Both kernels take their sums in a
fixed order: a second call on the same inputs gives the same bits.
"""

import pytest
import torch

from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops import conv3d_block as cb

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


def _inputs(gen, b, dhw, cin, cout, k):
    x = _rand(gen, b, *dhw, cin).to(torch.bfloat16)
    w = (torch.rand((k, k, k, cin, cout), generator=gen, device="cuda")
         - 0.5) * (6.0 / (k ** 3 * cin)) ** 0.5
    bias = _rand(gen, cout, scale=0.1)
    scale = torch.rand((b, cin), generator=gen, device="cuda") + 0.5
    shift = _rand(gen, b, cin, scale=0.3)
    return x, w, bias, scale, shift


def _bf16_close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= 2.0 ** -7 * r.abs()
                 + 1e-4 * r.abs().max()).all()), float((g - r).abs().max())


def _stats_close(got, ref):
    denom = ref.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    err = float(((got - ref).abs() / denom).max())
    assert err <= 1e-3, err


def _same_bits(got, again):
    return all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again))


# (B, grid, C, variant): row 1's launches on the bench forward (the four
# variants at 64^3 x 16, three at 32^3 x 32, "act" at 16^3 x 64), C 8
# (m16n8k8), non-cubic grids (planes in ranges of unequal length; the
# other W of each width), and the column-tiled widths: the 128^3 step's
# level 0, the 256^3 step's three levels (W 256 at 16 channels, 128 at
# 32, 64 at 64) and three tiles a row (W 192 at 8 channels)
CONV_CASES = [
    (8, (64, 64, 64), 16, "act"), (8, (64, 64, 64), 16, "accum"),
    (8, (64, 64, 64), 16, "stem"), (8, (64, 64, 64), 16, "no-stats"),
    (8, (32, 32, 32), 32, "act"), (8, (32, 32, 32), 32, "accum"),
    (8, (32, 32, 32), 32, "no-stats"), (8, (16, 16, 16), 64, "act"),
    (2, (8, 16, 16), 8, "act"), (1, (7, 8, 32), 32, "accum"),
    (2, (6, 8, 32), 64, "accum"), (2, (5, 8, 64), 8, "no-stats"),
    (2, (9, 16, 32), 16, "stem"),
    (1, (128, 128, 128), 16, "act"), (1, (128, 128, 128), 16, "accum"),
    (1, (4, 256, 256), 16, "no-stats"), (1, (8, 128, 128), 32, "stem"),
    (1, (64, 64, 64), 64, "act"), (1, (6, 64, 64), 64, "accum"),
    (1, (4, 16, 192), 8, "act"),
]


@pytest.mark.parametrize("b,dhw,c,case", CONV_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_conv3x3_mma_kernel(gen, b, dhw, c, case):
    """csrc/conv3d_dgrad.cu's forward against the plain version, and bit
    for bit the same in a second call (y, stats)."""
    x, w, bias, scale, shift = _inputs(gen, b, dhw, c, c, 3)
    accum = (_rand(gen, b, *dhw, c).to(torch.bfloat16) if case == "accum"
             else None)
    kw = dict(activate=case != "stem", want_stats=case != "no-stats")
    args = (x, w, bias, scale, shift, accum)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_gn_act_cuda(*args, **kw)
    again = cb.conv3x3_gn_act_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_mma"] == before["conv3x3_mma"] + 2
    assert cb.LAUNCHES["conv3x3_gn_act"] == before["conv3x3_gn_act"] + 2
    ref = cb.conv3x3_gn_act_plain(*args, **kw)
    _bf16_close(got[0], ref[0])
    if kw["want_stats"]:
        _stats_close(got[1], ref[1])
    else:
        assert got[1] is None
    assert _same_bits(got, again)


def test_conv3x3_forward_other_widths_take_the_direct_kernel(gen):
    """W = 8 (here 8^3 x 32 with accum, the 8^3 level of a 16^3 model)
    keeps conv3d_block.cu's conv_kernel, a route declared by shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, (8, 8, 8), 32, 32, 3)
    accum = _rand(gen, 2, 8, 8, 8, 32).to(torch.bfloat16)
    before = dict(cb.LAUNCHES)
    got = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift, accum)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_mma"] == before["conv3x3_mma"]
    assert cb.LAUNCHES["conv3x3_gn_act"] == before["conv3x3_gn_act"] + 1
    ref = cb.conv3x3_gn_act_plain(x, w, bias, scale, shift, accum)
    _bf16_close(got[0], ref[0])
    _stats_close(got[1], ref[1])


# (B, coarse grid, fine C): row 6's two launches on the bench forward
# (16^3 x 64 -> 32^3 x 32, 32^3 x 32 -> 64^3 x 16), C 8 and 64, and a
# ragged last tile (B1 3 x 5 x 12: 180 coarse voxels)
UP_CASES = [(8, (16, 16, 16), 32), (8, (32, 32, 32), 16),
            (2, (4, 4, 4), 8), (2, (4, 4, 8), 64), (1, (3, 5, 12), 16)]


@pytest.mark.parametrize("b,dhw,c", UP_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_up2x_mma_kernel(gen, b, dhw, c):
    """csrc/resample.cu's up block forward against the plain version, and
    bit for bit the same in a second call."""
    x, w, bias, scale, shift = _inputs(gen, b, dhw, 2 * c, c, 2)
    args = (x, w, bias, scale, shift)
    before = dict(cb.LAUNCHES)
    got = cb.up2x_gn_act_cuda(*args)
    again = cb.up2x_gn_act_cuda(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["up2x_mma"] == before["up2x_mma"] + 2
    assert cb.LAUNCHES["up2x_gn_act"] == before["up2x_gn_act"] + 2
    ref = cb.up2x_gn_act_plain(*args)
    _bf16_close(got[0], ref[0])
    _stats_close(got[1], ref[1])
    assert _same_bits(got, again)


def test_up2x_other_widths_take_the_cuda_core_kernel(gen):
    """2C != C2 (24 coarse channels over 16 fine ones) keeps
    conv3d_block.cu's up_kernel, a route declared by shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, (4, 4, 4), 24, 16, 2)
    before = dict(cb.LAUNCHES)
    got = cb.up2x_gn_act_cuda(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["up2x_mma"] == before["up2x_mma"]
    assert cb.LAUNCHES["up2x_gn_act"] == before["up2x_gn_act"] + 1
    ref = cb.up2x_gn_act_plain(x, w, bias, scale, shift)
    _bf16_close(got[0], ref[0])
    _stats_close(got[1], ref[1])


def test_bench_forward_and_step_launch_counts(gen):
    """One forward of the bench configuration (64^3, w16, 3 levels, bf16,
    scatter voxelize, gather devoxelize; B2 here) launches the 3^3 implicit
    GEMM 13 times and the up block's gathered GEMM twice, and no CUDA-core
    forward conv; a train step (forward and backward) launches the same
    forwards and every backward kernel on its tensor-core route."""
    model = VoxelUNet3d(num_classes=4, grid_size=64, width=16, levels=3,
                        compute_dtype="bfloat16", conv_impl="fused",
                        voxelize_impl="scatter", devox_impl="gather",
                        generator=torch.Generator().manual_seed(0)).cuda()
    points = torch.rand((2, 2048, 4), generator=gen, device="cuda") * 2 - 1
    mask = torch.ones((2, 2048), dtype=torch.bool, device="cuda")
    forward = {"conv3x3_gn_act": 13, "conv3x3_mma": 13, "up2x_gn_act": 2,
               "up2x_mma": 2, "down2x_gn_act": 2, "down2x_mma": 2}
    cb.reset_launches()
    model(points, mask)
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == forward
    cb.reset_launches()
    logits = model.apply(points, mask=mask)
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in cb.LAUNCHES.items() if v} == dict(
        forward, conv3x3_dgrad=12, conv3x3_dgrad_mma=12, conv3x3_wgrad=13,
        conv3x3_wgrad_mma=13, down2x_bwd=2, down2x_bwd_mma=2, up2x_bwd=2,
        up2x_bwd_mma=2)
