"""The kernels of the voxel U-Net's default configuration against their
plain versions, on the card: ``voxelize_contract`` and ``trilinear_gather``
(ops/voxel.py), the fused head and its backward (ops/conv3d_block.py),
and the default model's launches per forward and per train step.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_voxel_default.py

Tolerances as in chip_smoke.py: counts exact; f32 sums of the same terms
in another order (and with atomics) to 1e-3 of their largest value (the
voxel sums and the gather to 1e-5: a handful of terms each); bf16 outputs
within |d| <= 2^-7 |ref| + 1e-4 max|ref|.
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
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _close(got, ref, rel):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rel * float(ref.float().abs().max()) + 1e-12, err


def _bf16_close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= 2.0 ** -7 * r.abs()
                 + 1e-4 * r.abs().max()).all()), float((g - r).abs().max())


# (B, M, R, C1): the default row width (C1 3), the sparse model's (2), odd
# ones and one past 32 columns; M 2,000 and 1,000 are not multiples of 32,
# so warp chunks straddle events; R 2 and 3 give tables smaller than the
# grid's share of the fill and not 16-byte aligned at odd C1; B16 x 65,536
# at R64 runs the grid-stride loops several times
VOXELIZE_CASES = [(3, 2000, 6, 3), (3, 2000, 16, 3), (3, 2000, 16, 2),
                  (3, 2000, 64, 3), (3, 2000, 8, 5), (3, 2000, 8, 40),
                  (3, 1000, 2, 3), (3, 1000, 3, 5), (3, 1000, 2, 1),
                  (3, 1000, 3, 40), (16, 65536, 64, 3)]


@pytest.mark.parametrize("b,m,r,c1", VOXELIZE_CASES)
@pytest.mark.parametrize("layout", ["hot", "whole"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_voxelize_contract_kernel(gen, b, m, r, c1, layout, id_dtype):
    """The voxelizer (one persistent launch: the table's zeros, then
    warp-aggregated float atomics) against its plain version: counts
    exact, sums to 1e-5 (bf16 values in f32, both sides in another
    order), nothing for masked points; ids int32 or int64 as they come;
    "hot": 300 points of event 0 on one voxel, "whole": all M points of
    event 0 on one voxel."""
    r3 = r ** 3
    flat = torch.randint(0, r3, (b, m), generator=gen, device="cuda")
    masked = torch.rand((b, m), generator=gen, device="cuda") < 0.2
    if layout == "hot":
        flat[0, :300] = 5 % r3             # one voxel hit by many points
    else:
        flat[0] = 5 % r3                   # a whole event on one voxel
        masked[0] = False
    masked[-1] = True                       # an all-masked dummy row
    flat = torch.where(masked, r3, flat).to(id_dtype)
    ext = torch.cat([torch.rand((b, m, max(c1 - 2, 0)), generator=gen,
                                device="cuda") * 4,
                     torch.ones((b, m, min(c1, 2)), device="cuda")], -1)
    ext = torch.where(masked[..., None], 0.0, ext)
    before = vx.LAUNCHES["voxelize_contract"]
    got = vx.voxelize_contract(flat, ext, r)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["voxelize_contract"] == before + 1
    ref = vx.voxelize_contract_plain(flat, ext, r)
    assert torch.equal(got[..., -1], ref[..., -1])         # counts
    assert not got[-1].any()
    if layout == "whole":
        assert float(got[0, 5 % r3, -1]) == m
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_voxelize_contract_is_one_kernel(gen, id_dtype):
    """A call is one device kernel: no zero fill of the table and no cast
    of the ids beside the voxelizer's own launch (torch.profiler's kernel
    list of one warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, m, r = 8, 8192, 64
    flat = torch.randint(0, r ** 3 + 1, (b, m), generator=gen,
                         device="cuda").to(id_dtype)
    ext = torch.rand((b, m, 3), generator=gen, device="cuda")
    vx.voxelize_contract(flat, ext, r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vx.voxelize_contract(flat, ext, r)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    assert len(kernels) == 1, kernels
    (name, calls), = kernels.items()
    assert "voxelize_contract_kernel" in name and calls == 1, kernels


def test_voxelize_contract_at_both_call_sites(gen):
    """The two callers' shapes: the default voxel model's voxelize (B8 x
    8192 at 64^3, C1 3, 2,000 points of event 0 on one voxel) and the
    sparse model's block-sparse voxelize (tile-major ids, C1 2): each
    against the plain version."""
    from pcseg_tpu_torch.ops import block_sparse as bsp

    b, m, r = 8, 8192, 64
    pts = torch.cat([_rand(gen, b, m, 3, scale=5.0),
                     torch.rand((b, m, 1), generator=gen, device="cuda")],
                    -1)
    pts[0, 1:2001, :3] = pts[0, 0, :3]
    mask = torch.rand((b, m), generator=gen, device="cuda") < 0.9
    mask[-1] = False
    flat, ext, _, _ = vx.voxel_rows(pts, mask, r)
    got = vx.voxelize_contract(flat, ext, r)
    ref = vx.voxelize_contract_plain(flat, ext, r)
    assert torch.equal(got[..., -1], ref[..., -1])
    _close(got, ref, 1e-5)
    before = vx.LAUNCHES["voxelize_contract"]
    bs, _, _ = bsp.block_sparse_voxelize(pts, mask, r, 512, 8)
    plain, _, _ = bsp.block_sparse_voxelize(pts, mask, r, 512, 8,
                                            plain=True)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["voxelize_contract"] == before + 1
    assert torch.equal(bs.active, plain.active)
    _close(bs.feats, plain.feats, 1e-5)


# every instantiated width at every grid size, and two widths that take
# the next instantiation with masked lanes
GATHER_CASES = [(r, c) for r in (6, 16, 64, 128)
                for c in (1, 3, 4, 7, 16, 32)] + [(16, 12), (16, 20)]


@pytest.mark.parametrize("r,c", GATHER_CASES)
def test_trilinear_gather_kernel(gen, r, c):
    """Every instantiated width (and two that take the next one with
    masked lanes) against the plain version: clipped duplicate taps,
    integral coords, points on the faces, an event whose points all sit on
    one spot, an all-masked row."""
    b, m = 3, 3000
    u = torch.rand((b, m, 3), generator=gen, device="cuda") * (r + 1) - 1
    u[0] = u[0, :1]                         # one voxel hit by every point
    u[1, :50] = u[1, :50].floor()           # frac == 0, clipped duplicates
    u[1, 50:70] = torch.tensor([-0.5, r - 0.5, 0.0], device="cuda")  # faces
    u[1, 70:90] = torch.tensor([r - 0.5, -0.5, r - 0.5], device="cuda")
    mask = torch.rand((b, m), generator=gen, device="cuda") < 0.8
    mask[0] = True
    mask[-1] = False                        # an all-masked row
    g2 = _rand(gen, b, r * r, r * c).to(torch.bfloat16)
    before = vx.LAUNCHES["trilinear_gather"]
    got = vx.trilinear_gather(u, mask, g2)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["trilinear_gather"] == before + 1
    _close(got, vx.trilinear_gather_plain(u, mask, g2), 1e-5)
    assert not got[~mask].any()
    # a grid that does not start on 16 bytes is copied, not misread
    shifted = torch.empty(g2.numel() + 1, dtype=torch.bfloat16,
                          device="cuda")[1:].view(g2.shape)
    shifted.copy_(g2)
    assert torch.equal(vx.trilinear_gather(u, mask, shifted), got)


@pytest.mark.parametrize("c", [33, 40, 64, 121])
def test_trilinear_gather_kernel_past_32_channels(gen, c):
    """Above 32 channels (121: the most classes the matmul devoxelize
    takes at 32^3) a thread takes 32 columns of a point: against the
    plain version as below 32, and each column chunk's bits those of the
    same channels gathered alone."""
    b, m, r = 3, 3000, 16
    u = torch.rand((b, m, 3), generator=gen, device="cuda") * (r + 1) - 1
    u[1, :50] = u[1, :50].floor()
    mask = torch.rand((b, m), generator=gen, device="cuda") < 0.8
    mask[-1] = False
    g2 = _rand(gen, b, r * r, r * c).to(torch.bfloat16)
    before = vx.LAUNCHES["trilinear_gather"]
    got = vx.trilinear_gather(u, mask, g2)
    torch.cuda.synchronize()
    assert vx.LAUNCHES["trilinear_gather"] == before + 1
    _close(got, vx.trilinear_gather_plain(u, mask, g2), 1e-5)
    assert not got[~mask].any()
    grid = g2.reshape(b, r * r, r, c)
    for k0 in range(0, c, 32):
        part = grid[..., k0:k0 + 32].reshape(b, r * r, -1).contiguous()
        assert torch.equal(got[..., k0:k0 + 32],
                           vx.trilinear_gather(u, mask, part))


@pytest.mark.parametrize("r,c,nc", [(8, 16, 4), (16, 16, 4), (8, 16, 3),
                                     (8, 32, 5),
                                     # every width the JAX fused head
                                     # takes: 20 classes (at 32^3 in the
                                     # model), C 128, odd class counts
                                     (16, 16, 20), (8, 128, 8), (8, 8, 1),
                                     (8, 24, 13), (8, 128, 128)])
def test_head_grid2_kernels(gen, r, c, nc):
    b = 2
    x = _rand(gen, b, r, r, r, c).to(torch.bfloat16)
    w = (torch.rand((1, 1, 1, c, nc), generator=gen, device="cuda") - 0.5)
    bias = _rand(gen, nc, scale=0.1)
    scale = torch.rand((b, c), generator=gen, device="cuda") + 0.5
    shift = _rand(gen, b, c, scale=0.3)
    gy = _rand(gen, b, r, r, r, nc).to(torch.bfloat16)
    before = dict(cb.LAUNCHES)
    y = cb.head_grid2_cuda(x, w, bias, scale, shift)
    gk = cb.head_grid2_bwd_cuda(x, gy, w, scale, shift)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["head_grid2"] == before["head_grid2"] + 1
    assert cb.LAUNCHES["head_grid2_bwd"] == before["head_grid2_bwd"] + 1
    _bf16_close(y, cb.head_grid2_plain(x, w, bias, scale, shift))
    gp = cb.head_grid2_bwd_plain(x, gy, w, scale, shift)
    _bf16_close(gk[0], gp[0])
    for a, p in zip(gk[1:], gp[1:]):
        _close(a, p, 1e-3)
    # the backward sums in a fixed order: a second call gives the same bits
    for a, p in zip(gk, cb.head_grid2_bwd_cuda(x, gy, w, scale, shift)):
        assert torch.equal(a, p)


HEAD_FWD_WIDTHS = [(c, nc) for c in range(8, 129, 8)
                   for nc in (1, 3, 4, 8, 13, 20, 40, 121, 128)]


@pytest.mark.parametrize("c,nc", HEAD_FWD_WIDTHS)
def test_head_grid2_forward_every_width(gen, c, nc):
    """Row 8 on the tensor cores at every channel count it takes and
    class counts from 1 to 128 (odd ones, one and several n8 tiles, 40
    and 121 as the 32^3 models have), at a grid whose voxels end in a
    partial tile: the plain version's y within one bf16 step, two calls
    bit for bit."""
    b, r = 2, 7
    x = _rand(gen, b, r, r, r, c).to(torch.bfloat16)
    w = (torch.rand((1, 1, 1, c, nc), generator=gen, device="cuda") - 0.5)
    bias = _rand(gen, nc, scale=0.1)
    scale = torch.rand((b, c), generator=gen, device="cuda") + 0.5
    shift = _rand(gen, b, c, scale=0.3)
    before = cb.LAUNCHES["head_grid2"]
    y = cb.head_grid2_cuda(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["head_grid2"] == before + 1
    _bf16_close(y, cb.head_grid2_plain(x, w, bias, scale, shift))
    assert torch.equal(y, cb.head_grid2_cuda(x, w, bias, scale, shift))


def test_default_model_launches_and_matches_plain(gen):
    """Full depth (3 levels) at grid 16 with every impl at its default: a
    forward launches each kernel of the path as often as the JAX structure
    does, a train step adds the backward kernels, and the logits agree
    with the plain versions'."""
    model = VoxelUNet3d(4, grid_size=16, width=16, levels=3,
                        compute_dtype="bfloat16",
                        generator=torch.Generator().manual_seed(0)).cuda()
    assert model.resolve_forms()["head"] == "grid2"
    pts = torch.cat([_rand(gen, 2, 1024, 3, scale=5.0),
                     torch.rand((2, 1024, 1), generator=gen,
                                device="cuda")], -1)
    mask = torch.rand((2, 1024), generator=gen, device="cuda") < 0.9
    cb.reset_launches()
    vx.reset_launches()
    out = model(pts, mask)
    torch.cuda.synchronize()
    # grid 16: the six level-0 3^3 forwards take the implicit GEMM (W 16),
    # the 8^3 and 4^3 ones the direct kernel; both up blocks the gathered
    # GEMM
    fwd = {"conv3x3_gn_act": 13, "down2x_gn_act": 2, "up2x_gn_act": 2,
           "head_grid2": 1, "conv3x3_mma": 6, "down2x_mma": 2,
           "up2x_mma": 2}
    assert cb.LAUNCHES == {k: fwd.get(k, 0) for k in cb.LAUNCHES}
    assert vx.LAUNCHES == {"voxelize_contract": 1, "trilinear_gather": 1,
                           "trilinear_scatter": 0}
    ref = model(pts, mask, plain=True)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 4 * 2.0 ** -8 * float(
        ref.abs().max())

    cb.reset_launches()
    vx.reset_launches()
    logits, _ = model.apply(pts, train=True, mask=mask)
    logits.square().mean().backward()
    torch.cuda.synchronize()
    # grid 16: the five level-0 dgrads and six level-0 wgrads take the
    # implicit GEMMs (W 16), the 8^3 and 4^3 ones the direct kernels
    step = dict(fwd, conv3x3_dgrad=12, conv3x3_wgrad=13, down2x_bwd=2,
                up2x_bwd=2, head_grid2_bwd=1, up2x_bwd_mma=2,
                down2x_bwd_mma=2, conv3x3_dgrad_mma=5, conv3x3_wgrad_mma=6)
    assert cb.LAUNCHES == {k: step.get(k, 0) for k in cb.LAUNCHES}
    assert vx.LAUNCHES == {"voxelize_contract": 1, "trilinear_gather": 1,
                           "trilinear_scatter": 1}
