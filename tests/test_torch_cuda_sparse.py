"""The sparse family's kernels against their plain versions, on the card:
``block_conv`` (ops/block_conv.py) and ``bias_ln_relu_mask``
(ops/fused_ln.py), and the block-sparse model's launches per forward.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sparse.py

Tolerances: both versions sum in f32 and round once, in another order, so
a bf16 output may land on the neighbouring bf16 value, |d| <= 2^-7 |ref|
+ 1e-4 max|ref|; f32 outputs within 1e-5 of max|ref|. Padding tiles and
inactive rows are exactly zero.
"""

import pytest
import torch

from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.ops import block_conv as bc
from pcseg_tpu_torch.ops import fused_ln as fl
from pcseg_tpu_torch.ops import voxel as vx
from pcseg_tpu_torch.ops.block_sparse import (
    block_sparse_voxelize,
    neighbor_slots,
)

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
    assert bc.LAUNCHES == {"block_conv": 4}
    assert fl.LAUNCHES == {"bias_ln_relu_mask": 6}
    assert vx.LAUNCHES["voxelize_contract"] == int(dtype == "bfloat16")
    assert not dropped.any()
    ref = model(pts, mask, plain=True)
    assert bool(torch.isfinite(out).all()) and not out[~mask].any()
    assert float((out - ref).abs().max()) <= 4 * 2.0 ** -8 * float(
        ref.abs().max())
