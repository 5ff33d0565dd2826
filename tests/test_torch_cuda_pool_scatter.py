"""The port's fused global pool (ops/fused_pool.py) and segment scatter
(ops/voxel_scatter.py) kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pool_scatter.py

Tolerances: the pool's kernel rounds z = ((y - mu) * inv) * gamma + beta
at the plain version's points (no FMA contraction) and takes the max, an
exact operation, so g and idx match bit for bit; the backward's (B, C)
glue is shared and its write-only pass copies values, so every gradient
matches exactly too. The scatter's float atomics add in another order
than ``index_add_``: each sum is held to 1e-5 of the sum of its terms'
magnitudes.
"""

import pytest
import torch

from pcseg_tpu_torch.ops import fused_pool as fp
from pcseg_tpu_torch.ops import voxel_scatter as vs

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _pool_inputs(gen, b, rpb, c, dtype, ties=False, negative=False):
    y = torch.randn((b, rpb, c), generator=gen, device="cuda")
    if ties:
        y[:, 4] += 20.0                  # row 4 holds every channel's max
        y[:, 5:9] = y[:, 4:5]            # rows 5-8 repeat it
    y = y.reshape(b * rpb, c).to(dtype)
    mu = torch.randn(c, generator=gen, device="cuda") * 0.1
    inv = torch.rand(c, generator=gen, device="cuda") + 0.5
    gamma = torch.randn(c, generator=gen, device="cuda")
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    if ties:
        gamma = gamma.abs() + 0.1        # the repeated row is the max
    if negative:
        beta[::3] = -100.0               # these channels pool to 0
    return y, mu, inv, gamma, beta


def _pool_case(gen, b, rpb, c, dtype, **kw):
    args = _pool_inputs(gen, b, rpb, c, dtype, **kw)
    g_ref, idx_ref = fp.fused_pool_fwd_plain(*args, rpb)
    fp.reset_launches()
    g, idx = fp.fused_pool_fwd_cuda(*args, rpb)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["fused_pool"] == 1
    assert torch.equal(g, g_ref), float((g - g_ref).abs().max())
    assert torch.equal(idx, idx_ref)
    return args, g, idx


@pytest.mark.parametrize("b,rpb,c,dtype", [
    (64, 2048, 1024, torch.bfloat16),   # PointNet's global layer
    (4, 256, 64, torch.float32),        # the JAX test's shape
    (3, 1000, 64, torch.bfloat16),      # rows_per_batch not a tile multiple
    (2, 300, 20, torch.bfloat16),       # C not a multiple of 8: scalar path
    (2, 77, 6, torch.float32),          # C not a multiple of 4
])
def test_fused_pool_forward_matches_plain(gen, b, rpb, c, dtype):
    _pool_case(gen, b, rpb, c, dtype)


def test_fused_pool_ties_and_negative_channels(gen):
    (y, *_), g, idx = _pool_case(gen, 4, 512, 64, torch.bfloat16, ties=True,
                                 negative=True)
    assert bool((g[:, ::3] == 0).all()) and bool((idx[:, ::3] == 0).all())
    # the repeated row 4 holds the max of every other channel: first wins
    others = [k for k in range(64) if k % 3]
    assert bool((idx[:, others] == 4).all()), idx[:, others]


@pytest.mark.parametrize("b,rpb,c,dtype", [
    (64, 2048, 1024, torch.bfloat16),
    (4, 256, 64, torch.float32),
    (3, 1000, 64, torch.bfloat16),
    (2, 300, 20, torch.bfloat16),
])
def test_fused_pool_backward_matches_plain(gen, b, rpb, c, dtype):
    args = _pool_inputs(gen, b, rpb, c, dtype, negative=True)
    dg = torch.randn((b, c), generator=gen, device="cuda")
    grads = []
    for plain in (True, False):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        fp.reset_launches()
        out = fp.fused_global_pool(*leaves, rpb, plain=plain)
        out.backward(dg)
        torch.cuda.synchronize()
        want = 0 if plain else 1
        assert fp.LAUNCHES == {"fused_pool": want, "fused_pool_bwd": want}
        grads.append([t.grad for t in leaves])
    for name, ref, got in zip(("dy", "dmu", "dinv", "dgamma", "dbeta"),
                              *grads):
        assert got.dtype == ref.dtype, name
        assert torch.equal(got, ref), (name, float((got - ref).abs().max()))
    dy = grads[1][0].float().reshape(b, rpb, c)
    # write-only: at most one nonzero row a (batch row, channel)
    assert int((dy != 0).sum(1).max()) <= 1


def _scatter_check(ids, feats, nseg):
    ref = vs.segment_scatter_plain(ids, feats, nseg)
    mag = vs.segment_scatter_plain(ids, feats.abs(), nseg)
    vs.reset_launches()
    got = vs.segment_scatter(ids, feats, nseg)
    torch.cuda.synchronize()
    assert vs.LAUNCHES["segment_scatter"] == 1
    assert got.shape == ref.shape
    err = (got - ref).abs()
    assert bool((err <= 1e-5 * mag + 1e-30).all()), float(err.max())
    return got


@pytest.mark.parametrize("b,m,r,c", [(8, 8192, 64, 4), (2, 2048, 16, 3),
                                     (2, 256, 4, 1)])
def test_segment_scatter_matches_plain(gen, b, m, r, c):
    nseg = r ** 3
    ids = torch.randint(0, nseg, (b, m), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[:, -m // 8:] = nseg                       # spill rows: masked points
    feats = torch.randn((b, m, c), generator=gen, device="cuda")
    feats[:, -m // 8:] = 0.0
    _scatter_check(ids, feats, nseg)


def test_segment_scatter_hot_segment_and_bad_ids(gen):
    from pcseg_tpu_torch.ops._build import load_library, stream_of

    b, m, c, nseg = 4, 4096, 4, 16 ** 3
    ids = torch.full((b, m), 7, dtype=torch.int32, device="cuda")
    ids[1] = torch.randint(0, nseg, (m,), generator=gen, device="cuda",
                           dtype=torch.int32)
    ids[2, ::2] = nseg + 5                        # beyond the spill row
    ids[3, ::3] = -1
    ids[3, 1::3] = -2 ** 31
    feats = torch.randn((b, m, c), generator=gen, device="cuda")
    got = _scatter_check(ids, feats, nseg)
    assert float(got[0, 7].abs().sum()) > 0       # every point of event 0
    # the entry itself, into a buffer with guard zones around the output:
    # no id writes outside it
    guard = 1 << 16
    buf = torch.zeros(b * nseg * c + 2 * guard, device="cuda")
    out = buf[guard:guard + b * nseg * c]
    rc = load_library("onehot_contract").pcseg_segment_scatter(
        ids.data_ptr(), feats.data_ptr(), out.data_ptr(), b, m, nseg, c,
        stream_of(feats))
    torch.cuda.synchronize()
    assert rc == 0
    assert bool((buf[:guard] == 0).all()) and bool((buf[-guard:] == 0).all())
    assert torch.allclose(out.view(b, nseg, c), got, rtol=0, atol=1e-3)
