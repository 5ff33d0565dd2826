"""The port's PointNet training kernels against their plain versions, on
the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pointnet.py

Tolerances: the kernels and the plain versions share every rounding
point, so the prologue, the dropout masks and the bf16 cotangents agree
bit for bit; only f32 sums run in another order (and with atomics). A
bf16 output may therefore round to the neighbouring value,
|d| <= 2^-7 |ref| + 1e-4 max|ref|, and an f32 sum is held to 1e-3 of the
largest |ref| of its tensor. Dropout is elementwise: exact.
"""

import pytest
import torch

from pcseg_tpu_torch.ops import dropout as dr
from pcseg_tpu_torch.ops import fused_block as fb
from pcseg_tpu_torch.ops import fused_ce as fc
from pcseg_tpu_torch.ops import fused_global as fg

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close_bf16(got, ref, name):
    g, r = got.detach().float(), ref.detach().float()
    tol = 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()
    assert bool(((g - r).abs() <= tol).all()), (
        f"{name}: max err {float((g - r).abs().max())}")


def _close_sum(got, ref, name, rel=1e-3):
    got, ref = got.detach(), ref.detach()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rel * float(ref.float().abs().max()) + 1e-6, (
        f"{name}: max err {err} vs max|ref| {float(ref.abs().max())}")


def _bn(gen, c):
    mu = torch.randn(c, generator=gen, device="cuda") * 0.2
    inv = torch.rand(c, generator=gen, device="cuda") + 0.5
    gamma = torch.randn(c, generator=gen, device="cuda")
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    return [t.requires_grad_() for t in (mu, inv, gamma, beta)]


def _dense(gen, cin, cout):
    bound = cin ** -0.5
    w = (torch.rand((cin, cout), generator=gen, device="cuda") * 2 - 1) * bound
    b = (torch.rand(cout, generator=gen, device="cuda") * 2 - 1) * bound
    return w.requires_grad_(), b.requires_grad_()


def _grads(out_fn, leaves, cts):
    for t in leaves:
        t.grad = None
    outs = out_fn()
    total = sum((o.float() * c).sum() for o, c in zip(outs, cts)
                if o is not None and c is not None)
    total.backward()
    return [None if t.grad is None else t.grad.clone() for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_is_exact(gen, dtype):
    x = torch.randn((8, 512, 256), generator=gen, device="cuda").to(dtype)
    before = dr.LAUNCHES["dropout"]
    got = dr.dropout(x, 1234567, 0.3)
    torch.cuda.synchronize()
    assert dr.LAUNCHES["dropout"] == before + 1
    ref = dr.dropout(x, 1234567, 0.3, plain=True)
    assert torch.equal(got, ref)
    keep = float((got != 0).float().mean())
    assert abs(keep - 0.7) < 0.01


CASES = [  # (cin, cout, normalize, relu, drop, row bias, out f32, B, M)
    (4, 64, False, False, 0.0, False, False, 4, 1024),     # conv1
    (3, 64, False, False, 0.0, False, False, 4, 1024),     # input_dim 3
    (64, 64, True, True, 0.0, False, False, 4, 1024),      # conv2, conv3
    (64, 128, True, True, 0.0, False, False, 4, 1024),     # conv4
    (128, 1024, True, True, 0.0, False, False, 4, 1024),   # conv5
    (64, 512, True, True, 0.0, True, False, 4, 1024),      # seg1
    # N = 3000, not a multiple of 128: a partial last tile (its rows past N
    # are TMA's zeros); seg1's batch boundaries inside the 128-row tiles
    (64, 512, True, True, 0.0, True, False, 3, 1000),
    (64, 64, True, True, 0.0, False, False, 3, 1000),     # one sweep:
    (64, 128, True, True, 0.0, False, False, 3, 1000),    # its three
    (128, 128, True, True, 0.3, False, False, 3, 1000),   # instances
    (512, 256, True, True, 0.3, False, False, 4, 1024),    # seg2
    (256, 128, True, True, 0.3, False, False, 4, 1024),    # seg3
    (128, 4, True, True, 0.0, False, True, 4, 1024),       # logits
    (128, 13, True, True, 0.0, False, True, 4, 1024),
    # conv1 at input_dim 20 and 33 (K chunks of 16, a partial last one),
    # the simt route with a normalize prologue and dropout over 13 chunks;
    # the logits layer past 32 classes (the wide tiles), one with stats
    (20, 64, False, False, 0.0, False, False, 4, 1024),
    (33, 64, False, False, 0.0, False, False, 3, 1000),
    (200, 128, True, True, 0.3, False, False, 4, 1024),
    (128, 40, True, True, 0.0, False, True, 4, 1024),
    (128, 100, True, True, 0.0, False, True, 3, 1000),
    (128, 127, True, True, 0.0, False, False, 4, 1024),
    # the one-sweep backward without stats (no y read), an f32 output
    (64, 64, True, True, 0.0, False, True, 4, 1024),
]


def _case_id(c):
    return (f"{c[0]}x{c[1]}" + ("" if c[8] == 1024 else f"-M{c[8]}")
            + ("-f32out" if c[6] and c[1] % 64 == 0 else ""))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_fused_block_kernel(gen, case):
    cin, cout, norm, relu, drop, has_rb, out_f32, b_, m_ = case
    n = b_ * m_
    x = torch.randn((n, cin), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    bn = _bn(gen, cin) if norm else [None] * 4
    w, b = _dense(gen, cin, cout)
    rb = (torch.randn((b_, cout), generator=gen, device="cuda")
          .requires_grad_() if has_rb else None)
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    emit = not out_f32
    cts = [torch.randn((n, cout), generator=gen, device="cuda")]
    if emit:
        cts += [torch.randn(cout, generator=gen, device="cuda") * 1e-2,
                torch.randn(cout, generator=gen, device="cuda") * 1e-3]
    leaves = [t for t in [x, *bn, w, b, rb] if t is not None]

    def run(plain):
        return fb.fused_block(x, *bn, w, b, rb, 99, relu, drop, emit, m_,
                              out_dtype, plain=plain)

    before = dict(fb.LAUNCHES)
    yk, s1k, s2k = run(False)
    yp, s1p, s2p = run(True)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["fused_block"] == before["fused_block"] + 1
    _close_bf16(yk, yp, "y")
    if emit:
        _close_sum(s1k, s1p, "s1")
        _close_sum(s2k, s2p, "s2")
    gk = _grads(lambda: run(False), leaves, cts)
    gp = _grads(lambda: run(True), leaves, cts)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["fused_block_bwd"] == before["fused_block_bwd"] + 1
    for leaf, a, r in zip(leaves, gk, gp):
        name = f"grad {tuple(leaf.shape)}"
        if leaf is x:
            _close_bf16(a, r, name)
        else:
            _close_sum(a, r, name)


@pytest.mark.parametrize("cin, cout", [(64, 64), (128, 128)])
def test_fused_block_bwd_kernel_f32_cotangent(gen, cin, cout):
    """An f32 dy (the split backward, where the sweep takes bf16) against
    the plain version."""
    n = 3000
    x = torch.randn((n, cin), generator=gen, device="cuda").to(torch.bfloat16)
    bn = [t.detach() for t in _bn(gen, cin)]
    w, b = (t.detach() for t in _dense(gen, cin, cout))
    y = fb.fused_block_fwd_cuda(x, *bn, w, b, None, 5, True, 0.3, True, 0,
                                torch.bfloat16)[0]
    dy = torch.randn((n, cout), generator=gen, device="cuda")
    ds1 = torch.randn(cout, generator=gen, device="cuda") * 1e-2
    ds2 = torch.randn(cout, generator=gen, device="cuda") * 1e-3
    args = (x, *bn, w, y, dy, ds1, ds2, 5, True, 0.3, 0, False)
    gk = fb.fused_block_bwd_cuda(*args)
    gp = fb.fused_block_bwd_plain(*args)
    torch.cuda.synchronize()
    _close_bf16(gk[0], gp[0], "dx")
    for name, a, r in zip(("dw", "db", "dgamma", "dbeta"), gk[1:5], gp[1:5]):
        _close_sum(a, r, name)


@pytest.mark.parametrize("cin, cout", [(96, 96), (64, 96), (32, 32),
                                       (128, 129)])
def test_fused_block_kernel_refuses_widths(gen, cin, cout):
    """Widths that no route takes raise ValueError before any launch."""
    x = torch.randn((256, cin), generator=gen, device="cuda").to(
        torch.bfloat16)
    bn = [t.detach() for t in _bn(gen, cin)]
    w, b = (t.detach() for t in _dense(gen, cin, cout))
    before = dict(fb.LAUNCHES)
    with pytest.raises(ValueError, match="fused_block on a CUDA tensor"):
        fb.fused_block(x, *bn, w, b)
    assert fb.LAUNCHES == before


# (batch rows, rows_per_batch, cin, cout, tied rows): the first shape,
# B64 x 2048 at 1024 -> 1024 (the main path), 1000 rows a batch row (batch
# boundaries inside the 128-row tiles, a partial last tile, a partial
# column tile and a K shorter than the ring), 100 rows a batch row (8-row
# groups that straddle two batch rows) and repeated rows (first-max ties)
GLOBAL_CASES = [
    (4, 512, 256, 512, False),
    (64, 2048, 1024, 1024, False),
    (5, 1000, 192, 320, False),
    (3, 100, 64, 128, False),
    (4, 512, 256, 512, True),
]


@pytest.mark.parametrize(
    "case", GLOBAL_CASES,
    ids=lambda c: f"B{c[0]}xM{c[1]}-{c[2]}x{c[3]}" + ("-ties" if c[4] else ""))
def test_global_pool_kernel(gen, case):
    b_, m_, cin, cout, ties = case
    n = b_ * m_
    x = torch.randn((b_, m_, cin), generator=gen, device="cuda")
    if ties:  # rows 1-3 of each batch row repeat row 0; batch row 0 is flat
        x[:, 1:4] = x[:, :1]
        x[0] = x[0, :1]
    x = x.reshape(n, cin).to(torch.bfloat16)
    bn = [t.detach() for t in _bn(gen, cin)]
    w, b = (t.detach() for t in _dense(gen, cin, cout))
    sign = torch.sign(torch.randn(cout, generator=gen, device="cuda"))
    sign[::7] = 0.0          # gamma == 0 channels: every row ties at 0
    before = dict(fg.LAUNCHES)
    k = fg.global_pool_fwd_cuda(x, *bn, w, b, sign, m_)
    p = fg.global_pool_fwd_plain(x, *bn, w, b, sign, m_)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["fused_global_pool_block"] == \
        before["fused_global_pool_block"] + 1
    _close_bf16(k[0], p[0], "y")
    _close_sum(k[1], p[1], "s1")
    _close_sum(k[2], p[2], "s2")
    _close_bf16(k[3], p[3], "best")
    assert bool((k[4][:, ::7] == 0).all())
    same = float((k[4] == p[4]).float().mean())
    assert same >= 0.99, same
    if ties:
        assert not bool(torch.isin(k[4], torch.tensor([1, 2, 3],
                                                      device="cuda")).any())
        assert bool((k[4][0] == 0).all())
    # the backward from one forward's y and winners, so a near-tie that
    # the two forwards broke differently does not move the comparison
    ds1 = torch.randn(cout, generator=gen, device="cuda") * 1e-2
    ds2 = torch.randn(cout, generator=gen, device="cuda") * 1e-3
    pval = torch.randn((b_, cout), generator=gen, device="cuda")
    args = (x, *bn, w, k[0], ds1, ds2, pval, k[4], m_)
    gk = fg.global_pool_bwd_cuda(*args)
    gp = fg.global_pool_bwd_plain(*args)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["fused_global_pool_block_bwd"] == \
        before["fused_global_pool_block_bwd"] + 1
    _close_bf16(gk[0], gp[0], "dx")
    for name, a, r in zip(("dw", "db", "dg", "dbeta"), gk[1:], gp[1:]):
        _close_sum(a, r, name)


@pytest.mark.parametrize("cin, cout", [(100, 128), (128, 96)])
def test_global_pool_kernel_refuses_widths(gen, cin, cout):
    """Widths that are not multiples of 64 raise before any launch."""
    x = torch.randn((256, cin), generator=gen, device="cuda").to(
        torch.bfloat16)
    bn = [t.detach() for t in _bn(gen, cin)]
    w, b = (t.detach() for t in _dense(gen, cin, cout))
    sign = torch.ones(cout, device="cuda")
    before = dict(fg.LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 64"):
        fg.fused_global_pool_block(x, *bn, w, b, sign, 128)
    assert fg.LAUNCHES == before


# (classes, rows): the last case is ragged (no multiple of a block's rows)
# with a run of padded rows
@pytest.mark.parametrize("classes, n", [(4, 8192), (13, 8192), (32, 4096),
                                        (4, 5003), (40, 8192), (100, 4096),
                                        (128, 5003)])
def test_seg4_ce_kernel(gen, classes, n):
    cin = 128
    x = torch.randn((n, cin), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    bn = _bn(gen, cin)
    w, b = _dense(gen, cin, classes)
    labels = torch.randint(-1, classes, (n,), generator=gen, device="cuda")
    labels[n // 2:n // 2 + 300] = -1
    cw = torch.rand(classes, generator=gen, device="cuda") + 0.5
    leaves = [x, *bn, w, b]

    def run(plain):
        return fc.fused_seg4_ce(x, *bn, w, b, labels, cw, plain=plain)

    k = run(False)
    p = run(True)
    torch.cuda.synchronize()
    assert abs(float(k[0]) - float(p[0])) <= 1e-4 * abs(float(p[0]))
    assert abs(float(k[1]) - float(p[1])) <= 1e-4 * abs(float(p[1]))
    assert abs(float(k[2]) - float(p[2])) <= 2
    gk = _grads(lambda: run(False)[:1], leaves, [torch.ones((),
                                                           device="cuda")])
    gp = _grads(lambda: run(True)[:1], leaves, [torch.ones((),
                                                          device="cuda")])
    for leaf, a, r in zip(leaves, gk, gp):
        if leaf is x:
            _close_bf16(a, r, "dx")
        else:
            _close_sum(a, r, f"grad {tuple(leaf.shape)}")


# the conv biases that a train-mode BN follows: gradient 0 up to rounding
ZERO_GRAD = {f"{n}.bias" for n in ("conv1", "conv2", "conv3", "conv4",
                                   "conv5", "global_feat", "seg_conv1",
                                   "seg_conv2", "seg_conv3")}


# (classes, input_dim): the widths the JAX fused chain trains beyond the
# bench's, 40 classes (rows 15 and 17 past 32 classes) and 20 input
# features (conv1 on K chunks)
@pytest.mark.parametrize("classes, input_dim", [(40, 4), (4, 20)])
def test_fused_pointnet_step_at_new_widths(gen, classes, input_dim):
    """One fused train step of PointNetSeg through the kernels (8 + 8
    fused_block launches, 1 + 1 of the classifier + CE) against the same
    step on the plain versions: the loss to 2^-8, each gradient within 3x
    the plain chain's own distance from the same step in f32 (the
    train-mode BN backward amplifies one-ulp bf16 flips; phase 5 of
    chip_smoke.py holds the bench step so), except the biases that a BN
    follows (0 up to rounding)."""
    from pcseg_tpu_torch.models.pointnet import PointNetSeg, pointnet_apply
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    b_, m_ = 4, 1024
    pts = torch.randn((b_, m_, input_dim), generator=gen, device="cuda")
    labels = torch.randint(0, classes, (b_, m_), generator=gen,
                           device="cuda")
    labels[1, 700:] = -1
    pts[1, 700:] = 0.0
    cw = torch.rand(classes, generator=gen, device="cuda") + 0.5
    model = PointNetSeg(classes, input_dim=input_dim, dropout=0.0,
                        bn_stats="fused", compute_dtype="bfloat16",
                        generator=torch.Generator().manual_seed(1)).cuda()

    def step(plain):
        model.zero_grad(set_to_none=True)
        (num, den, _), _ = model.fused_train_loss(pts, labels, cw,
                                                  seeds=(0, 0), plain=plain)
        (num / den).backward()
        return float(num / den), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}

    fb.reset_launches()
    fc.reset_launches()
    lk, gk = step(False)
    assert fb.LAUNCHES == {"fused_block": 8, "fused_block_bwd": 8}
    assert fc.LAUNCHES == {"fused_seg4_ce": 1, "fused_seg4_ce_bwd": 1}
    lp, gp = step(True)
    model.zero_grad(set_to_none=True)
    logits, _ = pointnet_apply(model.params(), model.batch_stats(), pts,
                               train=True, seeds=(0, 0), dropout_rate=0.0,
                               compute_dtype=torch.float32,
                               fast_bn_stats=True, plain=True)
    num, den = cross_entropy_sums(logits, labels, cw)
    (num / den).backward()
    gf = {n: p.grad.clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    assert abs(lk - lp) <= 2.0 ** -8 * abs(lp)
    for n in gp:
        assert bool(torch.isfinite(gk[n]).all()), n
        if n in ZERO_GRAD:
            continue
        own = float((gp[n] - gf[n]).norm())
        assert float((gk[n] - gp[n]).norm()) <= 3.0 * own + 1e-6, n
