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


CASES = [  # (cin, cout, normalize, relu, drop, row bias, out f32)
    (4, 64, False, False, 0.0, False, False),
    (64, 64, True, True, 0.0, False, False),
    (128, 1024, True, True, 0.0, False, False),
    (64, 512, True, True, 0.0, True, False),
    (512, 256, True, True, 0.3, False, False),
    (256, 128, True, True, 0.3, False, False),
    (128, 4, True, True, 0.0, False, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_fused_block_kernel(gen, case):
    cin, cout, norm, relu, drop, has_rb, out_f32 = case
    b_, m_ = 4, 1024
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

    yk, s1k, s2k = run(False)
    yp, s1p, s2p = run(True)
    torch.cuda.synchronize()
    _close_bf16(yk, yp, "y")
    if emit:
        _close_sum(s1k, s1p, "s1")
        _close_sum(s2k, s2p, "s2")
    gk = _grads(lambda: run(False), leaves, cts)
    gp = _grads(lambda: run(True), leaves, cts)
    torch.cuda.synchronize()
    for leaf, a, r in zip(leaves, gk, gp):
        name = f"grad {tuple(leaf.shape)}"
        if leaf is x:
            _close_bf16(a, r, name)
        else:
            _close_sum(a, r, name)


def test_global_pool_kernel(gen):
    b_, m_, cin, cout = 4, 512, 256, 512
    n = b_ * m_
    x = torch.randn((n, cin), generator=gen, device="cuda").to(
        torch.bfloat16)
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
    # the backward from one forward's y and winners, so a near-tie that
    # the two forwards broke differently does not move the comparison
    ds1 = torch.randn(cout, generator=gen, device="cuda") * 1e-2
    ds2 = torch.randn(cout, generator=gen, device="cuda") * 1e-3
    pval = torch.randn((b_, cout), generator=gen, device="cuda")
    args = (x, *bn, w, k[0], ds1, ds2, pval, k[4], m_)
    gk = fg.global_pool_bwd_cuda(*args)
    gp = fg.global_pool_bwd_plain(*args)
    torch.cuda.synchronize()
    _close_bf16(gk[0], gp[0], "dx")
    for name, a, r in zip(("dw", "db", "dg", "dbeta"), gk[1:], gp[1:]):
        _close_sum(a, r, name)


@pytest.mark.parametrize("classes", [4, 13])
def test_seg4_ce_kernel(gen, classes):
    n, cin = 8192, 128
    x = torch.randn((n, cin), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    bn = _bn(gen, cin)
    w, b = _dense(gen, cin, classes)
    labels = torch.randint(-1, classes, (n,), generator=gen, device="cuda")
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
