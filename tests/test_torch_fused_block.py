"""The port's fused_block (ops/fused_block.py, its plain version on the
CPU) against the JAX package's Pallas fused_block (interpret mode on the
CPU), forward and backward, for every flag combination of the op.

Inputs are made with numpy from a seed; N = 2 batch rows x 64 points.
Dropout runs at rate 0 against JAX (the TPU's hardware PRNG has no CPU
counterpart); the dropout masks are tested in test_torch_dropout.py and
below against an explicit masked formula.

Tolerances: both sides round at the same points (prologue in f32 ->
bf16, f32 sums, bf16 y and bf16 cotangent), so they differ by f32
summation order, which can move a bf16 value by one ulp. Every output,
bf16 or f32, is held to atol = 2^-8 * max|ref| of its tensor (one bf16
ulp of its scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas.fused_block import fused_block as jax_fused_block
from pcseg_tpu_torch.ops import fused_block as fb
from pcseg_tpu_torch.ops.dropout import keep_mask

torch.set_num_threads(1)

B, M = 2, 64
N = B * M


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, cin, cout, normalize, row_bias):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(N, cin)) * 2.0)
    bn = None
    if normalize:
        bn = [rng.normal(size=cin) * 0.3, rng.uniform(0.5, 1.5, cin),
              rng.normal(size=cin), rng.normal(size=cin) * 0.3]
        bn = [a.astype(np.float32) for a in bn]
    w = (rng.uniform(-1, 1, (cin, cout)) / np.sqrt(cin)).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    rb = ((rng.normal(size=(B, cout)) * 0.5).astype(np.float32)
          if row_bias else None)
    return x, bn, w, b, rb


def _assert_close(got, ref, name):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    atol = 2.0 ** -8 * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= atol, f"{name}: max err {err} > {atol}"


# (cin, cout, normalize, relu, emit_stats, row_bias, out_f32)
CASES = [
    (4, 64, False, False, True, False, False),      # conv1
    (64, 64, False, True, True, False, False),
    (64, 128, True, True, True, False, False),      # conv2..conv5 shape
    (64, 64, True, False, True, False, False),
    (64, 512, True, True, True, True, False),       # seg1, row bias
    (128, 4, True, True, False, False, True),       # logits layer
    (64, 64, True, True, False, False, False),
    (64, 128, True, True, True, True, True),
]


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: "{}x{}-n{:d}r{:d}s{:d}b{:d}f{:d}".format(*c))
def test_fused_block_matches_jax(case):
    cin, cout, normalize, relu, emit, row_bias, out_f32 = case
    x, bn, w, b, rb = _inputs(cin * 7 + cout, cin, cout, normalize,
                              row_bias)
    rng = np.random.default_rng(1)
    dy = _bf16(rng.normal(size=(N, cout)))
    ds1 = (rng.normal(size=cout) * 0.01).astype(np.float32)
    ds2 = (rng.normal(size=cout) * 0.001).astype(np.float32)
    rpb = M if row_bias else 0
    jdt = jnp.float32 if out_f32 else jnp.bfloat16

    # --- JAX, Pallas in interpret mode
    def jf(x_, bn_, w_, b_, rb_):
        mu, inv, g, be = bn_ if bn_ is not None else (None,) * 4
        return jax_fused_block(x_, mu, inv, g, be, w_.astype(jnp.bfloat16),
                               b_, rb_, jnp.zeros((1,), jnp.int32), relu,
                               0.0, emit, rpb, 64, jdt)

    jbn = None if bn is None else [jnp.asarray(a) for a in bn]
    jrb = None if rb is None else jnp.asarray(rb)
    (jy, js1, js2), vjp = jax.vjp(jf, jnp.asarray(x, jnp.bfloat16), jbn,
                                  jnp.asarray(w), jnp.asarray(b), jrb)
    cts = (jnp.asarray(dy, jdt),
           jnp.asarray(ds1) if emit else None,
           jnp.asarray(ds2) if emit else None)
    jdx, jdbn, jdw, jdb, jdrb = vjp(cts)

    # --- the port (plain version on the CPU), autograd
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    tbn = ([torch.tensor(a).requires_grad_() for a in bn] if bn is not None
           else [None] * 4)
    tw = torch.tensor(w).requires_grad_()
    tb = torch.tensor(b).requires_grad_()
    trb = None if rb is None else torch.tensor(rb).requires_grad_()
    ty, ts1, ts2 = fb.fused_block(
        tx, *tbn, tw, tb, trb, 0, relu, 0.0, emit, rpb,
        torch.float32 if out_f32 else torch.bfloat16)
    assert ty.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    total = (ty.float() * torch.tensor(dy)).sum()
    if emit:
        total = total + (ts1 * torch.tensor(ds1)).sum() + (
            ts2 * torch.tensor(ds2)).sum()
    else:
        assert ts1 is None and ts2 is None
    total.backward()

    _assert_close(ty.detach().float(), np.asarray(jy, np.float32), "y")
    if emit:
        _assert_close(ts1.detach(), js1, "s1")
        _assert_close(ts2.detach(), js2, "s2")
    _assert_close(tx.grad.float(), np.asarray(jdx, np.float32), "dx")
    _assert_close(tw.grad, jdw, "dw")
    _assert_close(tb.grad, jdb, "db")
    if normalize:
        for name, t, r in zip(("dmu", "dinv", "dgamma", "dbeta"), tbn, jdbn):
            _assert_close(t.grad, r, name)
    if row_bias:
        _assert_close(trb.grad, jdrb, "d row_bias")


def test_fused_block_dropout_masks_forward_and_backward():
    """At rate 0.3 the plain version equals autograd of the explicit
    formula with the hash mask of the same seed (f32 sums in another
    order: 1e-5 of max|ref|; bf16 outputs one ulp, 2^-8 max|ref|)."""
    cin, cout, rate, seed = 64, 32, 0.3, 12345
    x, bn, w, b, _ = _inputs(3, cin, cout, True, False)
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    tbn = [torch.tensor(a).requires_grad_() for a in bn]
    tw = torch.tensor(w).requires_grad_()
    tb = torch.tensor(b).requires_grad_()
    leaves = [tx, *tbn, tw, tb]
    dy = torch.tensor(_bf16(np.random.default_rng(2).normal(size=(N, cout))))

    y, s1, s2 = fb.fused_block(tx, *tbn, tw, tb, None, seed, True, rate)
    (y.float() * dy).sum().backward()
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None

    mu, inv, g, be = tbn
    keep = keep_mask(seed, rate, (N, cin), "cpu")
    z = (tx.float() - mu) * inv * g + be
    a = torch.where(keep, torch.relu(z) * (1.0 / (1.0 - rate)), 0.0)
    a_b = a.to(torch.bfloat16).float()
    y_ref = (a_b @ tw.to(torch.bfloat16).float() + tb).detach()
    np.testing.assert_allclose(y.detach().float().numpy(),
                               y_ref.to(torch.bfloat16).float().numpy(),
                               rtol=0,
                               atol=2.0 ** -8 * float(y_ref.abs().max()))
    # the op's backward: bf16 cotangent, straight through the bf16
    # rounding of a and W (dW comes back f32), dx rounded to bf16
    a_st = a + (a_b - a).detach()
    w_st = tw + (tw.to(torch.bfloat16).float() - tw).detach()
    ((a_st @ w_st + tb) * dy).sum().backward()
    for t, r in zip(leaves, got):
        ref = t.grad.float()
        tol = (2.0 ** -8 if t is tx else 1e-5) * float(ref.abs().max())
        assert float((r.float() - ref).abs().max()) <= tol
    # the dropped elements get no gradient
    assert bool((got[0][~keep] == 0).all())


@pytest.mark.parametrize("cin, cout, route", [
    (4, 64, "simt"), (3, 256, "simt"), (128, 4, "narrow"), (128, 32, "narrow"),
    (64, 64, "wgmma"), (128, 1024, "wgmma"), (512, 256, "wgmma"),
    (1088 - 1024, 512, "wgmma")])
def test_route_of_takes_every_pointnet_width(cin, cout, route):
    assert fb.route_of(cin, cout) == route


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("cin, cout", [(96, 64), (32, 64), (128, 40),
                                       (4, 96), (2048, 64)])
def test_card_width_check_raises_before_the_library_loads(
        monkeypatch, direction, cin, cout):
    """A width no route takes raises ValueError in the card wrappers before
    the kernel library is built or loaded."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(fb, "load_library", no_library)
    n = 256
    x = torch.zeros((n, cin), dtype=torch.bfloat16)
    bn = [torch.ones(cin) for _ in range(4)]
    w = torch.zeros((cin, cout))
    with pytest.raises(ValueError, match="fused_block on a CUDA tensor"):
        if direction == "forward":
            fb.fused_block_fwd_cuda(x, *bn, w, torch.zeros(cout), None, 0,
                                    True, 0.0, True, 0, torch.bfloat16)
        else:
            z = torch.zeros(cout)
            fb.fused_block_bwd_cuda(
                x, *bn, w, torch.zeros((n, cout), dtype=torch.bfloat16),
                torch.zeros((n, cout)), z, z, 0, True, 0.0, 0, False)

