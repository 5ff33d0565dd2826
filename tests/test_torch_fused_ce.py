"""The port's fused_seg4_ce (ops/fused_ce.py, its plain version on the
CPU) against the JAX package's Pallas op (interpret mode on the CPU),
forward and backward, with argmax ties and ignored labels.

Ties by construction: class 1's weights and bias copy class 0's, so
their logits are equal on every row and the FIRST class wins the argmax
(torch's rule); a quarter of the labels are -1 (padding), which count in
none of num, den and correct.

Tolerances: same rounding points on both sides, f32 sums in another
order. num and den: 1e-5 relative (sums of ~100 f32 terms); correct:
exact; gradients, bf16 dx and f32 sums alike: atol = 2^-8 * max|ref| of
the tensor (one bf16 ulp of its scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce_sums
from pcseg_tpu.ops.pallas.fused_ce import fused_seg4_ce as jax_seg4_ce
from pcseg_tpu_torch.ops import fused_ce as fc

torch.set_num_threads(1)

N, CIN = 128, 128


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, c):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(N, CIN)) * 2.0)
    bn = [rng.normal(size=CIN) * 0.3, rng.uniform(0.5, 1.5, CIN),
          rng.normal(size=CIN), rng.normal(size=CIN) * 0.3]
    bn = [a.astype(np.float32) for a in bn]
    w = (rng.uniform(-1, 1, (CIN, c)) / np.sqrt(CIN)).astype(np.float32)
    b = (rng.normal(size=c) * 0.1).astype(np.float32)
    w[:, 1], b[1] = w[:, 0], b[0]            # classes 0 and 1 tie
    labels = rng.integers(0, c, N)
    labels[rng.random(N) < 0.25] = -1
    cw = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return x, bn, w, b, labels, cw


def _assert_close(got, ref, name):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    atol = 2.0 ** -8 * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= atol, f"{name}: max err {err} > {atol}"


@pytest.mark.parametrize("classes", [4, 13])
def test_fused_seg4_ce_matches_jax(classes):
    x, bn, w, b, labels, cw = _inputs(classes, classes)

    def jf(x_, bn_, w_, b_):
        return jax_seg4_ce(x_, *bn_, w_, b_, jnp.asarray(labels, jnp.int32),
                           jnp.asarray(cw), classes, 64)

    (jnum, jden, jcor), vjp = jax.vjp(
        jf, jnp.asarray(x, jnp.bfloat16), [jnp.asarray(a) for a in bn],
        jnp.asarray(w), jnp.asarray(b))
    jdx, jdbn, jdw, jdb = vjp((jnp.float32(1.0), jnp.float32(0.0),
                               jnp.float32(0.0)))

    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    tbn = [torch.tensor(a).requires_grad_() for a in bn]
    tw = torch.tensor(w).requires_grad_()
    tb = torch.tensor(b).requires_grad_()
    num, den, cor = fc.fused_seg4_ce(tx, *tbn, tw, tb, torch.tensor(labels),
                                     torch.tensor(cw))
    num.backward()
    num = num.detach()

    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-5)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-5)
    assert float(cor) == float(jcor)
    _assert_close(tx.grad.float(), np.asarray(jdx, np.float32), "dx")
    assert tw.grad.dtype == torch.float32
    _assert_close(tw.grad, jdw, "dw")
    _assert_close(tb.grad, jdb, "db")
    for name, t, r in zip(("dmu", "dinv", "dgamma", "dbeta"), tbn, jdbn):
        _assert_close(t.grad, r, name)


def test_fused_seg4_ce_is_the_loss_contract():
    """num/den/correct equal cross_entropy_sums and the first-class argmax
    count on the op's own logits (the JAX package's loss on them)."""
    x, bn, w, b, labels, cw = _inputs(7, 4)
    tx = torch.tensor(x).to(torch.bfloat16)
    *_, logits = fc._logits_plain(tx, *[torch.tensor(a) for a in bn],
                                  torch.tensor(w), torch.tensor(b))
    num, den, cor = fc.fused_seg4_ce(tx, *[torch.tensor(a) for a in bn],
                                     torch.tensor(w), torch.tensor(b),
                                     torch.tensor(labels), torch.tensor(cw))
    jnum, jden = jax_ce_sums(jnp.asarray(logits.numpy()),
                             jnp.asarray(labels), jnp.asarray(cw))
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-5)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-5)
    pred = logits.argmax(dim=1).numpy()
    assert not (pred == 1).any()             # the tie goes to class 0
    assert float(cor) == float(((pred == labels) & (labels >= 0)).sum())


@pytest.mark.parametrize("cin, classes", [(64, 4), (128, 33), (256, 4)])
def test_card_width_check_raises_before_the_library_loads(monkeypatch, cin,
                                                          classes):
    """Cin other than 128 or more than 32 classes raise ValueError in the
    card wrappers before the kernel library is built or loaded."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(fc, "load_library", no_library)
    n = 64
    args = (torch.zeros((n, cin), dtype=torch.bfloat16),
            *[torch.ones(cin) for _ in range(4)], torch.zeros((cin, classes)),
            torch.zeros(classes), torch.zeros(n, dtype=torch.int64),
            torch.ones(classes))
    with pytest.raises(ValueError, match="fused_seg4_ce on a CUDA tensor"):
        fc.seg4_ce_fwd_cuda(*args)
    with pytest.raises(ValueError, match="fused_seg4_ce on a CUDA tensor"):
        fc.seg4_ce_bwd_cuda(*args, torch.ones(()))
