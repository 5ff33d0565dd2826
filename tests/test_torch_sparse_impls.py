"""SparseVoxelNet's rulebook-gather and masked-dense impls in the port
(``ops/sparse.py``, ``ops/voxel.devoxelize_nearest``, ``impl="gather"`` /
``"dense"`` of ``models/sparse_unet.py``) against the JAX package's, on
the same inputs (numpy, seeded) and weights (numpy, carried over with
``ckpt.convert.from_jax_variables``).

- Each op against its JAX function: the integers of ``sparse_from_grid``
  and ``sparse_pool`` (``ijk``, ``site_mask``, ``lookup``, ``dropped``)
  equal at capacities that drop sites and at one that does not; the
  floats within the bounds stated at each test; the gradients of the four
  convs against ``jax.vjp`` in f32.
- Both models against the JAX model: grid 16, width 16, depth 2, 2
  levels, bf16 and f32, B2 x 512 track events with masked rows,
  ``max_active`` 2048 and 64. The dense JAX model runs row 20's Pallas
  kernel in interpret mode (``fused_ln="interpret"``), as the port runs
  its plain version here. One f32 train step's gradients against
  ``jax.value_and_grad``, and the two impls' gradients against each
  other. The dense impl's convs keep cuDNN's TF32 off; its LNs reach row
  20's wrapper at every width.
- ``api.fit`` for a few CPU steps and ``Predictor`` from the port's
  checkpoint and from a JAX checkpoint directory, for each impl.

Each JAX model output is computed once per module (``_jax_forward``).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pcseg_tpu.ckpt.checkpoint import save_checkpoint as jax_save
from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu.ops import sparse as jsp
from pcseg_tpu.ops.losses import cross_entropy_sums as jax_ce
from pcseg_tpu.ops.voxel import devoxelize_nearest as jax_devox_nearest
from pcseg_tpu.ops.voxel import voxelize as jax_voxelize
from pcseg_tpu.train.optim import make_optimizer
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.ops import sparse as tsp
from pcseg_tpu_torch.ops.conv3d import conv3d, conv3d_transpose
from pcseg_tpu_torch.ops.losses import cross_entropy_sums
from pcseg_tpu_torch.ops.voxel import VoxelGrid, devoxelize_nearest
from tests.test_torch_sparse_unet import _numpy_vars, _points

torch.set_num_threads(1)

C, R = 4, 16
SMALL = dict(num_classes=C, grid_size=R, width=16, depth=2, levels=2)
LOGITS_REL = 4 * 2.0 ** -8
# f32 on both sides, the same products summed in another order
F32_REL = 1e-5
CAPS = (2048, 64, 24)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _grid():
    """The JAX f32 voxel grid of the test batch, and its torch copy."""
    pts, mask = _points()
    g = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), R, impl="scatter")
    tg = VoxelGrid(*(_t(v) for v in g))
    return (pts, mask), g, tg


@functools.lru_cache(maxsize=None)
def _sites(cap):
    _, g, tg = _grid()
    return jsp.sparse_from_grid(g, cap), tsp.sparse_from_grid(tg, cap)


def _torch_sp(sp):
    """A JAX SparseVoxels as the port's."""
    return tsp.SparseVoxels(*(_t(v) for v in sp[:5]), sp.grid_size)


def _assert_sites_equal(got, want):
    for name in ("ijk", "site_mask", "lookup", "dropped"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.grid_size == want.grid_size


@pytest.mark.parametrize("cap", CAPS)
def test_sparse_from_grid_matches_jax(cap):
    """ijk, site_mask, lookup (sentinel slot -1) and dropped equal; the
    site features are the grid's own values, gathered: equal."""
    want, got = _sites(cap)
    _assert_sites_equal(got, want)
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(want.feats))
    assert (got.lookup[:, -1] == -1).all()
    dropped = got.dropped.numpy()
    assert (dropped > 0).any() == (cap < 2048), dropped


@pytest.mark.parametrize("cap,coarse_cap", [(2048, 2048), (64, 64),
                                             (64, 16)])
def test_sparse_pool_matches_jax(cap, coarse_cap):
    """The pooled hierarchy, from the JAX fine level, equal; at 16 sites
    the coarse level drops too."""
    want, _ = _sites(cap)
    jc = jsp.sparse_pool(want, coarse_cap)
    tc = tsp.sparse_pool(_torch_sp(want), coarse_cap)
    _assert_sites_equal(tc, jc)
    assert tc.feats.shape == (2, coarse_cap, 0)
    assert (tc.dropped.numpy() > 0).any() == (coarse_cap == 16)


def test_offsets_follow_the_dense_kernel_layout():
    """The taps of ``subm_conv`` are ``_offsets`` (the JAX order) and the
    DHWIO reshape of ``subm_conv_dense``: the two convs agree at every
    active site on a kernel with no symmetry (test_sparse.py's JAX
    check)."""
    np.testing.assert_array_equal(tsp._offsets().numpy(),
                                  np.asarray(jsp._offsets()))
    np.testing.assert_array_equal(tsp._taps2().numpy(),
                                  np.asarray(jsp._taps2()))
    _, _, tg = _grid()
    sp = tsp.sparse_from_grid(tg, 2048)
    rng = np.random.default_rng(3)
    cin, cout = sp.feats.shape[-1], 5
    p = {"kernel": _t(rng.normal(size=(27, cin, cout)).astype(np.float32)),
         "bias": _t(rng.normal(size=cout).astype(np.float32))}
    got = tsp.subm_conv(p, sp)
    active = tg.counts > 0
    dense = tsp.subm_conv_dense(p, tg.features * active[..., None], active)
    for b in range(2):
        ijk = sp.ijk[b][sp.site_mask[b]].long()
        want = dense[b][ijk[:, 0], ijk[:, 1], ijk[:, 2]]
        torch.testing.assert_close(got[b][sp.site_mask[b]], want,
                                   rtol=0, atol=F32_REL * 10)


def _feats(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _conv_params(shape, seed):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6.0 / np.prod(shape[:-1]))
    return {"kernel": rng.uniform(-bound, bound, shape).astype(np.float32),
            "bias": (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _conv_cases():
    """(name, JAX fn, port fn, params, input) of the four convs: f(p, x)
    with the sites and grid of the test batch closed over; inputs random
    everywhere, capacity padding included (nothing may read it)."""
    _, g, tg = _grid()
    jf, _ = _sites(64)
    jc = jsp.sparse_pool(jf, 64)
    tf, tc = _torch_sp(jf), _torch_sp(jc)
    af, ac = jf.ijk.shape[1], jc.ijk.shape[1]
    active = np.asarray(g.counts) > 0
    grid_x = _feats((2, R, R, R, 8), 4) * active[..., None]
    ja, ta = jnp.asarray(active), _t(active)
    return [
        ("subm_conv", lambda p, x, dt: jsp.subm_conv(
            p, jf._replace(feats=x), compute_dtype=dt),
         lambda p, x, dt: tsp.subm_conv(p, tf._replace(feats=x),
                                        compute_dtype=dt),
         _conv_params((27, 8, 12), 5), _feats((2, af, 8), 6)),
        ("subm_conv_dense", lambda p, x, dt: jsp.subm_conv_dense(
            p, x, ja, compute_dtype=dt),
         lambda p, x, dt: tsp.subm_conv_dense(p, x, ta, compute_dtype=dt),
         _conv_params((27, 8, 12), 7), grid_x),
        ("sparse_down2x", lambda p, x, dt: jsp.sparse_down2x(
            p, x, jf, jc, compute_dtype=dt),
         lambda p, x, dt: tsp.sparse_down2x(p, x, tf, tc, compute_dtype=dt),
         _conv_params((2, 2, 2, 8, 16), 8), _feats((2, af, 8), 9)),
        ("sparse_up2x", lambda p, x, dt: jsp.sparse_up2x(
            p, x, jc, jf, compute_dtype=dt),
         lambda p, x, dt: tsp.sparse_up2x(p, x, tc, tf, compute_dtype=dt),
         _conv_params((2, 2, 2, 16, 8), 10), _feats((2, ac, 16), 11)),
    ]


CONVS = ["subm_conv", "subm_conv_dense", "sparse_down2x", "sparse_up2x"]


def _case(name):
    return next(c for c in _conv_cases() if c[0] == name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONVS)
def test_conv_forward_matches_jax(name, dtype):
    """f32 outputs of compute-dtype operands: the gather convs sum the same
    exact products in another order (1e-5 of max|ref|); the dense conv
    rounds its output to the compute dtype, as the JAX conv does (one
    bf16 ulp, 2^-8 of max|ref|, in bf16)."""
    _, jfn, tfn, p, x = _case(name)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = np.asarray(jfn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jdt))
    got = tfn({k: _t(v) for k, v in p.items()}, _t(x), tdt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = 2.0 ** -8 if (name == "subm_conv_dense" and
                        dtype == "bfloat16") else F32_REL
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), err
    assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("name", CONVS)
def test_conv_gradients_match_jax_vjp(name):
    """f32: the gradients of the kernel, the bias and the input against
    jax.vjp of the JAX function for one random cotangent, within 1e-5 of
    each gradient's max|ref|."""
    _, jfn, tfn, p, x = _case(name)
    f32 = jnp.float32
    out, vjp = jax.vjp(lambda pp, xx: jfn(pp, xx, f32),
                       jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    gy = _feats(out.shape, 12)
    jp, jx = vjp(jnp.asarray(gy))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    tfn(tp, tx, torch.float32).backward(_t(gy))
    for what, got, want in (("kernel", tp["kernel"].grad, jp["kernel"]),
                            ("bias", tp["bias"].grad, jp["bias"]),
                            ("input", tx.grad, jx)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= F32_REL * float(np.abs(want).max()), (what, err)


class _Tf32Seen(TorchDispatchMode):
    """Records cuDNN's TF32 flag at each convolution, forward or
    backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def _plain_conv3d(p, x, stride):
    w = p["kernel"].permute(4, 3, 0, 1, 2)
    pad = p["kernel"].shape[0] // 2 if stride == 1 else 0
    y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w,
                                   stride=stride, padding=pad)
    return y.permute(0, 2, 3, 4, 1) + p["bias"]


def _plain_conv3d_transpose(p, x):
    w = p["kernel"].flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    y = torch.nn.functional.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w,
                                             stride=2)
    return y.permute(0, 2, 3, 4, 1) + p["bias"]


@pytest.mark.parametrize("name", ["subm_conv_dense", "conv3d",
                                  "conv3d_transpose"])
def test_f32_convs_keep_tf32_off(name):
    """The masked-dense impl's convs (``subm_conv_dense`` and the down /
    up ``ops/conv3d`` convs) run cuDNN with TF32 off in the forward and
    the backward, with the process at PyTorch's default (TF32 on), and
    leave the flag as they found it; here on the CPU their values and
    gradients are F.conv3d's / F.conv_transpose3d's, bit for bit."""
    rng = np.random.default_rng(16)
    if name == "subm_conv_dense":
        shape, x = (27, 6, 5), _feats((2, 6, 6, 6, 6), 17)
    elif name == "conv3d":
        shape, x = (2, 2, 2, 6, 5), _feats((2, 6, 6, 6, 6), 17)
    else:
        shape, x = (2, 2, 2, 6, 5), _feats((2, 3, 3, 3, 6), 17)
    p = {"kernel": rng.normal(size=shape).astype(np.float32),
         "bias": rng.normal(size=shape[-1:]).astype(np.float32)}
    active = torch.ones(x.shape[:4], dtype=torch.bool)
    runs = []
    for port in (True, False):
        tp = {k: _t(v).requires_grad_() for k, v in p.items()}
        tx = _t(x).requires_grad_()
        if name == "subm_conv_dense":
            k = tp["kernel"].reshape(3, 3, 3, *shape[1:])
            y = tsp.subm_conv_dense(tp, tx, active) if port else \
                _plain_conv3d({"kernel": k, "bias": tp["bias"]}, tx, 1)
        elif name == "conv3d":
            y = conv3d(tp, tx, stride=2) if port else \
                _plain_conv3d(tp, tx, 2)
        else:
            y = conv3d_transpose(tp, tx) if port else \
                _plain_conv3d_transpose(tp, tx)
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with _Tf32Seen() as mode:
                y.backward(_t(_feats(y.shape, 18)))
            seen = list(mode.seen)
            with _Tf32Seen() as mode:
                if name == "subm_conv_dense":
                    tsp.subm_conv_dense(tp, tx, active)
                elif name == "conv3d":
                    conv3d(tp, tx, stride=2)
                else:
                    conv3d_transpose(tp, tx)
            seen += mode.seen
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = before
        if port:
            assert {n for n, _ in seen} == {"convolution",
                                            "convolution_backward"}, seen
            assert not any(flag for _, flag in seen), seen
        runs.append([y.detach(), tp["kernel"].grad, tp["bias"].grad,
                     tx.grad])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_layer_norm_and_readouts_match_jax():
    """site_layer_norm (f32 and bf16 rows), gather_point_logits and
    devoxelize_nearest on the test batch: the readouts gather, so they
    are equal; the LayerNorm within 1e-6 of max|ref| in f32 and one bf16
    ulp in bf16."""
    (pts, mask), g, tg = _grid()
    jf, tf = _sites(64)
    ln = {"scale": np.linspace(0.5, 1.5, 12, dtype=np.float32),
          "bias": np.linspace(-0.1, 0.1, 12, dtype=np.float32)}
    x = _feats((2, 64, 12), 13) * 3 + 1
    for dt, tol in ((jnp.float32, 1e-6), (jnp.bfloat16, 2.0 ** -8)):
        want = np.asarray(jsp.site_layer_norm(
            ln, jnp.asarray(x).astype(dt)).astype(jnp.float32))
        got = tsp.site_layer_norm({k: _t(v) for k, v in ln.items()},
                                  _t(x).to(getattr(torch, dt.dtype.name)))
        assert got.dtype == getattr(torch, dt.dtype.name)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= tol * float(np.abs(want).max()), err
    vals = _feats((2, 64, C), 14)
    want = np.asarray(jsp.gather_point_logits(
        jnp.asarray(vals), jf, jnp.asarray(pts), jnp.asarray(mask)))
    got = tsp.gather_point_logits(_t(vals), tf, _t(pts), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[~_t(mask)].any()
    grid_vals = _feats((2, R, R, R, C), 15)
    want = np.asarray(jax_devox_nearest(jnp.asarray(grid_vals),
                                        jnp.asarray(pts), jnp.asarray(mask),
                                        g.lo, g.scale))
    got = devoxelize_nearest(_t(grid_vals), _t(pts), _t(mask), tg.lo,
                             tg.scale)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the models

MODELS = [("gather", "bfloat16", 2048), ("gather", "bfloat16", 64),
          ("gather", "float32", 2048), ("gather", "float32", 64),
          ("dense", "bfloat16", 2048), ("dense", "float32", 2048)]


def _kw(impl, dtype, cap):
    return dict(SMALL, impl=impl, compute_dtype=dtype, max_active=cap)


@functools.lru_cache(maxsize=None)
def _variables():
    return _numpy_vars(JaxSparseVoxelNet(**_kw("gather", "float32", 2048)),
                       0)


@functools.lru_cache(maxsize=None)
def _jax_forward(impl, dtype, cap):
    """The JAX model's logits, dropped counts and overflow_counts."""
    jm = JaxSparseVoxelNet(**_kw(impl, dtype, cap), fused_ln="interpret")
    pts, mask = _points()
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    logits, dropped = jm.apply(_variables(), jp, mask=jmask,
                               return_overflow=True)
    return (np.asarray(logits), np.asarray(dropped),
            np.asarray(jm.overflow_counts(jp, jmask)))


def _port(kw):
    model = SparseVoxelNet(**kw)
    model.load_state_dict(from_jax_variables(_variables()))
    return model


@pytest.mark.parametrize("impl,dtype,cap", MODELS)
def test_model_matches_jax(impl, dtype, cap):
    """Logits within 4 * 2^-8 of max|logit| in bf16 (the block test's
    bound), 1e-5 in f32; masked rows exactly 0; the forward's dropped
    count and overflow_counts equal the JAX model's (sites past 64 drop
    at level 0; the dense impl drops nothing)."""
    want, jdropped, jcounts = _jax_forward(impl, dtype, cap)
    pts, mask = _points()
    model = _port(_kw(impl, dtype, cap))
    tp, tm = _t(pts), _t(mask)
    got, dropped = model(tp, tm, return_overflow=True)
    got = got.numpy()
    err = float(np.abs(got - want).max())
    rel = LOGITS_REL if dtype == "bfloat16" else F32_REL
    assert got.shape == want.shape and np.isfinite(got).all()
    assert err <= rel * float(np.abs(want).max()), err
    assert not got[~mask].any()
    np.testing.assert_array_equal(dropped.numpy(), jdropped)
    np.testing.assert_array_equal(model.overflow_counts(tp, tm).numpy(),
                                  jcounts)
    assert (jdropped.sum() > 0) == (impl == "gather" and cap == 64)


def test_dense_and_gather_agree_in_capacity():
    """In f32 with no site dropped the two impls compute the same function
    (the JAX package's own check, test_sparse.py): 1e-5 of scale."""
    pts, mask = _points()
    a = _port(_kw("dense", "float32", 2048))(_t(pts), _t(mask))
    b = _port(_kw("gather", "float32", 2048))(_t(pts), _t(mask))
    err = float((a - b).abs().max())
    assert err <= F32_REL * float(b.abs().max()), err


def test_dense_ln_runs_row_20_at_any_width(monkeypatch):
    """The dense impl sends every LN to row 20's wrapper with the caller's
    ``plain`` flag at any width, 12 and 24 channels too (the JAX package's
    C % 8 gate is a TPU lane limit; the CUDA kernel takes any C)."""
    from pcseg_tpu_torch.models import sparse_unet

    calls = []
    real = sparse_unet.ln_relu_mask

    def spy(x, *args, plain=False):
        calls.append((x.shape[-1], plain))
        return real(x, *args, plain=plain)

    monkeypatch.setattr(sparse_unet, "ln_relu_mask", spy)
    pts, mask = _points()
    model = SparseVoxelNet(num_classes=C, grid_size=8, width=12, depth=1,
                           levels=2, impl="dense", compute_dtype="float32")
    model(_t(pts), _t(mask))
    assert calls == [(12, False), (24, False), (24, False), (12, False)]
    calls.clear()
    model(_t(pts), _t(mask), plain=True)
    assert {p for _, p in calls} == {True}


def _labels(mask):
    labels = np.random.default_rng(11).integers(0, C, mask.shape)
    return np.where(mask, labels, -1)


@pytest.mark.parametrize("impl,cap", [("gather", 64), ("dense", 2048)])
def test_train_step_gradients_match_jax(impl, cap):
    """One f32 train step (weighted CE): the loss within 1e-5 relative and
    every parameter's gradient within 1e-4 of its max|ref| (+1e-7) of
    ``jax.value_and_grad`` of the JAX model; the gather impl's aux holds
    the dropped counts, the dense impl's is empty."""
    kw = _kw(impl, "float32", cap)
    jm = JaxSparseVoxelNet(**kw, fused_ln="interpret")
    pts, mask = _points()
    labels = _labels(mask)
    cw = np.array([1.0, 2.0, 0.5, 1.5], np.float32)

    def loss_fn(params):
        logits, aux = jm.apply({"params": params, "batch_stats": {}},
                               jnp.asarray(pts), train=True,
                               mask=jnp.asarray(mask))
        num, den = jax_ce(logits, jnp.asarray(labels), jnp.asarray(cw))
        return num / den, aux

    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, _variables()["params"]))
    model = _port(kw)
    logits, aux = model.apply(_t(pts), train=True, mask=_t(mask))
    num, den = cross_entropy_sums(logits, _t(labels), _t(cw))
    loss = num / den
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    assert aux.keys() == jaux.keys()
    if impl == "gather":
        np.testing.assert_array_equal(aux["__overflow__"].numpy(),
                                      np.asarray(jaux["__overflow__"]))
    grads = dict(model.named_parameters())
    for name, group in jgrads.items():
        for leaf, want in group.items():
            want = np.asarray(want)
            got = grads[f"{name}.{leaf}"].grad.numpy()
            err = float(np.abs(got - want).max())
            tol = 1e-4 * float(np.abs(want).max()) + 1e-7
            assert err <= tol, (f"{name}.{leaf}", err, tol)


def test_dense_and_gather_gradients_agree():
    """In f32 with no site dropped one train step of the two impls on the
    same weights and batch: the same function, so every parameter's
    gradient within 1e-4 of its max (+1e-7), as each is held to JAX's."""
    pts, mask = _points()
    labels = _t(_labels(mask))
    cw = torch.tensor([1.0, 2.0, 0.5, 1.5])
    grads = []
    for impl in ("dense", "gather"):
        model = _port(_kw(impl, "float32", 2048))
        logits, _ = model.apply(_t(pts), train=True, mask=_t(mask))
        num, den = cross_entropy_sums(logits, labels, cw)
        (num / den).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        tol = 1e-4 * float(want.abs().max()) + 1e-7
        assert err <= tol, (name, err, tol)


def _events(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for m in rng.integers(150, 400, n):
        p = track_events(1, int(m), rng)[0]
        out.append((p, rng.integers(0, C, p.shape[0])))
    return out


def _overrides(impl, tmp_path, cap=2048):
    return ["model.name=sparse_voxelnet", f"model.grid_size={R}",
            "model.unet_width=16", "model.depth=2", "model.levels=2",
            f"model.impl={impl}", f"model.max_active={cap}",
            "model.compute_dtype=bfloat16", "data.batch_size=4",
            "data.buckets=512", "train.num_epochs=2",
            f"train.checkpoint_dir={tmp_path}"]


def _jax_dir(path, impl, variables):
    """A JAX TrainState directory of the impl, as the JAX train_model
    writes one."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.asarray(5, jnp.int32), params=params,
                          batch_stats={},
                          opt_state=make_optimizer().init(params))
    cfg = JaxModelConfig(name="sparse_voxelnet", grid_size=R, unet_width=16,
                         depth=2, levels=2, impl=impl, max_active=2048,
                         compute_dtype="bfloat16")
    jax_save(path, state, {"epoch": 1, "num_classes": C,
                           "config": {"model": dataclasses.asdict(cfg)}})
    return path


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_fit_and_serve(impl, tmp_path):
    """api.fit on the CPU (2 epochs of 3 steps of B4), finite losses and
    no dropped site; the best checkpoint served by Predictor gives the
    trained model's logits; a JAX directory of the impl serves with the
    logits of its carried weights."""
    events = _events(16, 2)
    res = api.fit(events, overrides=_overrides(impl, tmp_path / "ck"),
                  device="cpu", log=lambda _: None)
    assert len(res.history) == 2
    for h in res.history:
        assert np.isfinite([h["train_loss"], h["val_loss"]]).all()
        assert h["train_steps"] == 3
        assert h["dropped_train"] == h["dropped_val"] == 0
    assert res.state.model.impl == impl
    pred = Predictor.from_checkpoint(res.checkpoint_path, device="cpu")
    assert pred.model.impl == impl and pred.model.max_active == 2048
    pts = events[0][0]
    want = pred.model(_t(pts[None]))[0].numpy()
    np.testing.assert_array_equal(pred.logits(pts), want)

    variables = _variables()
    path = _jax_dir(str(tmp_path / "jax_ck"), impl, variables)
    served = Predictor.from_checkpoint(path, device="cpu")
    ref = Predictor(from_jax_variables(variables), C,
                    model=build_model(ModelConfig(
                        name="sparse_voxelnet", grid_size=R, unet_width=16,
                        depth=2, levels=2, impl=impl,
                        compute_dtype="bfloat16"), C), device="cpu")
    assert served.model.impl == impl
    for p, _ in events[:3]:
        assert served.logits(p).tobytes() == ref.logits(p).tobytes()


def test_gather_capacity_overflow_names_sites(tmp_path):
    """Past max_active the gather impl's Predictor warns (raises with
    strict_capacity) naming sites and max_active, and so does the train
    loop; the dense impl never drops."""
    variables = _variables()
    event = _points()[0][0]
    kw = _kw("gather", "bfloat16", 24)
    pred = Predictor(from_jax_variables(variables), C,
                     model=SparseVoxelNet(**kw), device="cpu")
    with pytest.warns(UserWarning, match="occupied sites.*max_active"):
        assert pred.predict(event).shape == (event.shape[0],)
    strict = Predictor(from_jax_variables(variables), C,
                       model=SparseVoxelNet(**kw), device="cpu",
                       strict_capacity=True)
    with pytest.raises(RuntimeError, match="sites"):
        strict.predict_batch([event, event[:100]])
    dense = Predictor(from_jax_variables(variables), C,
                      model=SparseVoxelNet(**_kw("dense", "bfloat16", 24)),
                      device="cpu", strict_capacity=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dense.predict_batch([event, event[:100]])
    with pytest.raises(RuntimeError, match="occupied sites.*max_active"):
        api.fit(_events(8, 3),
                overrides=_overrides("gather", tmp_path, cap=24)
                + ["model.strict_capacity=true", "train.num_epochs=1"],
                device="cpu", log=lambda _: None)
