"""The raw block-sparse 3^3 conv of the port (``ops/block_conv.py``
``block_conv_plain``, the CPU form of csrc/block_conv.cu) against the JAX
package's Pallas kernel in interpret mode (``ops/pallas/block_conv.py``
``block_conv``) and its XLA halo form (``block_subm_conv(raw=True)``), on
the same tiles, slot table, features and weights (numpy).

Small size: grid 16, tile 4, B2 x 512 track events, capacity 48 tiles.
Tolerances: f32 within 1e-5 of the output's scale; bf16 within one bf16
ulp at the output's scale (the same f32 sums in another order may round
to the neighbouring bf16 value). Capacity-padding rows are exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.block_sparse import (
    _gather_halo_slots,
    _neighbor_slots,
    block_subm_conv,
)
from pcseg_tpu.ops.block_sparse import (
    block_sparse_voxelize as jax_block_sparse_voxelize,
)
from pcseg_tpu.ops.pallas.block_conv import block_conv as jax_block_conv
from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.ops import block_conv as bc

torch.set_num_threads(1)

R, T, CAP, COUT = 16, 4, 48, 16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def tiles():
    pts = track_events(2, 512, 0)
    mask = np.ones(pts.shape[:2], bool)
    bs, _, _ = jax_block_sparse_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                         R, CAP, T)
    return bs, np.array(_neighbor_slots(bs, +1))


def _inputs(bs, cin, seed):
    rng = np.random.default_rng(seed)
    tmask = np.asarray(bs.tile_mask)
    b, nt = tmask.shape
    x = rng.normal(size=(b, nt, T ** 3, cin)).astype(np.float32)
    x *= tmask[..., None, None]                 # padding rows are zero
    bound = np.sqrt(6.0 / (27 * cin))
    kernel = rng.uniform(-bound, bound, (27, cin, COUT)).astype(np.float32)
    return x, kernel


def _ulp_tol(ref, dtype):
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _port(x, slots, kernel, dtype):
    cin = x.shape[-1]
    got = bc.block_conv(torch.from_numpy(x).to(TDT[dtype]),
                        torch.from_numpy(slots),
                        torch.from_numpy(kernel.reshape(27 * cin, COUT)))
    assert got.dtype == TDT[dtype]
    return got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [2, 8])
def test_block_conv_plain_matches_pallas_kernel(tiles, cin, dtype):
    bs, slots = tiles
    x, kernel = _inputs(bs, cin, seed=cin)
    jdt = JDT[dtype]
    want = np.asarray(jax_block_conv(
        jnp.asarray(x, jdt), jnp.asarray(slots),
        jnp.asarray(kernel.reshape(27 * cin, COUT), jdt), True),
        np.float32)
    got = _port(x, slots, kernel, dtype)
    err = float(np.abs(got - want).max())
    assert err <= _ulp_tol(want, dtype), err
    tmask = np.asarray(bs.tile_mask)
    assert not got[~tmask].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [2, 8])
def test_block_conv_plain_matches_xla_halo_form(tiles, cin, dtype):
    bs, slots = tiles
    x, kernel = _inputs(bs, cin, seed=10 + cin)
    b, nt = slots.shape[:2]
    jdt = JDT[dtype]
    p = {"kernel": jnp.asarray(kernel), "bias": jnp.zeros(COUT)}
    want = np.asarray(block_subm_conv(
        p, bs, feats=jnp.asarray(x.reshape(b, nt, T, T, T, cin), jdt),
        compute_dtype=jdt, raw=True), np.float32).reshape(b, nt, T ** 3, COUT)
    got = _port(x, slots, kernel, dtype)
    assert float(np.abs(got - want).max()) <= _ulp_tol(want, dtype)


def test_halo_gather_matches_jax(tiles):
    bs, slots = tiles
    x, _ = _inputs(bs, 3, seed=5)
    b, nt = slots.shape[:2]
    x6 = x.reshape(b, nt, T, T, T, 3)
    want = np.asarray(_gather_halo_slots(jnp.asarray(x6), jnp.asarray(slots),
                                         T, impl="gather"))
    got = bc.gather_halo_slots(torch.from_numpy(x6), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_conv_refuses_other_devices():
    x = torch.zeros((1, 1, 8, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        bc.block_conv(x.to("meta"), torch.zeros((1, 1, 27), dtype=torch.int32,
                                                device="meta"),
                      torch.zeros((54, 16), device="meta"))


def _cotangent(bs, cout, seed):
    """A cotangent of the conv's output, zero on capacity-padding rows
    (the rows the backward's LN gives zero)."""
    tmask = np.asarray(bs.tile_mask)
    g = np.random.default_rng(seed).normal(
        size=tmask.shape + (T ** 3, cout)).astype(np.float32)
    return g * tmask[..., None, None]


def _port_vjp(x, slots, kernel, g, dtype):
    """The port's dx and dW through autograd of ``block_conv`` (its plain
    dgrad and wgrad on the CPU)."""
    cin, cout = kernel.shape[1:]
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    tw = torch.from_numpy(kernel.reshape(27 * cin, cout)).to(
        TDT[dtype]).requires_grad_()
    y = bc.block_conv(tx, torch.from_numpy(slots), tw)
    y.backward(torch.from_numpy(g).to(TDT[dtype]))
    assert tx.grad.dtype == tw.grad.dtype == TDT[dtype]
    return tx.grad.float().numpy(), tw.grad.float().numpy()


@pytest.fixture(scope="module")
def dropping_tiles():
    """The same events at a capacity that drops tiles."""
    pts = track_events(2, 512, 0)
    mask = np.ones(pts.shape[:2], bool)
    bs, _, _ = jax_block_sparse_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                         R, 12, T)
    assert int(np.asarray(bs.dropped).sum()) > 0
    return bs, np.array(_neighbor_slots(bs, +1))


@pytest.mark.parametrize("which,dtype", [("tiles", "bfloat16"),
                                         ("dropping_tiles", "float32")])
def test_block_conv_vjp_matches_pallas_kernel(request, which, dtype):
    """dgrad and wgrad against ``jax.vjp`` of the Pallas block conv in
    interpret mode, at 16 channels in and out (lane-legal at t = 4); with
    dropped tiles too, where only the kept tiles' slot tables are
    adjoint."""
    import jax

    bs, slots = request.getfixturevalue(which)
    x, kernel = _inputs(bs, 16, seed=20)
    g = _cotangent(bs, COUT, seed=21)
    jdt = JDT[dtype]
    _, vjp = jax.vjp(lambda f, w: jax_block_conv(f, jnp.asarray(slots), w,
                                                 True),
                     jnp.asarray(x, jdt),
                     jnp.asarray(kernel.reshape(27 * 16, COUT), jdt))
    want_dx, want_dw = (np.asarray(w, np.float32)
                        for w in vjp(jnp.asarray(g, jdt)))
    dx, dw = _port_vjp(x, slots, kernel, g, dtype)
    print(f"block_conv vjp {which} {dtype}: dx max|err| "
          f"{float(np.abs(dx - want_dx).max()):.3e}, dW max|err| "
          f"{float(np.abs(dw - want_dw).max()):.3e}")
    assert float(np.abs(dx - want_dx).max()) <= _ulp_tol(want_dx, dtype)
    assert float(np.abs(dw - want_dw).max()) <= _ulp_tol(want_dw, dtype)
    assert not dx[~np.asarray(bs.tile_mask)].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_vjp_matches_xla_halo_form(tiles, dtype):
    """Cin 2 (the stem) and Cout 24, shapes the Pallas kernel's lanes do
    not take: dgrad and wgrad against ``jax.vjp`` of the XLA halo form
    (``block_subm_conv(raw=True)``), on the real tiles."""
    import jax

    bs, slots = tiles
    cin, cout = 2, 24
    rng = np.random.default_rng(30)
    tmask = np.asarray(bs.tile_mask)
    b, nt = tmask.shape
    x = (rng.normal(size=(b, nt, T ** 3, cin)) * tmask[..., None, None])
    x = x.astype(np.float32)
    bound = np.sqrt(6.0 / (27 * cin))
    kernel = rng.uniform(-bound, bound, (27, cin, cout)).astype(np.float32)
    g = (rng.normal(size=(b, nt, T ** 3, cout))
         * tmask[..., None, None]).astype(np.float32)
    jdt = JDT[dtype]

    def f(feats, kern):
        p = {"kernel": kern, "bias": jnp.zeros(cout)}
        y = block_subm_conv(p, bs, feats=feats.reshape(b, nt, T, T, T, cin),
                            compute_dtype=jdt, raw=True)
        return y.reshape(b, nt, T ** 3, cout)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(kernel, jdt))
    want_dx, want_dw = (np.asarray(w, np.float32)
                        for w in vjp(jnp.asarray(g, jdt)))
    dx, dw = _port_vjp(x, slots, kernel, g, dtype)
    want_dw = want_dw.reshape(27 * cin, cout)
    assert float(np.abs(dx - want_dx)[tmask].max()) <= _ulp_tol(want_dx,
                                                               dtype)
    assert float(np.abs(dw - want_dw).max()) <= _ulp_tol(want_dw, dtype)


def test_block_conv_stem_takes_no_dgrad(tiles):
    """A conv whose input needs no gradient (the stem's voxelized data)
    runs no dgrad: the weights get their gradient, the input none."""
    bs, slots = tiles
    x, kernel = _inputs(bs, 2, seed=40)
    tw = torch.from_numpy(kernel.reshape(54, COUT)).requires_grad_()
    bc.reset_launches()
    y = bc.block_conv(torch.from_numpy(x), torch.from_numpy(slots), tw)
    y.sum().backward()
    assert tw.grad is not None and tw.grad.shape == (54, COUT)
    assert bc.LAUNCHES == {"block_conv": 0, "block_conv_dgrad": 0,
                           "block_conv_wgrad": 0, "block_conv_mma": 0,
                           "block_conv_dgrad_mma": 0,
                           "block_conv_wgrad_mma": 0}
