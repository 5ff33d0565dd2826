"""The port's dropout (ops/dropout.py): counter-based masks, the plain
version's forward and backward, and the mask hash against a numpy
uint32 model of the CUDA kernel's arithmetic.

The JAX package's masks come from the TPU's hardware PRNG (or threefry
off the TPU) and cannot be matched; what is held is the op's contract:
keep iff bits >= floor(rate * 2^32), kept values scaled by 1 / (1 - rate)
in the input's dtype, the backward regenerating the forward's mask.
Tolerances: everything here is elementwise with the same operations on
both sides, so results are compared exactly; the keep share of 2^20
draws is held to within 1 % of 1 - rate.
"""

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.ops import dropout as dr

torch.set_num_threads(1)

RATE = 0.3


def _mix32_np(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_hash_matches_uint32_arithmetic():
    """The plain version's int64 emulation equals wrapping uint32
    arithmetic (what the CUDA kernel computes), indices past 2^32
    included."""
    seed = 987654321
    idx = np.concatenate([np.arange(4096), 2 ** 32 + np.arange(-50, 50),
                          np.array([2 ** 40 + 3, 2 ** 47 - 1])]).astype(
        np.uint64)
    with np.errstate(over="ignore"):
        key = _mix32_np(np.array([(seed & 0xFFFFFFFF) ^ 0x9E3779B9],
                                 np.uint64))[0]
        lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (idx >> np.uint64(32)).astype(np.uint32)
        ref = _mix32_np(_mix32_np(lo ^ key) ^ hi)
    got = dr.hash_bits(seed, torch.tensor(idx.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert dr.seed_key(seed) == int(key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_backward_against_masked_multiply(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 64, 256), generator=gen).to(dtype).requires_grad_()
    g = torch.randn((4, 64, 256), generator=gen).to(dtype)
    out = dr.dropout(x, 42, RATE)
    out.backward(g)
    keep = dr.keep_mask(42, RATE, x.shape, "cpu")
    scale = torch.tensor(1.0 / (1.0 - RATE), dtype=dtype)
    xr = x.detach().clone().requires_grad_()
    ref = xr * (keep.to(dtype) * scale)
    ref.backward(g)
    assert out.dtype == dtype
    assert torch.equal(out.detach(), ref.detach())
    assert torch.equal(x.grad, xr.grad)
    assert bool((g != 0).all()) and torch.equal(x.grad == 0, ~keep)


def test_keep_share_and_seeds():
    shape = (16, 256, 256)                    # 2^20 draws
    keep = dr.keep_mask(7, RATE, shape, "cpu")
    assert abs(float(keep.float().mean()) - (1.0 - RATE)) < 0.01
    assert torch.equal(keep, dr.keep_mask(7, RATE, shape, "cpu"))
    other = dr.keep_mask(8, RATE, shape, "cpu")
    assert 0.3 < float((keep != other).float().mean()) < 0.5
    # the threshold rule: bits >= floor(rate * 2^32)
    assert dr.threshold(RATE) == int(RATE * 2 ** 32)
    assert dr.threshold(1.0) == 2 ** 32 - 1


def test_rate_zero_is_identity():
    x = torch.randn(3, 5)
    assert dr.dropout(x, 1, 0.0) is x
