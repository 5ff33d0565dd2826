"""Dropout with counter-based masks: a CUDA kernel + its plain version.

Counterpart of pcseg_tpu/ops/pallas/dropout.py (``pallas_dropout`` /
``dropout``). The keep rule and the scale are the TPU kernel's:
``keep = bits >= floor(rate * 2^32)`` on 32 random bits per element, kept
values scaled by ``1 / (1 - rate)`` in the input's dtype. The bits cannot
be the TPU hardware PRNG's; here they are a hash of ``(seed, global
element index)``:

    key  = mix32(seed ^ 0x9E3779B9)
    bits = mix32(mix32(lo32(idx) ^ key) ^ hi32(idx))

with ``mix32`` the lowbias32 integer finaliser. The mask therefore depends
on neither the launch's tiling nor the device, the backward regenerates it
exactly from the seed (nothing is stored), and the plain version computes
the same bits in int64 torch ops: every product is reduced to 32 bits,
with the constant split into 16-bit halves so no product passes 2^48.

The same bits drive the dropout inside the fused PointNet blocks
(ops/fused_block.py), where ``idx`` is ``row * Cin + column`` of the
block's input.

``dropout`` runs the kernel (csrc/pointnet_fused.cu, ``pcseg_dropout``) on
a CUDA tensor and the plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B

# launches since the last reset (forward and backward each count one)
LAUNCHES = {"dropout": 0}


def reset_launches() -> None:
    LAUNCHES["dropout"] = 0


def _mix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The per-launch 32-bit key of a seed (the kernels take the key)."""
    return _mix32_int((int(seed) & _M32) ^ 0x9E3779B9)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without passing 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def hash_bits(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """32 random bits (as int64 in [0, 2^32)) per int64 element index."""
    h = _mix32((idx & _M32) ^ seed_key(seed))
    return _mix32(h ^ (idx >> 32))


def threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def keep_mask(seed: int, rate: float, shape, device, offset: int = 0):
    """Boolean keep mask of ``shape`` for elements ``offset + flat index``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return (hash_bits(seed, idx) >= threshold(rate)).reshape(shape)


def dropout_plain(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    keep = keep_mask(seed, rate, x.shape, x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _dropout_cuda(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout input must be contiguous")
    out = torch.empty_like(x)
    rc = load_library("pointnet_fused").pcseg_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), seed_key(seed),
        threshold(rate), 1.0 / (1.0 - rate), int(x.dtype == torch.bfloat16),
        stream_of(x),
    )
    raise_on(rc, "dropout")
    LAUNCHES["dropout"] += 1
    return out


def _run(x, seed, rate, plain):
    if on_cuda(x, plain):
        return _dropout_cuda(x, seed, rate)
    return dropout_plain(x, seed, rate)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, plain):
        ctx.seed, ctx.rate, ctx.plain = seed, rate, plain
        return _run(x, seed, rate, plain)

    @staticmethod
    def backward(ctx, g):
        # same seed -> same mask; the scale applies to the cotangent alike
        return _run(g.contiguous(), ctx.seed, ctx.rate, ctx.plain), None, \
            None, None


def dropout(x: torch.Tensor, seed: int, rate: float, *,
            plain: bool = False) -> torch.Tensor:
    """Dropout of ``x`` with the mask of ``seed`` (a 32-bit int).

    ``plain=True`` runs the plain version on any device (the on-card
    reference of chip_smoke.py)."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x.contiguous(), int(seed), float(rate), plain)
