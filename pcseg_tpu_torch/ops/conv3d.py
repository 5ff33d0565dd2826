"""3D convolution blocks of the voxel U-Net, plain PyTorch.

Counterpart of pcseg_tpu/ops/conv3d.py. Activations stay NDHWC and
kernels DHWIO at every public function, as in the JAX package; the
permutes to PyTorch's NCDHW / OIDHW happen only inside these functions.
Padding is XLA's "SAME".

Every conv here runs through ``convolution``, which keeps cuDNN's TF32
off in its forward and its backward: PyTorch lets cuDNN take TF32 for
f32 convs by default, and an f32 compute dtype means f32 sums, as in
the JAX package.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _cudnn_without_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` (no bias, dilation 1, one group), its forward
    and its backward run with cuDNN's TF32 off."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = ([stride] * 3, [padding] * 3, transposed)
        with _cudnn_without_tf32():
            return torch.ops.aten.convolution(
                x, w, None, [stride] * 3, [padding] * 3, [1] * 3,
                transposed, [0] * 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conf
        with _cudnn_without_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, [1] * 3, transposed,
                [0] * 3, 1, [ctx.needs_input_grad[0],
                             ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


def convolution(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0, transposed: bool = False) -> torch.Tensor:
    """``F.conv3d`` (``F.conv_transpose3d`` with ``transposed``) of NCDHW
    x and w, with f32 sums in f32: cuDNN's TF32 off, whatever the process
    set."""
    return _Convolution.apply(x, w, stride, padding, transposed)


def conv3d_init(k: int, cin: int, cout: int,
                generator: torch.Generator | None = None) -> dict:
    """He-uniform kernel (DHWIO) + zero bias."""
    bound = math.sqrt(6.0 / (k * k * k * cin))
    u = torch.rand((k, k, k, cin, cout), generator=generator)
    return {"kernel": u * (2 * bound) - bound, "bias": torch.zeros(cout)}


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv3d(p: dict, x: torch.Tensor, stride: int = 1,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """SAME conv, NDHWC in and out; math in ``compute_dtype``."""
    dt = compute_dtype or x.dtype
    k = p["kernel"].shape[0]
    pads: list[int] = []
    for n in reversed(x.shape[1:4]):        # F.pad wants W first
        pads.extend(_same_pad(n, k, stride))
    xt = F.pad(x.to(dt).permute(0, 4, 1, 2, 3), pads)
    w = p["kernel"].to(dt).permute(4, 3, 0, 1, 2)
    y = convolution(xt, w, stride).permute(0, 2, 3, 4, 1)
    return y + p["bias"].to(y.dtype)


def conv3d_transpose(p: dict, x: torch.Tensor, stride: int = 2,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """k=stride SAME transposed conv: output ``s*i + d`` takes
    ``x[i] @ w[k-1-d]`` per axis (the JAX ``lax.conv_transpose``
    convention, which does not flip the kernel the way
    ``F.conv_transpose3d`` does, hence the flip here)."""
    dt = compute_dtype or x.dtype
    k = p["kernel"].shape[0]
    if k != stride:
        raise ValueError(f"conv3d_transpose needs kernel == stride, got "
                         f"{k} vs {stride}")
    w = p["kernel"].to(dt).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    y = convolution(x.to(dt).permute(0, 4, 1, 2, 3), w, stride,
                    transposed=True)
    y = y.permute(0, 2, 3, 4, 1)
    return y + p["bias"].to(y.dtype)


def group_norm_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def num_groups(c: int, groups: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def group_norm(p: dict, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """Two-pass GroupNorm over (D, H, W, C/g) per sample."""
    b, d, h, w, c = x.shape
    g = num_groups(c, groups)
    xf = x.float().reshape(b, d, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 3, 5), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3, 5), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(b, d, h, w, c) * p["scale"] + p["bias"]
    return y.to(x.dtype)
