"""Fused conv-bias + LayerNorm + affine + ReLU + active-mask, forward and
backward (counterpart of pcseg_tpu/ops/pallas/fused_ln.py).

``bias_ln_relu_mask`` takes the RAW conv output of the sparse U-Net's
block stack, x (N, C), and per row computes in f32

    xb = x + pre_bias (the conv's bias, folded in)
    mean, var: single-pass moments over C, var = max(E[xb^2] - mean^2, 0)
    z = (xb - mean) * rsqrt(var + eps) * scale + bias
    out = active ? max(z, 0) : 0, rounded once to ``out_dtype``.

It is differentiable (the JAX custom VJP): the backward recomputes the
moments from x and gives, from the cotangent g of out,

    dz = active && z > 0 ? g : 0,  x_hat = (xb - mean) * rstd
    dx = rstd * (dz * scale - mean(dz * scale)
                 - x_hat * mean(dz * scale * x_hat)), rounded to x's dtype
    dscale = sum dz * x_hat, dbias = sum dz, dpre_bias = sum dx (f32 column
    sums over the N rows, dx before its rounding).

On a CUDA tensor the forward launches ``pcseg_bias_ln_relu_mask`` and the
backward ``pcseg_bias_ln_relu_mask_bwd`` (csrc/fused_ln.cu, lane groups
of a warp a row, any C; the backward on 8 channels a lane with vector
loads where C is a multiple of 8 up to 256, ``bwd_route``); on a CPU
tensor they run ``bias_ln_relu_mask_plain`` and
``bias_ln_relu_mask_bwd_plain``, the same formulas in PyTorch.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    define_op,
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

# launches since the last reset_launches(); a wrapper adds one where it
# launches its kernel and nowhere else
# (``bias_ln_relu_mask_bwd_vec`` counts the backward launches that took
# the vector route; every backward launch also counts as
# ``bias_ln_relu_mask_bwd``)
LAUNCHES = {"bias_ln_relu_mask": 0, "bias_ln_relu_mask_bwd": 0,
            "bias_ln_relu_mask_bwd_vec": 0}
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _moments(x: torch.Tensor, pre_bias: torch.Tensor, eps: float):
    xf = x.float() + pre_bias.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return xf, mean, torch.rsqrt(var + eps)


def bias_ln_relu_mask_plain(x: torch.Tensor, pre_bias: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            active: torch.Tensor, eps: float = 1e-5,
                            out_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """The kernel's formula in PyTorch, f32 throughout, one rounding."""
    xf, mean, rstd = _moments(x, pre_bias, eps)
    z = (xf - mean) * rstd * scale.float() + bias.float()
    keep = active.reshape(-1, 1).to(torch.bool) & (z > 0.0)
    return torch.where(keep, z, torch.zeros_like(z)).to(out_dtype)


def bias_ln_relu_mask_bwd_plain(x, pre_bias, scale, bias, active, g,
                                eps: float = 1e-5):
    """The backward kernel's formulas in PyTorch: (dx in x's dtype,
    dpre_bias, dscale, dbias in f32)."""
    xf, mean, rstd = _moments(x, pre_bias, eps)
    x_hat = (xf - mean) * rstd
    z = x_hat * scale.float() + bias.float()
    keep = active.reshape(-1, 1).to(torch.bool) & (z > 0.0)
    dz = torch.where(keep, g.float(), torch.zeros_like(z))
    dxhat = dz * scale.float()
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - x_hat * (dxhat * x_hat).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype), dx.sum(dim=0), (dz * x_hat).sum(dim=0),
            dz.sum(dim=0))


def _checked(x, pre_bias, scale, bias, active):
    """Shared checks of both kernels' operands; the three vectors as f32
    and the mask as bool, contiguous on x's device."""
    n, c = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"bias_ln_relu_mask takes bf16 or f32, got "
                         f"{x.dtype}")
    if c < 1 or n == 0:
        raise ValueError(f"bias_ln_relu_mask takes at least one channel and "
                         f"one row, got {tuple(x.shape)}")
    if tuple(active.shape) != (n,):
        raise ValueError(f"active must be ({n},), got {tuple(active.shape)}")
    vecs = [v.to(device=x.device, dtype=torch.float32).contiguous()
            for v in (pre_bias, scale, bias)]
    if any(tuple(v.shape) != (c,) for v in vecs):
        raise ValueError(f"pre_bias, scale and bias must be ({c},)")
    return vecs, active.to(device=x.device, dtype=torch.bool).contiguous()


def bias_ln_relu_mask_fwd(x: torch.Tensor, pre_bias: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          active: torch.Tensor, eps: float = 1e-5,
                          out_dtype: torch.dtype = torch.bfloat16, *,
                          plain: bool = False) -> torch.Tensor:
    """The forward without a graph: x (N, C) bf16 or f32; pre_bias, scale,
    bias (C,); active (N,) bool -> (N, C) ``out_dtype`` (bf16 or f32).
    The registered op ``pcseg::bias_ln_relu_mask``: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor (or with ``plain``)."""
    if plain:
        return bias_ln_relu_mask_plain(x, pre_bias, scale, bias, active, eps,
                                       out_dtype)
    on_cuda(x)                    # refuses a device other than CPU or CUDA
    return _fwd_op(x, pre_bias, scale, bias, active, eps, out_dtype)


def bias_ln_relu_mask_cuda(x, pre_bias, scale, bias, active, eps=1e-5,
                           out_dtype=torch.bfloat16):
    """The forward kernel's launch (arguments as ``bias_ln_relu_mask_fwd``,
    every tensor on one CUDA device)."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"bias_ln_relu_mask writes bf16 or f32, got "
                         f"{out_dtype}")
    vecs, active = _checked(x, pre_bias, scale, bias, active)
    n, c = x.shape
    x = x.contiguous()
    out = torch.empty((n, c), dtype=out_dtype, device=x.device)
    rc = load_library("fused_ln").pcseg_bias_ln_relu_mask(
        x.data_ptr(), *(v.data_ptr() for v in vecs), active.data_ptr(),
        out.data_ptr(), n, c, float(eps), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), stream_of(x))
    raise_on(rc, "bias_ln_relu_mask")
    LAUNCHES["bias_ln_relu_mask"] += 1
    return out


_fwd_op = define_op(
    "bias_ln_relu_mask(Tensor x, Tensor pre_bias, Tensor scale, "
    "Tensor bias, Tensor active, float eps, ScalarType out_dtype) -> Tensor",
    bias_ln_relu_mask_plain, bias_ln_relu_mask_cuda,
    lambda x, pre_bias, scale, bias, active, eps, out_dtype: x.new_empty(
        x.shape, dtype=out_dtype))


def bwd_route(lib, x: torch.Tensor, g: torch.Tensor) -> int:
    """1 where the backward takes the vector route (csrc/fused_ln.cu's
    ``bwd_vec_ok``: C a multiple of 8 up to 256) on 16-byte aligned x and
    g (dx is allocated aligned), else 0: decided by shape before the
    launch."""
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    return int(aligned and bool(
        lib.pcseg_bias_ln_relu_mask_bwd_vec_ok(x.shape[1])))


def bias_ln_relu_mask_bwd(x, pre_bias, scale, bias, active, g,
                          eps: float = 1e-5, *, plain: bool = False):
    """The backward: x (N, C) and g (N, C), the cotangent of the output
    (bf16 or f32 each) -> (dx in x's dtype, dpre_bias, dscale, dbias as
    (C,) f32). Launches the CUDA kernel on a CUDA tensor."""
    if not on_cuda(x, plain):
        return bias_ln_relu_mask_bwd_plain(x, pre_bias, scale, bias, active,
                                           g, eps)
    vecs, active = _checked(x, pre_bias, scale, bias, active)
    n, c = x.shape
    if tuple(g.shape) != (n, c) or g.dtype not in _DTYPES:
        raise ValueError(f"g must be ({n}, {c}) bf16 or f32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    lib = load_library("fused_ln")
    x, g = x.contiguous(), g.contiguous()
    x_bf16, g_bf16 = int(x.dtype == torch.bfloat16), int(
        g.dtype == torch.bfloat16)
    vec = bwd_route(lib, x, g)
    blocks = lib.pcseg_bias_ln_relu_mask_bwd_blocks(n, c, vec, x_bf16,
                                                    g_bf16)
    if c > lib.pcseg_bias_ln_relu_mask_bwd_max_c() or blocks < 1:
        raise ValueError(f"the bias_ln_relu_mask backward takes up to "
                         f"{lib.pcseg_bias_ln_relu_mask_bwd_max_c()} "
                         f"channels, got {tuple(x.shape)}")
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 3 * c), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((3, c), dtype=torch.float32, device=x.device)
    rc = lib.pcseg_bias_ln_relu_mask_bwd(
        x.data_ptr(), *(v.data_ptr() for v in vecs), active.data_ptr(),
        g.data_ptr(), dx.data_ptr(), partial.data_ptr(), sums.data_ptr(), n,
        c, float(eps), x_bf16, g_bf16, vec, stream_of(x))
    raise_on(rc, "bias_ln_relu_mask_bwd")
    LAUNCHES["bias_ln_relu_mask_bwd"] += 1
    LAUNCHES["bias_ln_relu_mask_bwd_vec"] += vec
    dscale, dbias, dpre = sums
    return dx, dpre, dscale, dbias


class _BiasLnReluMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pre_bias, scale, bias, active, eps, out_dtype,
                plain):
        out = bias_ln_relu_mask_fwd(x, pre_bias, scale, bias, active, eps,
                                    out_dtype, plain=plain)
        ctx.save_for_backward(x, pre_bias, scale, bias, active)
        ctx.cfg = (eps, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        x, pre_bias, scale, bias, active = ctx.saved_tensors
        eps, plain = ctx.cfg
        dx, dpre, dscale, dbias = bias_ln_relu_mask_bwd(
            x, pre_bias, scale, bias, active, g, eps, plain=plain)
        return (dx, dpre.to(pre_bias.dtype), dscale.to(scale.dtype),
                dbias.to(bias.dtype), None, None, None, None)


def bias_ln_relu_mask(x: torch.Tensor, pre_bias: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      active: torch.Tensor, eps: float = 1e-5,
                      out_dtype: torch.dtype = torch.bfloat16, *,
                      plain: bool = False) -> torch.Tensor:
    """The differentiable op (arguments as ``bias_ln_relu_mask_fwd``): the
    kernels on a CUDA tensor, the plain versions on a CPU tensor or with
    ``plain=True``."""
    return _BiasLnReluMask.apply(x, pre_bias, scale, bias, active, eps,
                                 out_dtype, plain)


def ln_relu_mask(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 active: torch.Tensor, eps: float = 1e-5,
                 out_dtype: torch.dtype = torch.bfloat16, *,
                 plain: bool = False) -> torch.Tensor:
    """LN + affine + ReLU + mask without a folded pre-bias (zeros)."""
    zeros = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    return bias_ln_relu_mask(x, zeros, scale, bias, active, eps, out_dtype,
                             plain=plain)
