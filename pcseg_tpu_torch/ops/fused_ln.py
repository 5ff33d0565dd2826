"""Fused conv-bias + LayerNorm + affine + ReLU + active-mask, forward
(counterpart of pcseg_tpu/ops/pallas/fused_ln.py).

``bias_ln_relu_mask`` takes the RAW conv output of the sparse U-Net's
block stack, x (N, C), and per row computes in f32

    xb = x + pre_bias (the conv's bias, folded in)
    mean, var: single-pass moments over C, var = max(E[xb^2] - mean^2, 0)
    z = (xb - mean) * rsqrt(var + eps) * scale + bias
    out = active ? max(z, 0) : 0, rounded once to ``out_dtype``.

On a CUDA tensor it launches ``pcseg_bias_ln_relu_mask``
(csrc/fused_ln.cu, one warp a row); on a CPU tensor it runs
``bias_ln_relu_mask_plain``, the same formula in PyTorch. The backward
waits for the sparse family's training slice (ROADMAP Queue B).
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

# launches since the last reset_launches(); the wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {"bias_ln_relu_mask": 0}
MAX_C = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bias_ln_relu_mask_plain(x: torch.Tensor, pre_bias: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            active: torch.Tensor, eps: float = 1e-5,
                            out_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """The kernel's formula in PyTorch, f32 throughout, one rounding."""
    xf = x.float() + pre_bias.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    z = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    keep = active.reshape(-1, 1).to(torch.bool) & (z > 0.0)
    return torch.where(keep, z, torch.zeros_like(z)).to(out_dtype)


def bias_ln_relu_mask(x: torch.Tensor, pre_bias: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      active: torch.Tensor, eps: float = 1e-5,
                      out_dtype: torch.dtype = torch.bfloat16, *,
                      plain: bool = False) -> torch.Tensor:
    """x (N, C) bf16 or f32; pre_bias, scale, bias (C,); active (N,) bool
    -> (N, C) ``out_dtype`` (bf16 or f32). Launches the CUDA kernel on a
    CUDA tensor."""
    if not on_cuda(x, plain):
        return bias_ln_relu_mask_plain(x, pre_bias, scale, bias, active, eps,
                                       out_dtype)
    n, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bias_ln_relu_mask takes bf16 or f32, got "
                         f"{x.dtype} -> {out_dtype}")
    if not 1 <= c <= MAX_C or n == 0:
        raise ValueError(f"bias_ln_relu_mask takes 1..{MAX_C} channels and "
                         f"at least one row, got {tuple(x.shape)}")
    if tuple(active.shape) != (n,):
        raise ValueError(f"active must be ({n},), got {tuple(active.shape)}")
    vecs = [v.to(device=x.device, dtype=torch.float32).contiguous()
            for v in (pre_bias, scale, bias)]
    if any(tuple(v.shape) != (c,) for v in vecs):
        raise ValueError(f"pre_bias, scale and bias must be ({c},)")
    x = x.contiguous()
    active = active.to(device=x.device, dtype=torch.bool).contiguous()
    out = torch.empty((n, c), dtype=out_dtype, device=x.device)
    rc = load_library("fused_ln").pcseg_bias_ln_relu_mask(
        x.data_ptr(), *(v.data_ptr() for v in vecs), active.data_ptr(),
        out.data_ptr(), n, c, float(eps), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), stream_of(x))
    raise_on(rc, "bias_ln_relu_mask")
    LAUNCHES["bias_ln_relu_mask"] += 1
    return out


def ln_relu_mask(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 active: torch.Tensor, eps: float = 1e-5,
                 out_dtype: torch.dtype = torch.bfloat16, *,
                 plain: bool = False) -> torch.Tensor:
    """LN + affine + ReLU + mask without a folded pre-bias (zeros)."""
    zeros = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    return bias_ln_relu_mask(x, zeros, scale, bias, active, eps, out_dtype,
                             plain=plain)
