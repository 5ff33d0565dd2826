"""Fused conv blocks of the voxel U-Net core: CUDA kernels + plain versions.

Counterpart of pcseg_tpu/ops/pallas/conv3d_block.py. Each block is
``relu(x * scale + shift) -> conv -> + bias (+ accum)``, bf16 out, with
the next GroupNorm's per-(batch, channel) (sum, sumsq) taken from the f32
value before rounding, so a layer's activations cross device memory once
and GroupNorm never needs a pass of its own:

- ``conv3x3_gn_act``: the 3^3 SAME conv (``fused_conv3x3_p`` and, with
  ``accum``, ``fused_conv3x3_add_p``);
- ``down2x_gn_act``: the k2 s2 conv C -> 2C (``fused_down2x_p``);
- ``up2x_gn_act``: the k2 s2 transposed conv 2C -> C (``fused_up2x_p``).

Everything is NDHWC. The TPU kernels' 128-lane packing of (W, C) and their
(B, 128) lane-tiled scale/shift/stats existed only for the TPU's vector
lanes; here scale/shift are (B, C) and stats (B, 2, C).

Each wrapper runs its CUDA kernel (csrc/conv3d_block.cu) on a CUDA tensor
and its plain PyTorch version on a CPU tensor; the plain version has the
kernel's rounding points, so the two agree up to f32 summation order. On
the card the plain versions are the reference the kernels are held to
(chip_smoke.py), with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    ptr,
    raise_on,
    stream_of,
)
from pcseg_tpu_torch.ops.conv3d import num_groups

# launches per kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else
LAUNCHES = {"conv3x3_gn_act": 0, "down2x_gn_act": 0, "up2x_gn_act": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# glue: GroupNorm folding, activation, head
# ---------------------------------------------------------------------------

def fold_gn(mean: torch.Tensor, var: torch.Tensor, gn_scale: torch.Tensor,
            gn_bias: torch.Tensor, eps: float = 1e-5):
    """Per-(batch, group) mean/var -> per-channel (B, C) scale/shift with
    relu(x * scale + shift) == relu(GroupNorm(x))."""
    c = gn_scale.shape[0]
    g = mean.shape[1]
    inv = torch.rsqrt(var + eps)
    per_c_inv = inv.repeat_interleave(c // g, dim=1)
    per_c_mean = mean.repeat_interleave(c // g, dim=1)
    scale = per_c_inv * gn_scale[None]
    shift = gn_bias[None] - per_c_mean * scale
    return scale, shift


def stats_scale_shift(stats: torch.Tensor, gn_scale: torch.Tensor,
                      gn_bias: torch.Tensor, groups: int, nvox: int):
    """Fold per-channel (B, 2, C) (sum, sumsq) into GroupNorm scale/shift.

    Single-pass variance E[y^2] - mean^2, unclamped, as the JAX package
    computes it. ``nvox`` = D*H*W of the grid the stats were taken over.
    """
    b, _, c = stats.shape
    g = num_groups(c, groups)
    s = stats.reshape(b, 2, g, c // g).sum(dim=3)
    n = nvox * (c // g)
    mean = s[:, 0] / n
    var = s[:, 1] / n - mean.square()
    return fold_gn(mean, var, gn_scale, gn_bias)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None, :]


def act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """relu(x * scale + shift) in f32, rounded to bf16 (the kernels'
    prologue as a standalone op)."""
    return torch.relu(x.float() * _bcast(scale) + _bcast(shift)).to(
        torch.bfloat16)


def head1x1(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """1x1 head on activated bf16 ``a``: bf16 operands, f32 product and
    bias, (B, D, H, W, NC) f32."""
    k = w.reshape(w.shape[-2], w.shape[-1]).to(torch.bfloat16).float()
    return a.float() @ k + bias.float()


# ---------------------------------------------------------------------------
# plain versions (same rounding points as the kernels)
# ---------------------------------------------------------------------------

def _prologue(x, scale, shift, activate):
    """Activated input as f32 values of bf16 numbers."""
    if activate:
        return act(x, scale, shift).float()
    return x.to(torch.bfloat16).float()


def _finish(yf, bias, accum, want_stats):
    yf = yf.permute(0, 2, 3, 4, 1) + bias.float()
    if accum is not None:
        yf = yf + accum.float()
    stats = None
    if want_stats:
        stats = torch.stack(
            [yf.sum(dim=(1, 2, 3)), yf.square().sum(dim=(1, 2, 3))], dim=1
        )
    return yf.to(torch.bfloat16).contiguous(), stats


def _wq(w):
    return w.to(torch.bfloat16).float()


def conv3x3_gn_act_plain(x, w, bias, scale, shift, accum=None, *,
                         activate=True, want_stats=True):
    a = _prologue(x, scale, shift, activate).permute(0, 4, 1, 2, 3)
    yf = F.conv3d(a, _wq(w).permute(4, 3, 0, 1, 2), padding=1)
    return _finish(yf, bias, accum, want_stats)


def down2x_gn_act_plain(x, w, bias, scale, shift):
    a = _prologue(x, scale, shift, True).permute(0, 4, 1, 2, 3)
    yf = F.conv3d(a, _wq(w).permute(4, 3, 0, 1, 2), stride=2)
    return _finish(yf, bias, None, True)


def up2x_gn_act_plain(x, w, bias, scale, shift):
    a = _prologue(x, scale, shift, True).permute(0, 4, 1, 2, 3)
    wt = _wq(w).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    yf = F.conv_transpose3d(a, wt, stride=2)
    return _finish(yf, bias, None, True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _common(x, w, bias, scale, shift, k, activate=True):
    """Validate a launch and return (weights as f32 of bf16, bias f32)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, cin, dev = x.shape[0], x.shape[-1], x.device
    _check("x", x, x.shape, torch.bfloat16, dev)
    cout = w.shape[-1]
    if tuple(w.shape[:4]) != (k, k, k, cin):
        raise ValueError(f"w must be ({k}, {k}, {k}, {cin}, Cout), got "
                         f"{tuple(w.shape)}")
    if cout % 4:
        raise ValueError(f"Cout={cout} must be a multiple of 4")
    _check("bias", bias, (cout,), torch.float32, dev)
    if activate:
        _check("scale", scale, (b, cin), torch.float32, dev)
        _check("shift", shift, (b, cin), torch.float32, dev)
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    return _wq(w).contiguous(), cout


def conv3x3_gn_act(x, w, bias, scale, shift, accum=None, *, activate=True,
                   want_stats=True):
    """relu(x * scale + shift) -> 3^3 SAME conv -> + bias (+ accum).

    x (B, D, H, W, Cin) bf16; w (3, 3, 3, Cin, Cout) DHWIO, rounded to
    bf16; bias (Cout,) f32; scale/shift (B, Cin) f32, ignored (may be None)
    when ``activate=False``; accum (B, D, H, W, Cout) bf16 added in f32
    after the bias. Returns (y bf16, stats (B, 2, Cout) f32 or None).
    """
    if not on_cuda(x):
        return conv3x3_gn_act_plain(x, w, bias, scale, shift, accum,
                                    activate=activate, want_stats=want_stats)
    wq, cout = _common(x, w, bias, scale, shift, 3, activate)
    b, d, h, wd, cin = x.shape
    if wd % 4:
        raise ValueError(f"W={wd} must be a multiple of 4")
    if accum is not None:
        _check("accum", accum, (b, d, h, wd, cout), torch.bfloat16, x.device)
    y = torch.empty((b, d, h, wd, cout), dtype=torch.bfloat16,
                    device=x.device)
    stats = (torch.zeros((b, 2, cout), dtype=torch.float32, device=x.device)
             if want_stats else None)
    rc = load_library().pcseg_conv3x3_gn_act(
        x.data_ptr(), wq.data_ptr(), bias.data_ptr(),
        ptr(scale) if activate else None, ptr(shift) if activate else None,
        ptr(accum), y.data_ptr(), ptr(stats), b, d, h, wd, cin, cout,
        int(activate), stream_of(x),
    )
    raise_on(rc, "conv3x3_gn_act")
    LAUNCHES["conv3x3_gn_act"] += 1
    return y, stats


def down2x_gn_act(x, w, bias, scale, shift):
    """relu(x * scale + shift) -> k2 s2 conv -> + bias.

    x (B, D, H, W, C) bf16 with D, H, W even; w (2, 2, 2, C, C2).
    Returns (y (B, D/2, H/2, W/2, C2) bf16, stats (B, 2, C2) f32).
    """
    if not on_cuda(x):
        return down2x_gn_act_plain(x, w, bias, scale, shift)
    wq, cout = _common(x, w, bias, scale, shift, 2)
    b, d, h, wd, cin = x.shape
    if d % 2 or h % 2 or wd % 8:
        raise ValueError(f"down2x needs even D, H and W a multiple of 8, "
                         f"got {tuple(x.shape)}")
    y = torch.empty((b, d // 2, h // 2, wd // 2, cout), dtype=torch.bfloat16,
                    device=x.device)
    stats = torch.zeros((b, 2, cout), dtype=torch.float32, device=x.device)
    rc = load_library().pcseg_down2x_gn_act(
        x.data_ptr(), wq.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), y.data_ptr(), stats.data_ptr(), b, d, h, wd, cin,
        cout, stream_of(x),
    )
    raise_on(rc, "down2x_gn_act")
    LAUNCHES["down2x_gn_act"] += 1
    return y, stats


def up2x_gn_act(x, w, bias, scale, shift):
    """relu(x * scale + shift) -> k2 s2 transposed conv -> + bias.

    x (B, D, H, W, C2) bf16; w (2, 2, 2, C2, C): output 2i+d takes
    x[i] @ w[1-d] per axis. Returns (y (B, 2D, 2H, 2W, C) bf16,
    stats (B, 2, C) f32).
    """
    if not on_cuda(x):
        return up2x_gn_act_plain(x, w, bias, scale, shift)
    wq, cout = _common(x, w, bias, scale, shift, 2)
    b, d, h, wd, cin = x.shape
    if wd % 2:
        raise ValueError(f"up2x needs even W, got {tuple(x.shape)}")
    y = torch.empty((b, 2 * d, 2 * h, 2 * wd, cout), dtype=torch.bfloat16,
                    device=x.device)
    stats = torch.zeros((b, 2, cout), dtype=torch.float32, device=x.device)
    rc = load_library().pcseg_up2x_gn_act(
        x.data_ptr(), wq.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), y.data_ptr(), stats.data_ptr(), b, d, h, wd, cin,
        cout, stream_of(x),
    )
    raise_on(rc, "up2x_gn_act")
    LAUNCHES["up2x_gn_act"] += 1
    return y, stats
