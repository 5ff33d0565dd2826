"""Fused conv blocks of the voxel U-Net core: CUDA kernels, plain versions
and their autograd.

Counterpart of pcseg_tpu/ops/pallas/conv3d_block.py. Each block is
``relu(x * scale + shift) -> conv -> + bias (+ accum)``, bf16 out, with
the next GroupNorm's per-(batch, channel) (sum, sumsq) taken from the f32
value before rounding, so a layer's activations cross device memory once
and GroupNorm never needs a pass of its own:

- ``conv3x3_gn_act``: the 3^3 SAME conv (``fused_conv3x3_p`` and, with
  ``accum``, ``fused_conv3x3_add_p``);
- ``down2x_gn_act``: the k2 s2 conv C -> 2C (``fused_down2x_p``);
- ``up2x_gn_act``: the k2 s2 transposed conv 2C -> C (``fused_up2x_p``);
- ``fused_head_grid2``: the 1x1 head on the activated last grid, bf16
  logits in the devoxelizer's (B, R*R, R*NC) grid2 layout
  (``fused_head_grid2``).

Each is a ``torch.autograd.Function`` whose backward is the JAX custom
VJP on kernels of its own. The stats output feeds the next GroupNorm, so
its cotangent ``gstats`` comes back beside ``gy``, and the conv's
cotangent is g' = gy + gs1 + 2 gs2 y, with y the stored bf16 output,
folded into the kernels' gy reads:

- ``conv3x3_dgrad``: dx = relu'(pre) * scale * conv(g', flip(W)^T) and the
  per-(batch, channel) dscale/dshift (``_dgrad_pallas``), plus the bf16
  g' itself, which is the add variant's accum gradient;
- ``conv3x3_wgrad``: dW and dbias (``_wgrad_pallas``);
- ``down2x_bwd`` / ``up2x_bwd``: dx, dscale/dshift, dW and dbias (the
  backward kernels of ``fused_down2x_p`` / ``fused_up2x_p``);
- ``head_grid2_bwd``: the head's dx, dscale/dshift, dW and dbias
  (``_head_bwd``); its cotangent has no stats term.

The 3^3 pair computes gy + (gs1 + 2 gs2 y) and rounds g' to bf16 before
both products and before dbias; down/up compute (gy + gs1) + 2 gs2 y,
take dbias from the f32 value and round only the product operand, as the
TPU kernels do. ``need_dx=False`` (the stem, whose input is data) skips
the dgrad launch.

Everything is NDHWC. The TPU kernels' 128-lane packing of (W, C) and their
(B, 128) lane-tiled scale/shift/stats existed only for the TPU's vector
lanes; here scale/shift are (B, C) and stats (B, 2, C).

Both resampling blocks, forward and backward, run, for C in 8, 16, 32,
64 with 2C on the coarse side (the widths the JAX fused core allows), as
gathered tensor-core GEMMs (csrc/resample.cu): a coarse voxel's row is
its eight children's channels (``gather_rows``), so the down conv is
``gather_rows(act(x)) @ pack_down_w(w)``, the up conv
``ungather_rows(act(x) @ pack_up_w(w))`` and the up block's dgrad
``gather_rows(g') @ pack_up_wt(w)``, its wgrad the transpose of the same
product; the down block's backward is the transposed pair,
``ungather_rows(G @ pack_down_w(w)^T)`` for dx and ``gather_rows(act(x))^T
@ G`` for dW, with G = bf16(g') on the coarse grid. Other shapes take the
CUDA-core kernels of csrc/conv3d_block.cu, chosen by shape before the
launch (``_mma_route``).

The 3^3 conv, forward, dgrad and wgrad, runs for Cin = Cout in 8, 16, 32,
64 on W 16, 32, 64 (16, 32 at 64 channels) and on any multiple of 64 (32
at 64 channels) in column tiles as implicit GEMMs on one ring of planes
(csrc/conv3d_dgrad.cu): a plane tile's output is the sum over the
27 taps of ring slots of three input planes (``ring_slot``) read at the
tap's shift, times the packed weights' row (``ring_plane``;
``pack_conv_w`` for the forward, ``pack_dgrad_w`` for the dgrad); the
wgrad's dW[t] is the sum over plane tiles of the forward's ring read at
tap t's shift, transposed, times the tile's own g', split over tap groups
and depth ranges into a partial table that one fixed-order pass sums
(tests/test_torch_wgrad_layout.py emulates that order). Other shapes take
conv3d_block.cu's direct kernels (``_conv_route``). The tensor-core
kernels read the bf16 weights these ``pack_*`` helpers return, so the
layout the CPU tests hold is the one the kernels read.

``*_cuda`` launch a kernel (csrc/conv3d_block.cu); ``*_plain`` are the
plain PyTorch versions, with the kernels' rounding points, so the two agree
up to f32 summation order. The differentiable ops run the kernels on a CUDA
tensor and the plain versions on a CPU tensor or with ``plain=True``. On
the card the plain versions are the reference the kernels are held to
(chip_smoke.py), with TF32 off.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from pcseg_tpu_torch.ops._build import (
    define_op,
    load_library,
    on_cuda,
    ptr,
    raise_on,
    stream_of,
)
from pcseg_tpu_torch.ops.conv3d import num_groups

# launches per kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else. The op keys count
# either route; "down2x_mma", "up2x_mma", "up2x_bwd_mma" and
# "down2x_bwd_mma" count the launches of csrc/resample.cu's gathered
# tensor-core kernels among them, "conv3x3_mma", "conv3x3_dgrad_mma" and
# "conv3x3_wgrad_mma" those of csrc/conv3d_dgrad.cu's implicit GEMMs.
LAUNCHES = {"conv3x3_gn_act": 0, "down2x_gn_act": 0, "up2x_gn_act": 0,
            "conv3x3_dgrad": 0, "conv3x3_wgrad": 0, "down2x_bwd": 0,
            "up2x_bwd": 0, "head_grid2": 0, "head_grid2_bwd": 0,
            "conv3x3_mma": 0, "down2x_mma": 0, "up2x_mma": 0,
            "up2x_bwd_mma": 0, "down2x_bwd_mma": 0, "conv3x3_dgrad_mma": 0,
            "conv3x3_wgrad_mma": 0}


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
    return a.float() @ _wq(_head_w(w)) + bias.float()


def _head_w(w):
    """The head's (1, 1, 1, C, NC) kernel as (C, NC)."""
    return w.reshape(w.shape[-2], w.shape[-1])


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


def _ncdhw(t):
    return t.permute(0, 4, 1, 2, 3)


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1)


def conv3x3_gn_act_plain(x, w, bias, scale, shift, accum=None, *,
                         activate=True, want_stats=True):
    a = _ncdhw(_prologue(x, scale, shift, activate))
    yf = F.conv3d(a, _wq(w).permute(4, 3, 0, 1, 2), padding=1)
    return _finish(yf, bias, accum, want_stats)


def down2x_gn_act_plain(x, w, bias, scale, shift):
    a = _ncdhw(_prologue(x, scale, shift, True))
    yf = F.conv3d(a, _wq(w).permute(4, 3, 0, 1, 2), stride=2)
    return _finish(yf, bias, None, True)


def up2x_gn_act_plain(x, w, bias, scale, shift):
    a = _ncdhw(_prologue(x, scale, shift, True))
    wt = _wq(w).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    yf = F.conv_transpose3d(a, wt, stride=2)
    return _finish(yf, bias, None, True)


def _gprime(gy, y, gstats, order):
    """The conv's f32 cotangent g' with the stats term: ``"3x3"`` computes
    gy + (gs1 + 2 gs2 y), ``"updown"`` (gy + gs1) + 2 gs2 y."""
    g = gy.float()
    if gstats is None:
        return g
    gs1 = _bcast(gstats[:, 0])
    t = _bcast(2.0 * gstats[:, 1]) * y.float()
    if order == "3x3":
        return g + (gs1 + t)
    return (g + gs1) + t


def _act_grad(da, x, scale, shift, activate):
    """The dgrad epilogue: dx = bf16(da * [pre > 0] * scale) and the
    per-(batch, channel) (sum dam * x, sum dam), or bf16(da) and None
    without the activation."""
    if not activate:
        return da.to(torch.bfloat16).contiguous(), None
    xs = x.float()
    pre = xs * _bcast(scale) + _bcast(shift)
    dam = torch.where(pre > 0, da, torch.zeros_like(da))
    dx = (dam * _bcast(scale)).to(torch.bfloat16).contiguous()
    dstats = torch.stack([(dam * xs).sum(dim=(1, 2, 3)),
                          dam.sum(dim=(1, 2, 3))], dim=1)
    return dx, dstats


def conv3x3_dgrad_plain(gy, y, gstats, x, w, scale, shift, activate=True,
                        want_gadj=False):
    gp = _gprime(gy, y, gstats, "3x3").to(torch.bfloat16)
    da = _ndhwc(F.conv_transpose3d(_ncdhw(gp.float()),
                                   _wq(w).permute(4, 3, 0, 1, 2), padding=1))
    dx, dstats = _act_grad(da, x, scale, shift, activate)
    return dx, dstats, gp.contiguous() if want_gadj else None


def conv3x3_wgrad_plain(x, scale, shift, gy, y, gstats, activate=True):
    gp = _gprime(gy, y, gstats, "3x3").to(torch.bfloat16).float()
    a = _prologue(x, scale, shift, activate)
    cin, cout = x.shape[-1], gy.shape[-1]
    dw = torch.nn.grad.conv3d_weight(_ncdhw(a), (cout, cin, 3, 3, 3),
                                     _ncdhw(gp), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous(), gp.sum(dim=(0, 1, 2, 3))


def down2x_bwd_plain(x, w, scale, shift, gy, y, gstats):
    ge = _gprime(gy, y, gstats, "updown")
    gb = ge.to(torch.bfloat16).float()
    b, d, h, wd, cin = x.shape
    a = _prologue(x, scale, shift, True).reshape(
        b, d // 2, 2, h // 2, 2, wd // 2, 2, cin)
    dw = torch.einsum("bzpyqxri,bzyxo->pqrio", a, gb)
    da = torch.einsum("bzyxo,pqrio->bzpyqxri", gb, _wq(w)).reshape(x.shape)
    dx, dstats = _act_grad(da, x, scale, shift, True)
    return dx, dstats, dw.contiguous(), ge.sum(dim=(0, 1, 2, 3))


def up2x_bwd_plain(x, w, scale, shift, gy, y, gstats):
    ge = _gprime(gy, y, gstats, "updown")
    b, d, h, wd, _ = x.shape
    gb = ge.to(torch.bfloat16).float().reshape(
        b, d, 2, h, 2, wd, 2, gy.shape[-1])
    a = _prologue(x, scale, shift, True)
    # output 2i+d takes x[i] @ w[1-d]: in flipped taps, wf[d]
    wf = _wq(w).flip(0, 1, 2)
    dw = torch.einsum("bzyxi,bzpyqxro->pqrio", a, gb).flip(0, 1, 2)
    da = torch.einsum("bzpyqxro,pqrio->bzyxi", gb, wf)
    dx, dstats = _act_grad(da, x, scale, shift, True)
    return dx, dstats, dw.contiguous(), ge.sum(dim=(0, 1, 2, 3))


# ---------------------------------------------------------------------------
# the gathered-GEMM layout of csrc/resample.cu
# ---------------------------------------------------------------------------

def gather_rows(t):
    """(B, D, H, W, C) fine grid -> (B, D/2, H/2, W/2, 8C): each coarse
    voxel's row of its eight children, k = ((dz * 2 + dy) * 2 + dx) * C +
    c (for each (dz, dy) the 2C contiguous values of the fine pair)."""
    b, d, h, w, c = t.shape
    return (t.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 5, 2, 4, 6, 7)
            .reshape(b, d // 2, h // 2, w // 2, 8 * c))


def ungather_rows(rows):
    """The inverse of ``gather_rows``: (B, D/2, H/2, W/2, 8C) coarse rows
    back to the (B, D, H, W, C) fine grid (the down block's dx, scattered)."""
    b, d2, h2, w2, k = rows.shape
    c = k // 8
    return (rows.reshape(b, d2, h2, w2, 2, 2, 2, c)
            .permute(0, 1, 4, 2, 5, 3, 6, 7)
            .reshape(b, 2 * d2, 2 * h2, 2 * w2, c))


def pack_down_w(w):
    """The down conv's (2, 2, 2, C, N) weights as the (8C, N) matrix the
    gathered rows multiply: row (tap, c)."""
    return w.reshape(-1, w.shape[-1])


def pack_up_wt(w):
    """The up conv's (2, 2, 2, C2, C) weights as its dgrad's (8C, C2)
    matrix: row (d, o) holds w[1 - d][:, o], the tap that sends coarse
    channel i to child d's channel o."""
    return w.flip(0, 1, 2).transpose(3, 4).reshape(-1, w.shape[3])


def pack_up_w(w):
    """The up conv's (2, 2, 2, C2, C) weights as its forward's (C2, 8C)
    matrix, the transpose of ``pack_up_wt``: Wu[i][(d, o)] = w[1 - d][i][o],
    so the up conv is ``ungather_rows(act(x) @ pack_up_w(w))``."""
    return w.flip(0, 1, 2).permute(3, 0, 1, 2, 4).reshape(w.shape[3], -1)


# ---------------------------------------------------------------------------
# the implicit-GEMM layout of csrc/conv3d_dgrad.cu
# ---------------------------------------------------------------------------

def ring_taps():
    """The 3^3 GEMM's tap order: tap t = (kz * 3 + ky) * 3 + kx reads the
    ring at the voxel offset (kz - 1, ky - 1, kx - 1) and multiplies row t
    of the packed weights (``pack_conv_w``, ``pack_dgrad_w``)."""
    return [(kz - 1, ky - 1, kx - 1) for kz in range(3) for ky in range(3)
            for kx in range(3)]


def pack_conv_w(w):
    """The forward's (3, 3, 3, Cin, Cout) weights as its B operand (27,
    Cout, Cin): row t holds tap t, [n = co][k = ci] (K contiguous), so y =
    sum_t A_t @ pack_conv_w(w)[t]^T."""
    return w.reshape(27, w.shape[3], w.shape[4]).transpose(1, 2)


def pack_dgrad_w(w):
    """The forward's (3, 3, 3, Cin, Cout) weights as the dgrad's B operand
    (27, Cin, Cout): row t holds the flipped tap 26 - t, [n = ci][k = co]
    (K contiguous), so da = sum_t A_t @ pack_dgrad_w(w)[t]^T."""
    return w.reshape(27, w.shape[3], w.shape[4]).flip(0)


def ring_slot(g, b, pd, h0, th, w0=0, tw=None):
    """A ring slot: plane pd of the ring's source (B, D, H, W, C), the
    forward's activated input or the dgrad's g', rows h0 - 1 .. h0 + th and
    columns w0 - 1 .. w0 + tw (tw = W: the whole rows) as ((th + 2) (tw +
    2), C), the halo read from the grid's neighbouring rows and columns,
    zeros outside the grid (the conv's zero padding). Position v = r (tw +
    2) + c holds voxel (h0 - 1 + r, w0 - 1 + c)."""
    _, d, h, w, c = g.shape
    tw = w if tw is None else tw
    out = g.new_zeros((th + 2, tw + 2, c))
    if 0 <= pd < d:
        lo, hi = max(h0 - 1, 0), min(h0 + th + 1, h)
        left, right = max(w0 - 1, 0), min(w0 + tw + 1, w)
        out[lo - h0 + 1:hi - h0 + 1, left - w0 + 1:right - w0 + 1] = \
            g[b, pd, lo:hi, left:right]
    return out.reshape(-1, c)


def ring_swizzle(u, units):
    """The stored place of 16-byte unit u of a tile whose voxels hold
    ``units`` units (csrc/conv3d_dgrad.cu swl): the unit's index within
    its voxel XOR bits of the voxel."""
    return u ^ ((u >> 3) & (units - 1))


def ring_plane(g, wpk, b, d, h0, th, w0=0, tw=None):
    """Rows h0 .. h0 + th, columns w0 .. w0 + tw (tw = W: the whole rows)
    of output plane d (th, tw, N) of the kernel's GEMM: sum over the taps
    of the ring slots of planes d - 1, d, d + 1 of the source g read at the
    tap's shift, times the packed weights' row (the dgrad's da with g' and
    ``pack_dgrad_w``, the forward's conv with the activated input and
    ``pack_conv_w``)."""
    tw = g.shape[3] if tw is None else tw
    slots = {pd: ring_slot(g, b, pd, h0, th, w0, tw)
             for pd in (d - 1, d, d + 1)}
    r = torch.arange(th)[:, None]
    c = torch.arange(tw)[None, :]
    da = 0.0
    for t, (dz, dy, dx) in enumerate(ring_taps()):
        v = ((r + 1 + dy) * (tw + 2) + (c + 1 + dx)).reshape(-1)
        da = da + slots[d + dz][v] @ wpk[t].t()
    return da.reshape(th, tw, -1)


def head_grid2_plain(x, w, bias, scale, shift):
    """The fused head: bf16(act(x) @ bf16(W) + bias), (B, D, H, W, NC)
    bf16, the f32 sum over C taken before the bias."""
    return head1x1(act(x, scale, shift), w, bias).to(torch.bfloat16)


def head_grid2_bwd_plain(x, gy, w, scale, shift):
    """The fused head's backward from its bf16 cotangent gy: (dx bf16,
    dstats (B, 2, C) = (dscale, dshift), dW (C, NC), dbias (NC,)), f32 sums
    (``_head_bwd_kernel``): dscale multiplies by the raw x, dW by the
    activated bf16 s."""
    g = gy.float()
    s = act(x, scale, shift).float()
    da = g @ _wq(_head_w(w)).t()
    dx, dstats = _act_grad(da, x, scale, shift, True)
    dw = s.reshape(-1, s.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
    return dx, dstats, dw, g.sum(dim=(0, 1, 2, 3))


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
    """Validate a launch and return Cout."""
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
    if bias is not None:
        _check("bias", bias, (cout,), torch.float32, dev)
    if activate:
        _check("scale", scale, (b, cin), torch.float32, dev)
        _check("shift", shift, (b, cin), torch.float32, dev)
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    return cout


def _cotangents(gy, y, gstats, shape):
    """Validate a backward launch's gy (and y, gstats when given)."""
    dev = gy.device
    _check("gy", gy, shape, torch.bfloat16, dev)
    if gstats is not None:
        _check("y", y, shape, torch.bfloat16, dev)
        _check("gstats", gstats, (shape[0], 2, shape[-1]), torch.float32,
               dev)


def _wgrad_checks(name, x, gy, y):
    """The wgrad kernel stages 8 channels per 16-byte load: Cin and Cout
    multiples of 8, Cout / 8 dividing 32, 16-byte aligned grids."""
    cin, cout = x.shape[-1], gy.shape[-1]
    if cin % 8 or cout % 8 or 32 % (cout // 8):
        raise ValueError(f"{name} needs Cin % 8 == 0 and Cout in 8, 16, "
                         f"..., 256, got {cin} -> {cout}")
    for t in (x, gy, y):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned grids")


def _wt(w):
    """A dgrad's weights: the forward's bf16 weights with the taps flipped
    and input/output swapped, f32."""
    return _wq(w).flip(0, 1, 2).transpose(3, 4).contiguous()


def _f32_zeros(like, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def conv3x3_gn_act_cuda(x, w, bias, scale, shift, accum=None, *,
                        activate=True, want_stats=True):
    """relu(x * scale + shift) -> 3^3 SAME conv -> + bias (+ accum).

    x (B, D, H, W, Cin) bf16; w (3, 3, 3, Cin, Cout) DHWIO, rounded to
    bf16; bias (Cout,) f32; scale/shift (B, Cin) f32, ignored (may be None)
    when ``activate=False``; accum (B, D, H, W, Cout) bf16 added in f32
    after the bias. Returns (y bf16, stats (B, 2, Cout) f32 or None). The
    tensor-core implicit GEMM where ``_conv_route`` takes the shape.
    """
    cout = _common(x, w, bias, scale, shift, 3, activate)
    b, d, h, wd, cin = x.shape
    if wd % 4:
        raise ValueError(f"W={wd} must be a multiple of 4")
    if accum is not None:
        _check("accum", accum, (b, d, h, wd, cout), torch.bfloat16, x.device)
    y = torch.empty((b, d, h, wd, cout), dtype=torch.bfloat16,
                    device=x.device)
    vecs = (ptr(scale) if activate else None,
            ptr(shift) if activate else None)
    if _conv_route(cin, cout, x.shape, x, accum):
        gx = _ring_grid(1, b, cin, d, h, wd, x.device.index)
        stats = part = None
        if want_stats:
            stats = torch.empty((b, 2, cout), dtype=torch.float32,
                                device=x.device)
            part = torch.empty((b, gx, 2, cout), dtype=torch.float32,
                               device=x.device)
        rc = load_library("conv3d_dgrad").pcseg_conv3x3_mma(
            x.data_ptr(), _bf16_packed(pack_conv_w(w)).data_ptr(),
            bias.data_ptr(), *vecs, ptr(accum), y.data_ptr(), ptr(stats),
            ptr(part), b, d, h, wd, cin, gx, stream_of(x))
        raise_on(rc, "conv3x3_mma")
        LAUNCHES["conv3x3_mma"] += 1
    else:
        stats = _f32_zeros(x, b, 2, cout) if want_stats else None
        rc = load_library().pcseg_conv3x3_gn_act(
            x.data_ptr(), _wq(w).contiguous().data_ptr(), bias.data_ptr(),
            *vecs, ptr(accum), y.data_ptr(), ptr(stats), b, d, h, wd, cin,
            cout, int(activate), stream_of(x),
        )
        raise_on(rc, "conv3x3_gn_act")
    LAUNCHES["conv3x3_gn_act"] += 1
    return y, stats


def _bf16_packed(w):
    """A tensor-core kernel's B operand: packed weights as contiguous bf16
    (the rounding the plain versions take in ``_wq``)."""
    return w.to(torch.bfloat16).contiguous()


def _mma_route(c, c2, *grids):
    """True where csrc/resample.cu's gathered tensor-core kernels take a
    resample launch: fine width C of 8, 16, 32 or 64, coarse width 2C and
    16-byte aligned grids (its 16-byte copies). Other shapes run on the
    CUDA-core kernels of csrc/conv3d_block.cu."""
    return c in (8, 16, 32, 64) and c2 == 2 * c and all(
        t is None or t.data_ptr() % 16 == 0 for t in grids)


@functools.lru_cache(maxsize=None)
def _mma_grid(kind, b, c, tiles, device_index):
    """Blocks a batch element of a resample.cu launch (kind 0 down2x, 1
    up2x's backward, 2 down2x's backward, 3 up2x): the rows of its partial
    table are B times this (times ``_down_bwd_slices`` for kind 2)."""
    with torch.cuda.device(device_index):
        gx = load_library("resample").pcseg_resample_grid(kind, b, c, tiles)
    if gx <= 0:
        raise RuntimeError(f"resample.cu: no launch grid for C={c}")
    return gx


def _tiles(d2, h2, w2):
    """64-voxel tiles of a coarse grid (csrc/resample.cu's kRows)."""
    return -(-(d2 * h2 * w2) // 64)


def down2x_gn_act_cuda(x, w, bias, scale, shift):
    """relu(x * scale + shift) -> k2 s2 conv -> + bias.

    x (B, D, H, W, C) bf16 with D, H, W even; w (2, 2, 2, C, C2).
    Returns (y (B, D/2, H/2, W/2, C2) bf16, stats (B, 2, C2) f32).
    """
    cout = _common(x, w, bias, scale, shift, 2)
    b, d, h, wd, cin = x.shape
    if d % 2 or h % 2 or wd % 8:
        raise ValueError(f"down2x needs even D, H and W a multiple of 8, "
                         f"got {tuple(x.shape)}")
    y = torch.empty((b, d // 2, h // 2, wd // 2, cout), dtype=torch.bfloat16,
                    device=x.device)
    if _mma_route(cin, cout, x):
        gx = _mma_grid(0, b, cin, _tiles(d // 2, h // 2, wd // 2),
                       x.device.index)
        stats = torch.empty((b, 2, cout), dtype=torch.float32,
                            device=x.device)
        part = torch.empty((b, gx, 2, cout), dtype=torch.float32,
                           device=x.device)
        rc = load_library("resample").pcseg_down2x_mma(
            x.data_ptr(), _bf16_packed(pack_down_w(w)).data_ptr(),
            bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), stats.data_ptr(), part.data_ptr(), b, d, h, wd,
            cin, gx, stream_of(x))
        raise_on(rc, "down2x_mma")
        LAUNCHES["down2x_mma"] += 1
    else:
        stats = _f32_zeros(x, b, 2, cout)
        rc = load_library().pcseg_down2x_gn_act(
            x.data_ptr(), _wq(w).contiguous().data_ptr(), bias.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            stats.data_ptr(), b, d, h, wd, cin, cout, stream_of(x),
        )
        raise_on(rc, "down2x_gn_act")
    LAUNCHES["down2x_gn_act"] += 1
    return y, stats


def up2x_gn_act_cuda(x, w, bias, scale, shift):
    """relu(x * scale + shift) -> k2 s2 transposed conv -> + bias.

    x (B, D, H, W, C2) bf16; w (2, 2, 2, C2, C): output 2i+d takes
    x[i] @ w[1-d] per axis. Returns (y (B, 2D, 2H, 2W, C) bf16,
    stats (B, 2, C) f32). The gathered tensor-core GEMM where
    ``_mma_route`` takes the shape.
    """
    cout = _common(x, w, bias, scale, shift, 2)
    b, d, h, wd, cin = x.shape
    if wd % 2:
        raise ValueError(f"up2x needs even W, got {tuple(x.shape)}")
    y = torch.empty((b, 2 * d, 2 * h, 2 * wd, cout), dtype=torch.bfloat16,
                    device=x.device)
    if _mma_route(cout, cin, x):
        gx = _mma_grid(3, b, cout, _tiles(d, h, wd), x.device.index)
        stats = torch.empty((b, 2, cout), dtype=torch.float32,
                            device=x.device)
        part = torch.empty((b, gx, 2, cout), dtype=torch.float32,
                           device=x.device)
        rc = load_library("resample").pcseg_up2x_mma(
            x.data_ptr(), _bf16_packed(pack_up_w(w)).data_ptr(),
            bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), stats.data_ptr(), part.data_ptr(), b, d, h, wd,
            cout, gx, stream_of(x))
        raise_on(rc, "up2x_mma")
        LAUNCHES["up2x_mma"] += 1
    else:
        stats = _f32_zeros(x, b, 2, cout)
        rc = load_library().pcseg_up2x_gn_act(
            x.data_ptr(), _wq(w).contiguous().data_ptr(), bias.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            stats.data_ptr(), b, d, h, wd, cin, cout, stream_of(x),
        )
        raise_on(rc, "up2x_gn_act")
    LAUNCHES["up2x_gn_act"] += 1
    return y, stats


# voxels of the implicit GEMM's plane tile, TH rows x TW columns, and the
# widest tile, kWmax columns (csrc/conv3d_dgrad.cu RingCfg::M, ::kWmax)
_RING_TILE = {8: 256, 16: 256, 32: 256, 64: 128}
_RING_WMAX = {8: 64, 16: 64, 32: 64, 64: 32}


def ring_tile_width(c, w):
    """The columns TW of conv3d_dgrad.cu's plane tile at C channels and
    grid width W (ring_tw), 0 where it takes no tile: W itself, a multiple
    of 16 up to kWmax that divides the tile's voxels; else column tiles of
    kWmax where kWmax divides W."""
    m, wmax = _RING_TILE[c], _RING_WMAX[c]
    if w % 16:
        return 0
    if w <= wmax and m % w == 0:
        return w
    return wmax if w % wmax == 0 else 0


def _conv_route(cin, cout, shape, *grids):
    """True where csrc/conv3d_dgrad.cu's tensor-core implicit GEMMs take a
    3^3 forward, dgrad or wgrad of a (B, D, H, W, C) grid (one rule for
    the three): Cin = Cout in 8, 16, 32, 64 (the JAX fused core's widths),
    a plane tile at that W (``ring_tile_width``: W 16, 32, 64 (16, 32 at
    64 channels) or any multiple of 64 (32), in column tiles), H a
    multiple of the tile's rows and 16-byte aligned grids (their 16-byte
    copies). Other shapes run on conv3d_block.cu's conv_kernel and
    wgrad_kernel."""
    h, w = shape[2], shape[3]
    if cin not in _RING_TILE or cout != cin:
        return False
    tw = ring_tile_width(cin, w)
    return (tw > 0 and h % (_RING_TILE[cin] // tw) == 0
            and all(t is None or t.data_ptr() % 16 == 0 for t in grids))


@functools.lru_cache(maxsize=None)
def _ring_grid(kind, b, c, d, h, w, device_index):
    """x blocks of a conv3d_dgrad.cu forward (``kind`` 1), dgrad (0) or
    wgrad (2): the rows of its partial table are B times this (for the
    forward and the dgrad a (batch element, N slice))."""
    with torch.cuda.device(device_index):
        gx = load_library("conv3d_dgrad").pcseg_ring_grid(kind, b, c, d, h,
                                                          w)
    if gx <= 0:
        raise RuntimeError(f"conv3d_dgrad.cu: no launch grid for C={c}, "
                           f"grid {d}x{h}x{w}")
    return gx


def conv3x3_dgrad_cuda(gy, y, gstats, x, w, scale, shift, activate=True,
                       want_gadj=False):
    """dgrad of the 3^3 block. gy (B, D, H, W, Cout) bf16; y the forward's
    output and gstats (B, 2, Cout) its stats cotangent, or both None; x
    the forward's input. Returns (dx bf16, dstats (B, 2, Cin) = (dscale,
    dshift) or None without the activation, g' bf16 when ``want_gadj``).
    The tensor-core implicit GEMM where ``_conv_route`` takes the
    shape."""
    cout = _common(x, w, None, scale, shift, 3, activate)
    b, d, h, wd, cin = x.shape
    if wd % 4 or cin % 4:
        raise ValueError(f"dgrad needs W and Cin multiples of 4, got "
                         f"{tuple(x.shape)}")
    _cotangents(gy, y, gstats, (b, d, h, wd, cout))
    dx = torch.empty_like(x)
    gadj = torch.empty_like(gy) if want_gadj and gstats is not None else None
    if _conv_route(cin, cout, x.shape, x, gy,
                   y if gstats is not None else None):
        gx = _ring_grid(0, b, cin, d, h, wd, x.device.index)
        dstats = part = None
        if activate:
            dstats = torch.empty((b, 2, cin), dtype=torch.float32,
                                 device=x.device)
            part = torch.empty((b, gx, 2, cin), dtype=torch.float32,
                               device=x.device)
        rc = load_library("conv3d_dgrad").pcseg_conv3x3_dgrad_mma(
            gy.data_ptr(), ptr(y) if gstats is not None else None,
            ptr(gstats), x.data_ptr(),
            _bf16_packed(pack_dgrad_w(w)).data_ptr(),
            ptr(scale) if activate else None,
            ptr(shift) if activate else None, dx.data_ptr(), ptr(dstats),
            ptr(gadj), ptr(part), b, d, h, wd, cin, gx, stream_of(x))
        raise_on(rc, "conv3x3_dgrad_mma")
        LAUNCHES["conv3x3_dgrad_mma"] += 1
    else:
        dstats = _f32_zeros(x, b, 2, cin) if activate else None
        rc = load_library().pcseg_conv3x3_dgrad(
            gy.data_ptr(), ptr(y) if gstats is not None else None,
            ptr(gstats), x.data_ptr(), _wt(w).data_ptr(),
            ptr(scale) if activate else None,
            ptr(shift) if activate else None, dx.data_ptr(), ptr(dstats),
            ptr(gadj), b, d, h, wd, cin, cout, int(activate), stream_of(x),
        )
        raise_on(rc, "conv3x3_dgrad")
    LAUNCHES["conv3x3_dgrad"] += 1
    if want_gadj and gadj is None:
        gadj = gy                     # no stats term: g' is gy
    return dx, dstats, gadj


def conv3x3_wgrad_cuda(x, scale, shift, gy, y, gstats, activate=True):
    """wgrad of the 3^3 block: (dW (3, 3, 3, Cin, Cout), dbias (Cout,)),
    f32; arguments as in ``conv3x3_dgrad_cuda``. The tensor-core split-K
    GEMM on the forward's ring where ``_conv_route`` takes the shape (the
    forward's rule: whole rows or column tiles; a partial table summed in
    a fixed order: two calls give the same bits), else conv3d_block.cu's
    wgrad_kernel."""
    b, d, h, wd, cin = x.shape
    cout = gy.shape[-1]
    _check("x", x, x.shape, torch.bfloat16, x.device)
    if activate:
        _check("scale", scale, (b, cin), torch.float32, x.device)
        _check("shift", shift, (b, cin), torch.float32, x.device)
    _cotangents(gy, y, gstats, (b, d, h, wd, cout))
    _wgrad_checks("conv3x3_wgrad", x, gy, y)
    if _conv_route(cin, cout, x.shape, x, gy,
                   y if gstats is not None else None):
        gx = _ring_grid(2, b, cin, d, h, wd, x.device.index)
        n_dw = 27 * cin * cout
        out = torch.empty(n_dw + cout, dtype=torch.float32, device=x.device)
        part = torch.empty((b * gx, n_dw + cout), dtype=torch.float32,
                           device=x.device)
        rc = load_library("conv3d_dgrad").pcseg_conv3x3_wgrad_mma(
            x.data_ptr(), ptr(scale) if activate else None,
            ptr(shift) if activate else None, gy.data_ptr(),
            ptr(y) if gstats is not None else None, ptr(gstats),
            out.data_ptr(), part.data_ptr(), b, d, h, wd, cin, gx,
            stream_of(x))
        raise_on(rc, "conv3x3_wgrad_mma")
        LAUNCHES["conv3x3_wgrad_mma"] += 1
        LAUNCHES["conv3x3_wgrad"] += 1
        return out[:n_dw].view(3, 3, 3, cin, cout), out[n_dw:]
    dw = _f32_zeros(x, 3, 3, 3, cin, cout)
    db = _f32_zeros(x, cout)
    rc = load_library().pcseg_conv3x3_wgrad(
        x.data_ptr(), ptr(scale) if activate else None,
        ptr(shift) if activate else None, gy.data_ptr(),
        ptr(y) if gstats is not None else None, ptr(gstats), dw.data_ptr(),
        db.data_ptr(), b, d, h, wd, cin, cout, int(activate), stream_of(x),
    )
    raise_on(rc, "conv3x3_wgrad")
    LAUNCHES["conv3x3_wgrad"] += 1
    return dw, db


def _resample_bwd_cuda(entry, x, w, scale, shift, gy, y, gstats, out_shape):
    _common(x, w, None, scale, shift, 2)
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    _cotangents(gy, y, gstats, out_shape)
    _wgrad_checks(entry, x, gy, y)
    dx = torch.empty_like(x)
    dstats = _f32_zeros(x, b, 2, cin)
    dw = _f32_zeros(x, 2, 2, 2, cin, cout)
    db = _f32_zeros(x, cout)
    rc = getattr(load_library(), f"pcseg_{entry}")(
        x.data_ptr(), _wt(w).data_ptr(), scale.data_ptr(), shift.data_ptr(),
        gy.data_ptr(), ptr(y) if gstats is not None else None, ptr(gstats),
        dx.data_ptr(), dstats.data_ptr(), dw.data_ptr(), db.data_ptr(), b, d,
        h, wd, cin, cout, stream_of(x),
    )
    raise_on(rc, entry)
    LAUNCHES[entry] += 1
    return dx, dstats, dw, db


@functools.lru_cache(maxsize=None)
def _down_bwd_slices(c):
    """Blocks a tile of down2x's backward splits the 8C gathered columns
    into (grid z; csrc/resample.cu down_bwd_slices): its partial table has
    B gx times that many rows."""
    return load_library("resample").pcseg_down2x_bwd_slices(c)


def down2x_bwd_cuda(x, w, scale, shift, gy, y, gstats):
    """Backward of the down block: (dx bf16, dstats (B, 2, C) = (dscale,
    dshift), dW (2, 2, 2, C, C2), dbias (C2,)); gy/y (B, D/2, H/2, W/2,
    C2), gstats (B, 2, C2) or None (with y None). One sweep of the
    gathered tensor-core kernel where ``_mma_route`` takes the shape."""
    b, d, h, wd, c = x.shape
    if d % 2 or h % 2 or wd % 8:
        raise ValueError(f"down2x needs even D, H and W a multiple of 8, "
                         f"got {tuple(x.shape)}")
    c2 = w.shape[-1]
    out_shape = (b, d // 2, h // 2, wd // 2, c2)
    if not _mma_route(c, c2, x, gy, y if gstats is not None else None):
        return _resample_bwd_cuda("down2x_bwd", x, w, scale, shift, gy, y,
                                  gstats, out_shape)
    _common(x, w, None, scale, shift, 2)
    _cotangents(gy, y, gstats, out_shape)
    gx = _mma_grid(2, b, c, _tiles(d // 2, h // 2, wd // 2), x.device.index)
    dx = torch.empty_like(x)
    n_dw = 16 * c * c
    out = torch.empty(n_dw + c2 + 2 * b * c, dtype=torch.float32,
                      device=x.device)
    part = torch.empty((b * gx * _down_bwd_slices(c), out.numel()),
                       dtype=torch.float32, device=x.device)
    rc = load_library("resample").pcseg_down2x_bwd_mma(
        x.data_ptr(), _bf16_packed(pack_down_w(w)).data_ptr(),
        scale.data_ptr(), shift.data_ptr(), gy.data_ptr(),
        ptr(y) if gstats is not None else None, ptr(gstats), dx.data_ptr(),
        out.data_ptr(), part.data_ptr(), b, d, h, wd, c, gx, stream_of(x))
    raise_on(rc, "down2x_bwd_mma")
    LAUNCHES["down2x_bwd_mma"] += 1
    LAUNCHES["down2x_bwd"] += 1
    dw = out[:n_dw].view(2, 2, 2, c, c2)
    return (dx, out[n_dw + c2:].view(b, 2, c), dw, out[n_dw:n_dw + c2])


def up2x_bwd_cuda(x, w, scale, shift, gy, y, gstats):
    """Backward of the up block, dW in the forward's tap order; gy/y
    (B, 2D, 2H, 2W, C), gstats (B, 2, C) or None. One sweep of the
    gathered tensor-core kernel where ``_mma_route`` takes the shape."""
    b, d, h, wd, c2 = x.shape
    c = w.shape[-1]
    if wd % 4:
        raise ValueError(f"up2x backward needs W a multiple of 4, got "
                         f"{tuple(x.shape)}")
    out_shape = (b, 2 * d, 2 * h, 2 * wd, c)
    if not _mma_route(c, c2, x, gy, y if gstats is not None else None):
        return _resample_bwd_cuda("up2x_bwd", x, w, scale, shift, gy, y,
                                  gstats, out_shape)
    _common(x, w, None, scale, shift, 2)
    _cotangents(gy, y, gstats, out_shape)
    gx = _mma_grid(1, b, c, _tiles(d, h, wd), x.device.index)
    dx = torch.empty_like(x)
    n_dw = 16 * c * c
    out = torch.empty(n_dw + c + 4 * b * c, dtype=torch.float32,
                      device=x.device)
    part = torch.empty((b * gx, out.numel()), dtype=torch.float32,
                       device=x.device)
    rc = load_library("resample").pcseg_up2x_bwd_mma(
        x.data_ptr(), _bf16_packed(pack_up_wt(w)).data_ptr(),
        scale.data_ptr(), shift.data_ptr(), gy.data_ptr(),
        ptr(y) if gstats is not None else None, ptr(gstats), dx.data_ptr(),
        out.data_ptr(), part.data_ptr(), b, d, h, wd, c, gx, stream_of(x))
    raise_on(rc, "up2x_bwd_mma")
    LAUNCHES["up2x_bwd_mma"] += 1
    LAUNCHES["up2x_bwd"] += 1
    dw = out[:n_dw].view(2, 2, 2, c2, c)
    return dx, out[n_dw + c:].view(b, 2, c2), dw, out[n_dw:n_dw + c]


def _head_checks(x, w, scale, shift):
    """Validate a head launch; returns (B, V voxels an event, C, NC)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, c, dev = x.shape[0], x.shape[-1], x.device
    _check("x", x, x.shape, torch.bfloat16, dev)
    _check("scale", scale, (b, c), torch.float32, dev)
    _check("shift", shift, (b, c), torch.float32, dev)
    nc = w.shape[-1]
    if tuple(w.shape[:-1]) not in ((c,), (1, 1, 1, c)) or w.device != dev:
        raise ValueError(f"w must be (1, 1, 1, {c}, NC) on {dev}, got "
                         f"{tuple(w.shape)} on {w.device}")
    # the class-count and shared-memory limits are head_shape_ok's in
    # csrc/conv3d_block.cu, which rejects any other shape at launch
    if c % 8 or x.data_ptr() % 16:
        raise ValueError(f"the head kernels take C a multiple of 8 (16-byte "
                         f"aligned x), got C={c}")
    return b, x.numel() // (b * c), c, nc


def head_grid2_cuda(x, w, bias, scale, shift):
    """relu(x * scale + shift) -> 1x1 head -> + bias, bf16 out.

    x (B, D, H, W, C) bf16; w (1, 1, 1, C, NC), rounded to bf16; bias
    (NC,) f32; scale/shift (B, C) f32. Returns y (B, D, H, W, NC) bf16.
    Above 4 classes the kernel is a tensor-core tile kernel (mma.sync,
    f32 sums in the hardware's order), at up to 4 a thread a voxel with
    in-order FMAs (csrc/conv3d_block.cu ``pcseg_head_grid2``).
    """
    b, v, c, nc = _head_checks(x, w, scale, shift)
    _check("bias", bias, (nc,), torch.float32, x.device)
    y = torch.empty(x.shape[:4] + (nc,), dtype=torch.bfloat16,
                    device=x.device)
    rc = load_library().pcseg_head_grid2(
        x.data_ptr(), _wq(_head_w(w)).contiguous().data_ptr(),
        bias.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), b,
        v, c, nc, stream_of(x))
    raise_on(rc, "head_grid2")
    LAUNCHES["head_grid2"] += 1
    return y


def head_grid2_bwd_cuda(x, gy, w, scale, shift):
    """Backward of the head from gy (B, D, H, W, NC) bf16: (dx bf16,
    dstats (B, 2, C) = (dscale, dshift), dW (C, NC), dbias (NC,)) f32."""
    b, v, c, nc = _head_checks(x, w, scale, shift)
    _check("gy", gy, x.shape[:4] + (nc,), torch.bfloat16, x.device)
    if gy.data_ptr() % 16:
        gy = gy.clone()
    lib = load_library()
    n_part = lib.pcseg_head_grid2_bwd_scratch(b, v, c, nc)
    if n_part < 0:
        raise ValueError(f"the head backward takes C a multiple of 8 up to "
                         f"128 and 1 to 128 classes, got C={c}, NC={nc}")
    # every output is written by the kernels: no zero fills
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dstats = torch.empty((b, 2, c), **f32)
    dw = torch.empty((c, nc), **f32)
    db = torch.empty((nc,), **f32)
    part = torch.empty((n_part,), **f32)
    rc = lib.pcseg_head_grid2_bwd(
        x.data_ptr(), gy.data_ptr(), _wq(_head_w(w)).contiguous().data_ptr(),
        scale.data_ptr(), shift.data_ptr(), dx.data_ptr(), dstats.data_ptr(),
        dw.data_ptr(), db.data_ptr(), part.data_ptr(), b, v, c, nc,
        stream_of(x))
    raise_on(rc, "head_grid2_bwd")
    LAUNCHES["head_grid2_bwd"] += 1
    return dx, dstats, dw, db


# ---------------------------------------------------------------------------
# the forward kernels as registered ops (pcseg::*, ``_build.define_op``): a
# CUDA tensor launches the ``*_cuda`` wrapper, a CPU tensor runs the plain
# version, and the fake gives their output shapes, so a torch.export graph
# holds each launch as one node. A launch without stats returns an empty
# stats tensor.
# ---------------------------------------------------------------------------

def _no_stats(x):
    return x.new_empty(0, dtype=torch.float32)


def _stats_fake(x, cout, want_stats=True):
    return x.new_empty((x.shape[0], 2, cout) if want_stats else (0,),
                       dtype=torch.float32)


def _conv3x3_with(fn):
    def op(x, w, bias, scale, shift, accum, activate, want_stats):
        y, stats = fn(x, w, bias, scale, shift, accum, activate=activate,
                      want_stats=want_stats)
        return y, _no_stats(x) if stats is None else stats
    return op


def _conv3x3_fake(x, w, bias, scale, shift, accum, activate, want_stats):
    cout = w.shape[-1]
    return (x.new_empty(x.shape[:4] + (cout,), dtype=torch.bfloat16),
            _stats_fake(x, cout, want_stats))


_conv3x3_plain = _conv3x3_with(conv3x3_gn_act_plain)
_conv3x3_op = define_op(
    "conv3x3_gn_act(Tensor x, Tensor w, Tensor bias, Tensor? scale, "
    "Tensor? shift, Tensor? accum, bool activate, bool want_stats) -> "
    "(Tensor, Tensor)", _conv3x3_plain, _conv3x3_with(conv3x3_gn_act_cuda),
    _conv3x3_fake)

_RESAMPLE_SCHEMA = ("(Tensor x, Tensor w, Tensor bias, Tensor scale, "
                    "Tensor shift) -> (Tensor, Tensor)")


def _resample_fake(out_dims):
    def fake(x, w, bias, scale, shift):
        cout = w.shape[-1]
        return (x.new_empty((x.shape[0], *out_dims(x.shape[1:4]), cout),
                            dtype=torch.bfloat16), _stats_fake(x, cout))
    return fake


_down2x_op = define_op(
    "down2x_gn_act" + _RESAMPLE_SCHEMA, down2x_gn_act_plain,
    down2x_gn_act_cuda, _resample_fake(lambda dhw: [n // 2 for n in dhw]))
_up2x_op = define_op(
    "up2x_gn_act" + _RESAMPLE_SCHEMA, up2x_gn_act_plain, up2x_gn_act_cuda,
    _resample_fake(lambda dhw: [2 * n for n in dhw]))
_head_grid2_op = define_op(
    "head_grid2(Tensor x, Tensor w, Tensor bias, Tensor scale, "
    "Tensor shift) -> Tensor", head_grid2_plain, head_grid2_cuda,
    lambda x, w, bias, scale, shift: x.new_empty(
        x.shape[:4] + (w.shape[-1],), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, accum, w, bias, scale, shift, activate, want_stats,
                need_dx, plain):
        kern = on_cuda(x, plain)
        y, stats = (_conv3x3_plain if plain else _conv3x3_op)(
            x, w, bias, scale, shift, accum, activate, want_stats)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, scale, shift, y if want_stats else None)
        ctx.cfg = (kern, activate, want_stats, need_dx, accum is not None)
        if not want_stats:
            ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w, scale, shift, y = ctx.saved_tensors
        kern, activate, want_stats, need_dx, has_accum = ctx.cfg
        if gy is None:
            gy = x.new_zeros(x.shape[:4] + (w.shape[-1],))
        gy = gy.to(torch.bfloat16).contiguous()
        if not want_stats or gstats is None:
            gstats = y = None
        else:
            gstats = gstats.contiguous()
        dx = dstats = gacc = None
        # the stem's input is data: no dgrad (its dx would be dead)
        if need_dx or activate or has_accum:
            dgrad = conv3x3_dgrad_cuda if kern else conv3x3_dgrad_plain
            dx, dstats, gacc = dgrad(gy, y, gstats, x, w, scale, shift,
                                     activate, has_accum)
        wgrad = conv3x3_wgrad_cuda if kern else conv3x3_wgrad_plain
        dw, dbias = wgrad(x, scale, shift, gy, y, gstats, activate)
        dscale = dshift = None
        if dstats is not None:
            dscale, dshift = dstats[:, 0], dstats[:, 1]
        return dx, gacc, dw, dbias, dscale, dshift, None, None, None, None


_RESAMPLE = {
    # up: (forward op, forward plain, backward cuda, backward plain)
    False: (_down2x_op, down2x_gn_act_plain, down2x_bwd_cuda,
            down2x_bwd_plain),
    True: (_up2x_op, up2x_gn_act_plain, up2x_bwd_cuda, up2x_bwd_plain),
}


class _Resample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, scale, shift, up, plain):
        kern = on_cuda(x, plain)
        fwd_op, fwd_p, _, _ = _RESAMPLE[up]
        y, stats = (fwd_p if plain else fwd_op)(x, w, bias, scale, shift)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, scale, shift, y)
        ctx.cfg = (kern, up)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w, scale, shift, y = ctx.saved_tensors
        kern, up = ctx.cfg
        gy = (torch.zeros_like(y) if gy is None
              else gy.to(torch.bfloat16).contiguous())
        if gstats is None:
            y = None
        else:
            gstats = gstats.contiguous()
        _, _, bwd_k, bwd_p = _RESAMPLE[up]
        dx, dstats, dw, dbias = (bwd_k if kern else bwd_p)(
            x, w, scale, shift, gy, y, gstats)
        return dx, dw, dbias, dstats[:, 0], dstats[:, 1], None, None


def conv3x3_gn_act(x, w, bias, scale, shift, accum=None, *, activate=True,
                   want_stats=True, need_dx=True, plain=False):
    """The differentiable 3^3 block (arguments as ``conv3x3_gn_act_cuda``).
    ``need_dx=False`` with ``activate=False`` and no accum: the caller's
    input is data, and the backward launches no dgrad. Returns (y, stats
    or None)."""
    y, stats = _Conv3x3.apply(x, accum, w, bias, scale, shift,
                              bool(activate), bool(want_stats),
                              bool(need_dx), bool(plain))
    return y, stats if want_stats else None


def down2x_gn_act(x, w, bias, scale, shift, *, plain=False):
    """The differentiable down block (``down2x_gn_act_cuda``)."""
    return _Resample.apply(x, w, bias, scale, shift, False, bool(plain))


def up2x_gn_act(x, w, bias, scale, shift, *, plain=False):
    """The differentiable up block (``up2x_gn_act_cuda``)."""
    return _Resample.apply(x, w, bias, scale, shift, True, bool(plain))


class _HeadGrid2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, scale, shift, plain):
        y = (head_grid2_plain if plain else _head_grid2_op)(
            x, w, bias, scale, shift)
        ctx.save_for_backward(x, w, scale, shift)
        ctx.kern = on_cuda(x, plain)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, scale, shift = ctx.saved_tensors
        bwd = head_grid2_bwd_cuda if ctx.kern else head_grid2_bwd_plain
        dx, dstats, dw, dbias = bwd(x, gy.to(torch.bfloat16).contiguous(),
                                    w, scale, shift)
        return (dx, dw.reshape(w.shape).to(w.dtype), dbias, dstats[:, 0],
                dstats[:, 1], None)


def fused_head_grid2(x, w, bias, scale, shift, num_classes, *, plain=False):
    """relu(x * scale + shift) -> 1x1 head -> + bias as bf16 logits in the
    (B, D*H, W*NC) grid2 layout (JAX ``fused_head_grid2``; the NDHWC
    (B, D, H, W, NC) output viewed, not copied). Differentiable: the
    backward (``head_grid2_bwd_cuda``) returns dx, dW, dbias and the
    per-(batch, channel) dscale/dshift, which flow on through
    ``stats_scale_shift`` into the last conv's stats cotangent."""
    if w.shape[-1] != num_classes:
        raise ValueError(f"head kernel {tuple(w.shape)} does not end in "
                         f"num_classes={num_classes}")
    b, d, h, wd, _ = x.shape
    y = _HeadGrid2.apply(x, w, bias, scale, shift, bool(plain))
    return y.reshape(b, d * h, wd * num_classes)
