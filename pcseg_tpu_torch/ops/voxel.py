"""Voxelize / devoxelize (counterpart of pcseg_tpu/ops/voxel.py).

Quantize each event's points onto an R^3 grid over its own bounding box,
scatter-mean the point features into voxels, and read per-point values
back by trilinear interpolation. The forwards are the JAX package's
f32-exact forms, ``voxelize(impl="scatter")`` and ``devoxelize_trilinear(
impl="gather")``; its one-hot matmul forward forms exist only to keep
scatters off the TPU and run through kernels that are not ported yet.

``devoxelize_trilinear`` carries the JAX package's hand-written VJP:
gradients flow to the grid only, through ``trilinear_scatter``, the CUDA
kernel of csrc/onehot_contract.cu (JAX ``onehot_contract.trilinear_scatter``)
in bf16 models, or an f32 scatter in f32 models.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

_EPS = 1e-6


class VoxelGrid(NamedTuple):
    features: torch.Tensor  # (B, R, R, R, C) mean point features per voxel
    counts: torch.Tensor    # (B, R, R, R) points per voxel
    lo: torch.Tensor        # (B, 3) event-box lower corner
    scale: torch.Tensor     # (B, 3) voxels per unit length


def _event_box(coords: torch.Tensor, mask: torch.Tensor):
    """Masked per-event AABB. Rows with no valid point (batch padding)
    get the unit box at the origin, so nothing downstream sees inf."""
    big = torch.tensor(3.4e38, dtype=coords.dtype, device=coords.device)
    m = mask[..., None]
    has_valid = mask.any(dim=1)[:, None]
    lo = torch.where(m, coords, big).amin(dim=1)
    hi = torch.where(m, coords, -big).amax(dim=1)
    lo = torch.where(has_valid, lo, torch.zeros_like(lo))
    hi = torch.where(has_valid, hi, torch.ones_like(hi))
    span = torch.clamp(hi - lo, min=_EPS)
    return lo, span


def voxel_indices(coords: torch.Tensor, mask: torch.Tensor, grid_size: int):
    """(B, M, 3) coords -> (B, M) flat voxel ids in [0, R^3), plus the box.
    Masked points get id R^3 (the spill voxel)."""
    lo, span = _event_box(coords, mask)
    scale = grid_size / span
    ijk = torch.floor((coords - lo[:, None, :]) * scale[:, None, :])
    ijk = ijk.to(torch.int64).clamp(0, grid_size - 1)
    flat = (ijk[..., 0] * grid_size + ijk[..., 1]) * grid_size + ijk[..., 2]
    flat = torch.where(mask, flat, torch.full_like(flat, grid_size ** 3))
    return flat, lo, scale


def voxelize(points: torch.Tensor, mask: torch.Tensor, grid_size: int,
             impl: str = "scatter") -> VoxelGrid:
    """Scatter-mean point features into an R^3 grid (f32).

    points (B, M, 3+F): the features scattered are columns 3: plus a
    constant-1 occupancy channel, so C = F + 1. Sums and counts go into
    an (R^3 + 1)-row table per event with ``index_add_``; masked points
    land in the spill row, which is dropped.
    """
    if impl != "scatter":
        raise NotImplementedError(
            f"voxelize impl {impl!r}: only 'scatter' is ported (the one-hot "
            "matmul form waits for ROADMAP Queue B, default voxel "
            "configuration)"
        )
    b, m = points.shape[:2]
    coords = points[..., :3].float()
    feats = points[..., 3:].float()
    feats = torch.cat([feats, torch.ones_like(feats[..., :1])], dim=-1)
    c = feats.shape[-1]
    r3 = grid_size ** 3
    flat, lo, scale = voxel_indices(coords, mask, grid_size)
    feats = torch.where(mask[..., None], feats, torch.zeros_like(feats))

    rows = (flat + torch.arange(b, device=flat.device)[:, None] * (r3 + 1))
    rows = rows.reshape(-1)
    sums = torch.zeros(b * (r3 + 1), c, device=points.device)
    sums.index_add_(0, rows, feats.reshape(-1, c))
    cnts = torch.zeros(b * (r3 + 1), device=points.device)
    cnts.index_add_(0, rows, torch.ones(b * m, device=points.device))
    sums = sums.reshape(b, r3 + 1, c)[:, :r3]
    cnts = cnts.reshape(b, r3 + 1)[:, :r3]
    mean = sums / torch.clamp(cnts[..., None], min=1.0)
    shape = (b, grid_size, grid_size, grid_size)
    return VoxelGrid(mean.reshape(shape + (c,)), cnts.reshape(shape), lo,
                     scale)


def trilinear_u(points: torch.Tensor, mask: torch.Tensor, lo: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Continuous, centered voxel coords (B, M, 3) f32: voxel i covers
    [i, i+1), center i + 0.5. Masked points are pinned to 0 so that they
    stay finite."""
    coords = points[..., :3].float()
    u = (coords - lo[:, None, :]) * scale[:, None, :] - 0.5
    return torch.where(mask[..., None], u, torch.zeros_like(u))


def _devox_gather(grid_feats, points, mask, lo, scale):
    b, r = grid_feats.shape[0], grid_feats.shape[1]
    c = grid_feats.shape[-1]
    flat_grid = grid_feats.float().reshape(b, r * r * r, c)
    u = trilinear_u(points, mask, lo, scale)
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = i0f.to(torch.int64)

    out = torch.zeros(b, points.shape[1], c, device=grid_feats.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ijk = (i0 + torch.tensor([dx, dy, dz], device=i0.device)
                       ).clamp(0, r - 1)
                flat = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                gathered = torch.gather(
                    flat_grid, 1, flat[..., None].expand(-1, -1, c)
                )
                out = out + gathered * w[..., None]
    return torch.where(mask[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# devoxelize backward: the trilinear scatter of the point cotangents
# ---------------------------------------------------------------------------

# launches since the last reset_launches(); the wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {"trilinear_scatter": 0}


def reset_launches() -> None:
    LAUNCHES["trilinear_scatter"] = 0


def _axis_taps(u1: torch.Tensor, r: int):
    """One axis' two (index, weight) taps, both indices clipped to
    [0, R-1] (so clipped edges give duplicates)."""
    i0f = torch.floor(u1)
    frac = u1 - i0f
    i0 = i0f.to(torch.int64)
    return ((i0.clamp(0, r - 1), 1.0 - frac),
            ((i0 + 1).clamp(0, r - 1), frac))


def trilinear_scatter_taps(u: torch.Tensor, go: torch.Tensor, r: int,
                           round_bf16: bool = True):
    """The scatter's terms: (rows (8, B*M) int64 into the flat (B*R^3, C)
    grid, values (8, B*M, C) f32), one per (zy, x) tap pair, with the
    kernel's rounding points (csrc/onehot_contract.cu): zy weights wz * wy
    in f32, duplicate taps summed in f32 and rounded to bf16 once, x
    weights likewise, operand bf16(wx * go). A duplicate tap's later
    copies carry zero values. ``round_bf16=False`` keeps every weight and
    operand in f32 (the f32 models' backward)."""
    if round_bf16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t
    b = go.shape[0]
    u = u.float()
    tz, ty, tx = (_axis_taps(u[..., a], r) for a in range(3))
    zi = [iz * r + iy for iz, _ in tz for iy, _ in ty]
    zw = [wz * wy for _, wz in tz for _, wy in ty]
    a = []
    for t in range(4):
        s = torch.zeros_like(zw[t])
        first = torch.ones_like(zi[t], dtype=torch.bool)
        for o in range(4):
            same = zi[o] == zi[t]
            s = s + torch.where(same, zw[o], torch.zeros_like(zw[o]))
            if o < t:
                first &= ~same
        a.append(torch.where(first, rnd(s), torch.zeros_like(s)))
    (x0, w0), (x1, w1) = tx
    dup = x0 == x1
    wx = [rnd(torch.where(dup, w0 + w1, w0)),
          torch.where(dup, torch.zeros_like(w1), rnd(w1))]
    gob = rnd(go.float())
    base = (torch.arange(b, device=go.device) * r ** 3)[:, None]
    rows, vals = [], []
    for t in range(4):
        for xi, wxe in zip((x0, x1), wx):
            rows.append((base + zi[t] * r + xi).reshape(-1))
            vals.append((a[t][..., None] * rnd(wxe[..., None] * gob))
                        .reshape(-1, go.shape[-1]))
    return torch.stack(rows), torch.stack(vals)


def trilinear_scatter_plain(u: torch.Tensor, go: torch.Tensor, r: int,
                            round_bf16: bool = True) -> torch.Tensor:
    """dgrid[b, (z*R + y)*R + x, k] = sum_p A[p, zy] Wx[p, x] go[p, k] as
    (B, R^3, C) f32: the terms of ``trilinear_scatter_taps`` added with
    ``index_add_``."""
    b, _, c = go.shape
    out = torch.zeros(b * r ** 3, c, dtype=torch.float32, device=go.device)
    rows, vals = trilinear_scatter_taps(u, go, r, round_bf16)
    for rw, vl in zip(rows, vals):
        out.index_add_(0, rw, vl)
    return out.reshape(b, r ** 3, c)


def trilinear_scatter(u: torch.Tensor, go: torch.Tensor, r: int, *,
                      plain: bool = False) -> torch.Tensor:
    """The devoxelize backward's grid cotangent (B, R^3, C) f32 (JAX
    ``onehot_contract.trilinear_scatter``). u (B, M, 3) continuous voxel
    coords (``trilinear_u``); go (B, M, C) point cotangents, masked rows
    zero. Launches the CUDA kernel on a CUDA tensor."""
    if not on_cuda(go, plain):
        return trilinear_scatter_plain(u, go, r)
    b, m, c = go.shape
    u = u.float().contiguous()
    go = go.float().contiguous()
    if tuple(u.shape) != (b, m, 3) or u.device != go.device:
        raise ValueError(f"u must be (B, M, 3) on {go.device}, got "
                         f"{tuple(u.shape)} on {u.device}")
    if c > 32:
        raise ValueError(f"trilinear_scatter takes at most 32 channels, "
                         f"got {c}")
    out = torch.zeros((b, r ** 3, c), dtype=torch.float32, device=go.device)
    rc = load_library("onehot_contract").pcseg_trilinear_scatter(
        u.data_ptr(), go.data_ptr(), out.data_ptr(), b, m, r, c,
        stream_of(go))
    raise_on(rc, "trilinear_scatter")
    LAUNCHES["trilinear_scatter"] += 1
    return out


class _Devoxelize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid_feats, points, mask, lo, scale, bwd_dtype, plain):
        ctx.save_for_backward(points, mask, lo, scale)
        ctx.cfg = (tuple(grid_feats.shape), grid_feats.dtype, bwd_dtype,
                   plain)
        return _devox_gather(grid_feats, points, mask, lo, scale)

    @staticmethod
    def backward(ctx, go):
        points, mask, lo, scale = ctx.saved_tensors
        shape, dtype, bwd_dtype, plain = ctx.cfg
        u = trilinear_u(points, mask, lo, scale)
        go = torch.where(mask[..., None], go.float(), 0.0)
        if bwd_dtype == torch.bfloat16:
            dgrid = trilinear_scatter(u, go, shape[1], plain=plain)
        else:
            dgrid = trilinear_scatter_plain(u, go, shape[1],
                                            round_bf16=False)
        return dgrid.reshape(shape).to(dtype), None, None, None, None, None, \
            None


def devoxelize_trilinear(grid_feats: torch.Tensor, points: torch.Tensor,
                         mask: torch.Tensor, lo: torch.Tensor,
                         scale: torch.Tensor, impl: str = "gather", *,
                         bwd_dtype: torch.dtype = torch.bfloat16,
                         plain: bool = False) -> torch.Tensor:
    """Trilinear interpolation over the 8 voxel centers around each point:
    (B, R, R, R, C) -> (B, M, C) f32. Taps are clipped per axis to
    [0, R-1]; masked points give 0.

    Backward (the JAX custom VJP): the grid cotangent is
    ``trilinear_scatter`` of the masked point cotangents, with bf16
    weights and operands when ``bwd_dtype`` is bf16 and in f32 otherwise;
    points, lo and scale get none (they are data in every training
    path)."""
    if impl != "gather":
        raise NotImplementedError(
            f"devoxelize impl {impl!r}: only 'gather' is ported (the one-hot "
            "matmul form waits for ROADMAP Queue B, default voxel "
            "configuration)"
        )
    if bwd_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bwd_dtype must be bf16 or f32, got {bwd_dtype}")
    return _Devoxelize.apply(grid_feats, points, mask, lo, scale, bwd_dtype,
                             bool(plain))
