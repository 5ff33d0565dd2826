"""Voxelize / devoxelize, forward only (counterpart of pcseg_tpu/ops/voxel.py).

Quantize each event's points onto an R^3 grid over its own bounding box,
scatter-mean the point features into voxels, and read per-point values
back by trilinear interpolation. These are the JAX package's f32-exact
forms, ``voxelize(impl="scatter")`` and ``devoxelize_trilinear(
impl="gather")``; its one-hot matmul forms exist only to keep scatters
off the TPU and run through kernels that are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def devoxelize_trilinear(grid_feats: torch.Tensor, points: torch.Tensor,
                         mask: torch.Tensor, lo: torch.Tensor,
                         scale: torch.Tensor,
                         impl: str = "gather") -> torch.Tensor:
    """Trilinear interpolation over the 8 voxel centers around each point:
    (B, R, R, R, C) -> (B, M, C) f32. Taps are clipped per axis to
    [0, R-1]; masked points give 0."""
    if impl != "gather":
        raise NotImplementedError(
            f"devoxelize impl {impl!r}: only 'gather' is ported (the one-hot "
            "matmul form waits for ROADMAP Queue B, default voxel "
            "configuration)"
        )
    b, r = grid_feats.shape[0], grid_feats.shape[1]
    c = grid_feats.shape[-1]
    flat_grid = grid_feats.float().reshape(b, r * r * r, c)
    coords = points[..., :3].float()
    # continuous voxel coords, centered: voxel i covers [i, i+1)
    u = (coords - lo[:, None, :]) * scale[:, None, :] - 0.5
    u = torch.where(mask[..., None], u, torch.zeros_like(u))
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
