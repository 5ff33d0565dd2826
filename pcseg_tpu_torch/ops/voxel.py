"""Voxelize / devoxelize (counterpart of pcseg_tpu/ops/voxel.py).

Quantize each event's points onto an R^3 grid over its own bounding box,
scatter-mean the point features into voxels, and read per-point values
back by trilinear interpolation. Each has the JAX package's two forms,
picked by ``impl`` ("auto" resolves by the JAX package's crossover rules,
``resolve_voxelize_impl`` / ``resolve_devoxelize_impl``; at 64^3 both
resolve to "matmul"):

- ``voxelize``: "scatter", the f32-exact scatter-add; "matmul", the one-hot
  contraction's values, the point features rounded to ``matmul_dtype``
  before the f32 sums: ``voxelize_contract``, the CUDA kernel of
  csrc/onehot_contract.cu (JAX ``onehot_contract.voxelize_contract``) in
  bf16, a plain f32 scatter-add in f32.
- ``devoxelize_trilinear`` / ``devoxelize_trilinear_grid2``: "gather", the
  f32-exact 8-tap gather; "matmul", the one-hot contraction's values, with
  bf16 zy tap weights and a bf16 grid when ``bwd_dtype`` is bf16:
  ``trilinear_gather``, the CUDA kernel of the same file (JAX
  ``onehot_contract.trilinear_gather``), or its plain f32 form in f32.

Both devoxelize forms carry the JAX package's hand-written VJP: gradients
flow to the grid only, through ``trilinear_scatter`` (JAX
``onehot_contract.trilinear_scatter``) in bf16, an f32 scatter in f32.
``devoxelize_nearest`` (the masked-dense SparseVoxelNet's readout) reads
each point's own voxel, a gather.

The bf16 forms are the kernels' contracts at every R. The JAX package
takes its kernels only at R <= 64 (``_use_plane_kernels``, a VMEM limit of
the TPU) and its XLA forms, which round the z and y weights separately,
above; the port has no such gate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pcseg_tpu_torch.ops._build import (
    define_op,
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


# launches since the last reset_launches(); each wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {"voxelize_contract": 0, "trilinear_gather": 0,
            "trilinear_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_voxelize_impl(impl: str, grid_size: int, c: int) -> str:
    """'auto' -> "matmul" while R^3 * C <= 4e6, else "scatter" (the JAX
    package's measured crossover); c counts the occupancy channel."""
    if impl != "auto":
        return impl
    return "matmul" if grid_size ** 3 * c <= 4_000_000 else "scatter"


def resolve_devoxelize_impl(impl: str, grid_size: int, c: int) -> str:
    """'auto' -> "matmul" while R^3 * (C + 1) <= 4e6, else "gather" (the
    JAX package's rule, counting C + 1 columns: at a boundary channel
    count the two resolvers can differ)."""
    if impl != "auto":
        return impl
    return "matmul" if grid_size ** 3 * (c + 1) <= 4_000_000 else "gather"


def _event_box(coords: torch.Tensor, mask: torch.Tensor):
    """Masked per-event AABB. Rows with no valid point (batch padding)
    get the unit box at the origin, so nothing downstream sees inf. The
    sentinel is a Python scalar: a tensor made from it on the card would be
    a blocking host-to-device copy in every voxelize."""
    m = mask[..., None]
    has_valid = mask.any(dim=1)[:, None]
    lo = torch.where(m, coords, 3.4e38).amin(dim=1)
    hi = torch.where(m, coords, -3.4e38).amax(dim=1)
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


# ---------------------------------------------------------------------------
# voxelize: the sums of point rows per voxel
# ---------------------------------------------------------------------------

def voxelize_contract_plain(flat: torch.Tensor, ext: torch.Tensor, r: int,
                            round_bf16: bool = True) -> torch.Tensor:
    """sums[b, v, k] = sum_p [flat[b, p] == v] ext[b, p, k] as (B, R^3, C1)
    f32, each value rounded to bf16 first unless ``round_bf16=False``: one
    ``index_add_`` into an (R^3 + 1)-row table per event whose spill row,
    where the sentinel ids of masked points land, is dropped."""
    b, _, c1 = ext.shape
    r3 = r ** 3
    vals = ext.to(torch.bfloat16).float() if round_bf16 else ext.float()
    rows = flat.long() + torch.arange(b, device=flat.device)[:, None] * (
        r3 + 1)
    out = torch.zeros(b * (r3 + 1), c1, dtype=torch.float32,
                      device=ext.device)
    out.index_add_(0, rows.reshape(-1), vals.reshape(-1, c1))
    return out.reshape(b, r3 + 1, c1)[:, :r3]


def voxelize_contract(flat: torch.Tensor, ext: torch.Tensor, r: int, *,
                      plain: bool = False) -> torch.Tensor:
    """The matmul voxelizer's sums (B, R^3, C1) f32 (JAX
    ``onehot_contract.voxelize_contract``, whose (B, R^2, R*C1) output is
    the same row-major memory): flat (B, M) int32 or int64 voxel ids with
    the sentinel R^3 for masked points; ext (B, M, C1) point rows, rounded
    to bf16. The registered op ``pcseg::voxelize_contract``: on a CUDA
    tensor one kernel launch writes the whole table, its zeros included,
    from the ids as they come; on a CPU tensor (or with ``plain``) the
    plain version."""
    if plain:
        return voxelize_contract_plain(flat, ext, r)
    on_cuda(ext)                  # refuses a device other than CPU or CUDA
    return _voxelize_op(flat, ext, r)


def voxelize_contract_cuda(flat: torch.Tensor, ext: torch.Tensor,
                           r: int) -> torch.Tensor:
    """The voxelizer's launch on CUDA tensors."""
    b, m, c1 = ext.shape
    if tuple(flat.shape) != (b, m) or flat.device != ext.device:
        raise ValueError(f"flat must be (B, M) = {(b, m)} on {ext.device}, "
                         f"got {tuple(flat.shape)} on {flat.device}")
    if flat.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"flat must be int32 or int64, got {flat.dtype}")
    flat = flat.contiguous()
    ext = ext.float().contiguous()
    out = torch.empty((b, r ** 3, c1), dtype=torch.float32,
                      device=ext.device)
    rc = load_library("onehot_contract").pcseg_voxelize_contract(
        flat.data_ptr(), flat.element_size(), ext.data_ptr(), out.data_ptr(),
        b, m, r, c1, stream_of(ext))
    raise_on(rc, "voxelize_contract")
    LAUNCHES["voxelize_contract"] += 1
    return out


_voxelize_op = define_op(
    "voxelize_contract(Tensor flat, Tensor ext, int r) -> Tensor",
    lambda flat, ext, r: voxelize_contract_plain(flat, ext, r).contiguous(),
    voxelize_contract_cuda,
    lambda flat, ext, r: ext.new_empty((ext.shape[0], r ** 3, ext.shape[2]),
                                       dtype=torch.float32))


def voxel_rows(points: torch.Tensor, mask: torch.Tensor, grid_size: int):
    """The voxelizer's operands: flat (B, M) voxel ids (R^3 for masked
    points), ext (B, M, C + 1) rows of the features (columns 3:), the
    occupancy 1 and the count 1, masked rows zero, and the box (lo,
    scale)."""
    feats = points[..., 3:].float()
    ones = feats.new_ones(feats.shape[:-1] + (1,))
    flat, lo, scale = voxel_indices(points[..., :3].float(), mask, grid_size)
    ext = torch.cat([feats, ones, ones], dim=-1)
    ext = torch.where(mask[..., None], ext, torch.zeros_like(ext))
    return flat, ext, lo, scale


def voxelize(points: torch.Tensor, mask: torch.Tensor, grid_size: int,
             feature_dim: int | None = None, impl: str = "scatter",
             matmul_dtype=torch.bfloat16, *,
             plain: bool = False) -> VoxelGrid:
    """Scatter-mean point features into an R^3 grid (f32).

    points (B, M, 3+F): the features are columns 3: (the first
    ``feature_dim`` of them, where given) plus a constant-1 occupancy
    channel, so C = F + 1; a ones column beside them counts the points.
    "scatter" sums in f32; "matmul" rounds the features to
    ``matmul_dtype`` first (bf16: ``voxelize_contract`` on C + 1 columns;
    f32: exact), as the JAX one-hot contraction does; counts are exact in
    both. The mean divides in f32.
    """
    if feature_dim is not None:
        points = torch.cat([points[..., :3],
                            points[..., 3:][..., :feature_dim]], dim=-1)
    b = points.shape[0]
    flat, ext, lo, scale = voxel_rows(points, mask, grid_size)
    c = ext.shape[-1] - 1
    impl = resolve_voxelize_impl(impl, grid_size, c)
    if impl == "scatter":
        sums = voxelize_contract_plain(flat, ext, grid_size, round_bf16=False)
    elif impl == "matmul":
        if matmul_dtype == torch.bfloat16:
            sums = voxelize_contract(flat, ext, grid_size, plain=plain)
        elif matmul_dtype == torch.float32:
            sums = voxelize_contract_plain(flat, ext, grid_size,
                                           round_bf16=False)
        else:
            raise ValueError(f"matmul_dtype must be bf16 or f32, got "
                             f"{matmul_dtype}")
    else:
        raise ValueError(f"unknown voxelize impl {impl!r}")
    cnts = sums[..., c]
    mean = sums[..., :c] / torch.clamp(cnts[..., None], min=1.0)
    shape = (b, grid_size, grid_size, grid_size)
    return VoxelGrid(mean.reshape(shape + (c,)), cnts.reshape(shape), lo,
                     scale)


def devoxelize_nearest(grid_feats: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, lo: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Each point's voxel value: grid_feats (B, R, R, R, C) -> (B, M, C),
    masked points zero."""
    b, r, c = grid_feats.shape[0], grid_feats.shape[1], grid_feats.shape[-1]
    coords = points[..., :3].float()
    ijk = torch.floor((coords - lo[:, None, :]) * scale[:, None, :])
    ijk = ijk.to(torch.int64).clamp(0, r - 1)
    flat = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
    flat = torch.where(mask, flat, 0)
    out = torch.gather(grid_feats.reshape(b, r ** 3, c), 1,
                       flat[..., None].expand(-1, -1, c))
    return torch.where(mask[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# devoxelize: the trilinear taps
# ---------------------------------------------------------------------------

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


def _axis_taps(u1: torch.Tensor, r: int):
    """One axis' two (index, weight) taps, both indices clipped to
    [0, R-1] (so clipped edges give duplicates)."""
    i0f = torch.floor(u1)
    frac = u1 - i0f
    i0 = i0f.to(torch.int64)
    return ((i0.clamp(0, r - 1), 1.0 - frac),
            ((i0 + 1).clamp(0, r - 1), frac))


def _tri_taps(u: torch.Tensor, r: int, rnd):
    """The kernels' taps (csrc/onehot_contract.cu zy_taps, x_taps): the four
    zy ids z * R + y in z-outer order with their weights, wz * wy in f32,
    duplicate ids summed in f32 and passed through ``rnd`` once, later
    copies 0; and the two x ids with their f32 weights, a duplicate folded
    into the first."""
    tz, ty, tx = (_axis_taps(u[..., a].float(), r) for a in range(3))
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
    wx = [torch.where(dup, w0 + w1, w0), torch.where(dup, torch.zeros_like(w1),
                                                     w1)]
    return zi, a, (x0, x1), wx


def _rounder(round_bf16: bool):
    if round_bf16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


# ---------------------------------------------------------------------------
# devoxelize forward, matmul form: the trilinear gather
# ---------------------------------------------------------------------------

def _grid2_dims(g2: torch.Tensor):
    b, rr, rc = g2.shape
    r = math.isqrt(rr)
    if r * r != rr or rc % r:
        raise ValueError(f"grid2 shape {tuple(g2.shape)} is not "
                         "(B, R*R, R*C)")
    return b, r, rc // r


def trilinear_gather_plain(u: torch.Tensor, mask: torch.Tensor,
                           g2: torch.Tensor,
                           round_bf16: bool = True) -> torch.Tensor:
    """out[p, k] = mask_p sum_x Wx[p, x] sum_zy A[p, zy] g2[zy, x*C + k] as
    (B, M, C) f32, with the kernel's taps (``_tri_taps``) and order of
    sums: for each x tap the zy sum first, then times the x weight, summed
    over x. ``round_bf16`` rounds the zy weights and the grid to bf16 (the
    kernel's contract); False keeps f32 (the f32 models' form)."""
    b, r, c = _grid2_dims(g2)
    rnd = _rounder(round_bf16)
    g = rnd(g2.float()).reshape(b, r ** 3, c)
    zi, a, xs, wx = _tri_taps(u, r, rnd)
    out = torch.zeros(u.shape[:2] + (c,), dtype=torch.float32,
                      device=g2.device)
    for xi, w in zip(xs, wx):
        s = torch.zeros_like(out)
        for t in range(4):
            idx = (zi[t] * r + xi)[..., None].expand(-1, -1, c)
            s = s + a[t][..., None] * torch.gather(g, 1, idx)
        out = out + w[..., None] * s
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the gather loads grid rows with vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def trilinear_gather(u: torch.Tensor, mask: torch.Tensor, g2: torch.Tensor,
                     *, plain: bool = False) -> torch.Tensor:
    """The matmul devoxelize forward (B, M, C) f32 (JAX
    ``onehot_contract.trilinear_gather``). u (B, M, 3) continuous voxel
    coords (``trilinear_u``); mask (B, M); g2 (B, R*R, R*C) grid2, rounded
    to bf16. The registered op ``pcseg::trilinear_gather``: the CUDA kernel
    on a CUDA tensor (above 32 channels, a thread a point and 32-channel
    column chunk), the plain version on a CPU tensor (or with
    ``plain``)."""
    if plain:
        return trilinear_gather_plain(u, mask, g2)
    on_cuda(g2)                   # refuses a device other than CPU or CUDA
    return _gather_op(u, mask, g2, _grid2_dims(g2)[1])


def trilinear_gather_cuda(u: torch.Tensor, mask: torch.Tensor,
                          g2: torch.Tensor) -> torch.Tensor:
    """The gather's launch on CUDA tensors."""
    b, r, c = _grid2_dims(g2)
    m = u.shape[1]
    if tuple(u.shape) != (b, m, 3) or tuple(mask.shape) != (b, m) or \
            u.device != g2.device or mask.device != g2.device:
        raise ValueError(f"u (B, M, 3) and mask (B, M) must lie on "
                         f"{g2.device} with B = {b}, got {tuple(u.shape)}, "
                         f"{tuple(mask.shape)}")
    if c > 32 * 65535:
        raise ValueError(f"trilinear_gather takes at most 65,535 column "
                         f"chunks of 32 channels, got {c} channels")
    u = u.float().contiguous()
    mask = mask.to(torch.bool).contiguous()
    g2 = _aligned(g2.to(torch.bfloat16).contiguous())
    out = torch.empty((b, m, c), dtype=torch.float32, device=g2.device)
    rc = load_library("onehot_contract").pcseg_trilinear_gather(
        u.data_ptr(), mask.data_ptr(), g2.data_ptr(), out.data_ptr(), b, m,
        r, c, stream_of(g2))
    raise_on(rc, "trilinear_gather")
    LAUNCHES["trilinear_gather"] += 1
    return out


# r, the grid's edge, is an argument so that the fake needs no square root
# of a symbolic size
_gather_op = define_op(
    "trilinear_gather(Tensor u, Tensor mask, Tensor g2, int r) -> Tensor",
    lambda u, mask, g2, r: trilinear_gather_plain(u, mask, g2),
    lambda u, mask, g2, r: trilinear_gather_cuda(u, mask, g2),
    lambda u, mask, g2, r: u.new_empty((u.shape[0], u.shape[1],
                                        g2.shape[2] // r),
                                       dtype=torch.float32))


# ---------------------------------------------------------------------------
# devoxelize backward: the trilinear scatter of the point cotangents
# ---------------------------------------------------------------------------

def trilinear_scatter_taps(u: torch.Tensor, go: torch.Tensor, r: int,
                           round_bf16: bool = True):
    """The scatter's terms: (rows (8, B*M) int64 into the flat (B*R^3, C)
    grid, values (8, B*M, C) f32), one per (zy, x) tap pair, with the
    kernel's rounding points (csrc/onehot_contract.cu): the taps of
    ``_tri_taps`` with the x weights rounded to bf16 too, operand
    bf16(wx * go). A duplicate tap's later copies carry zero values.
    ``round_bf16=False`` keeps every weight and operand in f32 (the f32
    models' backward)."""
    rnd = _rounder(round_bf16)
    b = go.shape[0]
    zi, a, xs, wx = _tri_taps(u, r, rnd)
    wx = [rnd(w) for w in wx]
    gob = rnd(go.float())
    base = (torch.arange(b, device=go.device) * r ** 3)[:, None]
    rows, vals = [], []
    for t in range(4):
        for xi, wxe in zip(xs, wx):
            rows.append((base + zi[t] * r + xi).reshape(-1))
            vals.append((a[t][..., None] * rnd(wxe[..., None] * gob))
                        .reshape(-1, go.shape[-1]))
    return torch.stack(rows), torch.stack(vals)


def trilinear_scatter_plain(u: torch.Tensor, go: torch.Tensor, r: int,
                            round_bf16: bool = True,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """dgrid[b, (z*R + y)*R + x, k] = sum_p A[p, zy] Wx[p, x] go[p, k] as
    (B, R^3, C): the terms of ``trilinear_scatter_taps`` added with
    ``index_add_`` in f32, each sum rounded once to ``out_dtype``."""
    b, _, c = go.shape
    out = torch.zeros(b * r ** 3, c, dtype=torch.float32, device=go.device)
    rows, vals = trilinear_scatter_taps(u, go, r, round_bf16)
    for rw, vl in zip(rows, vals):
        out.index_add_(0, rw, vl)
    return out.reshape(b, r ** 3, c).to(out_dtype)


_SCATTER_SCRATCH: dict = {}


def _scatter_scratch(b: int, m: int, r: int, c: int) -> int:
    """The 16-byte units of scratch the scatter's kernels use at this shape
    (the library's plan; -1 where it takes no such call)."""
    key = (b, m, r, c)
    n = _SCATTER_SCRATCH.get(key)
    if n is None:
        n = _SCATTER_SCRATCH[key] = load_library(
            "onehot_contract").pcseg_trilinear_scatter_scratch(b, m, r, c)
    return n


def trilinear_scatter(u: torch.Tensor, go: torch.Tensor, r: int, *,
                      out_dtype: torch.dtype = torch.float32,
                      plain: bool = False) -> torch.Tensor:
    """The devoxelize backward's grid cotangent (B, R^3, C) (JAX
    ``onehot_contract.trilinear_scatter``): f32 sums, each rounded once to
    ``out_dtype`` (f32, the JAX kernel's output, or bf16). u (B, M, 3)
    continuous voxel coords (``trilinear_u``); go (B, M, C) point
    cotangents, masked rows zero. Launches the CUDA kernels (binning, then
    one warp per grid tile, 32 channels at a time above 32) on a CUDA
    tensor."""
    if not on_cuda(go, plain):
        return trilinear_scatter_plain(u, go, r, out_dtype=out_dtype)
    b, m, c = go.shape
    if tuple(u.shape) != (b, m, 3) or u.device != go.device:
        raise ValueError(f"u must be (B, M, 3) on {go.device}, got "
                         f"{tuple(u.shape)} on {u.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"trilinear_scatter writes f32 or bf16, not "
                         f"{out_dtype}")
    units = _scatter_scratch(b, m, r, c)
    if units < 0:
        raise ValueError(f"trilinear_scatter takes no (B, M, R, C) = "
                         f"{(b, m, r, c)}: B <= 65,535 and one zy row of a "
                         "32-channel chunk in f32 within a block's shared "
                         "memory")
    u = u.float().contiguous()
    go = go.float().contiguous()
    out = torch.empty((b, r ** 3, c), dtype=out_dtype, device=go.device)
    scratch = torch.empty((units, 4), dtype=torch.int32, device=go.device)
    rc = load_library("onehot_contract").pcseg_trilinear_scatter(
        u.data_ptr(), go.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
        m, r, c, int(out_dtype == torch.bfloat16), stream_of(go))
    raise_on(rc, "trilinear_scatter")
    LAUNCHES["trilinear_scatter"] += 1
    return out


class _Devoxelize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid_feats, points, mask, lo, scale, bwd_dtype, impl,
                plain):
        ctx.save_for_backward(points, mask, lo, scale)
        ctx.cfg = (tuple(grid_feats.shape), grid_feats.dtype, bwd_dtype,
                   plain)
        if impl == "gather":
            return _devox_gather(grid_feats, points, mask, lo, scale)
        b, r, c = grid_feats.shape[0], grid_feats.shape[1], \
            grid_feats.shape[-1]
        u = trilinear_u(points, mask, lo, scale)
        g2 = grid_feats.reshape(b, r * r, r * c)
        if bwd_dtype == torch.bfloat16:
            return trilinear_gather(u, mask, g2, plain=plain)
        return trilinear_gather_plain(u, mask, g2, round_bf16=False)

    @staticmethod
    def backward(ctx, go):
        points, mask, lo, scale = ctx.saved_tensors
        shape, dtype, bwd_dtype, plain = ctx.cfg
        u = trilinear_u(points, mask, lo, scale)
        go = torch.where(mask[..., None], go.float(), 0.0)
        if bwd_dtype == torch.bfloat16:
            dgrid = trilinear_scatter(u, go, shape[1], out_dtype=dtype,
                                      plain=plain)
        else:
            dgrid = trilinear_scatter_plain(u, go, shape[1],
                                            round_bf16=False, out_dtype=dtype)
        return dgrid.reshape(shape), None, None, None, None, None, None, None


def devoxelize_trilinear(grid_feats: torch.Tensor, points: torch.Tensor,
                         mask: torch.Tensor, lo: torch.Tensor,
                         scale: torch.Tensor, impl: str = "gather", *,
                         bwd_dtype: torch.dtype = torch.bfloat16,
                         plain: bool = False) -> torch.Tensor:
    """Trilinear interpolation over the 8 voxel centers around each point:
    (B, R, R, R, C) -> (B, M, C) f32. Taps are clipped per axis to
    [0, R-1]; masked points give 0.

    ``impl``: "gather" (f32-exact), "matmul" (``trilinear_gather`` with
    bf16 zy weights and grid when ``bwd_dtype`` is bf16, its f32 form
    otherwise) or "auto" (``resolve_devoxelize_impl``).

    Backward (the JAX custom VJP): the grid cotangent is
    ``trilinear_scatter`` of the masked point cotangents, with bf16
    weights and operands when ``bwd_dtype`` is bf16 and in f32 otherwise,
    its f32 sums rounded once to the grid's dtype (the kernel writes that
    dtype itself); points, lo and scale get none (they are data in every
    training path)."""
    impl = resolve_devoxelize_impl(impl, grid_feats.shape[1],
                                   grid_feats.shape[-1])
    if impl not in ("gather", "matmul"):
        raise ValueError(f"unknown devoxelize impl {impl!r}")
    if bwd_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bwd_dtype must be bf16 or f32, got {bwd_dtype}")
    return _Devoxelize.apply(grid_feats, points, mask, lo, scale, bwd_dtype,
                             impl, bool(plain))


def devoxelize_trilinear_grid2(grid2: torch.Tensor, points: torch.Tensor,
                               mask: torch.Tensor, lo: torch.Tensor,
                               scale: torch.Tensor, impl: str = "matmul", *,
                               bwd_dtype: torch.dtype = torch.bfloat16,
                               plain: bool = False) -> torch.Tensor:
    """``devoxelize_trilinear`` on the (B, R*R, R*C) "grid2" layout, as
    the fused head (``conv3d_block.fused_head_grid2``) emits it. grid2 and
    the NDHWC (B, R, R, R, C) grid are the same row-major memory, so this
    is a view; the grid cotangent comes back in grid2's dtype (bf16 on the
    default path), as the JAX ``_devox_grid2_bwd`` casts it."""
    b, r, c = _grid2_dims(grid2)
    return devoxelize_trilinear(grid2.reshape(b, r, r, r, c), points, mask,
                                lo, scale, impl, bwd_dtype=bwd_dtype,
                                plain=plain)
