"""Block-sparse voxels: the occupied t^3 tiles of each event, with the
backward of the readout and the octant glue (counterpart of
pcseg_tpu/ops/block_sparse.py).

The R^3 grid is cut into (R/t)^3 tiles; each event keeps its occupied
tiles, in ascending tile id, up to a static capacity (the first
``max_tiles``, as ``jnp.nonzero(size=max_tiles)`` picks them) and counts the
rest as dropped. A (T^3 + 1,) lookup maps a tile id to its slot (-1 for
none), so the 27-neighbour table of every tile is one batched gather. The
JAX module's per-event ``vmap``s are batched indexing here.

- ``block_sparse_voxelize``: points straight into the tile layout, the
  voxelizer summing by the blocked id tid * t^3 + intra (bf16
  ``voxelize_contract`` on the "matmul" form in bf16, an f32 scatter-add
  otherwise), mean features plus the occupancy channel min(count, 1).
- ``neighbor_slots`` (JAX ``_neighbor_slots``), ``block_subm_conv`` (the
  raw form, through ops/block_conv.py, where the gather form of the JAX
  ``_gather_halo_slots`` lives beside the plain conv that uses it),
  ``point_cells`` and ``readout`` (JAX ``_point_cells``, ``_readout``),
  ``block_gather_point_logits``. The readout's backward is
  ``rowcol_scatter``, the form the TPU runs (JAX ``_readout_bwd``): the
  per-point cotangents rounded to bf16 and summed in f32 into their
  (slot, voxel) cells, on a CUDA tensor by ``pcseg_rowcol_scatter``
  (csrc/onehot_contract.cu), on a CPU tensor by ``rowcol_scatter_plain``.
- The hierarchy: ``block_pool`` (coarse skeleton, child slots, 2^3-pooled
  active mask), ``parent_rows``, ``octant_pack`` / ``octant_unpack``
  (JAX ``_octant_pack_raw`` / ``_octant_unpack_raw``), ``block_down2x``
  and ``block_up2x`` in the raw form the fused-LN model takes: the stride-2
  k=2 conv and the transposed conv as f32 products of dtype-valued
  operands, rounded once to the compute dtype, no bias, no mask.
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
from pcseg_tpu_torch.ops.block_conv import block_conv
from pcseg_tpu_torch.ops.voxel import (
    resolve_voxelize_impl,
    voxel_indices,
    voxelize_contract,
    voxelize_contract_plain,
)


# launches since the last reset_launches(); the wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {"rowcol_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _offsets(n: int, base: int, device) -> torch.Tensor:
    """(n, 3) digits (dz, dy, dx) of 0 .. n-1 in base ``base``: the tap
    deltas + 1 for (27, 3), the child octants for (8, 2). Made on the
    device, so that no blocking host-to-device copy enters the forward."""
    i = torch.arange(n, device=device)
    return torch.stack([i // (base * base), i // base % base, i % base], -1)


class BlockSparseVoxels(NamedTuple):
    tile_ijk: torch.Tensor   # (B, NT, 3) int64 tile coords in the T^3 grid
    feats: torch.Tensor      # (B, NT, t, t, t, C) tile feature blocks
    active: torch.Tensor     # (B, NT, t, t, t) bool per-voxel occupancy
    tile_mask: torch.Tensor  # (B, NT) bool: real tile vs capacity padding
    lookup: torch.Tensor     # (B, T^3 + 1) int64 tile id -> slot, -1 empty
    dropped: torch.Tensor    # (B,) int64 occupied tiles beyond capacity
    grid_size: int           # R
    tile: int                # t


def _batch_index(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)[:, None]


def _row_gather(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), rows (B, M) with -1 reading zeros -> (B, M, ...)."""
    xpad = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)
    return xpad[_batch_index(rows), rows + 1]


def _first_occupied(occ: torch.Tensor, cap: int):
    """The ids of an event's occupied entries in ascending order, the first
    ``cap`` of them padded with N (``jnp.nonzero(size=cap,
    fill_value=N)``), their mask, the (N + 1,) id -> slot lookup (-1 for
    none) and the count beyond ``cap``. occ (B, N) bool."""
    b, n = occ.shape
    ar = torch.arange(n, device=occ.device)
    ids = torch.where(occ, ar, n).sort(dim=1).values
    if cap > n:
        ids = torch.cat([ids, ids.new_full((b, cap - n), n)], dim=1)
    ids = ids[:, :cap]
    real = ids < n
    lookup = torch.full((b, n + 1), -1, dtype=torch.int64, device=occ.device)
    lookup.scatter_(1, ids, torch.arange(cap, device=occ.device).expand(b,
                                                                       cap))
    lookup[:, n] = -1
    dropped = torch.clamp(occ.sum(dim=1) - cap, min=0)
    return ids, real, lookup, dropped


def _tile_coords(ids: torch.Tensor, nt: int) -> torch.Tensor:
    return torch.stack([ids // (nt * nt), (ids // nt) % nt, ids % nt], dim=-1)


@torch.no_grad()
def block_sparse_voxelize(points: torch.Tensor, mask: torch.Tensor,
                          grid_size: int, max_tiles: int, tile: int = 8,
                          impl: str = "auto",
                          matmul_dtype: torch.dtype = torch.bfloat16, *,
                          plain: bool = False):
    """Voxelize straight into the tile layout -> (BlockSparseVoxels, lo,
    scale). Features are the point feature columns 3: (mean per voxel)
    plus the occupancy channel min(count, 1). ``impl``: "matmul" rounds the
    point features to ``matmul_dtype`` before the f32 sums (bf16:
    ``voxelize_contract``), "scatter" sums in f32, "auto" resolves as the
    JAX ``resolve_voxelize_impl``."""
    r, t = grid_size, tile
    if r % t:
        raise ValueError(f"grid {r} not divisible by tile {t}")
    nt = r // t
    nt3, t3, r3 = nt ** 3, t ** 3, r ** 3
    b = points.shape[0]
    feats = points[..., 3:].float()
    ones = torch.ones(feats.shape[:-1] + (1,), device=feats.device)
    ext = torch.cat([feats, ones], dim=-1)
    ext = torch.where(mask[..., None], ext, torch.zeros_like(ext))
    c = ext.shape[-1]                        # features + occupancy

    flat, lo, scale = voxel_indices(points[..., :3].float(), mask, r)
    i, j, k = flat // (r * r), (flat // r) % r, flat % r
    tid = ((i // t) * nt + (j // t)) * nt + (k // t)
    intra = ((i % t) * t + (j % t)) * t + (k % t)
    blocked = torch.where(flat >= r3, r3, tid * t3 + intra)

    impl = resolve_voxelize_impl(impl, r, c)
    if impl == "matmul" and matmul_dtype == torch.bfloat16:
        sums = voxelize_contract(blocked, ext, r, plain=plain)
    elif impl in ("matmul", "scatter"):
        sums = voxelize_contract_plain(blocked, ext, r, round_bf16=False)
    else:
        raise ValueError(f"unknown voxelize impl {impl!r}")
    cnts = sums[..., -1:]
    mean = torch.cat([sums[..., :-1] / torch.clamp(cnts, min=1.0),
                      torch.clamp(cnts, max=1.0)], dim=-1)
    bf = mean.reshape(b, nt3, t, t, t, c)
    act = (cnts[..., 0] > 0).reshape(b, nt3, t, t, t)
    tile_occ = act.reshape(b, nt3, -1).any(dim=-1)

    ids, real, lookup, dropped = _first_occupied(tile_occ, max_tiles)
    safe = torch.where(real, ids, 0)
    bi = _batch_index(safe)
    f = torch.where(real[..., None, None, None, None], bf[bi, safe], 0.0)
    a = act[bi, safe] & real[..., None, None, None]
    bs = BlockSparseVoxels(_tile_coords(safe, nt), f, a, real, lookup,
                           dropped, r, t)
    return bs, lo, scale


@torch.no_grad()
def neighbor_slots(bs: BlockSparseVoxels, sign: int = 1) -> torch.Tensor:
    """(B, NT, 27) slot of the tile at ``pos + sign * delta`` in tap order
    (-1 when out of the grid, unoccupied, or this row is padding)."""
    nt = bs.grid_size // bs.tile
    deltas = sign * (_offsets(27, 3, bs.tile_ijk.device) - 1)  # tap order
    nijk = bs.tile_ijk[:, :, None, :] + deltas               # (B, NT, 27, 3)
    inb = ((nijk >= 0) & (nijk < nt)).all(dim=-1) & bs.tile_mask[..., None]
    nflat = (nijk[..., 0] * nt + nijk[..., 1]) * nt + nijk[..., 2]
    nflat = torch.where(inb, nflat, nt ** 3)
    b = nflat.shape[0]
    return torch.gather(bs.lookup, 1, nflat.reshape(b, -1)).reshape(
        nflat.shape)


def block_subm_conv(p: dict, bs: BlockSparseVoxels, feats: torch.Tensor,
                    compute_dtype: torch.dtype | None = None,
                    slots: torch.Tensor | None = None, *,
                    plain: bool = False) -> torch.Tensor:
    """The raw submanifold 3^3 conv on occupied tiles (JAX
    ``block_subm_conv(raw=True)``): (B, NT, t, t, t, Cin) ->
    (B, NT, t, t, t, Cout) in the compute dtype, no bias, no mask. Pass
    ``slots`` (``neighbor_slots(bs)``) to reuse a level's table."""
    dt = compute_dtype or feats.dtype
    b, nt, t = feats.shape[:3]
    cin = feats.shape[-1]
    cout = p["kernel"].shape[-1]
    if slots is None:
        slots = neighbor_slots(bs)
    y = block_conv(feats.to(dt).reshape(b, nt, t ** 3, cin), slots,
                   p["kernel"].reshape(27 * cin, cout).to(dt), plain=plain)
    return y.reshape(b, nt, t, t, t, cout)


@torch.no_grad()
def point_cells(bs: BlockSparseVoxels, points: torch.Tensor,
                mask: torch.Tensor):
    """Per point, its tile's slot and its intra-tile voxel id, (B, M) each;
    the slot is the sentinel NT for masked points and points of
    unoccupied or dropped tiles (they read zeros)."""
    t, r = bs.tile, bs.grid_size
    nt = r // t
    flat, _, _ = voxel_indices(points[..., :3].float(), mask, r)
    i, j, k = flat // (r * r), (flat // r) % r, flat % r
    tid = ((i // t) * nt + (j // t)) * nt + (k // t)
    tid = torch.where(flat >= r ** 3, nt ** 3, tid)
    slot = torch.gather(bs.lookup, 1, tid)
    slot = torch.where(slot >= 0, slot, bs.tile_ijk.shape[1])
    intra = ((i % t) * t + (j % t)) * t + (k % t)
    return slot, intra


def _readout_raw(site_flat, slot, intra):
    vpad = torch.cat([site_flat, torch.zeros_like(site_flat[:, :1])], dim=1)
    return vpad[_batch_index(slot), slot, intra]


def rowcol_scatter_plain(rows: torch.Tensor, cols: torch.Tensor,
                         vals: torch.Tensor, nrows: int, ncols: int
                         ) -> torch.Tensor:
    """out[b, r, col * C + k] = sum_p [rows_p = r, cols_p = col]
    bf16(vals[b, p, k]) as (B, nrows, ncols * C) f32; a row >= nrows (the
    sentinel) adds nothing. One ``index_add_`` into a table with a spill
    row per event."""
    b, _, c = vals.shape
    cells = nrows * ncols
    idx = torch.where(rows < nrows, rows.long() * ncols + cols.long(), cells)
    idx = idx + torch.arange(b, device=vals.device)[:, None] * (cells + 1)
    out = torch.zeros((b * (cells + 1), c), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, idx.reshape(-1),
                   vals.to(torch.bfloat16).float().reshape(-1, c))
    return out.reshape(b, cells + 1, c)[:, :cells].reshape(b, nrows,
                                                           ncols * c)


def rowcol_scatter(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, nrows: int, ncols: int, *,
                   plain: bool = False) -> torch.Tensor:
    """The block readout's backward (JAX ``onehot_contract.rowcol_scatter``,
    arguments as ``rowcol_scatter_plain``). Launches the CUDA kernel on a
    CUDA tensor."""
    if not on_cuda(vals, plain):
        return rowcol_scatter_plain(rows, cols, vals, nrows, ncols)
    b, m, c = vals.shape
    if tuple(rows.shape) != (b, m) or tuple(cols.shape) != (b, m):
        raise ValueError(f"rows and cols must be {(b, m)}, got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}")
    rows = rows.to(device=vals.device, dtype=torch.int32).contiguous()
    cols = cols.to(device=vals.device, dtype=torch.int32).contiguous()
    vals = vals.float().contiguous()
    out = torch.zeros((b, nrows, ncols * c), dtype=torch.float32,
                      device=vals.device)
    rc = load_library("onehot_contract").pcseg_rowcol_scatter(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), out.data_ptr(), b,
        m, nrows, ncols, c, stream_of(vals))
    raise_on(rc, "rowcol_scatter")
    LAUNCHES["rowcol_scatter"] += 1
    return out


class _Readout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, site_flat, slot, intra, plain):
        ctx.save_for_backward(slot, intra)
        ctx.cfg = (tuple(site_flat.shape), site_flat.dtype, plain)
        return _readout_raw(site_flat, slot, intra)

    @staticmethod
    def backward(ctx, g):
        slot, intra = ctx.saved_tensors
        (b, nt, t3, c), dtype, plain = ctx.cfg
        dv = rowcol_scatter(slot, intra, g, nt, t3, plain=plain)
        return dv.reshape(b, nt, t3, c).to(dtype), None, None, None


def readout(site_flat: torch.Tensor, slot: torch.Tensor,
            intra: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """site_flat (B, NT, t^3, C), slot / intra (B, M) -> (B, M, C); the
    sentinel slot NT reads zeros. The backward is ``rowcol_scatter``, cast
    to site_flat's dtype."""
    return _Readout.apply(site_flat, slot, intra, plain)


def block_gather_point_logits(site_values: torch.Tensor,
                              bs: BlockSparseVoxels, points: torch.Tensor,
                              mask: torch.Tensor, *,
                              plain: bool = False) -> torch.Tensor:
    """Per-point readout (nearest voxel) from the tile blocks; masked
    points and points of unoccupied or dropped tiles read zeros."""
    slot, intra = point_cells(bs, points, mask)
    b, nt = site_values.shape[:2]
    out = readout(site_values.reshape(b, nt, bs.tile ** 3, -1), slot, intra,
                  plain=plain)
    return torch.where(mask[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# the tile hierarchy: stride-2 down / transposed up between resolutions
# ---------------------------------------------------------------------------

@torch.no_grad()
def block_pool(bs: BlockSparseVoxels, max_tiles: int):
    """The coarse level (grid R/2, same t) and its child slot table
    (B, NTc, 8): a coarse tile is occupied iff one of its 8 children is;
    its active mask is the 2^3-pooled fine mask; feats is a zero-channel
    placeholder."""
    t = bs.tile
    nt = bs.grid_size // t
    if nt % 2:
        raise ValueError(f"block_pool needs an even tile grid (R/t = {nt})")
    ntc = nt // 2
    ntc3 = ntc ** 3
    b = bs.tile_ijk.shape[0]
    ijk = bs.tile_ijk // 2
    pflat = (ijk[..., 0] * ntc + ijk[..., 1]) * ntc + ijk[..., 2]
    pflat = torch.where(bs.tile_mask, pflat, ntc3)
    occ = torch.zeros((b, ntc3 + 1), dtype=torch.bool,
                      device=pflat.device)
    occ.scatter_(1, pflat, True)
    ids, cmask, clookup, dropped = _first_occupied(occ[:, :ntc3], max_tiles)
    cijk = _tile_coords(torch.where(cmask, ids, 0), ntc)

    deltas = _offsets(8, 2, cijk.device)
    cf = 2 * cijk[:, :, None, :] + deltas                    # (B, NTc, 8, 3)
    cflat = (cf[..., 0] * nt + cf[..., 1]) * nt + cf[..., 2]
    cflat = torch.where(cmask[..., None], cflat, nt ** 3)
    slots = torch.gather(bs.lookup, 1, cflat.reshape(b, -1)).reshape(
        cflat.shape)                                         # -1 empty
    ch = _row_gather(bs.active, slots.reshape(b, -1))        # (B, NTc*8, ...)
    asm = ch.reshape(b, -1, 2, 2, 2, t, t, t).permute(0, 1, 2, 5, 3, 6, 4, 7)
    cact = asm.reshape(b, -1, t, 2, t, 2, t, 2).any(dim=7).any(dim=5).any(
        dim=3)
    feats0 = torch.zeros(cact.shape + (0,), device=cact.device)
    bsc = BlockSparseVoxels(cijk, feats0, cact, cmask, clookup, dropped,
                            bs.grid_size // 2, t)
    return bsc, slots


@torch.no_grad()
def parent_rows(bs_coarse: BlockSparseVoxels, bs_fine: BlockSparseVoxels):
    """(B, NTf) parent slot of each fine tile (-1 when dropped / padding)
    and its octant index in the parent."""
    ntc = bs_coarse.grid_size // bs_coarse.tile
    ijk = bs_fine.tile_ijk
    pflat = ((ijk[..., 0] // 2) * ntc + ijk[..., 1] // 2) * ntc \
        + ijk[..., 2] // 2
    pflat = torch.where(bs_fine.tile_mask, pflat, ntc ** 3)
    pslot = torch.gather(bs_coarse.lookup, 1, pflat)
    octant = (ijk[..., 0] % 2) * 4 + (ijk[..., 1] % 2) * 2 + ijk[..., 2] % 2
    return pslot, octant


def _octant_pack_raw(ych: torch.Tensor, child_slots: torch.Tensor
                     ) -> torch.Tensor:
    b, ntc = child_slots.shape[:2]
    th, c = ych.shape[2], ych.shape[-1]
    ch = _row_gather(ych, child_slots.reshape(b, -1)).reshape(
        b, ntc, 2, 2, 2, th, th, th, c)
    asm = ch.permute(0, 1, 2, 5, 3, 6, 4, 7, 8)
    return asm.reshape(b, ntc, 2 * th, 2 * th, 2 * th, c)


def _octant_unpack_raw(cf: torch.Tensor, pslot: torch.Tensor,
                       octant: torch.Tensor) -> torch.Tensor:
    b, ntc = cf.shape[:2]
    th, c = cf.shape[2] // 2, cf.shape[-1]
    octs = cf.reshape(b, ntc, 2, th, 2, th, 2, th, c).permute(
        0, 1, 2, 4, 6, 3, 5, 7, 8).reshape(b, ntc * 8, th, th, th, c)
    rows = torch.where(pslot >= 0, pslot * 8 + octant, -1)
    return _row_gather(octs, rows)


class _OctantPack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ych, child_slots, pslot, octant):
        ctx.save_for_backward(pslot, octant)
        return _octant_pack_raw(ych, child_slots)

    @staticmethod
    def backward(ctx, g):
        pslot, octant = ctx.saved_tensors
        return _octant_unpack_raw(g, pslot, octant), None, None, None


class _OctantUnpack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cf, pslot, octant, child_slots):
        ctx.save_for_backward(child_slots)
        return _octant_unpack_raw(cf, pslot, octant)

    @staticmethod
    def backward(ctx, g):
        (child_slots,) = ctx.saved_tensors
        return _octant_pack_raw(g, child_slots), None, None, None


def octant_pack(ych: torch.Tensor, child_slots: torch.Tensor,
                pslot: torch.Tensor, octant: torch.Tensor) -> torch.Tensor:
    """(B, NTf, th, th, th, C) + (B, NTc, 8) -> (B, NTc, 2th, 2th, 2th, C):
    each parent assembled from its 8 children's blocks (zeros where a child
    is absent). The backward is ``octant_unpack``'s gather through the fine
    tiles' parent rows (pslot, octant: ``parent_rows``)."""
    return _OctantPack.apply(ych, child_slots, pslot, octant)


def octant_unpack(cf: torch.Tensor, pslot: torch.Tensor,
                  octant: torch.Tensor, child_slots: torch.Tensor
                  ) -> torch.Tensor:
    """(B, NTc, 2th, 2th, 2th, C) + (B, NTf) x 2 -> (B, NTf, th, th, th,
    C): each fine tile reads its parent's octant (zeros when absent). The
    backward is ``octant_pack``'s gather through the coarse tiles' child
    slots."""
    return _OctantUnpack.apply(cf, pslot, octant, child_slots)


def block_down2x(p: dict, feats: torch.Tensor, bs_coarse: BlockSparseVoxels,
                 bs_fine: BlockSparseVoxels, child_slots: torch.Tensor,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The stride-2 k=2 conv, fine tiles -> coarse tiles, raw (JAX
    ``block_down2x(raw=True)``): feats (B, NTf, t, t, t, Cin), kernel
    (2, 2, 2, Cin, Cout) -> (B, NTc, t, t, t, Cout) in the compute dtype.
    The windows never cross a fine tile, so the conv runs on the fine
    tiles (an f32 product of dtype-valued operands, rounded once) and the
    octants are assembled after it (``octant_pack``, whose backward
    gathers through the fine tiles' parent rows)."""
    dt = compute_dtype or feats.dtype
    b, ntf, t = feats.shape[:3]
    th = t // 2
    cin = feats.shape[-1]
    cout = p["kernel"].shape[-1]
    x = feats.to(dt).float().reshape(b, ntf, th, 2, th, 2, th, 2, cin)
    x = x.permute(0, 1, 2, 4, 6, 3, 5, 7, 8).reshape(b, ntf, th, th, th,
                                                     8 * cin)
    w = p["kernel"].to(dt).float().reshape(8 * cin, cout)
    y = (x @ w).to(dt)
    return octant_pack(y, child_slots, *parent_rows(bs_coarse, bs_fine))


def block_up2x(p: dict, cfeats: torch.Tensor, bs_coarse: BlockSparseVoxels,
               bs_fine: BlockSparseVoxels, child_slots: torch.Tensor,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The stride-2 k=2 transposed conv, coarse tiles -> fine tiles, raw
    (JAX ``block_up2x(raw=True)``): each fine tile reads its parent's
    octant and expands it, fine[2a+dz, 2b+dy, 2c+dx] = sub[a, b, c] @
    W[1-dz, 1-dy, 1-dx], summed in f32 on dtype-valued operands and
    rounded once to the compute dtype. ``child_slots`` is the coarse
    level's ``block_pool`` table, through which the backward of the octant
    read gathers."""
    dt = compute_dtype or cfeats.dtype
    t = bs_fine.tile
    th = t // 2
    cin = cfeats.shape[-1]
    cout = p["kernel"].shape[-1]
    pslot, octant = parent_rows(bs_coarse, bs_fine)
    sub = octant_unpack(cfeats, pslot, octant, child_slots)
    wflip = p["kernel"].flip(0, 1, 2).to(dt).float()
    w = wflip.permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
    y = sub.to(dt).float() @ w                       # (..., 8 * Cout)
    b, ntf = sub.shape[:2]
    y = y.reshape(b, ntf, th, th, th, 2, 2, 2, cout).permute(
        0, 1, 2, 5, 3, 6, 4, 7, 8)
    return y.reshape(b, ntf, t, t, t, cout).to(dt)
