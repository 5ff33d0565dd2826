"""Submanifold sparse 3D convolution on occupied voxels (counterpart of
pcseg_tpu/ops/sparse.py): the layers of SparseVoxelNet's rulebook-gather
(``impl="gather"``) and masked-dense (``impl="dense"``) impls, and the
parameter inits that every sparse impl shares.

- ``sparse_from_grid``: each event's occupied voxels at a static capacity
  ``max_active``, in ascending flat-id order (the JAX ``jnp.nonzero(size=
  max_active, fill_value=R^3)``), ranked by a cumulative sum and scattered
  into place, so the capacity stays static and nothing waits for the host;
  ``lookup`` maps a flat voxel id to its site (-1 where empty; the sentinel
  slot R^3 stays -1) and ``dropped`` counts the occupied voxels past the
  capacity.
- ``subm_conv``: per site, the sum over the 27 offsets of W_k @
  x[neighbour_k], the neighbours found through ``lookup`` (the rulebook);
  ``subm_conv_dense``: the same values from a SAME 3^3 conv of the dense
  grid masked to the occupied voxels.
- ``sparse_pool`` / ``sparse_down2x`` / ``sparse_up2x``: the gather U-Net's
  hierarchy (2^3 occupancy pooling, the stride-2 conv and its transpose on
  sites); ``site_layer_norm``; ``gather_point_logits``, the readout.

Every product takes operands rounded to the compute dtype and sums in f32
to an f32 result, as the JAX ``dot_general(preferred_element_type=f32)``
does (the dense conv through ``ops/conv3d.convolution``, which keeps
cuDNN's TF32 off; the matmuls under PyTorch's default, TF32 off). The
gathered rows of a site form one (27 Cin) row, so a conv is one matmul;
absent neighbours (and every tap of a capacity-padding site) read zero
rows appended to the feature table, spread over ``SPREAD`` of them so
that the gather's backward (``index_add_``) piles no more than a few
hundred reads onto one row. The JAX
package computes these layers in XLA, outside any Pallas kernel, so they
are PyTorch on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pcseg_tpu_torch.ops.conv3d import convolution
from pcseg_tpu_torch.ops.voxel import VoxelGrid, voxel_indices

# zero rows after a feature table: absent reads take them in turn
SPREAD = 1024


class SparseVoxels(NamedTuple):
    ijk: torch.Tensor        # (B, A, 3) int32 voxel coords of active sites
    feats: torch.Tensor      # (B, A, C) site features
    site_mask: torch.Tensor  # (B, A) bool: real site vs capacity padding
    lookup: torch.Tensor     # (B, R^3+1) int32 flat id -> site, -1 empty
    dropped: torch.Tensor    # (B,) int32 occupied sites beyond capacity
    grid_size: int


def subm_conv_init(cin: int, cout: int,
                   generator: torch.Generator | None = None,
                   kernel: int = 3) -> dict:
    """He-uniform (k^3, Cin, Cout) taps in ``_offsets`` order + zero
    bias."""
    k3 = kernel ** 3
    bound = math.sqrt(6.0 / (k3 * cin))
    u = torch.rand((k3, cin, cout), generator=generator)
    return {"kernel": u * (2 * bound) - bound, "bias": torch.zeros(cout)}


def site_layer_norm_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _sites(counts: torch.Tensor, feats: torch.Tensor, r: int,
           max_active: int) -> SparseVoxels:
    b = counts.shape[0]
    r3 = r ** 3
    dev = counts.device
    occ = counts.reshape(b, r3) > 0
    rank = torch.cumsum(occ, dim=1) - 1
    # occupied voxels past the capacity and empty ones land in slot
    # max_active, which is cut off
    slot = torch.where(occ & (rank < max_active), rank, max_active)
    ids = torch.full((b, max_active + 1), r3, dtype=torch.int64, device=dev)
    ids.scatter_(1, slot, torch.arange(r3, device=dev).expand(b, r3))
    ids = ids[:, :max_active]
    site_mask = ids < r3
    dropped = torch.clamp(occ.sum(dim=1) - max_active, min=0).to(torch.int32)
    safe = torch.where(site_mask, ids, 0)
    c = feats.shape[-1]
    if c:
        g = torch.gather(feats.reshape(b, r3, c), 1,
                         safe[..., None].expand(-1, -1, c))
        site_feats = torch.where(site_mask[..., None], g, 0.0)
    else:
        site_feats = feats.new_zeros((b, max_active, 0))
    ijk = torch.stack([safe // (r * r), (safe // r) % r, safe % r],
                      dim=-1).to(torch.int32)
    lookup = torch.full((b, r3 + 1), -1, dtype=torch.int32, device=dev)
    lookup.scatter_(1, torch.where(site_mask, ids, r3),
                    torch.arange(max_active, dtype=torch.int32,
                                 device=dev).expand(b, max_active))
    lookup[:, r3] = -1        # capacity padding writes land in the sentinel
    return SparseVoxels(ijk, site_feats, site_mask, lookup, dropped, r)


def sparse_from_grid(grid: VoxelGrid, max_active: int) -> SparseVoxels:
    """The occupied voxels of a dense VoxelGrid, at most ``max_active`` an
    event (the first in flat-id order); the rest are counted in
    ``.dropped`` (their points read zero logits)."""
    return _sites(grid.counts, grid.features, grid.features.shape[1],
                  max_active)


def _offsets(kernel: int = 3, device=None) -> torch.Tensor:
    """(K^3, 3) int32 neighbour deltas, center included, dx outermost (the
    order of a (k, k, k) reshape of the taps, DHW)."""
    rng = range(-(kernel // 2), kernel // 2 + 1)
    return torch.tensor([[dx, dy, dz] for dx in rng for dy in rng
                         for dz in rng], dtype=torch.int32, device=device)


def _taps2(device=None) -> torch.Tensor:
    """(8, 3) int32 within-parent offsets, ordered as a (2, 2, 2)
    reshape."""
    return torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1)
                         for k in (0, 1)], dtype=torch.int32, device=device)


def _rows(site: torch.Tensor, n_src: int) -> torch.Tensor:
    """Rows of a ``_table`` of B events of ``n_src`` rows that ``site``
    (B, ...) reads: each site of its event, or for -1 the zero rows after
    the table, in turn."""
    b = site.shape[0]
    base = torch.arange(b, device=site.device).reshape(
        (b,) + (1,) * (site.dim() - 1)) * n_src
    spread = torch.arange(site.numel(), device=site.device).reshape(
        site.shape) % SPREAD
    return torch.where(site >= 0, site.long() + base, b * n_src + spread)


def _site_rows(nijk: torch.Tensor, valid: torch.Tensor, lookup: torch.Tensor,
               r: int, n_src: int) -> torch.Tensor:
    """``_rows`` of the voxels ``nijk`` (B, A, K, 3): the site of each
    voxel in its event, or a zero row where ``valid`` is false or the
    voxel is empty."""
    b = nijk.shape[0]
    flat = (nijk[..., 0] * r + nijk[..., 1]) * r + nijk[..., 2]
    flat = torch.where(valid, flat, r ** 3).long()
    site = torch.gather(lookup, 1, flat.reshape(b, -1)).reshape(flat.shape)
    return _rows(site, n_src)


def _table(x: torch.Tensor, dt: torch.dtype | None = None) -> torch.Tensor:
    """(B, n, C) features -> (B * n + SPREAD, C) f32 rows, rounded to
    ``dt`` where given, zero rows last (the gather's backward sums in
    f32)."""
    flat = x.reshape(-1, x.shape[-1])
    flat = (flat.to(dt) if dt is not None else flat).float()
    return torch.cat([flat, flat.new_zeros((SPREAD, flat.shape[1]))])


def _read(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[rows] for rows of any shape, flattened; the backward is
    ``index_add_`` (float atomics)."""
    return torch.index_select(table, 0, rows.reshape(-1))


def _tap_product(x: torch.Tensor, rows: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """sum_k x[rows[..., k]] @ kernel[k] + bias, f32: x (B, n, Cin), rows
    (B, A, K), kernel (K, Cin, Cout) -> (B, A, Cout)."""
    b, a, k = rows.shape
    cin, cout = kernel.shape[-2:]
    g = _read(_table(x, dt), rows).reshape(b * a, k * cin)
    y = g @ kernel.reshape(k * cin, cout).to(dt).float()
    return (y + bias.float()).reshape(b, a, cout)


def subm_conv(p: dict, sp: SparseVoxels, kernel: int = 3,
              compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Submanifold conv: (B, A, Cin) -> (B, A, Cout) f32 on the same
    sites, zero at capacity padding."""
    dt = compute_dtype or sp.feats.dtype
    r = sp.grid_size
    deltas = _offsets(kernel, sp.ijk.device)
    nijk = sp.ijk[:, :, None, :] + deltas
    inb = ((nijk >= 0) & (nijk < r)).all(dim=-1) & sp.site_mask[..., None]
    rows = _site_rows(nijk, inb, sp.lookup, r, sp.feats.shape[1])
    y = _tap_product(sp.feats, rows, p["kernel"], p["bias"], dt)
    return torch.where(sp.site_mask[..., None], y, 0.0)


def subm_conv_dense(p: dict, grid_feats: torch.Tensor, active: torch.Tensor,
                    compute_dtype: torch.dtype | None = None
                    ) -> torch.Tensor:
    """Submanifold conv as a masked DENSE conv: grid_feats (B, R, R, R, C)
    with zeros at empty voxels, active (B, R, R, R) bool -> (B, R, R, R,
    Cout) f32, zero off the active set, so stacked layers never grow it.
    The conv runs in the compute dtype (its output rounded to it, as the
    JAX conv's is); the bias is added in f32 after it."""
    dt = compute_dtype or grid_feats.dtype
    k3, cin, cout = p["kernel"].shape
    k = round(k3 ** (1 / 3))
    w = p["kernel"].reshape(k, k, k, cin, cout).to(dt).permute(4, 3, 0, 1, 2)
    y = convolution(grid_feats.to(dt).permute(0, 4, 1, 2, 3), w,
                    padding=k // 2)
    y = y.permute(0, 2, 3, 4, 1).float() + p["bias"].float()
    return torch.where(active[..., None], y, 0.0)


def sparse_pool(sp: SparseVoxels, max_active: int) -> SparseVoxels:
    """Stride-2 occupancy pooling: a coarse site is active iff any of its
    2^3 children is an (in-capacity) active fine site, the dense impl's
    or-pooling of the occupancy. Returns the coarse SparseVoxels at R/2
    with zero-width features; its ``.dropped`` counts coarse sites beyond
    the capacity."""
    r = sp.grid_size
    rc = r // 2
    b = sp.lookup.shape[0]
    occ = (sp.lookup[:, : r ** 3] >= 0).reshape(b, rc, 2, rc, 2, rc, 2)
    cnt = occ.any(dim=6).any(dim=4).any(dim=2)
    return _sites(cnt, sp.feats.new_zeros((b, rc ** 3, 0)), rc, max_active)


def sparse_down2x(p: dict, x_fine: torch.Tensor, sp_fine: SparseVoxels,
                  sp_coarse: SparseVoxels,
                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Stride-2 down conv on sites: (B, Af, Cin) -> (B, Ac, Cout) f32; per
    coarse site o, sum_t W[t] @ x[2o + t] over its 2^3 children (absent
    ones read zero). p["kernel"]: (2, 2, 2, Cin, Cout)."""
    dt = compute_dtype or x_fine.dtype
    kern = p["kernel"].reshape(8, *p["kernel"].shape[-2:])
    child = sp_coarse.ijk[:, :, None, :] * 2 + _taps2(x_fine.device)
    valid = sp_coarse.site_mask[..., None].expand(-1, -1, 8)
    rows = _site_rows(child, valid, sp_fine.lookup, sp_fine.grid_size,
                      x_fine.shape[1])
    y = _tap_product(x_fine, rows, kern, p["bias"], dt)
    return torch.where(sp_coarse.site_mask[..., None], y, 0.0)


def sparse_up2x(p: dict, h_coarse: torch.Tensor, sp_coarse: SparseVoxels,
                sp_fine: SparseVoxels,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Stride-2 transposed conv on sites: (B, Ac, Cin) -> (B, Af, Cout)
    f32; fine site f = 2q + t reads W[1 - t] @ h[parent q] (the tap of the
    JAX ``lax.conv_transpose(k=2, s=2, SAME)``). The JAX package sums 8
    masked products, of which 7 are exact zeros; here one product of each
    site's parent row with all 8 taps' columns, (Cin, 8 Cout), and a
    select of its own tap give the same f32 value, without per-site
    kernels."""
    dt = compute_dtype or h_coarse.dtype
    rc = sp_coarse.grid_size
    cin, cout = p["kernel"].shape[-2:]
    ijk = sp_fine.ijk
    b, af = ijk.shape[:2]
    rows = _site_rows(ijk[:, :, None, :] // 2, sp_fine.site_mask[..., None],
                      sp_coarse.lookup, rc, h_coarse.shape[1])
    hp = _read(_table(h_coarse, dt), rows)                 # (B*Af, Cin)
    kern = p["kernel"].reshape(8, cin, cout).to(dt).float()
    y_all = (hp @ kern.permute(1, 0, 2).reshape(cin, 8 * cout)).reshape(
        b * af, 8, cout)
    t = 1 - ijk.long() % 2
    tidx = ((t[..., 0] * 2 + t[..., 1]) * 2 + t[..., 2]).reshape(-1)
    y = torch.gather(y_all, 1, tidx[:, None, None].expand(-1, 1, cout))
    y = (y.reshape(b, af, cout) + p["bias"].float())
    return torch.where(sp_fine.site_mask[..., None], y, 0.0)


def site_layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Per-site LayerNorm over channels (two-pass moments in f32), in x's
    dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()
    return y.to(x.dtype)


def gather_point_logits(site_values: torch.Tensor, sp: SparseVoxels,
                        points: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Per-point readout (B, A, C) -> (B, M, C): each point takes its
    voxel's site value; points in dropped voxels and masked points read
    zeros."""
    flat, _, _ = voxel_indices(points[..., :3].float(), mask, sp.grid_size)
    site = torch.gather(sp.lookup, 1, flat)
    b, m = flat.shape
    out = _read(_table(site_values), _rows(site, site_values.shape[1]))
    return torch.where(mask[..., None], out.reshape(b, m, -1), 0.0)
