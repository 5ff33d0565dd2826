"""SparseVoxelNet, serving and training (counterpart of
pcseg_tpu/models/sparse_unet.py), in the JAX package's three impls.

Run a stack of ``depth`` submanifold 3^3 conv blocks on the occupied
voxels (conv -> LayerNorm -> ReLU -> active mask, residual after the
first), and with ``levels`` > 1 a sparse U-Net over the pooled occupancy
(stride-2 down, a block stack at width w * 2^lv, transposed up, skip sum);
a per-voxel head and the nearest-voxel readout give (B, M, num_classes)
f32 logits. The impls hold the occupied voxels three ways:

- ``"block"`` (the default): voxelized straight into occupied t^3 tiles
  at the capacities ``max_tiles`` / ``max_tiles_schedule``;
- ``"gather"``: occupied sites at the capacity ``max_active`` a level,
  each conv a gather of its 27 neighbours through the site lookup
  (ops/sparse.py), ``site_layer_norm`` after it;
- ``"dense"``: the whole R^3 grid, each conv a dense one masked to the
  occupied voxels, no capacity (``dropped`` is 0, and the train aux has no
  ``__overflow__``). Each LN is ``ln_relu_mask`` (csrc/fused_ln.cu, row
  20) at every width (the JAX package gates its Pallas kernel on C % 8,
  a TPU lane limit that the CUDA kernel does not have).

The gather and dense impls voxelize with ``ops/voxel.voxelize`` (row 10
in bf16 at the "auto" form's R^3 C <= 4e6); the gather impl's convs, LNs
and readout have no TPU kernel (the JAX package computes them in XLA).

The block impl follows what the JAX package runs on a TPU (``fused_ln=
True``, ``conv_impl="auto"``): every 3^3 conv is the RAW conv of ``block_conv``
(csrc/block_conv.cu; the stem too, which the JAX package sends through
the XLA halo form of the same function because of a TPU lane gate), and
``bias_ln_relu_mask`` (csrc/fused_ln.cu) adds the conv bias, normalizes,
applies ReLU and masks. Down and up take the raw forms of
ops/block_sparse.py, including ``block_up2x``'s bf16 rounding of its f32
sums. The head and the up product sum in f32 on compute-dtype operands;
residual sums happen in the compute dtype.

Parameters carry the JAX names (``conv0``, ``ln0``, ``down1``,
``down1_ln``, ``l1_conv0``, ``l1_ln0``, ``up1``, ``up1_ln``, ``head``),
so ``ckpt.convert.from_jax_variables`` maps JAX parameters one to one;
all three impls share them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pcseg_tpu_torch.models.voxel_unet import DTYPES, Params
from pcseg_tpu_torch.ops.block_sparse import (
    block_down2x,
    block_gather_point_logits,
    block_pool,
    block_sparse_voxelize,
    block_subm_conv,
    block_up2x,
    neighbor_slots,
)
from pcseg_tpu_torch.ops.conv3d import (
    conv3d,
    conv3d_init,
    conv3d_transpose,
)
from pcseg_tpu_torch.ops.fused_ln import bias_ln_relu_mask, ln_relu_mask
from pcseg_tpu_torch.ops.sparse import (
    gather_point_logits,
    site_layer_norm,
    site_layer_norm_init,
    sparse_down2x,
    sparse_from_grid,
    sparse_pool,
    sparse_up2x,
    subm_conv,
    subm_conv_dense,
    subm_conv_init,
)
from pcseg_tpu_torch.ops.voxel import devoxelize_nearest, voxelize

LN_EPS = 1e-5
IMPLS = ("block", "dense", "gather")


def capacity_words(impl: str) -> tuple[str, str]:
    """What a sparse impl drops beyond its capacity, and the setting that
    raises it: the gather impl's sites and ``max_active``, the block
    impl's tiles and ``max_tiles`` (the JAX message names both; the dense
    impl drops nothing)."""
    if impl == "gather":
        return "sites", "max_active"
    return "tiles", "max_tiles"


class SparseVoxelNet(nn.Module):
    def __init__(self, num_classes: int, input_dim: int = 4,
                 grid_size: int = 64, width: int = 32, depth: int = 4,
                 compute_dtype: str = "float32",
                 impl: str = "block", max_tiles: int = 128, tile: int = 8,
                 max_tiles_schedule: tuple = (), levels: int = 1,
                 voxelize_impl: str = "auto", max_active: int = 8192,
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown SparseVoxelNet impl {impl!r}; "
                             f"options: {IMPLS}")
        self.num_classes = num_classes
        self.input_dim = input_dim
        self.grid_size = grid_size
        self.width = width
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.max_tiles = max_tiles
        self.tile = tile
        self.max_tiles_schedule = tuple(max_tiles_schedule)
        self.levels = levels
        self.voxelize_impl = voxelize_impl
        self.max_active = max_active

        g = generator
        cin = self.in_channels
        for i in range(depth):
            self.add_module(f"conv{i}", Params(subm_conv_init(cin, width, g)))
            self.add_module(f"ln{i}", Params(site_layer_norm_init(width)))
            cin = width
        for lv in range(1, levels):
            wl = width * 2 ** lv
            self.add_module(f"down{lv}",
                            Params(conv3d_init(2, wl // 2, wl, g)))
            self.add_module(f"down{lv}_ln", Params(site_layer_norm_init(wl)))
            for i in range(depth):
                self.add_module(f"l{lv}_conv{i}",
                                Params(subm_conv_init(wl, wl, g)))
                self.add_module(f"l{lv}_ln{i}",
                                Params(site_layer_norm_init(wl)))
            self.add_module(f"up{lv}", Params(conv3d_init(2, wl, wl // 2, g)))
            self.add_module(f"up{lv}_ln",
                            Params(site_layer_norm_init(wl // 2)))
        bound = 1.0 / math.sqrt(width)
        u = torch.rand((width, num_classes), generator=g)
        self.head = Params({"kernel": u * (2 * bound) - bound,
                            "bias": torch.zeros(num_classes)})

    @property
    def in_channels(self) -> int:
        return self.input_dim - 3 + 1        # features + occupancy

    def tile_cap(self, lv: int) -> int:
        """Static occupied-tile capacity of hierarchy level ``lv``."""
        if self.max_tiles_schedule:
            sched = self.max_tiles_schedule
            return int(sched[min(lv, len(sched) - 1)])
        return self.max_tiles

    def p(self, name: str) -> dict:
        return getattr(self, name).as_dict()

    def _voxelize(self, points, mask, plain):
        return block_sparse_voxelize(
            points, mask, self.grid_size, self.tile_cap(0), self.tile,
            impl=self.voxelize_impl, matmul_dtype=DTYPES[self.compute_dtype],
            plain=plain)[0]

    def supports_fused_loss(self) -> bool:
        return False

    def load_batch_stats(self, new_bn: dict) -> None:
        """LayerNorm keeps no running statistics: nothing to load."""

    def apply(self, points: torch.Tensor, *, train: bool = False,
              mask: torch.Tensor | None = None, seeds=None,
              return_overflow: bool = False, plain: bool = False):
        """(B, M, 3+F) points -> (B, M, num_classes) f32 logits,
        differentiable with respect to the parameters. ``train=True``
        returns ``(logits, aux)``, aux ``{"__overflow__": dropped}`` (the
        dense impl's ``{}``), with ``return_overflow`` (eval) ``(logits,
        dropped)``: the (B,) count of occupied tiles (block) or sites
        (gather) beyond the capacities, every level summed; 0 for the
        dense impl, which has none. ``seeds`` is unused (no dropout).
        ``plain=True`` runs every kernel's plain version, forward and
        backward, on any device: the on-card reference."""
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        if self.impl == "block":
            bs = self._voxelize(points, mask, plain)
            logits, dropped = self._apply_block(bs, points, mask, plain)
        else:
            grid = voxelize(points, mask, self.grid_size,
                            impl=self.voxelize_impl,
                            matmul_dtype=DTYPES[self.compute_dtype],
                            plain=plain)
            if self.impl == "dense":
                logits = self._apply_dense(grid, points, mask, plain)
                dropped = torch.zeros(points.shape[0], dtype=torch.int32,
                                      device=points.device)
            else:
                logits, dropped = self._apply_gather(grid, points, mask)
        if train:
            aux = {} if self.impl == "dense" else {"__overflow__": dropped}
            return logits, aux
        return (logits, dropped) if return_overflow else logits

    @torch.no_grad()
    def forward(self, points: torch.Tensor,
                mask: torch.Tensor | None = None, *,
                return_overflow: bool = False, plain: bool = False):
        """Serving: ``apply`` in eval mode without a graph."""
        return self.apply(points, mask=mask, return_overflow=return_overflow,
                          plain=plain)

    @torch.no_grad()
    def overflow_counts(self, points: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B,) occupied tiles (block) or sites (gather) beyond the static
        capacity, every level of the hierarchy counted, 0 for the dense
        impl; one voxelize (of the coordinates for the block impl), no
        conv."""
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        if self.impl == "dense":
            return torch.zeros(points.shape[0], dtype=torch.int32,
                               device=points.device)
        if self.impl == "gather":
            grid = voxelize(points, mask, self.grid_size,
                            impl=self.voxelize_impl,
                            matmul_dtype=DTYPES[self.compute_dtype])
            sp = sparse_from_grid(grid, self.max_active)
            dropped = sp.dropped
            for _ in range(1, self.levels):
                sp = sparse_pool(sp, self.max_active)
                dropped = dropped + sp.dropped
            return dropped
        bs = self._voxelize(points[..., :3], mask, False)
        dropped = bs.dropped
        for lv in range(1, self.levels):
            bs, _ = block_pool(bs, self.tile_cap(lv))
            dropped = dropped + bs.dropped
        return dropped

    def _ln(self, y, pre_bias, ln_name, active, plain):
        """conv bias + LayerNorm + ReLU + mask on a raw conv output."""
        ln = self.p(ln_name)
        c = y.shape[-1]
        out = bias_ln_relu_mask(y.reshape(-1, c), pre_bias, ln["scale"],
                                ln["bias"], active.reshape(-1), LN_EPS,
                                DTYPES[self.compute_dtype], plain=plain)
        return out.reshape(y.shape)

    def _block_stack(self, prefix, x, bs, plain):
        dt = DTYPES[self.compute_dtype]
        slots = neighbor_slots(bs)                 # once a level
        for i in range(self.depth):
            pp = self.p(f"{prefix}conv{i}")
            y = block_subm_conv(pp, bs, x, dt, slots, plain=plain)
            y = self._ln(y, pp["bias"], f"{prefix}ln{i}", bs.active,
                         plain).to(dt)
            x = y if (i == 0 and prefix == "") else x + y
        return x

    def _apply_block(self, bs, points, mask, plain):
        dt = DTYPES[self.compute_dtype]
        dropped = bs.dropped
        x = self._block_stack("", bs.feats.to(dt), bs, plain)
        if self.levels > 1:
            skips, bss, slot_tables = [x], [bs], [None]
            cur = bs
            for lv in range(1, self.levels):
                bsc, slots = block_pool(cur, self.tile_cap(lv))
                dropped = dropped + bsc.dropped
                down = self.p(f"down{lv}")
                h = block_down2x(down, skips[-1], bsc, cur, slots, dt)
                h = self._ln(h, down["bias"], f"down{lv}_ln", bsc.active,
                             plain)
                h = self._block_stack(f"l{lv}_", h.to(dt), bsc, plain)
                skips.append(h)
                bss.append(bsc)
                slot_tables.append(slots)
                cur = bsc
            h = skips[-1]
            for lv in range(self.levels - 1, 0, -1):
                up = self.p(f"up{lv}")
                u = block_up2x(up, h, bss[lv], bss[lv - 1], slot_tables[lv],
                               dt)
                u = self._ln(u, up["bias"], f"up{lv}_ln", bss[lv - 1].active,
                             plain).to(dt)
                h = skips[lv - 1] + u
            x = h
        head = self.p("head")
        site_logits = x.to(dt).float() @ head["kernel"].to(dt).float() \
            + head["bias"]
        return block_gather_point_logits(site_logits, bs, points, mask,
                                         plain=plain), dropped

    # -- the rulebook-gather impl

    def _gather_stack(self, prefix, x, sp):
        dt = DTYPES[self.compute_dtype]
        for i in range(self.depth):
            y = subm_conv(self.p(f"{prefix}conv{i}"), sp._replace(feats=x),
                          compute_dtype=dt)
            y = site_layer_norm(self.p(f"{prefix}ln{i}"), y)
            y = torch.relu(y).to(dt)
            # capacity padding keeps relu(bias) here, as in the JAX
            # package: every reader goes through the lookup or the mask
            x = y if (i == 0 and prefix == "") else x + y
        return x

    def _apply_gather(self, grid, points, mask):
        dt = DTYPES[self.compute_dtype]
        sp = sparse_from_grid(grid, self.max_active)
        dropped = sp.dropped
        x = self._gather_stack("", sp.feats.to(dt), sp)
        if self.levels > 1:
            skips, sps = [x], [sp]
            for lv in range(1, self.levels):
                spc = sparse_pool(sps[-1], self.max_active)
                dropped = dropped + spc.dropped
                h = sparse_down2x(self.p(f"down{lv}"), skips[-1], sps[-1],
                                  spc, compute_dtype=dt)
                h = site_layer_norm(self.p(f"down{lv}_ln"), h)
                h = self._gather_stack(f"l{lv}_", torch.relu(h).to(dt), spc)
                skips.append(h)
                sps.append(spc)
            h = skips[-1]
            for lv in range(self.levels - 1, 0, -1):
                u = sparse_up2x(self.p(f"up{lv}"), h, sps[lv], sps[lv - 1],
                                compute_dtype=dt)
                u = site_layer_norm(self.p(f"up{lv}_ln"), u)
                h = skips[lv - 1] + torch.relu(u).to(dt)
            x = h
        head = self.p("head")
        site_logits = x.to(dt).float() @ head["kernel"].to(dt).float() \
            + head["bias"]
        return gather_point_logits(site_logits, sp, points, mask), dropped

    # -- the masked-dense impl

    def _dense_ln(self, y, ln_name, active, plain):
        """LayerNorm + ReLU + active mask of a dense activation, in the
        compute dtype: row 20 (``ln_relu_mask``) at any C."""
        ln = self.p(ln_name)
        c = y.shape[-1]
        out = ln_relu_mask(y.reshape(-1, c), ln["scale"], ln["bias"],
                           active.reshape(-1), LN_EPS,
                           DTYPES[self.compute_dtype], plain=plain)
        return out.reshape(y.shape)

    def _subm_stack(self, prefix, x, active, plain):
        dt = DTYPES[self.compute_dtype]
        for i in range(self.depth):
            y = subm_conv_dense(self.p(f"{prefix}conv{i}"), x, active,
                                compute_dtype=dt)
            y = self._dense_ln(y, f"{prefix}ln{i}", active, plain)
            x = y if (i == 0 and prefix == "") else x + y
        return x

    def _apply_dense(self, grid, points, mask, plain):
        dt = DTYPES[self.compute_dtype]
        active = grid.counts > 0
        x = self._subm_stack("", grid.features.to(dt), active, plain)
        if self.levels > 1:
            skips, actives = [x], [active]
            a = active
            for lv in range(1, self.levels):
                b, r = a.shape[0], a.shape[1] // 2
                # 2^3 or-pooling of the occupancy
                a = a.reshape(b, r, 2, r, 2, r, 2).any(dim=6).any(
                    dim=4).any(dim=2)
                h = conv3d(self.p(f"down{lv}"), skips[-1], stride=2,
                           compute_dtype=dt)
                h = self._dense_ln(h, f"down{lv}_ln", a, plain)
                skips.append(self._subm_stack(f"l{lv}_", h, a, plain))
                actives.append(a)
            h = skips[-1]
            for lv in range(self.levels - 1, 0, -1):
                u = conv3d_transpose(self.p(f"up{lv}"), h, stride=2,
                                     compute_dtype=dt)
                h = skips[lv - 1] + self._dense_ln(u, f"up{lv}_ln",
                                                   actives[lv - 1], plain)
            x = h
        head = self.p("head")
        voxel_logits = x.to(dt).float() @ head["kernel"].to(dt).float() \
            + head["bias"]
        return devoxelize_nearest(voxel_logits, points, mask, grid.lo,
                                  grid.scale)
