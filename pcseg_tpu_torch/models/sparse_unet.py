"""SparseVoxelNet, block impl, serving and training (counterpart of
pcseg_tpu/models/sparse_unet.py).

Voxelize each event straight into its occupied t^3 tiles, run a stack of
``depth`` submanifold 3^3 conv blocks on them (conv -> LayerNorm ->
ReLU -> active mask, residual after the first), and with ``levels`` > 1 a
sparse U-Net over the pooled tile hierarchy (stride-2 down, a block stack
at width w * 2^lv, transposed up, skip sum); a per-voxel head and the
nearest-voxel readout give (B, M, num_classes) f32 logits.

The port follows what the JAX package runs on a TPU (``fused_ln=True``,
``conv_impl="auto"``): every 3^3 conv is the RAW conv of ``block_conv``
(csrc/block_conv.cu; the stem too, which the JAX package sends through
the XLA halo form of the same function because of a TPU lane gate), and
``bias_ln_relu_mask`` (csrc/fused_ln.cu) adds the conv bias, normalizes,
applies ReLU and masks. Down and up take the raw forms of
ops/block_sparse.py, including ``block_up2x``'s bf16 rounding of its f32
sums. The head and the up product sum in f32 on compute-dtype operands;
residual sums happen in the compute dtype.

Parameters carry the JAX names (``conv0``, ``ln0``, ``down1``,
``down1_ln``, ``l1_conv0``, ``l1_ln0``, ``up1``, ``up1_ln``, ``head``),
so ``ckpt.convert.from_jax_variables`` maps JAX parameters one to one.
Only ``impl="block"`` is ported; "dense" and "gather" raise
(ROADMAP Queue A item 8).
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
from pcseg_tpu_torch.ops.conv3d import conv3d_init
from pcseg_tpu_torch.ops.fused_ln import bias_ln_relu_mask
from pcseg_tpu_torch.ops.sparse import site_layer_norm_init, subm_conv_init

LN_EPS = 1e-5


class SparseVoxelNet(nn.Module):
    def __init__(self, num_classes: int, input_dim: int = 4,
                 grid_size: int = 64, width: int = 32, depth: int = 4,
                 compute_dtype: str = "float32",
                 impl: str = "block", max_tiles: int = 128, tile: int = 8,
                 max_tiles_schedule: tuple = (), levels: int = 1,
                 voxelize_impl: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if impl != "block":
            raise NotImplementedError(
                f"SparseVoxelNet impl={impl!r} is not ported to "
                "pcseg_tpu_torch yet (ROADMAP Queue A item 8); impl='block' "
                "is")
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
        returns ``(logits, {"__overflow__": dropped})``, with
        ``return_overflow`` (eval) ``(logits, dropped)``: the (B,) count of
        occupied tiles beyond the capacities, every level summed.
        ``seeds`` is unused (no dropout). ``plain=True`` runs every
        kernel's plain version, forward and backward, on any device: the
        on-card reference."""
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        bs = self._voxelize(points, mask, plain)
        logits, dropped = self._apply_block(bs, points, mask, plain)
        if train:
            return logits, {"__overflow__": dropped}
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
        """(B,) occupied tiles beyond the static capacity, every level of
        the hierarchy counted; one voxelize of the coordinates, no conv."""
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
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
