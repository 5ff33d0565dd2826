"""VoxelUNet3d — voxelize -> 3D U-Net -> devoxelize (counterpart of
pcseg_tpu/models/voxel_unet.py).

Architecture (grid R, widths w, 2w, 4w, ...): stem 3^3 conv -> per level
two conv-GN-ReLU blocks and a stride-2 down conv -> per decoder level a
transposed up conv, skip concat, two blocks -> 1x1 head -> per-voxel
logits -> trilinear devoxelize -> (B, M, num_classes).

Parameters carry the JAX names (``stem``, ``stem_gn``, ``enc{i}_a``, ...,
``up{i}``, ``dec{i}_a``, ``head``), each a small module holding
``kernel``/``bias`` (DHWIO convs) or ``scale``/``bias`` (GroupNorm), so
``ckpt.convert.from_jax_variables`` maps JAX params one to one.

Two cores, as in the JAX model:
- ``conv_impl="fused"``: the CUDA conv kernels of ops/conv3d_block.py,
  with each GroupNorm folded from the previous kernel's stats into the
  next kernel's prologue and the decoder concat never built
  (``conv(up, W[:, :w]) + conv_add(skip, W[:, w:])``). bf16 only. Each
  block is an autograd Function whose backward runs the backward kernels.
- ``conv_impl="xla"``: plain torch convs and the two-pass GroupNorm, the
  CPU and f32 oracle.

Voxelize and devoxelize take the JAX model's forms: ``voxelize_impl`` and
``devox_impl`` default to "auto", which resolves to the one-hot "matmul"
forms at 64^3, as in the JAX package. With the fused core and the matmul
devoxelize, the head is ``fused_head_grid2`` (activation and 1x1 head in
one kernel, bf16 logits in the grid2 layout) and devoxelize reads that
grid2; otherwise the head is the plain ``head1x1`` with f32 logits. The
voxelize and devoxelize precision follows ``compute_dtype``: bf16 models
run the bf16 kernels (voxelize_contract, trilinear_gather and, in the
backward, trilinear_scatter), f32 models the plain f32 forms.

Training follows the JAX model's ``apply(train=True)``: there are no
running statistics (GroupNorm), so ``apply`` returns ``(logits, {})`` and
``load_batch_stats`` has nothing to load. ``remat=True`` recomputes the
core (the convs and the head; not voxelize or devoxelize) in the
backward, ``torch.utils.checkpoint`` in place of the JAX
``jax.checkpoint``: the step keeps the core's input and output instead of
its activations, and runs the core's forward kernels twice. The stages
run under ``utils.observe.named_scope`` ("voxelize", "core", "head",
"devoxelize"), which a profiler trace shows.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcseg_tpu_torch.ops import conv3d_block as cb
from pcseg_tpu_torch.ops.conv3d import (
    conv3d,
    conv3d_init,
    conv3d_transpose,
    group_norm,
    group_norm_init,
)
from pcseg_tpu_torch.ops.voxel import (
    devoxelize_trilinear,
    devoxelize_trilinear_grid2,
    resolve_devoxelize_impl,
    resolve_voxelize_impl,
    voxelize,
)
from pcseg_tpu_torch.utils.observe import named_scope

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GROUPS = 8


class Params(nn.Module):
    """One JAX parameter group: a dict of named tensors."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            self.register_parameter(k, nn.Parameter(v))

    def as_dict(self) -> dict:
        return dict(self.named_parameters(recurse=False))


class VoxelUNet3d(nn.Module):
    def __init__(self, num_classes: int, input_dim: int = 4,
                 grid_size: int = 64, width: int = 16, levels: int = 3,
                 compute_dtype: str = "float32", conv_impl: str = "auto",
                 voxelize_impl: str = "auto", devox_impl: str = "auto",
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype not in DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.num_classes = num_classes
        self.input_dim = input_dim
        self.grid_size = grid_size
        self.width = width
        self.levels = levels
        self.compute_dtype = compute_dtype
        self.conv_impl = conv_impl
        self.voxelize_impl = voxelize_impl
        self.devox_impl = devox_impl
        self.remat = remat

        g = generator
        w = width
        widths = self.widths
        self.stem = Params(conv3d_init(3, self.in_channels, w, g))
        self.stem_gn = Params(group_norm_init(w))
        for i, wi in enumerate(widths):
            self.add_module(f"enc{i}_a", Params(conv3d_init(3, wi, wi, g)))
            self.add_module(f"enc{i}_a_gn", Params(group_norm_init(wi)))
            self.add_module(f"enc{i}_b", Params(conv3d_init(3, wi, wi, g)))
            self.add_module(f"enc{i}_b_gn", Params(group_norm_init(wi)))
            if i < levels - 1:
                self.add_module(
                    f"down{i}", Params(conv3d_init(2, wi, widths[i + 1], g)))
                self.add_module(
                    f"down{i}_gn", Params(group_norm_init(widths[i + 1])))
        for i in range(levels - 2, -1, -1):
            wi, wlow = widths[i], widths[i + 1]
            self.add_module(f"up{i}", Params(conv3d_init(2, wlow, wi, g)))
            self.add_module(f"up{i}_gn", Params(group_norm_init(wi)))
            self.add_module(
                f"dec{i}_a", Params(conv3d_init(3, 2 * wi, wi, g)))
            self.add_module(f"dec{i}_a_gn", Params(group_norm_init(wi)))
            self.add_module(f"dec{i}_b", Params(conv3d_init(3, wi, wi, g)))
            self.add_module(f"dec{i}_b_gn", Params(group_norm_init(wi)))
        self.head = Params(conv3d_init(1, w, num_classes, g))

    @property
    def in_channels(self) -> int:
        return self.input_dim - 3 + 1   # features + occupancy

    @property
    def widths(self) -> list[int]:
        return [self.width * (2 ** i) for i in range(self.levels)]

    def _fused_ok(self) -> bool:
        """The JAX package's gate for its fused core (channels divide 128,
        each level's grid edge splits into whole 128-lane blocks), kept so
        that "auto" picks the same core in both packages."""
        for i, wi in enumerate(self.widths):
            ri = self.grid_size // (2 ** i)
            if 128 % wi or ri % (128 // wi) or ri < 2:
                return False
        return True

    def resolve_conv_impl(self) -> str:
        impl = self.conv_impl
        if impl == "auto":
            impl = ("fused" if self.compute_dtype == "bfloat16"
                    and self._fused_ok() else "xla")
        if impl == "fused" and self.compute_dtype != "bfloat16":
            raise ValueError(
                "conv_impl='fused' requires compute_dtype='bfloat16' (the "
                f"conv kernels are bf16); got {self.compute_dtype!r}")
        if impl not in ("fused", "xla"):
            raise ValueError(f"unknown conv_impl {self.conv_impl!r}")
        return impl

    def resolve_forms(self) -> dict:
        """The forms ``apply`` takes, as the JAX ``apply`` resolves them:
        the conv core, the voxelize and devoxelize forms, and the head
        ("grid2": ``fused_head_grid2``, the fused core with the matmul
        devoxelize; "1x1": ``head1x1``)."""
        conv = self.resolve_conv_impl()
        devox = resolve_devoxelize_impl(self.devox_impl, self.grid_size,
                                        self.num_classes)
        return {
            "conv": conv,
            "voxelize": resolve_voxelize_impl(
                self.voxelize_impl, self.grid_size, self.in_channels),
            "devoxelize": devox,
            "head": "grid2" if conv == "fused" and devox == "matmul"
            else "1x1",
        }

    def p(self, name: str) -> dict:
        return getattr(self, name).as_dict()

    # -- the duck type of train/steps.train_step
    def supports_fused_loss(self) -> bool:
        return False

    def load_batch_stats(self, new_bn: dict) -> None:
        """GroupNorm keeps no running statistics: nothing to load."""

    def apply(self, points: torch.Tensor, *, train: bool = False,
              mask: torch.Tensor | None = None, seeds=None,
              plain: bool = False):
        """(B, M, 3+F) points -> (B, M, num_classes) f32 logits, and
        ``(logits, {})`` when ``train=True``. Differentiable with respect
        to the parameters. ``seeds`` is unused (no dropout).

        ``plain=True`` runs voxelize, the fused core, the head and
        devoxelize with its backward through the kernels' plain versions
        on any device: the on-card reference of the kernel path.
        """
        dt = DTYPES[self.compute_dtype]
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        forms = self.resolve_forms()
        with named_scope("voxelize"):
            grid = voxelize(points, mask, self.grid_size,
                            impl=forms["voxelize"], matmul_dtype=dt,
                            plain=plain)
            # the matmul voxelizer's bf16 grid, zero-padded to w0 channels
            # by the fused core, has the values of JAX voxelize_packed
            x = grid.features.to(dt)
        grid2 = forms["head"] == "grid2"
        if forms["conv"] == "fused":
            def core(v):
                return self._unet_core_fused(v, plain, grid2)
        else:
            def core(v):
                return self._unet_core(v, dt)
        with named_scope("core"):
            if self.remat and torch.is_grad_enabled():
                voxel_logits = checkpoint(core, x, use_reentrant=False)
            else:
                voxel_logits = core(x)
        devox = devoxelize_trilinear_grid2 if grid2 else devoxelize_trilinear
        with named_scope("devoxelize"):
            logits = devox(voxel_logits, points, mask, grid.lo, grid.scale,
                           forms["devoxelize"], bwd_dtype=dt, plain=plain)
        return (logits, {}) if train else logits

    @torch.no_grad()
    def forward(self, points: torch.Tensor, mask: torch.Tensor | None = None,
                *, plain: bool = False) -> torch.Tensor:
        """Serving: eval-mode logits without a graph."""
        return self.apply(points, mask=mask, plain=plain)

    def _unet_core_fused(self, x: torch.Tensor, plain: bool,
                         grid2_out: bool = False) -> torch.Tensor:
        """Mirror of the JAX ``_unet_core_fused``: 13 conv3x3 launches,
        levels-1 down and levels-1 up launches per forward at levels=3; the
        backward launches 12 dgrads (none for the stem), 13 wgrads and
        levels-1 of each resample backward. ``grid2_out``: the head is
        ``fused_head_grid2`` (one launch forward, one backward) with bf16
        (B, R*R, R*NC) logits; else ``head1x1`` with f32 NDHWC logits."""

        def conv(*args, **kw):
            return cb.conv3x3_gn_act(*args, plain=plain, **kw)

        def down(*args):
            return cb.down2x_gn_act(*args, plain=plain)

        def up(*args):
            return cb.up2x_gn_act(*args, plain=plain)

        widths = self.widths
        rs = [self.grid_size // (2 ** i) for i in range(self.levels)]

        def fold(st, gn_name, lv):
            gn = self.p(gn_name)
            return cb.stats_scale_shift(st, gn["scale"], gn["bias"], GROUPS,
                                        rs[lv] ** 3)

        # stem through the same kernel: input channels zero-padded to w0,
        # the (3,3,3,cin,w0) kernel embedded in a square zero kernel (the
        # pad rows get no gradient); its input is data, so no dgrad
        w0 = widths[0]
        cin = x.shape[-1]
        xp = torch.nn.functional.pad(x.to(torch.bfloat16), (0, w0 - cin))
        stem = self.p("stem")
        kstem = torch.nn.functional.pad(stem["kernel"], (0, 0, 0, w0 - cin))
        xp, st = conv(xp.contiguous(), kstem, stem["bias"], None, None,
                      activate=False, need_dx=False)
        sc, sh = fold(st, "stem_gn", 0)
        skips = []
        for i in range(self.levels):
            for part in ("a", "b"):
                name = f"enc{i}_{part}"
                prm = self.p(name)
                xp, st = conv(xp, prm["kernel"], prm["bias"], sc, sh)
                sc, sh = fold(st, f"{name}_gn", i)
            if i < self.levels - 1:
                skips.append((xp, sc, sh))
                prm = self.p(f"down{i}")
                xp, st = down(xp, prm["kernel"], prm["bias"], sc, sh)
                sc, sh = fold(st, f"down{i}_gn", i + 1)
        for i in range(self.levels - 2, -1, -1):
            wi = widths[i]
            prm = self.p(f"up{i}")
            up_x, st_u = up(xp, prm["kernel"], prm["bias"], sc, sh)
            sc_u, sh_u = fold(st_u, f"up{i}_gn", i)
            skip_x, sc_s, sh_s = skips[i]
            prm = self.p(f"dec{i}_a")
            wk = prm["kernel"]
            y1, _ = conv(up_x, wk[:, :, :, :wi], torch.zeros_like(prm["bias"]),
                         sc_u, sh_u, want_stats=False)
            xp, st = conv(skip_x, wk[:, :, :, wi:], prm["bias"], sc_s, sh_s,
                          accum=y1)
            sc, sh = fold(st, f"dec{i}_a_gn", i)
            prm = self.p(f"dec{i}_b")
            xp, st = conv(xp, prm["kernel"], prm["bias"], sc, sh)
            sc, sh = fold(st, f"dec{i}_b_gn", i)
        head = self.p("head")
        with named_scope("head"):
            if grid2_out:
                return cb.fused_head_grid2(xp, head["kernel"], head["bias"],
                                           sc, sh, self.num_classes,
                                           plain=plain)
            return cb.head1x1(cb.act(xp, sc, sh), head["kernel"],
                              head["bias"])

    def _unet_core(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Mirror of the JAX ``_unet_core``: plain convs + GroupNorm."""

        def block(name, x, stride=1, transpose=False):
            conv = conv3d_transpose if transpose else conv3d
            y = conv(self.p(name), x, stride=stride, compute_dtype=dt)
            y = group_norm(self.p(f"{name}_gn"), y)
            return torch.relu(y).to(dt)

        x = block("stem", x)
        skips = []
        for i in range(self.levels):
            x = block(f"enc{i}_a", x)
            x = block(f"enc{i}_b", x)
            if i < self.levels - 1:
                skips.append(x)
                x = block(f"down{i}", x, stride=2)
        for i in range(self.levels - 2, -1, -1):
            x = block(f"up{i}", x, stride=2, transpose=True)
            x = torch.cat([x, skips[i].to(dt)], dim=-1)
            x = block(f"dec{i}_a", x)
            x = block(f"dec{i}_b", x)
        with named_scope("head"):
            return conv3d(self.p("head"), x, compute_dtype=dt).float()
