"""Block-sparse submanifold 3^3 convolution, raw, with its backward
(counterpart of pcseg_tpu/ops/pallas/block_conv.py ``block_conv``).

feats (B, NT, t^3, Cin) are the features of each event's occupied t^3
tiles (intra-tile voxel order (z * t + y) * t + x); slots (B, NT, 27) is
the +delta neighbour table of ``block_sparse.neighbor_slots`` (tap order
d = (dz+1)*9 + (dy+1)*3 + (dx+1), -1 where there is no tile); w2
(27 * Cin, Cout) is ``subm_conv_init``'s (27, Cin, Cout) kernel
flattened. The output (B, NT, t^3, Cout) is the raw conv in feats' dtype:
f32 sums rounded once, no bias, no active mask (``fused_ln`` applies
both). A voxel's neighbour outside its tile is read from the neighbour
tile at the wrapped position, zero where the slot is -1; capacity-padding
rows (all slots -1, zero features) give zeros.

``block_conv`` is differentiable (the JAX custom VJP, ``_block_conv_bwd``):
the cotangent is cast to feats' dtype; the dgrad is the same conv over the
same slot table with the flipped, channel-transposed taps of ``flip_w2``
(the exact adjoint for kept tiles); the wgrad sums halo(v + d)^T g(v) over
the real tiles' voxels in f32 and rounds once to w2's dtype. On a CUDA
tensor the three launch ``pcseg_block_conv``, ``pcseg_block_conv_dgrad``
and ``pcseg_block_wgrad`` (csrc/block_conv.cu; bf16 or f32, t up to 16,
any channel counts); on a CPU tensor they run ``block_conv_plain``,
``block_conv_dgrad_plain`` and ``block_conv_wgrad_plain``, which assemble
each tile's (t+2)^3 halo from the slot table (the gather form of the JAX
``_gather_halo_slots``) and sum the 27 taps in f32 on dtype-valued
operands.

On the card, bf16 at t = 8 with an output width that is a multiple of 32
(up to 128 for the forward and the dgrad; every conv of the sparse U-Net)
runs the tensor-core implicit GEMMs of csrc/block_conv.cu, everything else
its CUDA-core kernels. The route is decided before the launch by the
library's own rule (``pcseg_block_route``, which the entries apply too),
and the tensor-core launches are counted apart ("block_conv_mma",
"block_conv_dgrad_mma", "block_conv_wgrad_mma"). Both dgrad routes read
the forward's taps flipped in place: ``flip_w2`` serves the plain version
only. tests/test_torch_block_conv_layout.py emulates the tensor-core
kernels' staging, swizzle and summation order on the CPU.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    define_op,
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

# launches since the last reset_launches(); the wrapper adds one where it
# launches its kernel and nowhere else. The op keys count either route,
# the "_mma" keys the tensor-core launches among them
LAUNCHES = {"block_conv": 0, "block_conv_dgrad": 0, "block_conv_wgrad": 0,
            "block_conv_mma": 0, "block_conv_dgrad_mma": 0,
            "block_conv_wgrad_mma": 0}
# pcseg_block_route's kinds
_FWD, _DGRAD, _WGRAD = 0, 1, 2
MAX_TILE = 16
# (dz, dy, dx) of tap / slot d, d = (dz+1)*9 + (dy+1)*3 + (dx+1)
TAPS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tile_edge(t3: int) -> int:
    t = round(t3 ** (1 / 3))
    if t ** 3 != t3:
        raise ValueError(f"{t3} voxels a tile is not a cube")
    return t


def gather_halo_slots(feats: torch.Tensor, slots: torch.Tensor
                      ) -> torch.Tensor:
    """(B, NT, t, t, t, C) tile features and the (B, NT, 27) slot table ->
    (B, NT, t+2, t+2, t+2, C) halo blocks: the tile itself in the centre
    and, from each neighbour, the face, edge or corner the halo needs;
    slot -1 reads zeros."""
    b, nt, t = feats.shape[:3]
    fpad = torch.cat([torch.zeros_like(feats[:, :1]), feats], dim=1)
    rows = slots.long() + 1
    bi = torch.arange(b, device=feats.device)[:, None]
    halo = feats.new_zeros((b, nt, t + 2, t + 2, t + 2, feats.shape[-1]))
    prov = {-1: slice(t - 1, t), 0: slice(0, t), 1: slice(0, 1)}
    dest = {-1: slice(0, 1), 0: slice(1, t + 1), 1: slice(t + 1, t + 2)}
    for d, (dz, dy, dx) in enumerate(TAPS):
        if dz == dy == dx == 0:
            halo[:, :, 1:t + 1, 1:t + 1, 1:t + 1] = feats
            continue
        src = fpad[:, :, prov[dz], prov[dy], prov[dx]]
        halo[:, :, dest[dz], dest[dy], dest[dx]] = src[bi, rows[..., d]]
    return halo


def block_conv_plain(feats: torch.Tensor, slots: torch.Tensor,
                     w2: torch.Tensor) -> torch.Tensor:
    """The raw conv through the assembled halo: the 27 taps summed in f32
    on feats-dtype operands, rounded once to feats' dtype; zeros on the
    capacity-padding rows (slot 13 = -1), as the kernel writes them."""
    b, nt, t3, cin = feats.shape
    t = _tile_edge(t3)
    cout = w2.shape[-1]
    halo = gather_halo_slots(feats.reshape(b, nt, t, t, t, cin), slots)
    halo = halo.float()
    w = w2.to(feats.dtype).float().reshape(27, cin, cout)
    out = torch.zeros((b, nt, t, t, t, cout), dtype=torch.float32,
                      device=feats.device)
    for d, (dz, dy, dx) in enumerate(TAPS):
        win = halo[:, :, dz + 1:dz + 1 + t, dy + 1:dy + 1 + t,
                   dx + 1:dx + 1 + t]
        out += win @ w[d]
    # capacity-padding rows write zeros, whatever their input
    real = (slots[..., 13] >= 0).reshape(b, nt, 1, 1, 1, 1)
    out = torch.where(real, out, 0.0)
    return out.to(feats.dtype).reshape(b, nt, t3, cout)


def flip_w2(w2: torch.Tensor) -> torch.Tensor:
    """w2 (27 * Cin, Cout) -> the transposed conv's taps (27 * Cout, Cin):
    tap d takes W[-d]^T (JAX ``_flip_w2``)."""
    cout = w2.shape[-1]
    w = w2.reshape(27, -1, cout)
    return w.flip(0).transpose(1, 2).reshape(27 * cout, -1)


def block_conv_dgrad_plain(g: torch.Tensor, slots: torch.Tensor,
                           w2: torch.Tensor) -> torch.Tensor:
    """dx of the raw conv: the plain conv of the cotangent with the flipped
    taps over the same slot table."""
    return block_conv_plain(g, slots, flip_w2(w2))


def block_conv_wgrad_plain(feats: torch.Tensor, slots: torch.Tensor,
                           g: torch.Tensor,
                           out_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """dW (27 * Cin, Cout): for each tap the f32 product of the shifted
    halo windows and the cotangent over the real tiles' voxels (slot 13 >=
    0), rounded once to ``out_dtype`` (feats' dtype by default)."""
    b, nt, t3, cin = feats.shape
    t = _tile_edge(t3)
    cout = g.shape[-1]
    real = (slots[..., 13] >= 0)[..., None, None]
    halo = gather_halo_slots(feats.reshape(b, nt, t, t, t, cin), slots)
    halo = halo.float()
    gf = torch.where(real, g.float(), 0.0).reshape(-1, cout)
    dw = torch.empty((27, cin, cout), dtype=torch.float32,
                     device=feats.device)
    for d, (dz, dy, dx) in enumerate(TAPS):
        win = halo[:, :, dz + 1:dz + 1 + t, dy + 1:dy + 1 + t,
                   dx + 1:dx + 1 + t]
        dw[d] = win.reshape(-1, cin).T @ gf
    return dw.reshape(27 * cin, cout).to(out_dtype or feats.dtype)


def _check(feats, slots, w2_shape, cout):
    b, nt, t3, cin = feats.shape
    t = _tile_edge(t3)
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block_conv takes bf16 or f32, got {feats.dtype}")
    if t > MAX_TILE or cout < 1:
        raise ValueError(f"block_conv takes tiles up to {MAX_TILE}^3 and at "
                         f"least one output channel, got t={t}, Cout={cout}")
    if tuple(slots.shape) != (b, nt, 27) or tuple(w2_shape) != (27 * cin,
                                                                 cout):
        raise ValueError(f"slots must be {(b, nt, 27)} and w2 "
                         f"{(27 * cin, cout)}, got {tuple(slots.shape)}, "
                         f"{tuple(w2_shape)}")
    return b, nt, t, cin


def _aligned(*tensors) -> int:
    return int(all(x.data_ptr() % 16 == 0 for x in tensors))


def _route(lib, kind, t, k, n, dtype, aligned) -> bool:
    """True where the library takes a launch of ``kind`` with GEMM input
    and output channels k and n on its tensor-core route (its own rule,
    which its entries apply to the same arguments)."""
    return bool(lib.pcseg_block_route(kind, t, k, n,
                                      int(dtype == torch.bfloat16), aligned))


def _launch(entry, key, kind, feats, slots, w2, cin_k, cout_k, w2_shape):
    """One conv kernel launch (forward or dgrad) of feats (B, NT, t^3,
    cin_k) with the forward's taps w2 (``w2_shape``) -> (B, NT, t^3,
    cout_k)."""
    b, nt, t, _ = _check(feats, slots, (27 * cin_k, cout_k), cout_k)
    if tuple(w2.shape) != tuple(w2_shape):
        raise ValueError(f"w2 must be {tuple(w2_shape)}, got "
                         f"{tuple(w2.shape)}")
    feats = feats.contiguous()
    slots = slots.to(device=feats.device, dtype=torch.int32).contiguous()
    w2 = w2.to(device=feats.device, dtype=feats.dtype).contiguous()
    out = torch.empty((b, nt, t ** 3, cout_k), dtype=feats.dtype,
                      device=feats.device)
    lib = load_library("block_conv")
    mma = _route(lib, kind, t, cin_k, cout_k, feats.dtype,
                 _aligned(feats, slots, w2, out))
    rc = getattr(lib, entry)(
        feats.data_ptr(), slots.data_ptr(), w2.data_ptr(), out.data_ptr(), b,
        nt, t, cin_k, cout_k, int(feats.dtype == torch.bfloat16),
        stream_of(feats))
    raise_on(rc, key)
    LAUNCHES[key] += 1
    if mma:
        LAUNCHES[f"{key}_mma"] += 1
    return out


def block_conv_fwd(feats: torch.Tensor, slots: torch.Tensor,
                   w2: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """The raw block conv without a graph (module docstring): the
    registered op ``pcseg::block_conv``, which launches the CUDA kernel on
    a CUDA tensor and runs the plain version on a CPU tensor (or with
    ``plain``)."""
    if plain:
        return block_conv_plain(feats, slots, w2)
    on_cuda(feats)                # refuses a device other than CPU or CUDA
    return _fwd_op(feats, slots, w2)


def block_conv_cuda(feats: torch.Tensor, slots: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch on CUDA tensors."""
    cin, cout = feats.shape[-1], w2.shape[-1]
    return _launch("pcseg_block_conv", "block_conv", _FWD, feats, slots, w2,
                   cin, cout, (27 * cin, cout))


_fwd_op = define_op(
    "block_conv(Tensor feats, Tensor slots, Tensor w2) -> Tensor",
    block_conv_plain, block_conv_cuda,
    lambda feats, slots, w2: feats.new_empty(feats.shape[:3] +
                                             (w2.shape[-1],)))


def block_conv_dgrad(g: torch.Tensor, slots: torch.Tensor, w2: torch.Tensor,
                     *, plain: bool = False) -> torch.Tensor:
    """dx (B, NT, t^3, Cin) of the raw conv from its cotangent g (B, NT,
    t^3, Cout) in the feature dtype. Launches the forward's kernel body
    (entry ``pcseg_block_conv_dgrad``) on a CUDA tensor, which reads the
    forward's taps w2 flipped in place."""
    if not on_cuda(g, plain):
        return block_conv_dgrad_plain(g, slots, w2)
    cin, cout = w2.shape[0] // 27, w2.shape[-1]
    return _launch("pcseg_block_conv_dgrad", "block_conv_dgrad", _DGRAD, g,
                   slots, w2, cout, cin, (27 * cin, cout))


def block_conv_wgrad(feats: torch.Tensor, slots: torch.Tensor,
                     g: torch.Tensor, out_dtype: torch.dtype | None = None,
                     *, plain: bool = False) -> torch.Tensor:
    """dW (27 * Cin, Cout) in ``out_dtype`` (feats' dtype by default) from
    the features and the cotangent g (B, NT, t^3, Cout), both in the
    feature dtype. Launches the CUDA kernel and its fixed-order sum on a
    CUDA tensor."""
    out_dtype = out_dtype or feats.dtype
    if not on_cuda(feats, plain):
        return block_conv_wgrad_plain(feats, slots, g, out_dtype)
    cout = g.shape[-1]
    b, nt, t, cin = _check(feats, slots, (27 * feats.shape[-1], cout), cout)
    if g.shape[:3] != feats.shape[:3] or g.dtype != feats.dtype:
        raise ValueError(f"g must be {tuple(feats.shape[:3]) + (cout,)} "
                         f"{feats.dtype}, got {tuple(g.shape)} {g.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block_conv's wgrad writes bf16 or f32, got "
                         f"{out_dtype}")
    is_bf16 = int(feats.dtype == torch.bfloat16)
    lib = load_library("block_conv")
    feats, g = feats.contiguous(), g.contiguous()
    slots = slots.to(device=feats.device, dtype=torch.int32).contiguous()
    aligned = _aligned(feats, slots, g)
    mma = _route(lib, _WGRAD, t, cin, cout, feats.dtype, aligned)
    groups = lib.pcseg_block_wgrad_groups(b, nt, t, cin, cout, is_bf16,
                                          aligned)
    partial = torch.empty((groups, 27 * cin, cout), dtype=torch.float32,
                          device=feats.device)
    dw = torch.empty((27 * cin, cout), dtype=out_dtype, device=feats.device)
    rc = lib.pcseg_block_wgrad(
        feats.data_ptr(), slots.data_ptr(), g.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), b, nt, t, cin, cout, is_bf16,
        int(out_dtype == torch.bfloat16), groups, stream_of(feats))
    raise_on(rc, "block_conv_wgrad")
    LAUNCHES["block_conv_wgrad"] += 1
    if mma:
        LAUNCHES["block_conv_wgrad_mma"] += 1
    return dw


class _BlockConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, slots, w2, plain):
        ctx.save_for_backward(feats, slots, w2)
        ctx.plain = plain
        return block_conv_fwd(feats, slots, w2, plain=plain)

    @staticmethod
    def backward(ctx, g):
        feats, slots, w2 = ctx.saved_tensors
        g = g.to(feats.dtype)
        dx = dw = None
        # the stem's input is data: no dgrad
        if ctx.needs_input_grad[0]:
            dx = block_conv_dgrad(g, slots, w2.to(feats.dtype),
                                  plain=ctx.plain)
        if ctx.needs_input_grad[2]:
            dw = block_conv_wgrad(feats, slots, g, w2.dtype, plain=ctx.plain)
        return dx, None, dw, None


def block_conv(feats: torch.Tensor, slots: torch.Tensor, w2: torch.Tensor,
               *, plain: bool = False) -> torch.Tensor:
    """The differentiable raw block conv (module docstring): the kernels on
    a CUDA tensor, the plain versions on a CPU tensor or with
    ``plain=True``."""
    return _BlockConv.apply(feats, slots, w2, plain)
