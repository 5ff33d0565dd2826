"""Block-sparse submanifold 3^3 convolution, raw forward (counterpart of
pcseg_tpu/ops/pallas/block_conv.py ``block_conv``).

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

On a CUDA tensor ``block_conv`` launches ``pcseg_block_conv``
(csrc/block_conv.cu); on a CPU tensor it runs ``block_conv_plain``, which
assembles each tile's (t+2)^3 halo from the slot table (the gather form of
the JAX ``_gather_halo_slots``) and sums the 27 taps in f32 on
dtype-valued operands. The dgrad and wgrad wait for the sparse family's
training slice (ROADMAP Queue B).
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

# launches since the last reset_launches(); the wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {"block_conv": 0}
MAX_TILE = 8
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
    on feats-dtype operands, rounded once to feats' dtype."""
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
    return out.to(feats.dtype).reshape(b, nt, t3, cout)


def block_conv(feats: torch.Tensor, slots: torch.Tensor, w2: torch.Tensor,
               *, plain: bool = False) -> torch.Tensor:
    """The raw block conv (module docstring). Launches the CUDA kernel on
    a CUDA tensor."""
    if not on_cuda(feats, plain):
        return block_conv_plain(feats, slots, w2)
    b, nt, t3, cin = feats.shape
    t = _tile_edge(t3)
    cout = w2.shape[-1]
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block_conv takes bf16 or f32, got {feats.dtype}")
    if t > MAX_TILE or cout % 16:
        raise ValueError(f"block_conv takes tiles up to {MAX_TILE}^3 and a "
                         f"multiple of 16 output channels, got t={t}, "
                         f"Cout={cout}")
    if tuple(slots.shape) != (b, nt, 27) or tuple(w2.shape) != (27 * cin,
                                                                 cout):
        raise ValueError(f"slots must be {(b, nt, 27)} and w2 "
                         f"{(27 * cin, cout)}, got {tuple(slots.shape)}, "
                         f"{tuple(w2.shape)}")
    feats = feats.contiguous()
    slots = slots.to(device=feats.device, dtype=torch.int32).contiguous()
    w2 = w2.to(device=feats.device, dtype=feats.dtype).contiguous()
    out = torch.empty((b, nt, t3, cout), dtype=feats.dtype,
                      device=feats.device)
    rc = load_library("block_conv").pcseg_block_conv(
        feats.data_ptr(), slots.data_ptr(), w2.data_ptr(), out.data_ptr(), b,
        nt, t, cin, cout, int(feats.dtype == torch.bfloat16),
        stream_of(feats))
    raise_on(rc, "block_conv")
    LAUNCHES["block_conv"] += 1
    return out
