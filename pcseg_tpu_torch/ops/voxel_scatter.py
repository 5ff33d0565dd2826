"""Segment sums of point rows by voxel id: a CUDA kernel + its plain
version.

Counterpart of pcseg_tpu/ops/pallas/voxel_scatter.py
(``pallas_segment_scatter``): ``flat_ids`` (B, M) int32 in [0, R3], where
R3 is the spill row of masked points, and ``feats`` (B, M, C) f32, already
zeroed at masked points, give the (B, R3, C) f32 sums; the spill row is
dropped. Any id outside [0, R3) adds nothing, so no id writes outside the
output. As in the JAX package there is no VJP, and no entry point reaches
the op (``ops/voxel.voxelize`` keeps its own scatter); the TPU kernel's
8-lane padding of C is a layout detail and is not ported.

On the card a thread takes one (point, channel) value and adds it with a
float atomic, so sums run in another order than the TPU's point-by-point
accumulation: hold them to a tolerance relative to the sum of the terms'
magnitudes, not bit for bit.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)

LAUNCHES = {"segment_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def segment_scatter_plain(flat_ids: torch.Tensor, feats: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """One ``index_add_`` into a table with a spill row per event, where
    every id outside [0, num_segments) lands."""
    b, _, c = feats.shape
    ids = flat_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    ids = ids + torch.arange(b, device=feats.device)[:, None] * (
        num_segments + 1)
    out = torch.zeros((b * (num_segments + 1), c), dtype=torch.float32,
                      device=feats.device)
    out.index_add_(0, ids.reshape(-1), feats.float().reshape(-1, c))
    return out.reshape(b, num_segments + 1, c)[:, :num_segments]


def segment_scatter(flat_ids: torch.Tensor, feats: torch.Tensor,
                    num_segments: int, *, plain: bool = False
                    ) -> torch.Tensor:
    """(B, M) int32 ids, (B, M, C) f32 rows -> (B, num_segments, C) f32
    segment sums (JAX ``pcseg_tpu.ops.pallas.voxel_scatter.
    pallas_segment_scatter``). Launches the CUDA kernel on a CUDA tensor
    unless ``plain``."""
    if not on_cuda(feats, plain):
        return segment_scatter_plain(flat_ids, feats, num_segments)
    b, m, c = feats.shape
    if tuple(flat_ids.shape) != (b, m) or flat_ids.device != feats.device:
        raise ValueError(f"flat_ids must be (B, M) = {(b, m)} on "
                         f"{feats.device}, got {tuple(flat_ids.shape)} on "
                         f"{flat_ids.device}")
    ids = flat_ids.to(torch.int32).contiguous()
    feats = feats.float().contiguous()
    out = torch.zeros((b, num_segments, c), dtype=torch.float32,
                      device=feats.device)
    rc = load_library("onehot_contract").pcseg_segment_scatter(
        ids.data_ptr(), feats.data_ptr(), out.data_ptr(), b, m, num_segments,
        c, stream_of(feats))
    raise_on(rc, "segment_scatter")
    LAUNCHES["segment_scatter"] += 1
    return out
