"""Ragged events -> static-shape padded batches (numpy).

Copies of ``DEFAULT_BUCKETS``, ``pick_bucket`` and ``pad_events`` from
pcseg_tpu/data/batching.py, without its native C++ packer (the numpy
form is byte-identical to it). Padding to a few bucket lengths keeps the
set of batch shapes small; a short batch is filled with all-masked rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"event with {n} points exceeds largest bucket {buckets[-1]}; "
        "raise data.buckets"
    )


def pad_events(
    events: Sequence[tuple[np.ndarray, np.ndarray]],
    max_points: int,
    batch_size: Optional[int] = None,
    feature_dim: int = 4,
):
    """Pad a list of ragged events to (B, max_points, ...) dense arrays.

    Returns (points f32 (B,M,D), labels i64 (B,M) with -1 padding,
    masks bool (B,M)). ``batch_size`` > len(events) adds fully-masked rows.
    """
    b = batch_size if batch_size is not None else len(events)
    points = np.zeros((b, max_points, feature_dim), np.float32)
    labels = np.full((b, max_points), -1, np.int64)
    masks = np.zeros((b, max_points), bool)
    for i, (pts, labs) in enumerate(events):
        n = pts.shape[0]
        if n > max_points:
            raise ValueError(f"event has {n} points > max_points {max_points}")
        points[i, :n] = pts
        labels[i, :n] = labs
        masks[i, :n] = True
    return points, labels, masks
