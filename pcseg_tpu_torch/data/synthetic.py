"""Synthetic LArTPC-style events (copy of pcseg_tpu/data/synthetic.py).

``synthetic_events``: ragged ``(N, 4)`` float32 point clouds (x, y, z, e)
with one int label per point, built from a few noisy line tracks per
class; class 2 is made rare. The same seed gives the same events as the
JAX package's copy.

``track_events``: the sparse family's benchmark batch (copy of
``_track_batch`` in pcseg_tpu/bench.py), points evenly spaced on four line
segments in the unit cube, ~0.1 % voxel occupancy at R64; the same
generator state gives the same batch.
"""

from __future__ import annotations

import numpy as np


def synthetic_events(
    num_events: int,
    *,
    num_classes: int = 4,
    min_points: int = 100,
    max_points: int = 2000,
    seed: int = 0,
):
    """Yield (points (N,4) f32, labels (N,) i64) tuples."""
    rng = np.random.default_rng(seed)
    freqs = np.ones(num_classes)
    if num_classes > 2:
        freqs[2] = 0.15
    freqs = freqs / freqs.sum()

    for _ in range(num_events):
        n = int(rng.integers(min_points, max_points + 1))
        counts = rng.multinomial(n, freqs)
        counts = np.maximum(counts, 1)
        pts, labs = [], []
        for c, k in enumerate(counts):
            origin = rng.uniform(-50, 50, size=3)
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction) + 1e-9
            t = rng.uniform(0, 30 + 5 * c, size=(k, 1))
            xyz = origin + t * direction + rng.normal(scale=0.5 + 0.2 * c, size=(k, 3))
            e = rng.gamma(2.0, 0.5 + 0.3 * c, size=(k, 1)).astype(np.float32)
            pts.append(np.concatenate([xyz, e], axis=1).astype(np.float32))
            labs.append(np.full(k, c, np.int64))
        points = np.concatenate(pts, axis=0)
        labels = np.concatenate(labs, axis=0)
        perm = rng.permutation(points.shape[0])
        yield points[perm], labels[perm]


def track_events(b: int, m: int, rng=0) -> np.ndarray:
    """(b, m, 4) float32 track events; ``rng`` a seed or a numpy
    Generator."""
    rng = np.random.default_rng(rng)
    pts = []
    for _ in range(b):
        k = 4
        seg = []
        for _ in range(k):
            a, d = rng.random(3), rng.normal(size=3)
            d /= np.linalg.norm(d)
            s = np.linspace(0, 1, m // k + 1)[:, None]
            seg.append(a + s * d * 0.8)
        p = np.concatenate(seg)[:m]
        e = rng.random((m, 1))
        pts.append(np.concatenate([np.clip(p, 0, 1), e], axis=1))
    return np.stack(pts).astype(np.float32)
