"""Synthetic LArTPC-style events (copy of pcseg_tpu/data/synthetic.py).

Ragged ``(N, 4)`` float32 point clouds (x, y, z, e) with one int label
per point, built from a few noisy line tracks per class; class 2 is made
rare. The same seed gives the same events as the JAX package's copy.
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
