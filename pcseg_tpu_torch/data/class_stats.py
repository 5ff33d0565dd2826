"""Class scan + inverse-frequency weighting (copy of
pcseg_tpu/data/class_stats.py).

- scan the first ``min(scan_events, len(ds))`` events;
- ``num_classes = len(set(labels))`` (the reference's rule: it assumes
  contiguous labels 0..C-1; ``max_label_plus_one`` exposes the hazard);
- weights ``max_count / count`` per class, the target class (2) boosted
  2x, absent classes 1.0, then scaled so the weights sum to num_classes.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np


@dataclass
class ClassStats:
    num_classes: int
    max_label_plus_one: int
    counts: dict[int, int]
    weights: np.ndarray  # (num_classes,) float32, sums to num_classes


def scan_classes(dataset, scan_events: int = 1000, target_class: int = 2,
                 target_boost: float = 2.0) -> ClassStats:
    counts: Counter = Counter()
    for i in range(min(scan_events, len(dataset))):
        _, labels = dataset[i]
        vals, c = np.unique(np.asarray(labels), return_counts=True)
        for v, k in zip(vals, c):
            counts[int(v)] += int(k)
    if not counts:
        raise ValueError("no labels found in scan")
    num_classes = len(counts)
    max_count = max(counts.values())
    weights = []
    for class_id in range(num_classes):
        if class_id in counts:
            w = max_count / counts[class_id]
            if class_id == target_class:
                w *= target_boost
            weights.append(w)
        else:
            weights.append(1.0)
    weights = np.asarray(weights, np.float64)
    weights = weights * num_classes / weights.sum()
    return ClassStats(
        num_classes=num_classes,
        max_label_plus_one=max(counts) + 1,
        counts=dict(counts),
        weights=weights.astype(np.float32),
    )
