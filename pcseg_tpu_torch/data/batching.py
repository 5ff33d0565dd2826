"""Ragged events -> static-shape padded batches.

Copies of ``DEFAULT_BUCKETS``, ``pick_bucket``, ``pad_events`` and
``BucketBatcher`` from pcseg_tpu/data/batching.py. Padding to a few
bucket lengths keeps the set of batch shapes small; a short batch is
filled with all-masked rows. The packing and the epoch plan's window sort
run in the native packer (``data/native.py``; a dataset with a
``pack_batch`` method, the HDF5 one, packs its batches itself) unless the
caller passes ``use_native=False``, which takes the numpy forms: the
same bytes.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from pcseg_tpu_torch.data import native

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
    use_native: bool = True,
):
    """Pad a list of ragged events to (B, max_points, ...) dense arrays.

    Returns (points f32 (B,M,D), labels i64 (B,M) with -1 padding,
    masks bool (B,M)). ``batch_size`` > len(events) adds fully-masked rows.
    ``use_native``: the C++ packer (else numpy, byte-identical).
    """
    b = batch_size if batch_size is not None else len(events)
    if use_native:
        return native.pack_batch(events, max_points, b, feature_dim)
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


def predict_in_buckets(forward, events: Sequence[np.ndarray],
                       batch_size: int, buckets: Sequence[int],
                       feature_dim: int = 4) -> list:
    """Per-point argmax predictions of ragged (N, D) f32 ``events`` through
    ``forward(points, mask) -> (B, M, C) logits`` on padded numpy batches,
    ``batch_size`` events a call, grouped by length so that each group pads
    to one bucket (the serving loop of ``infer.Predictor`` and
    ``serve.ExportedPredictor``)."""
    order = sorted(range(len(events)), key=lambda i: events[i].shape[0])
    out: list = [None] * len(events)
    for s in range(0, len(order), batch_size):
        idx = order[s : s + batch_size]
        group = [events[i] for i in idx]
        bucket = pick_bucket(max(e.shape[0] for e in group), buckets)
        pts, _, msk = pad_events(
            [(e, np.zeros(e.shape[0], np.int64)) for e in group], bucket,
            batch_size=batch_size, feature_dim=feature_dim)
        logits = forward(pts, msk)
        for j, i in enumerate(idx):
            out[i] = np.argmax(logits[j, : events[i].shape[0]], axis=-1)
    return out


# length sorting happens inside windows of this many batches (the
# default of ``BucketBatcher``'s ``window_batches``)
WINDOW_BATCHES = 32


class BucketBatcher:
    """Iterate a dataset as static-shape batches.

    Groups a (possibly shuffled) index order into fixed-size batches and
    pads each to the smallest bucket >= its max point count. With
    ``bucket_by_length`` the order is sorted by point count inside
    windows of ``window_batches`` batches, so batches are homogeneous in
    length (less padding) while staying shuffled across epochs. A short
    final batch is kept unless ``drop_last``. ``use_native``: pack and
    sort with the C++ packer (else numpy, the same batches).

    ``shard=(rank, n)``: yield only rank ``rank``'s rows [rank·B/n,
    (rank+1)·B/n) of each batch of B (``parallel.mesh``), read and packed
    alone, padded to the bucket of the WHOLE batch, so that every rank
    runs the point count one process would (the fused PointNet chain's
    statistics count padded points); rows past a short final batch are
    all-masked. B not divisible by n raises ValueError.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        indices: Optional[np.ndarray] = None,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        bucket_by_length: bool = True,
        window_batches: int = WINDOW_BATCHES,
        feature_dim: int = 4,
        use_native: bool = True,
        shard: tuple[int, int] = (0, 1),
    ):
        if batch_size % shard[1]:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"the mesh data axis ({shard[1]})")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.indices = (
            np.arange(len(dataset)) if indices is None else np.asarray(indices)
        )
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.bucket_by_length = bucket_by_length
        self.window = window_batches * batch_size
        self.feature_dim = feature_dim
        self.use_native = use_native
        self.epoch = 0
        self._lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _all_lengths(self) -> np.ndarray:
        if self._lengths is None:
            ds = self.dataset
            self._lengths = np.asarray(
                [ds.num_points(i) if hasattr(ds, "num_points")
                 else ds[i][0].shape[0] for i in range(len(ds))], np.int32)
        return self._lengths

    def _epoch_order(self) -> np.ndarray:
        order = self.indices.astype(np.int64)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        if not self.bucket_by_length or not len(order):
            return order
        lengths = self._all_lengths()
        if self.use_native:
            return native.window_sort(order, lengths, self.window)
        return np.concatenate([
            win[np.argsort(lengths[win], kind="stable")]
            for win in (order[s : s + self.window]
                        for s in range(0, len(order), self.window))])

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = self._epoch_order()
        self.epoch += 1
        bs = self.batch_size
        stop = len(order) - len(order) % bs if self.drop_last else len(order)
        # an HDF5 dataset packs a batch straight from its files
        gather = self.use_native and hasattr(self.dataset, "pack_batch") \
            and self.dataset.feature_dim == self.feature_dim
        rank, n = self.shard
        rows = bs // n
        for s in range(0, stop, bs):
            idx = order[s : s + bs]
            mine = idx[rank * rows : (rank + 1) * rows]
            bucket = pick_bucket(int(self._all_lengths()[idx].max()),
                                 self.buckets)
            if gather:
                yield self.dataset.pack_batch(mine, bucket, rows)
                continue
            events = [self.dataset[int(i)] for i in mine]
            yield pad_events(events, bucket, batch_size=rows,
                             feature_dim=self.feature_dim,
                             use_native=self.use_native)
