"""The native host packer (counterpart of pcseg_tpu/native/build.py).

``csrc/collate.cpp``, the port's copy of the JAX package's C++ source,
holds ``pack_gather`` (the ragged -> padded collation of one batch in one
pass of memsets and memcpys, the JAX ``pack_batch`` reading each event
where it lies: in the concatenation of in-memory events, ``pack_batch``
here, or in two mapped HDF5 files, ``pack_gather`` here and
``data/hdf5.py``, so a batch from files costs one foreign call and no
per-event Python) and ``bucket_sort_windows`` (the epoch plan's stable
sort by length inside each window). It is compiled at
first use with ``g++`` into ``build/pcseg_tpu_torch/`` beside the CUDA
kernels (``ops/_build.build_host``) and loaded with ``ctypes``, whose
foreign calls release the GIL, so a prefetch thread packs while the main
thread runs the step.

Unlike the JAX ``load_native``, which returns None and leaves its callers
on numpy when the build fails, a failed build or load raises here with
the compiler's output: the numpy forms in ``data/batching.py`` run only
when a caller passes ``use_native=False``.

``CALLS`` counts the calls of each entry (``reset_calls`` zeroes it).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

CALLS = {"pack_batch": 0, "pack_gather": 0, "bucket_sort_windows": 0}
_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_LIB: list = []


def reset_calls() -> None:
    with _COUNT_LOCK:
        for k in CALLS:
            CALLS[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        CALLS[name] += 1


def load() -> ctypes.CDLL:
    """Build (if needed) and load the packer, with typed signatures."""
    with _LOAD_LOCK:
        if not _LIB:
            from pcseg_tpu_torch.ops._build import build_host

            lib = ctypes.CDLL(str(build_host("collate")))
            p = ctypes.c_void_p
            lib.pack_gather.restype = ctypes.c_int32
            lib.pack_gather.argtypes = [p] * 5 + [ctypes.c_int32] * 4 + \
                [p, p, p]
            lib.bucket_sort_windows.restype = None
            lib.bucket_sort_windows.argtypes = [p, p, ctypes.c_int64,
                                                ctypes.c_int64]
            _LIB.append(lib)
        return _LIB[0]


def pack_batch(events, max_points: int, batch_size: int, feature_dim: int):
    """``pad_events``'s result, packed by the native library."""
    lib = load()
    n_points = np.asarray([e[0].shape[0] for e in events], np.int32)
    pts = np.concatenate(
        [np.asarray(e[0], np.float32).reshape(-1) for e in events]) \
        if events else np.zeros(0, np.float32)
    labs = np.concatenate(
        [np.asarray(e[1], np.int64).reshape(-1) for e in events]) \
        if events else np.zeros(0, np.int64)
    if pts.size != n_points.sum() * feature_dim or labs.size != \
            n_points.sum():
        raise ValueError("events' points and labels do not match their "
                         f"point counts at feature_dim {feature_dim}")
    starts = np.cumsum(n_points, dtype=np.int64) - n_points
    _count("pack_batch")
    return _pack(lib, pts.ctypes.data, labs.ctypes.data,
                 starts * (4 * feature_dim), starts * 8, n_points,
                 max_points, batch_size, feature_dim)


def _pack(lib, pts_base, lab_base, pts_off, lab_off, n_points, max_points,
          batch_size, feature_dim):
    if len(n_points) > batch_size:
        raise ValueError(f"{len(n_points)} events > batch_size {batch_size}")
    if len(n_points) and (n_points > max_points).any():
        raise ValueError(
            f"event has {n_points.max()} points > max_points {max_points}")
    points = np.empty((batch_size, max_points, feature_dim), np.float32)
    labels = np.empty((batch_size, max_points), np.int64)
    masks = np.empty((batch_size, max_points), np.bool_)
    pts_off = np.ascontiguousarray(pts_off, np.int64)
    lab_off = np.ascontiguousarray(lab_off, np.int64)
    n_points = np.ascontiguousarray(n_points, np.int32)
    rc = lib.pack_gather(pts_base, lab_base, pts_off.ctypes.data,
                         lab_off.ctypes.data, n_points.ctypes.data,
                         len(n_points), batch_size, max_points, feature_dim,
                         points.ctypes.data, labels.ctypes.data,
                         masks.ctypes.data)
    if rc != 0:
        raise ValueError("native pack_gather failed (size mismatch)")
    return points, labels, masks


def pack_gather(data_file, label_file, indices: np.ndarray,
                n_points: np.ndarray, max_points: int, batch_size: int,
                feature_dim: int):
    """``pack_batch``'s result for events ``indices`` of two open
    ``data.hdf5.VlenFile``s (float32 points, int64 labels) whose point
    counts ``n_points`` the caller checked against both files."""
    lib = load()
    _count("pack_gather")
    return _pack(lib, data_file.address, label_file.address,
                 data_file.offsets[indices], label_file.offsets[indices],
                 n_points, max_points, batch_size, feature_dim)


def window_sort(order: np.ndarray, lengths: np.ndarray,
                window: int) -> np.ndarray:
    """A copy of ``order`` (int64) stably sorted by ``lengths`` (int32,
    indexed by the entries of ``order``) inside each window."""
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    lib = load()
    out = np.array(order, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if len(out) and (out.min() < 0 or out.max() >= len(lengths)):
        raise ValueError("order holds indices outside lengths")
    _count("bucket_sort_windows")
    lib.bucket_sort_windows(out.ctypes.data, lengths.ctypes.data, len(out),
                            int(window))
    return out
