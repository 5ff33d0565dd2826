"""The port's HDF5 event files (``pcseg_tpu_torch/data/hdf5.py``) against
h5py and the JAX package's ``PointCloudDataset``: files written by the
JAX ``write_event_files`` (h5py's default form), by h5py chunked with
gzip + shuffle, and a file of 70,000 one-point events (h5py spreads it
over many global-heap collections, the port's writer over two: a
collection holds at most 65,535 objects) read equal, event by event; the
port's files read back equal by h5py and by the JAX class; the forms
outside the reader's scope raise NotImplementedError; the port's
BucketBatcher over the port's dataset yields the JAX batcher's batches
bit for bit."""

import threading

import h5py
import numpy as np
import pytest
import torch

from pcseg_tpu.data import hdf5 as jax_hdf5
from pcseg_tpu.data.batching import BucketBatcher as JaxBucketBatcher
from pcseg_tpu_torch.data import hdf5, native
from pcseg_tpu_torch.data.batching import BucketBatcher
from pcseg_tpu_torch.data.synthetic import synthetic_events

torch.set_num_threads(1)

MANY = 70_000


def _events(n=24, seed=5, **kw):
    kw = {"min_points": 1, "max_points": 300, **kw}
    out = list(synthetic_events(n, seed=seed, **kw))
    # an empty event and a one-point event at the edges of the format
    out[3] = (np.zeros((0, 4), np.float32), np.zeros(0, np.int64))
    out[4] = (out[4][0][:1], out[4][1][:1])
    return out


def _many_events():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(MANY, 1, 4)).astype(np.float32)
    labs = rng.integers(0, 4, size=(MANY, 1)).astype(np.int64)
    return list(zip(pts, labs))


def _h5py_write(path, name, arrays, dtype, **kw):
    """One vlen dataset written by h5py in one call (``kw``: chunking and
    filters)."""
    vt = h5py.vlen_dtype(dtype)
    with h5py.File(path, "w") as f:
        d = f.create_dataset(name, (len(arrays),), dtype=vt, **kw)
        arr = np.empty(len(arrays), dtype=vt)
        for i, a in enumerate(arrays):
            arr[i] = np.asarray(a, dtype).reshape(-1)
        d.write_direct(arr)


CHUNKED = dict(chunks=True, compression="gzip", shuffle=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{form: (data path, label path, events)} written by h5py."""
    root = tmp_path_factory.mktemp("h5")
    out = {}
    ev = _events()
    jax_hdf5.write_event_files(str(root / "d.h5"), str(root / "l.h5"), ev)
    out["jax_default"] = (str(root / "d.h5"), str(root / "l.h5"), ev)
    for form, kw, events in (("chunked_gzip_shuffle", CHUNKED, ev),
                             ("chunked_small", dict(CHUNKED, chunks=(5,)),
                              ev),
                             ("many_collections", {}, _many_events())):
        d, lab = str(root / f"{form}_d.h5"), str(root / f"{form}_l.h5")
        _h5py_write(d, "data", [p for p, _ in events], np.float32, **kw)
        _h5py_write(lab, "labels", [y for _, y in events], np.int64, **kw)
        out[form] = (d, lab, events)
    return out


def _assert_same(ds, ref, events):
    """Every event of the port's dataset against the events written, and
    against the JAX class (h5py, ~1 ms an event: every event of a small
    file, and of the 70,000 those of every 16th batch of 64, the last
    included)."""
    n = len(events)
    assert len(ds) == len(ref) == n
    checked = [i for i in range(n)
               if n < 1000 or i % 1024 < 64 or i >= n - 64]
    for i, (p, y) in enumerate(events):
        got_p, got_y = ds[i]
        assert got_p.dtype == np.float32 and got_y.dtype == np.int64
        assert got_p.shape == p.shape and got_y.shape == y.shape
        assert got_p.tobytes() == p.tobytes(), i
        assert got_y.tobytes() == y.tobytes(), i
        assert ds.num_points(i) == p.shape[0]
    for i in checked:
        ref_p, ref_y = ref[i]
        assert ref_p.tobytes() == events[i][0].tobytes(), i
        assert ref_y.tobytes() == events[i][1].tobytes(), i
        assert ref.num_points(i) == events[i][0].shape[0]


@pytest.mark.parametrize("form", ["jax_default", "chunked_gzip_shuffle",
                                  "chunked_small", "many_collections"])
def test_reads_h5py_files_as_jax_does(files, form):
    d, lab, events = files[form]
    with hdf5.PointCloudDataset(d, lab) as ds, \
            jax_hdf5.PointCloudDataset(d, lab) as ref:
        _assert_same(ds, ref, events)
        collections = len(set(ds.data_file.refs["addr"].tolist()))
        assert collections > 1 if form == "many_collections" else True


@pytest.mark.parametrize("n", [24, MANY], ids=["small", "70000"])
def test_port_files_read_by_h5py_and_jax(tmp_path, n):
    events = _events() if n == 24 else _many_events()
    d, lab = str(tmp_path / "sub" / "d.h5"), str(tmp_path / "l.h5")
    assert hdf5.write_event_files(d, lab, events) == n
    with h5py.File(d, "r") as fd, h5py.File(lab, "r") as fl:
        data, labels = fd["data"][:], fl["labels"][:]
        assert fd["data"].dtype == h5py.vlen_dtype(np.float32)
        assert fl["labels"].dtype == h5py.vlen_dtype(np.int64)
    for i, (p, y) in enumerate(events):
        assert data[i].tobytes() == p.tobytes()
        assert labels[i].tobytes() == y.tobytes()
    with hdf5.PointCloudDataset(d, lab) as ds, \
            jax_hdf5.PointCloudDataset(d, lab) as ref:
        _assert_same(ds, ref, events)
        if n == MANY:
            # the u16 object index: 65,535 objects a collection at most
            assert len(set(ds.data_file.refs["addr"].tolist())) == 2
            assert int(ds.label_file.refs["idx"].max()) == 65535


def test_mismatches_raise_as_jax(tmp_path):
    ev = _events(6)
    d, lab = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    hdf5.write_event_files(d, lab, ev)
    d5, l5 = str(tmp_path / "d5.h5"), str(tmp_path / "l5.h5")
    hdf5.write_event_files(d5, l5, ev[:5])
    for cls in (hdf5.PointCloudDataset, jax_hdf5.PointCloudDataset):
        with pytest.raises(ValueError, match="6 events but labels has 5"):
            cls(d, l5)
    # event 1's labels cut short
    bad = [(p, y[:-1] if i == 1 else y) for i, (p, y) in enumerate(ev)]
    lb = str(tmp_path / "lb.h5")
    hdf5.write_event_files(str(tmp_path / "db.h5"), lb, bad)
    for cls in (hdf5.PointCloudDataset, jax_hdf5.PointCloudDataset):
        with cls(d, lb) as ds:
            ds[0]
            with pytest.raises(ValueError, match="event 1: "):
                ds[1]


def test_unsupported_forms_raise(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("data", (2,), dtype=h5py.vlen_dtype(np.float32))
    with pytest.raises(NotImplementedError, match="superblock version 3 at "
                                                  "file offset 0"):
        hdf5.VlenFile(path, "data")
    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", (2,), dtype=h5py.vlen_dtype(np.float32),
                         chunks=True, compression="lzf")
    with pytest.raises(NotImplementedError, match="filter 32000 at file "
                                                  "offset"):
        hdf5.VlenFile(path, "data")
    path = str(tmp_path / "fixed.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.zeros(8, np.float32))
    with pytest.raises(NotImplementedError, match="datatype class 1"):
        hdf5.VlenFile(path, "data")
    with pytest.raises(KeyError, match="no dataset 'labels'"):
        hdf5.VlenFile(path, "labels")
    path = str(tmp_path / "not.h5")
    with open(path, "wb") as f:
        f.write(b"x" * 200)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.VlenFile(path, "data")


def test_threads_read_at_once(files):
    d, lab, events = files["jax_default"]
    errors = []
    with hdf5.PointCloudDataset(d, lab) as ds:
        def reader(k):
            try:
                for _ in range(20):
                    for i in range(k, len(events), 4):
                        assert ds[i][0].tobytes() == events[i][0].tobytes()
            except AssertionError as e:     # reported below
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors


@pytest.mark.parametrize("form", ["chunked_gzip_shuffle",
                                  "many_collections"])
def test_batcher_over_files_matches_jax(files, form):
    """Two shuffled epochs: the port's batcher packing straight from the
    files (``pack_gather``), and on numpy from events read one by one,
    against the JAX batcher over the JAX dataset."""
    d, lab, _ = files[form]
    with hdf5.PointCloudDataset(d, lab) as ds, \
            jax_hdf5.PointCloudDataset(d, lab) as ref:
        idx = np.random.default_rng(0).permutation(len(ds))[:21]
        kw = dict(buckets=(1, 64, 128, 512), indices=idx, shuffle=True,
                  seed=3)
        mine = BucketBatcher(ds, 4, **kw)
        plain = BucketBatcher(ds, 4, use_native=False, **kw)
        theirs = JaxBucketBatcher(ref, 4, window_batches=32, **kw)
        native.reset_calls()
        for _ in range(2):
            got, numpy_got, want = list(mine), list(plain), list(theirs)
            assert len(got) == len(numpy_got) == len(want) == 6
            for a, b, c in zip(got, numpy_got, want):
                for x, y, z in zip(a, b, c):
                    assert x.dtype == y.dtype == z.dtype
                    assert x.shape == y.shape == z.shape
                    assert x.tobytes() == y.tobytes() == z.tobytes()
        assert native.CALLS == {"pack_batch": 0, "pack_gather": 12,
                                "bucket_sort_windows": 2}


def test_gather_refuses_mismatched_events(tmp_path):
    ev = _events(6)
    bad = [(p, y[:-1] if i == 1 else y) for i, (p, y) in enumerate(ev)]
    d, lab = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    hdf5.write_event_files(d, str(tmp_path / "ok.h5"), ev)
    hdf5.write_event_files(str(tmp_path / "x.h5"), lab, bad)
    with hdf5.PointCloudDataset(d, lab) as ds:
        ds.pack_batch([0, 2], 512, 4)
        with pytest.raises(ValueError, match="event 1: "):
            ds.pack_batch([0, 1], 512, 4)
        with pytest.raises(ValueError, match="> max_points 8"):
            ds.pack_batch([0, 2], 8, 4)
