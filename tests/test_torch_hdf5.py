"""The port's HDF5 event files (``pcseg_tpu_torch/data/hdf5.py``) against
h5py and the JAX package's ``PointCloudDataset``: files written by the
JAX ``write_event_files`` (h5py's default form), by h5py chunked with
gzip + shuffle, and a file of 70,000 one-point events (h5py spreads it
over many global-heap collections, the port's writer over two: a
collection holds at most 65,535 objects) read equal, event by event; so
does every other form h5py writes for the schema (superblocks 0, 2 and 3,
``OHDR`` headers with continuation blocks, compact and dense link groups,
compact, contiguous and chunked layouts on each chunk index, gzip /
shuffle / lzf, unallocated chunks), and the committed fixtures under
``tests/fixtures/hdf5/`` to their manifest; the port's files read back
equal by h5py and by the JAX class; what stays outside the reader's scope
raises; the port's BucketBatcher over the port's dataset yields the JAX
batcher's batches bit for bit."""

import hashlib
import json
import os
import re
import shutil
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


def _h5py_write(path, name, arrays, dtype, libver=None, extra=None,
                written=None, **kw):
    """One vlen dataset written by h5py in one call (``kw``: chunking,
    filters, ``dcpl``; ``libver``: the file's; ``extra(f, d)``: more
    objects; ``written``: (start, stop) ranges, the only ones written)."""
    vt = h5py.vlen_dtype(dtype)
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset(name, (len(arrays),), dtype=vt, **kw)
        arr = np.empty(len(arrays), dtype=vt)
        for i, a in enumerate(arrays):
            arr[i] = np.asarray(a, dtype).reshape(-1)
        if written is None:
            d.write_direct(arr)
        for lo, hi in written or ():
            d[lo:hi] = arr[lo:hi]
        if extra is not None:
            extra(f, d)


CHUNKED = dict(chunks=True, compression="gzip", shuffle=True)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "hdf5")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{form: (data path, label path, events)} written by h5py."""
    root = tmp_path_factory.mktemp("h5")
    out = {}
    ev = _events()
    jax_hdf5.write_event_files(str(root / "d.h5"), str(root / "l.h5"), ev)
    out["jax_default"] = (str(root / "d.h5"), str(root / "l.h5"), ev)
    for form, kw, events in (
            ("chunked_gzip_shuffle", CHUNKED, ev),
            ("chunked_small", dict(CHUNKED, chunks=(5,)), ev),
            ("many_collections", {}, _many_events()),
            # one form of each newer superblock
            ("sb2_lzf_btree", dict(chunks=(3,), compression="lzf",
                                   libver=("v108", "latest")), ev),
            ("sb3_lzf_shuffle_extensible", dict(
                chunks=(2,), maxshape=(None,), compression="lzf",
                shuffle=True, libver="latest"), ev)):
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


def _dcpl(layout=None, chunk=None):
    """A dataset creation list: compact layout, or chunks allocated at
    creation (the implicit chunk index of a fixed-size dataset)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout is not None:
        dcpl.set_layout(layout)
    if chunk is not None:
        dcpl.set_chunk((chunk,))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _groups(n, long=False):
    """``n`` empty groups beside the dataset (past 8 links a new-style
    group keeps its links in a fractal heap; a few hundred long names
    take an indirect block and a two-level name index)."""
    def extra(f, d):
        for k in range(n):
            f.create_group(f"{'run_with_a_long_group_name_' if long else 'g'}"
                           f"{k:05d}")
    return extra


def _attrs(f, d):
    """Attributes enough to overflow the dataset header's first block."""
    for k in range(6):
        d.attrs[f"calibration_{k}"] = np.arange(60)


LATEST, V108 = dict(libver="latest"), dict(libver=("v108", "latest"))
LZF = dict(compression="lzf")
# id: (events, h5py keywords, signatures the files must hold)
FORMS = {
    "sb0_compact": (40, dict(dcpl=_dcpl(layout=h5py.h5d.COMPACT)), ()),
    "sb0_gzip": (40, dict(chunks=(4,), compression="gzip"), (b"TREE",)),
    "sb0_lzf": (40, dict(chunks=(4,), **LZF), (b"TREE",)),
    "sb0_lzf_shuffle": (40, dict(chunks=(4,), shuffle=True, **LZF),
                        (b"TREE",)),
    "sb0_lzf_raw_chunks": (40, dict(chunks=(1,), **LZF), (b"TREE",)),
    "sb0_link_messages": (40, dict(extra=lambda f, d: f.__setitem__(
        "elsewhere", h5py.ExternalLink("other.h5", "/data"))), ()),
    "sb2_contiguous": (40, V108, (b"OHDR",)),
    "sb2_compact": (40, dict(dcpl=_dcpl(layout=h5py.h5d.COMPACT), **V108),
                    (b"OHDR",)),
    "sb2_lzf_btree": (40, dict(chunks=(4,), **LZF, **V108),
                      (b"OHDR", b"TREE")),
    "sb2_dense_links": (40, dict(extra=_groups(12), **V108),
                        (b"FRHP", b"FHDB", b"BTHD", b"BTLF")),
    "sb2_continuation": (40, dict(chunks=(4,), extra=_attrs, **LZF, **V108),
                         (b"OCHK",)),
    "sb3_contiguous": (40, LATEST, (b"OHDR",)),
    "sb3_compact": (40, dict(dcpl=_dcpl(layout=h5py.h5d.COMPACT), **LATEST),
                    (b"OHDR",)),
    "sb3_single_chunk": (40, dict(chunks=(40,), **LATEST), (b"OHDR",)),
    "sb3_single_chunk_gzip": (40, dict(chunks=(40,), compression="gzip",
                                       **LATEST), (b"OHDR",)),
    "sb3_implicit": (40, dict(dcpl=_dcpl(chunk=4), **LATEST), (b"OHDR",)),
    "sb3_fixed_array_gzip_shuffle": (40, dict(
        chunks=(4,), compression="gzip", shuffle=True, **LATEST),
        (b"FAHD", b"FADB")),
    "sb3_fixed_array_paged_lzf_raw": (1100, dict(chunks=(1,), **LZF,
                                                 **LATEST),
                                      (b"FAHD", b"FADB")),
    "sb3_extensible_array_lzf_shuffle": (260, dict(
        chunks=(1,), maxshape=(None,), shuffle=True, **LZF, **LATEST),
        (b"EAHD", b"EAIB", b"EASB", b"EADB")),
    "sb3_dense_links": (40, dict(extra=_groups(12), **LATEST),
                        (b"FRHP", b"FHDB", b"BTHD", b"BTLF")),
    "sb3_dense_links_indirect": (40, dict(extra=_groups(300, long=True),
                                          **LATEST),
                                 (b"FHIB", b"BTIN")),
    "sb3_continuation": (40, dict(chunks=(4,), extra=_attrs, **LZF,
                                  **LATEST), (b"OCHK",)),
    "sb3_partial_fixed_array": (40, dict(chunks=(4,), written=[
        (0, 5), (17, 19), (38, 40)], **LATEST), (b"FADB",)),
    "sb3_partial_extensible_array": (600, dict(
        chunks=(2,), maxshape=(None,), compression="gzip",
        written=[(0, 3), (100, 130), (590, 600)], **LATEST),
        (b"EASB", b"EADB")),
    "sb3_partial_paged": (2100, dict(chunks=(1,), written=[(5, 9),
                                                           (1500, 1540)],
                                     **LATEST), (b"FADB",)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_reads_every_h5py_form_as_jax_does(tmp_path, form):
    """Each form's pair, written by h5py, read equal event by event to
    h5py's read and the JAX class's (unwritten events: empty)."""
    n, kw, sigs = FORMS[form]
    events = _events(n, max_points=40)
    d, lab = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    _h5py_write(d, "data", [p for p, _ in events], np.float32, **kw)
    _h5py_write(lab, "labels", [y for _, y in events], np.int64, **kw)
    version = 2 if "v108" in str(kw.get("libver")) else \
        3 if kw.get("libver") else 0
    for path in (d, lab):
        raw = open(path, "rb").read()
        assert raw[8] == version
        assert all(sig in raw for sig in sigs), form
    with h5py.File(d, "r") as fd, h5py.File(lab, "r") as fl:
        want = list(zip(fd["data"][:], fl["labels"][:]))
        if "raw_chunks" in form:        # lzf left some chunks raw
            info = [fd["data"].id.get_chunk_info(i) for i in range(8)]
            assert {i.filter_mask for i in info} == {0, 1}
    if "written" in kw:
        assert any(p.size == 0 for p, _ in want[5:])
        assert not all(p.size == 0 for p, _ in want[5:])
    else:
        assert all(w.tobytes() == e[0].tobytes() for w, e in zip(
            (p for p, _ in want), events))
    with hdf5.PointCloudDataset(d, lab) as ds, \
            jax_hdf5.PointCloudDataset(d, lab) as ref:
        assert len(ds) == len(ref) == n
        for i, (p, y) in enumerate(want):
            got_p, got_y = ds[i]
            ref_p, ref_y = ref[i]
            assert got_p.dtype == np.float32 and got_y.dtype == np.int64
            assert got_p.tobytes() == ref_p.tobytes() == p.tobytes(), i
            assert got_y.tobytes() == ref_y.tobytes() == y.tobytes(), i
            assert ds.num_points(i) == ref.num_points(i) == len(y)


def _digests(ds, i):
    p, y = ds[i]
    return (hashlib.sha256(np.asarray(p, np.float32).tobytes()).hexdigest(),
            hashlib.sha256(np.asarray(y, np.int64).tobytes()).hexdigest())


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("form", sorted(_manifest()["forms"]))
def test_fixtures_match_manifest(form):
    """The committed fixtures (tests/fixtures/make_hdf5_forms.py) still
    read to their manifest through h5py, the JAX class and the port."""
    entry = _manifest()["forms"][form]
    d, lab = (os.path.join(FIXTURES, entry[k]) for k in ("data", "labels"))
    want = list(zip(entry["points_sha256"], entry["labels_sha256"]))
    assert len(want) == entry["events"]
    with h5py.File(d, "r") as fd, h5py.File(lab, "r") as fl:
        got = [(hashlib.sha256(p.tobytes()).hexdigest(),
                hashlib.sha256(y.tobytes()).hexdigest())
               for p, y in zip(fd["data"][:], fl["labels"][:])]
    assert got == want
    with hdf5.PointCloudDataset(d, lab) as ds, \
            jax_hdf5.PointCloudDataset(d, lab) as ref:
        assert [_digests(ref, i) for i in range(len(ref))] == want
        assert [_digests(ds, i) for i in range(len(ds))] == want


def test_unsupported_forms_raise(tmp_path):
    """What stays outside the reader's scope raises, naming it: a
    non-vlen datatype, a missing dataset, a file that is not HDF5, a
    version-2 object header that fails its checksum (ValueError), a soft
    link (in a symbol-table group and in a link-message one), the
    Fletcher-32 filter's id and an unknown one."""
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

    vt = h5py.vlen_dtype(np.float32)
    events = [p for p, _ in _events(8)]
    good = str(tmp_path / "latest.h5")
    _h5py_write(good, "data", events, np.float32, libver="latest")
    v = hdf5.VlenFile(good, "data")
    header = v._lookup(v._superblock(), "data")
    _, at, _, _ = v._messages(header)[0]
    v.close()
    bad = str(tmp_path / "bad_checksum.h5")
    raw = bytearray(open(good, "rb").read())
    raw[at + 2] ^= 0x01             # a byte of the dataspace's dims
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match=f"object header at file offset "
                                         f"{header} fails its checksum"):
        hdf5.VlenFile(bad, "data")

    for libver in (None, "latest"):
        path = str(tmp_path / f"soft_{libver}.h5")
        with h5py.File(path, "w", libver=libver) as f:
            f.create_dataset("data", (2,), dtype=vt)
            f["labels"] = h5py.SoftLink("/data")
        assert hdf5.VlenFile(path, "data").refs.size == 2
        with pytest.raises(NotImplementedError, match="soft link 'labels' "
                                                      "at file offset"):
            hdf5.VlenFile(path, "labels")

    # lzf's id patched, in a version-1 header, to Fletcher-32's (which
    # the library refuses on a vlen dataset) and to one no reader knows
    path = str(tmp_path / "lzf.h5")
    _h5py_write(path, "data", events, np.float32, chunks=(4,), **LZF)
    raw = bytearray(open(path, "rb").read())
    k = raw.index(b"lzf\0") - 8
    assert raw[k : k + 2] == (32000).to_bytes(2, "little")
    for fid in (3, 32099):
        raw[k : k + 2] = fid.to_bytes(2, "little")
        path = str(tmp_path / f"filter_{fid}.h5")
        open(path, "wb").write(bytes(raw))
        with pytest.raises(NotImplementedError, match=f"filter {fid} at "
                                                      "file offset"):
            hdf5.VlenFile(path, "data")


@pytest.mark.parametrize("swmr", [False, True], ids=["writer", "swmr"])
def test_file_open_for_writing_refused(tmp_path, swmr):
    """A superblock-3 file copied while a writer holds it open carries the
    write-access flags (and the SWMR one under SWMR): refused, naming
    them, as the HDF5 library refuses it; the closed file reads."""
    path, copy = str(tmp_path / "open.h5"), str(tmp_path / "copy.h5")
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("data", (3,), dtype=h5py.vlen_dtype(np.int64),
                             chunks=(1,), maxshape=(None,))
        if swmr:
            f.swmr_mode = True
        d[0] = np.arange(3)
        f.flush()
        shutil.copy(path, copy)
    assert hdf5.VlenFile(path, "data").read(0).tolist() == [0, 1, 2]
    flags = "0x05 (SWMR write access)" if swmr else "0x01 (write access)"
    with pytest.raises(ValueError, match=re.escape(f"consistency flags "
                                                  f"{flags}")):
        hdf5.VlenFile(copy, "data")


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
                                  "many_collections", "sb2_lzf_btree",
                                  "sb3_lzf_shuffle_extensible"])
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
