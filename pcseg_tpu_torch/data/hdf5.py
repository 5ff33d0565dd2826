"""HDF5 event files without h5py (counterpart of pcseg_tpu/data/hdf5.py).

Schema (the reference's ``PointCloudDataset``): two files, one holding a
dataset ``data`` of per-event flat float arrays that reshape to ``(N, 4)``
(x, y, z, e), the other a dataset ``labels`` of per-event int arrays
``(N,)``; both 1-D and variable-length.

The port reads and writes these files with its own code in numpy and the
standard library, because h5py is absent where the port runs.

Reader scope: what h5py writes for this schema,
- with default settings: superblock version 0, version-1 object headers
  (continuation messages followed), a symbol-table root group, and the
  dataset in contiguous layout;
- with ``chunks=True, compression="gzip", shuffle=True``: layout version 3
  chunked, its chunks indexed by a version-1 B-tree, with the deflate and
  shuffle filters (a chunk's filter mask honoured).
Each element of a variable-length dataset is a 16-byte reference (u32
element count, u64 global-heap collection address, u32 object index);
the elements themselves live in ``GCOL`` collections. Anything else
(superblock 2/3, ``OHDR`` headers, link-message groups, other layouts,
filters or datatypes) raises ``NotImplementedError`` naming the structure
and its file offset.

Reads go through a read-only memory map, so threads read at once with no
shared file position. The collections' object tables are parsed once, at
open, into each entry's byte offset; ``num_points`` reads the count from
the reference without touching the event, and ``pack_batch`` hands a
batch's offsets to the native packer, which copies the events straight
from the maps into the padded batch (``csrc/collate.cpp``
``pack_gather``), with no per-event work in Python.

Writer scope: the default form only (as ``h5py`` writes it with default
settings), one dataset per file, collections of at most 65,535 objects.
The local heap's empty free list is the value 1, which is what the HDF5
library writes and reads as "no free block" (the format specification's
"undefined address" is refused by it), so the writer keeps h5py's 88-byte
heap with one free block.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Iterable

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
# a variable-length element: (count, collection address, object index)
REF_DTYPE = np.dtype([("n", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
# message types of a version-1 object header
_DATASPACE, _DATATYPE, _FILL, _LAYOUT = 1, 3, 5, 8
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0xB, 0x10, 0x11
_LINK_INFO, _LINK = 0x2, 0x6
_DEFLATE, _SHUFFLE = 1, 2
# the group B-tree's K values h5py writes (leaf K 4: 8 entries a symbol
# node; internal K 16: 32 children a B-tree node)
_LEAF_K, _NODE_K = 4, 16
_GCOL_MIN = 4096          # the HDF5 library's smallest collection
_GCOL_CAP = 4 << 20       # the writer starts a new collection past this
_GCOL_MAX_OBJECTS = 65535  # a u16 object index, 0 being free space


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Unsupported(NotImplementedError):
    def __init__(self, path, what, offset):
        super().__init__(f"{path}: {what} at file offset {offset} is not "
                         "supported (the port reads the forms h5py writes "
                         "by default or chunked with gzip + shuffle)")


class VlenFile:
    """One variable-length 1-D dataset of an HDF5 file, read-only:
    ``len``, ``length(i)`` (elements of entry i, from its reference),
    ``read(i)`` (a new array of the base type), and ``offsets`` (entry
    i's byte offset in the file) with ``address`` (the map's address) for
    native readers."""

    def __init__(self, path: str, name: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            root = self._superblock()
            header = self._lookup(root, name)
            self.refs, self.base = self._dataset(header, name)
            self.offsets = self._entry_offsets()
            self._view = np.frombuffer(self._mm, np.uint8)
        except BaseException:
            self._mm.close()
            raise

    # -- low-level reads

    def _bytes(self, offset: int, n: int) -> bytes:
        if offset < 0 or offset + n > len(self._mm):
            raise ValueError(f"{self.path}: {n} bytes at offset {offset} lie "
                             f"past the end of the file ({len(self._mm)})")
        return self._mm[offset : offset + n]

    def _unpack(self, fmt: str, offset: int):
        return struct.unpack_from(fmt, self._bytes(offset,
                                                   struct.calcsize(fmt)))

    def _superblock(self) -> int:
        if self._bytes(0, 8) != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (no signature "
                             "at offset 0)")
        version, = self._unpack("<B", 8)
        if version != 0:
            raise _Unsupported(self.path, f"superblock version {version}", 0)
        size_off, size_len = self._unpack("<BB", 13)
        if (size_off, size_len) != (8, 8):
            raise _Unsupported(self.path, f"{size_off}-byte offsets and "
                               f"{size_len}-byte lengths", 13)
        base, = self._unpack("<Q", 24)
        if base != 0:
            raise _Unsupported(self.path, f"base address {base}", 24)
        # the root group's symbol-table entry: its object header address
        return self._unpack("<Q", 56 + 8)[0]

    def _messages(self, addr: int):
        """(type, data offset, size, flags) of every message of the
        version-1 object header at ``addr``, continuations followed."""
        if self._bytes(addr, 4) == b"OHDR":
            raise _Unsupported(self.path, "version-2 object header", addr)
        version, _, count, _, size = self._unpack("<BBHII", addr)
        if version != 1:
            raise _Unsupported(self.path,
                               f"object header version {version}", addr)
        out, blocks = [], [(addr + 16, size)]
        while blocks and len(out) < count:
            p, n = blocks.pop(0)
            end = p + n
            while p + 8 <= end and len(out) < count:
                mtype, msize, flags = self._unpack("<HHB", p)
                if mtype == _CONTINUATION:
                    blocks.append(self._unpack("<QQ", p + 8))
                out.append((mtype, p + 8, msize, flags))
                p += 8 + msize
        return out

    def _lookup(self, root: int, name: str) -> int:
        """Object header address of ``name`` in the root group."""
        msgs = self._messages(root)
        for mtype, p, _, _ in msgs:
            if mtype in (_LINK_INFO, _LINK):
                raise _Unsupported(self.path, "link-message group", p)
        table = [p for mtype, p, _, _ in msgs if mtype == _SYMBOL_TABLE]
        if not table:
            raise _Unsupported(self.path, "root group without a symbol "
                               "table", root)
        btree, heap = self._unpack("<QQ", table[0])
        if self._bytes(heap, 4) != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        heap_size, _, heap_data = self._unpack("<QQQ", heap + 8)
        names = self._bytes(heap_data, heap_size)
        for entry in self._group_entries(btree):
            name_off, header = struct.unpack_from("<QQ", entry)
            end = names.index(b"\0", name_off)
            if names[name_off:end].decode() == name:
                return header
        raise KeyError(f"{self.path}: no dataset {name!r} in the root group")

    def _group_entries(self, node: int):
        """Symbol-table entries (40 bytes each) under a group B-tree."""
        sig, ntype, level, used = self._unpack("<4sBBH", node)
        if sig != b"TREE" or ntype != 0:
            raise _Unsupported(self.path, f"group B-tree node {sig!r} type "
                               f"{ntype}", node)
        for i in range(used):
            child, = self._unpack("<Q", node + 24 + 8 + 16 * i)
            if level > 0:
                yield from self._group_entries(child)
                continue
            sig, _, _, nsyms = self._unpack("<4sBBH", child)
            if sig != b"SNOD":
                raise _Unsupported(self.path, f"symbol node {sig!r}", child)
            for k in range(nsyms):
                yield self._bytes(child + 8 + 40 * k, 40)

    def _dtype(self, p: int, nested: bool = False) -> np.dtype:
        """numpy dtype of a datatype message at ``p``: the base type of a
        variable-length sequence (for the outer message, with
        ``nested=False``), or a fixed-point / floating-point base."""
        cv, b0, b1, _, size = self._unpack("<BBBBI", p)
        cls = cv & 0x0F
        if not nested:
            if cls != 9 or (b0 & 0x0F) != 0 or size != 16:
                raise _Unsupported(self.path, f"datatype class {cls} (not "
                                   "a variable-length sequence)", p)
            return self._dtype(p + 8, nested=True)
        order = ">" if b0 & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if b0 & 8 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8):
            return np.dtype(f"{order}f{size}")
        raise _Unsupported(self.path, f"base datatype class {cls} of "
                           f"{size} bytes", p)

    def _dataset(self, header: int, name: str):
        msgs = {}
        for mtype, p, size, flags in self._messages(header):
            if flags & 2 and mtype == _DATATYPE:
                raise _Unsupported(self.path, "shared (committed) datatype", p)
            msgs.setdefault(mtype, (p, size))
        for need in (_DATASPACE, _DATATYPE, _LAYOUT):
            if need not in msgs:
                raise ValueError(f"{self.path}: dataset {name!r} lacks "
                                 f"message type {need}")
        p, _ = msgs[_DATASPACE]
        version, rank, flags = self._unpack("<BBB", p)
        if version not in (1, 2) or rank != 1:
            raise _Unsupported(self.path, f"dataspace version {version} of "
                               f"rank {rank}", p)
        count, = self._unpack("<Q", p + (8 if version == 1 else 4))
        base = self._dtype(msgs[_DATATYPE][0])
        filters = self._filters(msgs[_FILTERS][0]) if _FILTERS in msgs \
            else []
        p, _ = msgs[_LAYOUT]
        version, layout = self._unpack("<BB", p)
        if version != 3 or layout not in (1, 2):
            raise _Unsupported(self.path, f"layout version {version} class "
                               f"{layout}", p)
        raw = np.zeros(count * REF_DTYPE.itemsize, np.uint8)
        if layout == 1:
            addr, = self._unpack("<Q", p + 2)
            if addr != UNDEF and count:
                raw[:] = np.frombuffer(self._bytes(addr, raw.size), np.uint8)
        else:
            ndims, = self._unpack("<B", p + 2)
            addr, = self._unpack("<Q", p + 3)
            dims = self._unpack(f"<{ndims}I", p + 11)
            if ndims != 2 or dims[1] != REF_DTYPE.itemsize:
                raise _Unsupported(self.path, f"chunk dims {dims}", p)
            if addr != UNDEF:
                self._read_chunks(addr, dims[0], filters, raw)
        return raw.view(REF_DTYPE), base

    def _filters(self, p: int):
        version, nfilters = self._unpack("<BB", p)
        if version != 1:
            raise _Unsupported(self.path, f"filter pipeline version "
                               f"{version}", p)
        out, q = [], p + 8
        for _ in range(nfilters):
            fid, name_len, _, nvalues = self._unpack("<HHHH", q)
            if fid not in (_DEFLATE, _SHUFFLE):
                raise _Unsupported(self.path, f"filter {fid}", q)
            out.append(fid)
            q += 8 + _pad8(name_len) + 4 * nvalues + 4 * (nvalues % 2)
        return out

    def _read_chunks(self, node: int, chunk: int, filters, raw) -> None:
        """Fill ``raw`` (the references' bytes) from the chunks under a
        version-1 chunk B-tree node."""
        sig, ntype, level, used = self._unpack("<4sBBH", node)
        if sig != b"TREE" or ntype != 1:
            raise _Unsupported(self.path, f"chunk B-tree node {sig!r} type "
                               f"{ntype}", node)
        key = 8 + 8 * 2             # size, filter mask, 2 offsets
        for i in range(used):
            k = node + 24 + i * (key + 8)
            nbytes, mask, start, _ = self._unpack("<IIQQ", k)
            child, = self._unpack("<Q", k + key)
            if level > 0:
                self._read_chunks(child, chunk, filters, raw)
                continue
            data = self._bytes(child, nbytes)
            for j in reversed(range(len(filters))):
                if mask & (1 << j):
                    continue
                if filters[j] == _DEFLATE:
                    data = zlib.decompress(data)
                else:
                    data = np.frombuffer(data, np.uint8).reshape(
                        REF_DTYPE.itemsize, -1).T.tobytes()
            lo = start * REF_DTYPE.itemsize
            n = min(len(data), raw.size - lo, chunk * REF_DTYPE.itemsize)
            raw[lo : lo + n] = np.frombuffer(data, np.uint8, n)

    def _collection(self, addr: int):
        """(offsets, sizes) by object index of the collection at
        ``addr``."""
        sig, version, size = self._unpack("<4sB3xQ", addr)
        if sig != b"GCOL" or version != 1:
            raise _Unsupported(self.path, f"global heap {sig!r} version "
                               f"{version}", addr)
        blob = self._bytes(addr, size)
        idxs, offs, sizes = [], [], []
        p = 16
        while p + 16 <= size:
            idx, _, n = struct.unpack_from("<HH4xQ", blob, p)
            if idx == 0:        # free space, always last
                break
            if p + 16 + n > size:
                raise ValueError(f"{self.path}: object {idx} of the "
                                 f"collection at {addr} runs past its end")
            idxs.append(idx)
            offs.append(addr + p + 16)
            sizes.append(n)
            p += 16 + _pad8(n)
        table = (np.zeros(max(idxs, default=0) + 1, np.int64),
                 np.full(max(idxs, default=0) + 1, -1, np.int64))
        table[0][idxs] = offs
        table[1][idxs] = sizes
        return table

    def _entry_offsets(self) -> np.ndarray:
        """Each entry's byte offset (0 for an empty one), every collection
        parsed once."""
        out = np.zeros(len(self.refs), np.int64)
        n, addr, idx = (self.refs[k] for k in ("n", "addr", "idx"))
        used = n > 0
        for a in np.unique(addr[used]):
            at = np.flatnonzero(used & (addr == a))
            offs, sizes = self._collection(int(a))
            obj = idx[at].astype(np.int64)
            short = obj >= len(sizes)
            short[~short] = sizes[obj[~short]] < n[at[~short]].astype(
                np.int64) * self.base.itemsize
            if short.any():
                i = int(at[np.flatnonzero(short)[0]])
                raise ValueError(f"{self.path}: entry {i} names object "
                                 f"{int(idx[i])} of the collection at "
                                 f"{int(a)}, which holds fewer than its "
                                 f"{int(n[i])} elements")
            out[at] = offs[obj]
        return out

    # -- the dataset

    def __len__(self) -> int:
        return len(self.refs)

    def length(self, i: int) -> int:
        return int(self.refs["n"][i])

    def read(self, i: int) -> np.ndarray:
        n = int(self.refs["n"][i])
        return np.frombuffer(self._mm, self.base, n,
                             int(self.offsets[i])).copy()

    @property
    def address(self) -> int:
        return self._view.ctypes.data

    def close(self) -> None:
        self._view = None
        self._mm.close()


class PointCloudDataset:
    """Map-style view over the two event files.

    ``ds[idx] -> (points (N, feature_dim) float32, labels (N,) int64)``,
    the JAX class's contract, with ``num_points``, ``close`` and the
    context manager; a ValueError where the files hold different event
    counts, or an event different point and label counts.
    """

    def __init__(self, data_path: str, label_path: str,
                 feature_dim: int = 4):
        self.data_file = VlenFile(data_path, "data")
        try:
            self.label_file = VlenFile(label_path, "labels")
        except BaseException:
            self.data_file.close()
            raise
        self.feature_dim = feature_dim
        self.num_events = len(self.data_file)
        if len(self.label_file) != self.num_events:
            n = len(self.label_file)
            self.close()
            raise ValueError(f"data has {self.num_events} events but labels "
                             f"has {n}")

    def __len__(self) -> int:
        return self.num_events

    def __getitem__(self, idx: int):
        points = self.data_file.read(idx).astype(np.float32, copy=False) \
            .reshape(-1, self.feature_dim)
        labels = self.label_file.read(idx).astype(np.int64, copy=False)
        if labels.shape[0] != points.shape[0]:
            raise ValueError(f"event {idx}: {points.shape[0]} points vs "
                             f"{labels.shape[0]} labels")
        return points, labels

    def num_points(self, idx: int) -> int:
        """Point count from the event's reference, without reading it."""
        return self.data_file.length(idx) // self.feature_dim

    def pack_batch(self, indices, max_points: int, batch_size: int):
        """``pad_events([self[i] for i in indices], max_points,
        batch_size, feature_dim)``, byte for byte, packed by the native
        library straight from the files (float32 and int64 little-endian
        data, the schema; other element types read event by event)."""
        from pcseg_tpu_torch.data import native

        idx = np.asarray(indices, np.int64)
        if self.data_file.base != np.dtype("<f4") or \
                self.label_file.base != np.dtype("<i8"):
            return native.pack_batch([self[int(i)] for i in idx],
                                     max_points, batch_size,
                                     self.feature_dim)
        n_data = self.data_file.refs["n"][idx].astype(np.int64)
        n_labels = self.label_file.refs["n"][idx].astype(np.int64)
        bad = (n_data % self.feature_dim != 0) | \
            (n_data // self.feature_dim != n_labels)
        if bad.any():
            k = int(np.flatnonzero(bad)[0])
            raise ValueError(f"event {int(idx[k])}: {int(n_data[k])} values "
                             f"({self.feature_dim} a point) vs "
                             f"{int(n_labels[k])} labels")
        return native.pack_gather(
            self.data_file, self.label_file, idx, n_labels.astype(np.int32),
            max_points, batch_size, self.feature_dim)

    def close(self) -> None:
        self.data_file.close()
        self.label_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the writer (h5py's default form)

def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype(base: np.dtype) -> bytes:
    """The variable-length sequence of ``base`` (float32 or int64, little
    endian), as h5py encodes it."""
    if base == np.float32:
        inner = struct.pack("<BBBBI", 0x11, 0x20, 31, 0, 4) + struct.pack(
            "<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
    elif base == np.int64:
        inner = struct.pack("<BBBBI", 0x10, 0x08, 0, 0, 8) + struct.pack(
            "<HH", 0, 64)
    else:
        raise ValueError(f"the writer takes float32 or int64, not {base}")
    return struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + inner


def _write_vlen_file(path: str, name: str, arrays: list[np.ndarray],
                     base: np.dtype) -> None:
    """One file holding ``name``, a 1-D variable-length dataset of
    ``base`` with one entry per array."""
    count = len(arrays)
    names = b"\0" * 8 + name.encode() + b"\0"
    names += b"\0" * (_pad8(len(names)) - len(names))
    heap_size = max(88, len(names) + 16)
    # metadata, at fixed offsets: superblock, root header, group B-tree,
    # local heap, dataset header, symbol node
    root_at, btree_at = 96, 136
    btree_size = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
    heap_at = btree_at + btree_size
    heap_data_at = heap_at + 32
    dset_at = heap_data_at + heap_size
    fill = bytes([2, 2, 0, 1, 0, 0, 0, 0])

    def dataset_header(refs_at):
        return _object_header([
            _message(_DATASPACE, struct.pack("<BBBB4xQQ", 1, 1, 1, 0, count,
                                             count)),
            _message(_DATATYPE, _datatype(base), flags=1),
            _message(_FILL, fill, flags=1),
            _message(_LAYOUT, struct.pack(
                "<BBQQ", 3, 1, refs_at if count else UNDEF,
                count * REF_DTYPE.itemsize)),
        ])

    snod_at = dset_at + len(dataset_header(0))
    gcol_at = snod_at + 8 + 2 * _LEAF_K * 40
    refs = np.zeros(count, REF_DTYPE)
    with open(path, "wb") as f:
        f.seek(gcol_at)
        pos, i = gcol_at, 0
        while i < count:
            # one collection: up to 65,535 objects, closed past _GCOL_CAP
            parts, used, j = [], 16, i
            while j < count and j - i < _GCOL_MAX_OBJECTS:
                a = np.ascontiguousarray(arrays[j], base.newbyteorder("<"))
                n = _pad8(a.nbytes)
                if j > i and used + 16 + n > _GCOL_CAP:
                    break
                if a.size:
                    idx = j - i + 1
                    refs[j] = (a.size, pos, idx)
                    parts += [struct.pack("<HH4xQ", idx, 0, a.nbytes),
                              a.tobytes(), b"\0" * (n - a.nbytes)]
                    used += 16 + n
                j += 1
            size = max(_GCOL_MIN, used)
            if 0 < size - used < 16:
                size = used + 16
            f.write(struct.pack("<4sB3xQ", b"GCOL", 1, size))
            f.writelines(parts)
            if size > used:
                f.write(struct.pack("<HH4xQ", 0, 0, size - used))
                f.write(b"\0" * (size - used - 16))
            pos += size
            i = j
        refs_at = pos
        f.write(refs.tobytes())
        eof = f.tell()

        f.seek(0)
        f.write(SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0, 0, UNDEF,
            eof, UNDEF))
        f.write(struct.pack("<QQII2Q", 0, root_at, 1, 0, btree_at, heap_at))
        f.write(_object_header([_message(_SYMBOL_TABLE, struct.pack(
            "<QQ", btree_at, heap_at))]))
        node = struct.pack("<4sBBHQQ", b"TREE", 0, 0, 1, UNDEF, UNDEF) + \
            struct.pack("<QQQ", 0, snod_at, 8)
        f.write(node + b"\0" * (btree_size - len(node)))
        # the local heap: the names, then one free block (next 1 = none)
        f.write(struct.pack("<4sB3xQQQ", b"HEAP", 0, heap_size, len(names),
                            heap_data_at))
        f.write(names + struct.pack("<QQ", 1, heap_size - len(names)))
        f.write(b"\0" * (heap_size - len(names) - 16))
        f.write(dataset_header(refs_at))
        entry = struct.pack("<QQII16x", 8, dset_at, 0, 0)
        f.write(struct.pack("<4sBBH", b"SNOD", 1, 0, 1) + entry
                + b"\0" * (40 * (2 * _LEAF_K - 1)))


def write_event_files(data_path: str, label_path: str,
                      events: Iterable[tuple[np.ndarray, np.ndarray]]) -> int:
    """Write ragged events in the reference schema (flat float32 ``data``,
    int64 ``labels``, both variable-length). Returns the event count."""
    os.makedirs(os.path.dirname(os.path.abspath(data_path)), exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(label_path)), exist_ok=True)
    events = list(events)
    _write_vlen_file(data_path, "data",
                     [np.asarray(p, np.float32).reshape(-1)
                      for p, _ in events], np.dtype(np.float32))
    _write_vlen_file(label_path, "labels",
                     [np.asarray(lab, np.int64).reshape(-1)
                      for _, lab in events], np.dtype(np.int64))
    return len(events)
