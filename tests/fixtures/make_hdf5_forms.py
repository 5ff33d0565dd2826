"""Write the HDF5 fixtures under ``tests/fixtures/hdf5/``: data/label
pairs in the reference schema (``data``: flat float32 (x, y, z, e) per
event, ``labels``: int64 per point, both variable-length) in forms that
h5py writes and its default form does not cover, and ``manifest.json``
with each pair's form, event count and the sha256 of every event's
points and labels as h5py reads them back.

The events are ``pcseg_tpu_torch.data.synthetic.synthetic_events`` of 16
to 128 points (seed 26). Regenerate with h5py installed, from the
repository root::

    python tests/fixtures/make_hdf5_forms.py

``tests/test_torch_hdf5.py`` checks that h5py and the JAX package's
``PointCloudDataset`` still read the committed files to the manifest, and
``chip_smoke.py`` (phase 21 (e)) reads them with the port's reader alone,
on a machine without h5py.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import h5py
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(ROOT)))

from pcseg_tpu_torch.data.synthetic import synthetic_events  # noqa: E402

OUT = os.path.join(ROOT, "hdf5")
SEED = 26


def _groups(f, n=10):
    """``n`` empty groups beside the dataset: past 8 links the library
    moves a ``libver="latest"`` group's links into a fractal heap."""
    for k in range(n):
        f.create_group(f"run{k:02d}")


# name: (events, h5py.File keywords, create_dataset keywords, extra,
# what the file holds)
FORMS = {
    "sb3_lzf_shuffle_fixed_array": (
        512, dict(libver="latest"),
        dict(chunks=(4,), compression="lzf", shuffle=True), None,
        "superblock 3, OHDR headers, layout v4 chunked (4 events a chunk, "
        "lzf + shuffle) on a fixed-array index (FAHD/FADB)"),
    "sb3_gzip_extensible_array": (
        256, dict(libver="latest"),
        dict(chunks=(1,), maxshape=(None,), compression="gzip"), None,
        "superblock 3, layout v4 chunked (1 event a chunk, gzip, maxshape "
        "None) on an extensible-array index with a super block (EAHD/EAIB/"
        "EASB/EADB)"),
    "sb2_lzf_btree": (
        64, dict(libver=("v108", "latest")),
        dict(chunks=(8,), compression="lzf"), None,
        "superblock 2, OHDR headers, layout v3 chunked (8 events a chunk, "
        "lzf) on a version-1 B-tree"),
    "sb3_dense_links": (
        64, dict(libver="latest"), {}, _groups,
        "superblock 3, contiguous layout v4, the root group's links in "
        "dense storage (FRHP/FHDB and a version-2 B-tree name index)"),
}


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _write(path, name, arrays, dtype, file_kw, dset_kw, extra):
    vt = h5py.vlen_dtype(dtype)
    arr = np.empty(len(arrays), dtype=vt)
    for i, a in enumerate(arrays):
        arr[i] = np.asarray(a, dtype).reshape(-1)
    with h5py.File(path, "w", **file_kw) as f:
        if extra is not None:
            extra(f)
        d = f.create_dataset(name, (len(arrays),), dtype=vt, **dset_kw)
        d.write_direct(arr)


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    manifest = {"h5py": h5py.__version__,
                "hdf5": h5py.version.hdf5_version, "forms": {}}
    for k, (name, (n, file_kw, dset_kw, extra, what)) in enumerate(
            FORMS.items()):
        events = list(synthetic_events(n, min_points=16, max_points=128,
                                       seed=SEED + k))
        data, labels = f"{name}_xyze.h5", f"{name}_label.h5"
        _write(os.path.join(OUT, data), "data", [p for p, _ in events],
               np.float32, file_kw, dset_kw, extra)
        _write(os.path.join(OUT, labels), "labels", [y for _, y in events],
               np.int64, file_kw, dset_kw, extra)
        # the digests of what h5py reads back
        with h5py.File(os.path.join(OUT, data), "r") as fd, \
                h5py.File(os.path.join(OUT, labels), "r") as fl:
            pts, labs = fd["data"][:], fl["labels"][:]
        manifest["forms"][name] = {
            "form": what, "data": data, "labels": labels, "events": n,
            "points_sha256": [_sha(p.astype(np.float32)) for p in pts],
            "labels_sha256": [_sha(y.astype(np.int64)) for y in labs]}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, separators=(",", ":"))
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, p))
                for p in os.listdir(OUT))
    print(f"{len(FORMS)} pairs and the manifest in {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
