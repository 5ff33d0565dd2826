"""The port's native host packer (``csrc/collate.cpp`` via
``data/native.py``): ``pad_events`` and the epoch plan's window sort
byte-identical to the JAX package's (its native library and its numpy
forms) and to the port's own numpy forms (``use_native=False``); the
call counts; a failed build raises with the compiler's output instead of
falling back to numpy."""

import numpy as np
import pytest
import torch

from pcseg_tpu.data import batching as jax_batching
from pcseg_tpu_torch.data import native
from pcseg_tpu_torch.data.batching import BucketBatcher, pad_events
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.ops import _build

torch.set_num_threads(1)


def _events(n, seed, lo=1, hi=500, d=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        out.append((rng.normal(size=(k, d)).astype(np.float32),
                    rng.integers(0, 5, size=k).astype(np.int64)))
    return out


@pytest.mark.parametrize("n, bucket, batch, d", [
    (6, 512, 8, 4), (8, 512, 8, 4), (3, 500, 3, 4), (5, 512, 7, 20),
    (0, 64, 2, 4)], ids=["padded_rows", "full", "exact_fit", "dim20",
                         "no_events"])
def test_pad_events_byte_identical(n, bucket, batch, d):
    events = _events(n, seed=n + d, hi=bucket, d=d)
    native.reset_calls()
    got = pad_events(events, bucket, batch_size=batch, feature_dim=d)
    assert native.CALLS["pack_batch"] == 1
    plain = pad_events(events, bucket, batch_size=batch, feature_dim=d,
                       use_native=False)
    assert native.CALLS["pack_batch"] == 1
    for want in (jax_batching.pad_events(events, bucket, batch_size=batch,
                                         feature_dim=d, use_native=True),
                 jax_batching.pad_events(events, bucket, batch_size=batch,
                                         feature_dim=d, use_native=False),
                 plain):
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def test_pad_events_refuses_what_does_not_fit():
    events = _events(3, 1, lo=100, hi=100)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="> max_points 64"):
            pad_events(events, 64, use_native=use_native)
    with pytest.raises(ValueError, match="3 events > batch_size 2"):
        pad_events(events, 128, batch_size=2)
    with pytest.raises(ValueError, match="do not match"):
        pad_events([(events[0][0], events[0][1][:-1])], 128)


@pytest.mark.parametrize("n, window", [(300, 64), (257, 256), (50, 7),
                                       (40, 100)])
def test_window_sort_byte_identical(n, window):
    rng = np.random.default_rng(n)
    lengths = rng.integers(1, 30, size=n + 5).astype(np.int32)  # ties
    order = rng.permutation(n + 5)[:n].astype(np.int64)
    native.reset_calls()
    got = native.window_sort(order, lengths, window)
    assert native.CALLS["bucket_sort_windows"] == 1
    want = jax_batching.BucketBatcher._window_sort(order.copy(), lengths,
                                                   window)
    plain = np.concatenate([
        w[np.argsort(lengths[w], kind="stable")]
        for w in (order[s : s + window] for s in range(0, n, window))])
    assert got.dtype == want.dtype == np.int64
    assert got.tobytes() == want.tobytes() == plain.tobytes()
    assert order.tobytes() != got.tobytes()     # a copy, sorted
    with pytest.raises(ValueError, match="outside lengths"):
        native.window_sort(order, lengths[:3], window)


def test_batcher_native_and_numpy_give_the_same_epochs():
    events = list(synthetic_events(70, min_points=10, max_points=400,
                                   seed=4))

    class Events:
        def __len__(self):
            return len(events)

        def __getitem__(self, i):
            return events[i]

    kw = dict(buckets=(128, 256, 512), shuffle=True, seed=9)
    fast = BucketBatcher(Events(), 4, **kw)
    plain = BucketBatcher(Events(), 4, use_native=False, **kw)
    jax = jax_batching.BucketBatcher(Events(), 4, **kw)
    native.reset_calls()
    for _ in range(2):
        got, want, ref = list(fast), list(plain), list(jax)
        assert len(got) == len(want) == len(ref) == 18
        for a, b, c in zip(got, want, ref):
            for x, y, z in zip(a, b, c):
                assert x.tobytes() == y.tobytes() == z.tobytes()
    assert native.CALLS == {"pack_batch": 36, "pack_gather": 0,
                            "bucket_sort_windows": 2}


def test_library_lands_in_the_build_dir():
    path = _build.build_host("collate")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libcollate-") and path.suffix == ".so"
    assert native.load().pack_gather is not None


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "collate.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "_CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for .*collate"
                                           "(.|\\n)*error"):
        _build.build_host("collate")
    assert not list((tmp_path / "build").glob("*.so"))
