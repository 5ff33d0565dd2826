"""``data/prefetch.py`` (the JAX ``Prefetcher``'s contract: everything in
order, a new pass per ``__iter__``, the producer's error at the consumer;
and ``close()``, which the training loop calls so that an early stop or
an error leaves no thread holding batches), and ``api.fit`` on HDF5
files: the same history and weights bit for bit as ``api.fit`` on the
same events in memory, with ``data.prefetch_depth`` 0 and 2."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint
from pcseg_tpu_torch.data.batching import BucketBatcher
from pcseg_tpu_torch.data.hdf5 import PointCloudDataset, write_event_files
from pcseg_tpu_torch.data.prefetch import (
    DevicePlace,
    Prefetcher,
    device_batch,
    prefetch,
)
from pcseg_tpu_torch.data.synthetic import synthetic_events
from pcseg_tpu_torch.train import loop

torch.set_num_threads(1)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "pcseg-prefetch" and t.is_alive()]


def _wait_no_threads(timeout=10.0):
    end = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < end:
        time.sleep(0.01)
    return not _prefetch_threads()


def test_yields_everything_in_order_and_reiterates():
    items = list(range(37))
    p = prefetch(items, depth=3)
    assert list(p) == items
    assert list(p) == items          # a second pass
    assert list(prefetch(items, depth=0)) == items    # depth 1 at least
    placed = list(Prefetcher(items, 2, place=lambda x: x * 2))
    assert placed == [2 * x for x in items]
    assert _wait_no_threads()


def test_producer_error_reaches_the_consumer():
    def gen():
        yield 1
        yield 2
        raise KeyError("event 3")

    got = []
    with pytest.raises(KeyError, match="event 3"):
        for x in prefetch(gen(), 2):
            got.append(x)
    assert got == [1, 2]
    assert _wait_no_threads()


def test_close_frees_a_blocked_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield np.zeros(1000, np.float32) + i
            i += 1

    p = prefetch(endless(), 2)
    it = iter(p)
    assert next(it)[0] == 0
    time.sleep(0.1)                  # the producer fills the queue, blocks
    assert len(_prefetch_threads()) == 1
    assert len(produced) <= 4
    p.close()
    assert not _prefetch_threads()
    # leaving a pass early does the same for that pass
    for x in prefetch(range(100), 2):
        break
    assert _wait_no_threads()


def test_device_place_on_the_cpu():
    batch = (np.arange(6, dtype=np.float32).reshape(2, 3),
             np.ones((2, 3), np.int64), np.ones((2, 3), bool))
    place = DevicePlace(torch.device("cpu"))
    assert place.stream is None
    got = device_batch(place(batch), torch.device("cpu"))
    inline = device_batch(batch, torch.device("cpu"))
    for g, i, b in zip(got, inline, batch):
        assert g.device.type == "cpu" and torch.equal(g, i)
        assert np.shares_memory(g.numpy(), b)


def test_threads_share_one_dataset(tmp_path):
    """Sixteen prefetch passes over one HDF5 dataset at once, with a short
    switch interval: every batch equal to the inline batcher's."""
    events = list(synthetic_events(40, min_points=5, max_points=120, seed=2))
    d, lab = str(tmp_path / "d.h5"), str(tmp_path / "l.h5")
    write_event_files(d, lab, events)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with PointCloudDataset(d, lab) as ds:
            want = [tuple(a.tobytes() for a in b)
                    for b in BucketBatcher(ds, 4, buckets=(128,))]
            results = [None] * 16

            def consume(k):
                results[k] = [tuple(a.tobytes() for a in b) for b in
                              prefetch(BucketBatcher(ds, 4, buckets=(128,)),
                                       2)]

            threads = [threading.Thread(target=consume, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(r == want for r in results)
    assert _wait_no_threads()


FIT = ["data.batch_size=4", "data.buckets=128", "train.num_epochs=2",
       "train.log_every_steps=0", "model.compute_dtype=float32"]
_TIMES = ("train_seconds", "seconds")


def _fit(tmp_path, tag, depth, events=None, files=None):
    res = api.fit(events, data_path=files and files[0],
                  label_path=files and files[1], device="cpu",
                  log=lambda *a: None,
                  overrides=FIT + [f"data.prefetch_depth={depth}",
                                   f"train.checkpoint_dir={tmp_path / tag}"])
    hist = [{k: v for k, v in h.items() if k not in _TIMES}
            for h in res.history]
    sd, _, _ = load_checkpoint(res.checkpoint_path)
    return hist, sd


def test_fit_from_files_equals_fit_from_memory(tmp_path):
    events = list(synthetic_events(20, min_points=20, max_points=120,
                                   seed=6))
    files = (str(tmp_path / "d.h5"), str(tmp_path / "l.h5"))
    write_event_files(*files, events)
    ref_hist, ref_sd = _fit(tmp_path, "mem0", 0, events=events)
    assert len(ref_hist) == 2
    for tag, depth, kw in (("file0", 0, dict(files=files)),
                           ("file2", 2, dict(files=files)),
                           ("mem2", 2, dict(events=events))):
        hist, sd = _fit(tmp_path, tag, depth, **kw)
        assert hist == ref_hist, tag
        assert sd.keys() == ref_sd.keys()
        for k in sd:
            assert torch.equal(sd[k], ref_sd[k]), (tag, k)
    assert _wait_no_threads()


def test_loop_closes_its_prefetchers_on_an_error(tmp_path, monkeypatch):
    """An exception in the step leaves no prefetch thread behind."""
    events = list(synthetic_events(24, min_points=20, max_points=120,
                                   seed=8))
    calls = []

    def failing_step(state, batch, *a, **kw):
        calls.append(1)
        raise FloatingPointError("loss is nan")

    monkeypatch.setattr(loop, "train_step", failing_step)
    with pytest.raises(FloatingPointError, match="epoch 0, step 0"):
        api.fit(events, device="cpu", log=lambda *a: None,
                overrides=FIT + ["data.prefetch_depth=2",
                                 f"train.checkpoint_dir={tmp_path}"])
    assert calls == [1]
    assert _wait_no_threads()
