"""The port's cross-request top-k batcher
(``flink_ms_tpu_torch/serve/microbatch.py``): batched results equal single
results (and the JAX package's), a bad query fails alone, and streaming
updates reach batched queries.  No test asserts a latency."""

import threading

import numpy as np
import pytest

from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu.serve.topk import DeviceFactorIndex as RefIndex
from flink_ms_tpu_torch.serve.microbatch import (TopKBatcher,
                                                 batching_enabled)
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import ALSTopkHandler, DeviceFactorIndex

WAIT_S = 10


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")


def _fill(table, n_items, k, rng, n_users=8):
    for u in range(n_users):
        table.put(f"{u}-U", ";".join(repr(float(x))
                                     for x in rng.normal(size=k)))
    vecs = rng.normal(size=(n_items, k))
    for i in range(n_items):
        table.put(f"{i}-I", ";".join(repr(float(x)) for x in vecs[i]))
    return vecs


def _ids(res):
    return [i for i, _ in res]


@pytest.mark.parametrize("batch_size", [1, 2, 5, 8, 13])
def test_topk_many_matches_single_queries_and_reference(batch_size):
    rng = np.random.default_rng(batch_size)
    table, ref_table = ModelTable(4), RefTable(4)
    _fill(table, 300, 6, np.random.default_rng(0))
    _fill(ref_table, 300, 6, np.random.default_rng(0))
    index = DeviceFactorIndex(table, "-I", device="cpu")
    ref = RefIndex(ref_table, "-I")
    qs = rng.normal(size=(batch_size, 6)).astype(np.float32)
    batched = index.topk_many(qs, 7)
    assert batched == [index.topk(q, 7) for q in qs]
    for want, got in zip(ref.topk_many(qs, 7), batched):
        assert _ids(want) == _ids(got)
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=1e-6)


def test_concurrent_submitters_coalesce():
    rng = np.random.default_rng(1)
    table = ModelTable(4)
    _fill(table, 150, 5, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    index.topk(np.zeros(5, np.float32), 1)  # build off the clock
    batcher = TopKBatcher(index, max_batch=32, max_wait_us=20_000)
    n_threads = 24
    qs = rng.normal(size=(n_threads, 5)).astype(np.float32)
    expected = [index.topk(q, 4) for q in qs]
    results = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait(timeout=WAIT_S)
        results[i] = batcher.score(qs[i], 4, timeout=WAIT_S)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert batcher.submitted == n_threads
    assert batcher.dispatches < batcher.submitted
    assert batcher.max_batch_seen > 1
    assert results == expected  # bit-equal, scores included


def test_mixed_k_and_bad_width_fail_only_their_own():
    rng = np.random.default_rng(2)
    table = ModelTable(2)
    _fill(table, 60, 4, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    batcher = TopKBatcher(index, max_batch=8, max_wait_us=50_000)
    good_a = batcher.submit(rng.normal(size=4).astype(np.float32), 3)
    good_b = batcher.submit(rng.normal(size=4).astype(np.float32), 5)
    bad = batcher.submit(rng.normal(size=6).astype(np.float32), 3)
    assert len(good_a.wait(timeout=WAIT_S)) == 3
    assert len(good_b.wait(timeout=WAIT_S)) == 5
    with pytest.raises(ValueError, match="index has 4"):
        bad.wait(timeout=WAIT_S)
    batcher.close()
    assert batcher.dispatches == 2  # the two good groups


def test_dirty_updates_visible_to_batched_queries():
    rng = np.random.default_rng(3)
    table = ModelTable(4)
    _fill(table, 80, 6, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    qs = rng.normal(size=(3, 6)).astype(np.float32)
    index.topk_many(qs, 5)  # initial build
    target = qs[1] * 100.0
    table.put("33-I", ";".join(repr(float(x)) for x in target))
    batcher = TopKBatcher(index, max_batch=8, max_wait_us=50_000)
    pending = [batcher.submit(q, 3, allow_inline=False) for q in qs]
    got = [p.wait(timeout=WAIT_S) for p in pending]
    batcher.close()
    assert got[1][0][0] == "33"
    assert got[1][0][1] == pytest.approx(float(qs[1] @ target), rel=1e-5)
    assert index.full_builds == 1 and index.inplace_updates == 1


def test_lone_ivf_query_rides_the_frame_path(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_TIER", "ivf")
    monkeypatch.setenv("TPUMS_ANN_NLIST", "8")
    rng = np.random.default_rng(4)
    table = ModelTable(4)
    _fill(table, 400, 4, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    q = np.ones(4, dtype=np.float32)
    index.topk(q, 3)
    assert index.prefers_frames
    calls = []
    real_many = index.topk_many
    monkeypatch.setattr(
        index, "topk_many",
        lambda *a, **kw: calls.append(1) or real_many(*a, **kw))
    batcher = TopKBatcher(index)
    try:
        res = batcher.submit(q, 3, allow_inline=False).wait(timeout=WAIT_S)
        assert len(res) == 3 and calls == [1]
    finally:
        batcher.close()


def test_inline_single_when_idle_and_closed_batcher_refuses():
    rng = np.random.default_rng(5)
    table = ModelTable(2)
    _fill(table, 30, 4, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    batcher = TopKBatcher(index, max_wait_us=0)
    q = np.ones(4, np.float32)
    first = batcher.score(q, 2, timeout=WAIT_S)  # starts the dispatcher
    assert batcher.score(q, 2, timeout=WAIT_S) == first
    assert batcher.inline_singles == 1
    batcher.close()
    batcher.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(q, 1)


def test_handler_routes_through_the_batcher_unless_switched_off(monkeypatch):
    rng = np.random.default_rng(6)
    table = ModelTable(2)
    _fill(table, 40, 4, rng)
    handler = ALSTopkHandler(table, device="cpu")
    assert batching_enabled() and handler.batching
    batched = handler("1", 3)
    handler.batching = False
    assert handler("1", 3) == batched
    handler.close()
    monkeypatch.setenv("TPUMS_TOPK_BATCH", "0")
    assert ALSTopkHandler(table, device="cpu").batcher is None


def test_batch_knobs_and_registry_series(monkeypatch):
    from flink_ms_tpu_torch.obs import metrics

    monkeypatch.setenv("TPUMS_TOPK_BATCH_MAX", "4")
    monkeypatch.setenv("TPUMS_TOPK_BATCH_WAIT_US", "1000")
    rng = np.random.default_rng(7)
    table = ModelTable(2)
    _fill(table, 40, 4, rng)
    index = DeviceFactorIndex(table, "-I", device="cpu")
    batcher = TopKBatcher(index)
    assert batcher.max_batch == 4 and batcher.max_wait_s == 0.001
    with pytest.raises(ValueError):
        TopKBatcher(index, max_batch=0)
    reg = metrics.get_registry()
    sizes = reg.histogram("tpums_topk_batch_size", bounds=metrics.SIZE_BUCKETS)
    before = sizes.count
    pending = [batcher.submit(q, 2, allow_inline=False)
               for q in rng.normal(size=(6, 4)).astype(np.float32)]
    assert all(len(p.wait(timeout=WAIT_S)) == 2 for p in pending)
    batcher.close()
    assert batcher.max_batch_seen <= 4
    assert sizes.count - before == batcher.dispatches >= 2
    assert all(p.batch_size >= 1 and p.device_s >= 0 for p in pending)
