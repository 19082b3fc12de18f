"""The port's top-k index (``flink_ms_tpu_torch/serve/topk.py``) against the
JAX package's ``DeviceFactorIndex`` on the CPU, on the same table rows.

Factors made of small multiples of 1/8 give dot products that are exact in
float32, so both packages compute the same scores bit for bit and ties are
real; random factors are held by ids (their score gaps exceed the
round-off of either backend's sums) and by scores at rtol 1e-6."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu.serve.topk import DeviceFactorIndex as RefIndex
from flink_ms_tpu_torch.serve import topk as topk_mod
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import (DeviceFactorIndex,
                                           make_als_topk_handler,
                                           topk_lowest_first)

WAIT_S = 10  # every wait on a rebuild thread is bounded


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    # the suite's 8 virtual JAX devices must not shard the reference
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")


def _payload(vec) -> str:
    return ";".join(repr(float(x)) for x in vec)


def _tables(rows, n_users=0, user_rows=None):
    """A reference table and a port table holding the same item rows."""
    ref, port = RefTable(4), ModelTable(4)
    for t in (ref, port):
        for i, vec in enumerate(rows):
            t.put(f"{i}-I", _payload(vec))
        for u in range(n_users):
            t.put(f"{u}-U", _payload(user_rows[u]))
    return ref, port


def _indexes(rows):
    ref, port = _tables(rows)
    return RefIndex(ref, "-I"), DeviceFactorIndex(port, "-I", device="cpu")


def _grid(rng, shape, lo=-16, hi=16):
    """Small multiples of 1/8: their dot products are exact in float32."""
    return rng.integers(lo, hi, size=shape) / 8.0


def _ids(res):
    return [i for i, _ in res]


def _assert_close(ref, got):
    assert _ids(ref) == _ids(got)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               rtol=1e-6)


# -- the tie rule -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_topk_lowest_first_is_lax_top_k(seed):
    """Values and indices equal ``lax.top_k``'s bit for bit on rows full of
    ties, signed zeros included, for every k from 0 to n."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        b, n = int(rng.integers(1, 5)), int(rng.integers(1, 70))
        x = rng.integers(-3, 4, size=(b, n)).astype(np.float32)
        x[rng.random((b, n)) < 0.15] = -0.0
        for k in sorted({0, n, int(rng.integers(0, n + 1))}):
            ws, wi = jax.lax.top_k(x, k)
            gs, gi = topk_lowest_first(torch.from_numpy(x.copy()), k)
            assert np.array_equal(np.asarray(wi), gi.numpy())
            assert np.array_equal(np.asarray(ws).view(np.int32),
                                  gs.numpy().view(np.int32))


def test_topk_lowest_first_straddling_tie_takes_lowest_rows():
    # five rows tie at the 3rd value; lax takes rows 1 and 2 of them
    x = np.array([[5.0, 2.0, 2.0, 2.0, 9.0, 2.0, 2.0, 1.0]], np.float32)
    s, i = topk_lowest_first(torch.from_numpy(x.copy()), 3)
    assert i.tolist() == [[4, 0, 1]] and s.tolist() == [[9.0, 5.0, 2.0]]
    s, i = topk_lowest_first(torch.from_numpy(x.copy()), 4)
    assert i.tolist() == [[4, 0, 1, 2]]


@pytest.mark.parametrize("k", [1, 3, 7, 12, 40])
def test_ties_at_the_kth_place_match_the_reference(k):
    """Duplicated item rows tie exactly; both packages must pick the same
    rows, in the same order, with the same reply bytes."""
    rng = np.random.default_rng(k)
    base = _grid(rng, (6, 5))
    rows = base[rng.integers(0, 6, size=40)]  # 40 rows, 6 distinct
    ref, port = _indexes(rows)
    for q in _grid(rng, (8, 5)):
        want, got = ref.topk(q, k), port.topk(q, k)
        assert want == got
    qs = _grid(rng, (8, 5)).astype(np.float32)
    assert ref.topk_many(qs, k) == port.topk_many(qs, k)


# -- exact tier parity ------------------------------------------------------


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 25), (3, 300)])
def test_topk_matches_reference_on_random_factors(seed, k):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(300, 6))
    ref, port = _indexes(rows)
    for q in rng.normal(size=(5, 6)):
        _assert_close(ref.topk(q, k), port.topk(q, k))


@pytest.mark.parametrize("b", [1, 3, 8])
def test_topk_many_matches_reference(b):
    rng = np.random.default_rng(b)
    rows = rng.normal(size=(250, 7))
    ref, port = _indexes(rows)
    qs = rng.normal(size=(b, 7)).astype(np.float32)
    for want, got in zip(ref.topk_many(qs, 9), port.topk_many(qs, 9)):
        _assert_close(want, got)
    # exact factors: the replies are equal byte for byte
    rows = _grid(rng, (250, 7))
    ref, port = _indexes(rows)
    qs = _grid(rng, (b, 7)).astype(np.float32)
    assert ref.topk_many(qs, 9) == port.topk_many(qs, 9)


def test_batched_rows_equal_single_queries():
    """Every query is scored by a product of at least eight rows, so a row
    of a batch is bit-equal to the query asked alone."""
    rng = np.random.default_rng(5)
    _, port = _indexes(rng.normal(size=(400, 9)))
    for b in (1, 2, 5, 8, 13, 32):
        qs = rng.normal(size=(b, 9)).astype(np.float32)
        assert port.topk_many(qs, 11) == [port.topk(q, 11) for q in qs]


def test_k_larger_than_catalog_returns_every_row():
    rng = np.random.default_rng(3)
    rows = _grid(rng, (12, 4))
    ref, port = _indexes(rows)
    q = _grid(rng, (4,))
    got = port.topk(q, 50)
    assert len(got) == 12 and got == ref.topk(q, 50)
    assert port.topk_many(q[None], 50) == ref.topk_many(q[None], 50)


def test_width_mismatch_raises_like_the_reference():
    rng = np.random.default_rng(4)
    ref, port = _indexes(rng.normal(size=(20, 5)))
    for index in (ref, port):
        with pytest.raises(ValueError, match="index has 5"):
            index.topk(np.ones(7), 3)
        with pytest.raises(ValueError, match="index has 5"):
            index.topk_many(np.ones((2, 3)), 3)


def test_empty_table_answers_nothing():
    port = DeviceFactorIndex(ModelTable(), "-I", device="cpu")
    assert port.topk(np.ones(3), 5) == []
    assert port.topk_many(np.ones((2, 3)), 5) == [[], []]


# -- streaming maintenance --------------------------------------------------


def test_row_update_applied_in_place_without_full_rebuild():
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(50, 6))
    ref_t, port_t = _tables(rows)
    ref = RefIndex(ref_t, "-I")
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = rng.normal(size=6)
    port.topk(q, 5)
    ref.topk(q, 5)
    assert port.full_builds == 1
    matrix = port._matrix
    for t in (ref_t, port_t):
        t.put("17-I", _payload(q * 100.0))
    got = port.topk(q, 3)
    assert got[0][0] == "17"
    _assert_close(ref.topk(q, 3), got)
    assert port.full_builds == 1 and port.inplace_updates == 1
    assert port._matrix is matrix  # rewritten in place, not re-placed


def test_bulk_loaded_rows_are_copied_not_shared():
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    table = ModelTable()
    port = DeviceFactorIndex(table, "-I", device="cpu")
    port.bulk_load(["a", "b", "c", "d"], rows)
    table.put("a-I", "90;90;90")
    assert port.topk(np.ones(3), 1)[0] == ("a", 270.0)
    assert rows[0].tolist() == [0.0, 1.0, 2.0]  # the caller's array


def _wait_for(index, pred):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_new_item_lands_via_background_rebuild():
    rng = np.random.default_rng(7)
    _, port_t = _tables(rng.normal(size=(20, 5)))
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = rng.normal(size=5)
    port.topk(q, 5)
    port_t.put("999-I", _payload(q * 50.0))
    assert _wait_for(port, lambda: port.topk(q, 3)[0][0] == "999")
    assert port.full_builds == 2  # exactly one background rebuild
    assert port.inplace_updates == 0


def test_update_during_rebuild_not_lost():
    """A row update arriving while a rebuild is in flight survives the
    swap (queries peek the dirty set, never drain it, meanwhile)."""
    rng = np.random.default_rng(8)
    _, port_t = _tables(rng.normal(size=(30, 4)))
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = rng.normal(size=4)
    port.topk(q, 3)
    orig_snapshot = port._snapshot_rows

    def slow_snapshot():
        out = orig_snapshot()
        time.sleep(0.5)
        return out

    port._snapshot_rows = slow_snapshot
    port_t.put("777-I", _payload(rng.normal(size=4)))
    port.topk(q, 3)  # starts the slow background rebuild
    port_t.put("5-I", _payload(q * 80.0))
    assert port.topk(q, 3)[0][0] == "5"  # peek-applied in place
    port._rebuild_thread.join(timeout=WAIT_S)
    assert not port._rebuild_thread.is_alive()
    port._snapshot_rows = orig_snapshot
    assert port.topk(q, 3)[0][0] == "5"  # after the swap too
    assert port.full_builds == 2


def test_replay_scale_batch_absorbed_by_one_rebuild(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_APPLY_CAP", "4")
    rng = np.random.default_rng(9)
    _, port_t = _tables(rng.normal(size=(40, 3)))
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = np.ones(3)
    port.topk(q, 2)
    port_t.put_many([(f"{i}-I", _payload(-np.ones(3))) for i in range(40)]
                    + [("5-I", _payload(np.full(3, 7.0)))])
    assert port._replay_backlog == 41  # counted, not stored
    assert _wait_for(port, lambda: port.topk(q, 1)[0][0] == "5")
    assert port.full_builds == 2 and port.inplace_updates == 0


class _PlainTable:
    """A table without change listeners: the index rebuilds when its put
    counter moves."""

    def __init__(self):
        self.rows, self.puts = {}, 0

    def put(self, key, value):
        self.rows[key] = value
        self.puts += 1

    def get(self, key):
        return self.rows.get(key)

    def items(self):
        return list(self.rows.items())


def test_table_without_listeners_rebuilds_on_its_put_counter():
    table = _PlainTable()
    for i in range(5):
        table.put(f"{i}-I", f"{i}.0;1.0")
    port = DeviceFactorIndex(table, "-I", device="cpu")
    assert port.topk(np.array([1.0, 0.0]), 1) == [("4", 4.0)]
    assert port.topk(np.array([1.0, 0.0]), 1) == [("4", 4.0)]
    assert port.full_builds == 1
    table.put("9-I", "9.0;0.0")
    assert port.topk(np.array([1.0, 0.0]), 1) == [("9", 9.0)]
    assert port.full_builds == 2


def test_snapshot_drops_malformed_rows_like_the_reference():
    rng = np.random.default_rng(10)
    rows = rng.normal(size=(40, 5))
    ref_t, port_t = _tables(rows)
    for t in (ref_t, port_t):
        t.put("7-I", "0.25;0.5")                      # truncated
        t.put("13-I", ";".join(["1.0"] * 7))           # over-long
        t.put("21-I", "1.0;oops;3.0;4.0;5.0")          # non-numeric
        t.put("MEAN-I", _payload(np.ones(5)))          # cold-start row
    want = RefIndex(ref_t, "-I")._snapshot_rows()
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    ids, got_rows, width = port._snapshot_rows()
    assert width == want[2] == 5
    assert set(ids) == set(want[0]) == {str(i) for i in range(40)} - {
        "7", "13", "21"}
    order = np.argsort(np.asarray(ids, dtype=np.int64))
    ref_order = np.argsort(np.asarray(want[0], dtype=np.int64))
    assert np.array_equal(got_rows[order], want[1][ref_order])
    got = port.topk(rng.normal(size=5), 3)
    assert len(got) == 3 and not {"7", "13", "21", "MEAN"} & set(_ids(got))


def test_snapshot_first_row_truncated_does_not_poison_width():
    table = ModelTable(1)  # one shard: the bad row is iterated first
    table.put("0-I", "0.5")
    vecs = np.random.default_rng(11).normal(size=(20, 6))
    for i in range(1, 21):
        table.put(f"{i}-I", _payload(vecs[i - 1]))
    ids, rows, width = DeviceFactorIndex(table, "-I",
                                         device="cpu")._snapshot_rows()
    assert width == 6 and len(ids) == 20 and "0" not in ids


def test_health_gauges_track_rebuilds_and_staleness():
    rng = np.random.default_rng(12)
    _, port_t = _tables(rng.normal(size=(30, 4)))
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = np.ones(4)
    port.topk(q, 3)
    base = port._obs_rebuilds.value
    port_t.put("3-I", _payload(np.full(4, 2.0)))
    time.sleep(0.05)
    with port._lock:
        port._observe_health()
    assert port._obs_staleness.value >= 0.05
    assert port._obs_dirty_depth.value == 1
    port.topk(q, 3)  # drains
    with port._lock:
        port._observe_health()
    assert port._obs_staleness.value == 0.0
    port_t.put("new-I", _payload(np.ones(4)))
    port.topk(q, 3)
    port._rebuild_thread.join(timeout=WAIT_S)
    assert port._obs_rebuilds.value >= base + 1


# -- the one funnel to the host ----------------------------------------------


def test_to_host_sees_only_result_sized_arrays(monkeypatch):
    rng = np.random.default_rng(13)
    _, port = _indexes(rng.normal(size=(500, 6)))
    q = rng.normal(size=(8, 6)).astype(np.float32)
    port.topk_many(q, 10)  # build off the spy
    seen = []
    real = topk_mod._to_host

    def spy(x):
        seen.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(topk_mod, "_to_host", spy)
    port.topk_many(q, 10)
    port.topk(q[0], 10)
    port.warm_batch_shapes(10, max_batch=4)
    assert seen[:4] == [(8, 10), (8, 10), (1, 10), (1, 10)]
    assert all(len(s) == 2 and s[1] == 10 and s[0] <= 8 for s in seen)


def test_frame_rows_floor_and_powers_of_two():
    assert [topk_mod._frame_rows(b) for b in (1, 2, 7, 8, 9, 17, 32, 33)] \
        == [8, 8, 8, 8, 16, 32, 32, 64]


# -- device and knobs -------------------------------------------------------


def test_sharded_tier_is_refused_not_run_on_one_device(monkeypatch):
    # one device has nothing to shard over: every value of the variable
    # serves the single-device tier, as the reference's index does (the
    # port refused "1" until the sharded tier was ported)
    table = ModelTable()
    table.put("7-I", "1.0;2.0")
    for mode in ("1", "0", "auto"):
        monkeypatch.setenv("TPUMS_TOPK_SHARDED", mode)
        index = DeviceFactorIndex(table, "-I", device="cpu")
        assert index.device.type == "cpu"
        assert index.topk(np.array([1.0, 1.0]), 1) == [("7", 3.0)]
        assert isinstance(index._matrix, torch.Tensor)
        handler = make_als_topk_handler(table, device="cpu")
        assert handler.by_vector("1.0;1.0", 1) == "7:3.0"
        handler.close()


def test_cuda_index_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFactorIndex(ModelTable(), "-I")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_als_topk_handler(ModelTable())
    # the operator's explicit host pin is the one way to the CPU
    monkeypatch.setenv("TPUMS_TOPK_PLATFORM", "cpu")
    assert DeviceFactorIndex(ModelTable(), "-I").device.type == "cpu"


def test_engine_other_than_torch_is_refused():
    assert DeviceFactorIndex(ModelTable(), "-I", engine="torch",
                             device="cpu").engine == "torch"
    with pytest.raises(ValueError, match="one engine"):
        DeviceFactorIndex(ModelTable(), "-I", engine="pallas", device="cpu")


def test_handler_replies_equal_the_reference_handler(monkeypatch):
    from flink_ms_tpu.serve.topk import ALSTopkHandler as RefHandler

    monkeypatch.setenv("TPUMS_TOPK_BATCH", "0")
    rng = np.random.default_rng(14)
    ref_t, port_t = _tables(_grid(rng, (60, 5)), n_users=6,
                            user_rows=_grid(rng, (6, 5)))
    ref = RefHandler(ref_t)
    port = make_als_topk_handler(port_t, device="cpu")
    assert port.batcher is None and not port.batching
    for u in range(6):
        assert port(str(u), 7) == ref(str(u), 7)
        payload = port_t.get(f"{u}-U")
        assert port.by_vector(payload, 4) == ref.by_vector(payload, 4)
    assert port("nobody", 3) is None


def test_concurrent_writer_and_queries_keep_answering():
    """Queries and a writer thread in turns on one index: every reply has k
    rows of the catalog, and the in-place updates land."""
    rng = np.random.default_rng(15)
    _, port_t = _tables(rng.normal(size=(200, 4)))
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = rng.normal(size=4)
    port.topk(q, 5)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            port_t.put(f"{i % 200}-I", _payload(rng.normal(size=4)))
            i += 1
            time.sleep(1e-4)  # yield the GIL: a spinning writer starves
            # the query thread at every torch call's GIL hand-back

    t = threading.Thread(target=writer)
    t.start()
    deadline = time.monotonic() + WAIT_S
    try:
        n = 0
        while n < 50 or (port.inplace_updates == 0
                         and time.monotonic() < deadline):
            assert len(port.topk(q, 5)) == 5
            n += 1
    finally:
        stop.set()
        t.join(timeout=WAIT_S)
    assert not t.is_alive() and port.inplace_updates > 0
