"""The port's row-sharded exact top-k tier (``ShardedMatrix`` in
``flink_ms_tpu_torch/serve/topk.py``) against the JAX package's sharded
program on the CPU: shards on ``["cpu"] * D`` against the reference's
``shard_map`` over D of the suite's virtual devices, the pad-row bias,
in-place row updates in the owning shard, the size gate, the IVF tier's
re-rank over shards, and ``TPUMS_TOPK_SHARDED=1`` on one device serving
the single-device tier as the reference does."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from flink_ms_tpu.parallel.mesh import BLOCK_AXIS, make_mesh
from flink_ms_tpu.parallel.mesh import row_bucket as ref_row_bucket
from flink_ms_tpu.serve import topk as ref_topk
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.parallel.mesh import row_bucket
from flink_ms_tpu_torch.serve import topk as topk_mod
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import (DeviceFactorIndex, ShardedMatrix,
                                           make_als_topk_handler)


@pytest.fixture(autouse=True)
def _exact_tier(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "1")


def _payload(vec) -> str:
    return ";".join(repr(float(x)) for x in vec)


def _table(rows, cls=ModelTable):
    t = cls()
    for i, vec in enumerate(rows):
        t.put(f"{i}-I", _payload(vec))
    return t


def _grid(rng, shape):
    """Small multiples of 1/8: their dot products are exact in float32,
    so both packages score bit for bit and ties are real."""
    return (rng.integers(-16, 16, size=shape) / 8.0).astype(np.float32)


def _index(rows, D=None):
    """An index holding ``rows`` as rows 0..n-1 in order (a table's
    iteration order need not be its insertion order, and among tied
    scores the lower row comes first), sharded over ``["cpu"] * D``."""
    index = DeviceFactorIndex(_table(rows), "-I", device="cpu",
                              shard_devices=None if D is None
                              else ["cpu"] * D)
    index.bulk_load([str(i) for i in range(len(rows))], rows)
    return index


def _ids(res):
    return [[int(i) for i, _ in r] for r in res]


@pytest.mark.parametrize("n", [1, 5, 10, 1000, 1024, 1025, 100_003])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_row_bucket_equals_reference(n, shards):
    assert row_bucket(n, shards) == ref_row_bucket(n, shards)
    assert row_bucket(n, shards, floor=1) == ref_row_bucket(n, shards,
                                                            floor=1)
    with pytest.raises(ValueError):
        row_bucket(n, 0)


def _reference_index(rows, q, k, D):
    """The reference's sharded program over D virtual devices, on the same
    padded layout -> (scores, row ids) as numpy."""
    mesh = make_mesh(D)
    n = rows.shape[0]
    n_pad = ref_row_bucket(n, D)
    mat = np.zeros((n_pad, rows.shape[1]), np.float32)
    mat[:n] = rows
    bias = np.zeros((n_pad,), np.float32)
    bias[n:] = ref_topk._PAD_SCORE
    m = jax.device_put(mat, NamedSharding(mesh, P(BLOCK_AXIS, None)))
    b = jax.device_put(bias, NamedSharding(mesh, P(BLOCK_AXIS)))
    s, i = ref_topk._sharded_topk_program(mesh)(m, b, q, k)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("width", [6, 16])
@pytest.mark.parametrize("n,k", [(1000, 17), (37, 30), (300, 1)])
def test_sharded_ids_equal_reference_program(rng, D, width, n, k):
    # exact scores with real ties: the ids equal in value and order
    rows = _grid(rng, (n, width))
    q = _grid(rng, (5, width))
    index = _index(rows, D)
    got = index.topk_many(q, k)
    assert isinstance(index._matrix, ShardedMatrix)
    assert index._matrix.n_pad == ref_row_bucket(n, D)
    want_s, want_i = _reference_index(rows, q, k, D)
    assert _ids(got) == want_i.tolist()
    np.testing.assert_allclose([[s for _, s in r] for r in got], want_s,
                               rtol=1e-6)
    # and a lone query, through the same frame path
    assert [int(i) for i, _ in index.topk(q[0], k)] == want_i[0].tolist()


def test_sharded_equals_reference_index_on_eight_devices(rng, monkeypatch):
    # the reference index shards over every one of the suite's 8 devices
    rows = _grid(rng, (3000, 8))
    q = _grid(rng, (6, 8))
    ref = ref_topk.DeviceFactorIndex(_table(rows, RefTable), "-I")
    want = ref.topk_many(q, 17)
    assert ref._is_sharded
    port = DeviceFactorIndex(_table(rows), "-I", device="cpu",
                             shard_devices=["cpu"] * 8)
    got = port.topk_many(q, 17)
    assert isinstance(port._matrix, ShardedMatrix)
    assert [[i for i, _ in r] for r in got] == \
        [[i for i, _ in r] for r in want]


def test_sharded_equals_single_device(rng, monkeypatch):
    rows, q = _grid(rng, (2000, 8)), _grid(rng, (9, 8))
    single, sharded = _index(rows), _index(rows, 3)
    assert isinstance(single._matrix, torch.Tensor)
    for a, b in zip(single.topk_many(q, 25), sharded.topk_many(q, 25)):
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                   rtol=1e-6)
    assert sharded.prefers_frames and not single.prefers_frames


def test_sharded_pad_rows_never_surface(rng):
    # 10 rows over 8 shards pad to 64: 54 pad rows, every real score
    # negative; the bias keeps the pads out
    rows = -np.abs(rng.normal(size=(10, 4))).astype(np.float32) - 1.0
    index = _index(rows, 8)
    res = index.topk(np.ones(4, np.float32), 10)
    assert index._matrix.n_pad == 64
    assert sorted(int(i) for i, _ in res) == list(range(10))
    assert all(s < 0 for _, s in res)


def test_dirty_rows_land_in_their_shard(rng):
    rows = _grid(rng, (100, 4))
    index = _index(rows, 4)
    probe = np.ones(4, np.float32)
    index.topk(probe, 5)
    per = index._matrix.per
    builds = index.full_builds
    for row in (3, per + 1, 3 * per - 1):
        index.table.put(f"{row}-I", "7.5;7.5;7.5;7.5")
    res = index.topk(probe, 3)
    assert sorted(int(i) for i, _ in res) == [3, per + 1, 3 * per - 1]
    assert index.full_builds == builds and index.inplace_updates == 3
    for row in (3, per + 1, 3 * per - 1):
        s, local = divmod(row, per)
        assert torch.equal(index._matrix.slices[s][local],
                           torch.full((4,), 7.5))
    # the pad rows stay zero, their bias the pad score
    assert torch.equal(index._matrix.slices[3][100 - 3 * per:],
                       torch.zeros((4 * per - 100, 4)))


@pytest.mark.parametrize("mode,n,want", [
    ("auto", 500, False), ("auto", 1500, True), ("1", 20, True),
    ("0", 1500, False)])
def test_sharding_gate(rng, monkeypatch, mode, n, want):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", mode)
    monkeypatch.setenv("TPUMS_TOPK_SHARD_MIN_ROWS", "1000")
    index = _index(rng.normal(size=(n, 4)).astype(np.float32), 2)
    index.topk(np.ones(4, np.float32), 3)
    assert isinstance(index._matrix, ShardedMatrix) == want
    # one shard device: nothing to shard over
    one = DeviceFactorIndex(index.table, "-I", device="cpu",
                            shard_devices=["cpu"])
    one.topk(np.ones(4, np.float32), 3)
    assert isinstance(one._matrix, torch.Tensor)


@pytest.mark.parametrize("mode,card_bytes,want", [
    ("auto", 1 << 40, False), ("auto", 40_000, True), ("1", 1 << 40, True),
    ("0", 40_000, False)])
def test_sharding_gate_on_cards(rng, monkeypatch, mode, card_bytes, want):
    # on GPUs auto also needs a catalog larger than half of one card; the
    # decision alone, since the slices would need the cards
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", mode)
    monkeypatch.setenv("TPUMS_TOPK_SHARD_MIN_ROWS", "1000")
    monkeypatch.setattr(topk_mod, "_card_bytes", lambda device: card_bytes)
    rows = rng.normal(size=(1500, 4)).astype(np.float32)  # 24,000 bytes
    index = DeviceFactorIndex(_table(rows), "-I", device="cpu",
                              shard_devices=["cuda:0", "cuda:1"])
    assert (index._shards_if_sharding(rows) is not None) == want


def test_ivf_tier_reranks_over_the_shards(rng, monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_TIER", "ivf")
    monkeypatch.setenv("TPUMS_ANN_NLIST", "16")
    monkeypatch.setenv("TPUMS_ANN_NPROBE", "4")
    cents = rng.normal(size=(16, 8)).astype(np.float32) * 3
    rows = cents[rng.integers(0, 16, 4000)] + \
        rng.normal(size=(4000, 8)).astype(np.float32) * 0.5
    q = rng.normal(size=(7, 8)).astype(np.float32)
    single, sharded = _index(rows), _index(rows, 4)
    a, b = single.topk_many(q, 10), sharded.topk_many(q, 10)
    assert single._ann is not None and sharded._ann is not None
    assert isinstance(sharded._matrix, ShardedMatrix)
    assert a == b
    idx = torch.tensor([[0, 3999, 1000], [2048, 5, 5]])
    assert torch.equal(sharded._matrix[idx],
                       torch.from_numpy(rows)[idx])


def test_sharded_one_on_one_device_serves_like_reference(rng, monkeypatch):
    """``TPUMS_TOPK_SHARDED=1`` on a host with one device: the reference
    serves its single-device tier (``_index_mesh`` is None with one
    device visible); so does the port, where it used to refuse."""
    monkeypatch.setitem(ref_topk._index_mesh_cache, ref_topk._index_platform(),
                        None)
    rows = _grid(rng, (500, 6))
    q = _grid(rng, (4, 6))
    ref = ref_topk.DeviceFactorIndex(_table(rows, RefTable), "-I")
    want = ref.topk_many(q, 12)
    assert not ref._is_sharded
    handler = make_als_topk_handler(_table(rows), device="cpu")
    try:
        got = handler.index.topk_many(q, 12)
        assert isinstance(handler.index._matrix, torch.Tensor)
        assert [[i for i, _ in r] for r in got] == \
            [[i for i, _ in r] for r in want]
        assert handler.by_vector(_payload(q[0]), 12) == ";".join(
            f"{i}:{s}" for i, s in got[0])
    finally:
        handler.close()
    assert topk_mod.visible_gpus("cpu") is None
