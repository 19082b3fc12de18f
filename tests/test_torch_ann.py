"""The port's IVF tier (``flink_ms_tpu_torch/serve/ann.py``) against the JAX
package's ``IVFIndex`` on the CPU.

The catalogs are mixtures of well-separated gaussians (the shape of
``tests/test_retrieval_plane.py``), rounded to multiples of 1/8 so that
every dot product is exact in float32: the k-means assignments lie far
from ties, so both packages assign every row alike and the posting lists
are equal array for array, while the centroids (means, summed in another
order) agree to round-off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.serve.ann import IVFIndex as RefIVF
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu.serve.topk import DeviceFactorIndex as RefIndex
from flink_ms_tpu_torch.serve import ann as ann_mod
from flink_ms_tpu_torch.serve.ann import IVFIndex
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import DeviceFactorIndex


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")


def _clustered(n, d, seed, n_clusters=16):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    x = cents[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.5
    return (np.round(x * 8) / 8).astype(np.float32)


def _assert_same_index(ref, got):
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(ref.centroids),
                               rtol=1e-4, atol=1e-5)
    assert np.array_equal(got.postings.numpy(), np.asarray(ref.postings))
    for name in ("nlist", "nprobe", "list_len", "dropped", "n_rows",
                 "recall_probe", "probe_k"):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("n,d,nlist,nprobe", [
    (3000, 8, 16, 4),       # a quarter of the rows dropped from full lists
    (5000, 8, 64, 8),       # more lists than true clusters
    (40000, 8, 64, 8),      # the assignment pass over two chunks
    (1200, 4, None, None),  # default nlist / nprobe
])
def test_build_matches_reference(n, d, nlist, nprobe):
    rows = _clustered(n, d, seed=n)
    ref = RefIVF.build(rows, nlist=nlist, nprobe=nprobe)
    got = IVFIndex.build(rows, nlist=nlist, nprobe=nprobe, device="cpu")
    _assert_same_index(ref, got)
    q = _clustered(16, d, seed=n + 1)
    for k in (1, 10, 50):
        ws, wi = ref.search(jnp.asarray(rows), jnp.asarray(q), k)
        gs, gi = got.search(torch.from_numpy(rows), torch.from_numpy(q), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def test_chunked_training_matches_reference(monkeypatch):
    """Lloyd's sums over several chunks, the tail chunk unpadded, equal the
    reference's (which pads its tail and subtracts the pad's mass)."""
    monkeypatch.setattr(ann_mod, "_ASSIGN_CHUNK", 700)
    monkeypatch.setenv("TPUMS_ANN_TRAIN_CAP", "2500")
    rows = _clustered(6000, 8, seed=3)
    ref = RefIVF.build(rows, nlist=24, nprobe=6, seed=5)
    got = IVFIndex.build(rows, nlist=24, nprobe=6, seed=5, device="cpu")
    _assert_same_index(ref, got)


def test_build_accepts_the_resident_matrix():
    rows = _clustered(2000, 8, seed=4)
    a = IVFIndex.build(rows, nlist=16, device="cpu")
    b = IVFIndex.build(torch.from_numpy(rows), nlist=16)
    assert torch.equal(a.postings, b.postings)
    assert torch.equal(a.centroids, b.centroids)
    assert a.recall_probe == b.recall_probe


@pytest.mark.parametrize("n", [1, 100, 5000, 70000, 10_000_000])
def test_default_sizing_matches_reference(n, monkeypatch):
    assert IVFIndex.default_nlist(n) == RefIVF.default_nlist(n)
    assert IVFIndex.default_nprobe(IVFIndex.default_nlist(n)) == \
        RefIVF.default_nprobe(RefIVF.default_nlist(n))
    monkeypatch.setenv("TPUMS_ANN_NLIST", "4096")
    monkeypatch.setenv("TPUMS_ANN_NPROBE", "64")
    assert IVFIndex.default_nlist(n) == RefIVF.default_nlist(n)
    assert IVFIndex.default_nprobe(4096) == RefIVF.default_nprobe(4096) == 64


def test_short_shortlist_slots_are_minus_one_and_dropped():
    """k past the probed lists' real rows: the slots are -1 in search and
    absent from replies, as in the reference."""
    rows = _clustered(400, 4, seed=6)
    ref = RefIVF.build(rows, nlist=16, nprobe=1)
    got = IVFIndex.build(rows, nlist=16, nprobe=1, device="cpu")
    q = rows[:3]
    ws, wi = ref.search(jnp.asarray(rows), jnp.asarray(q), 200)
    gs, gi = got.search(torch.from_numpy(rows), torch.from_numpy(q), 200)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert (gi.numpy() == -1).any()
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def _tables(rows):
    ref, port = RefTable(), ModelTable()
    for t in (ref, port):
        for i, vec in enumerate(rows):
            t.put(f"it{i}-I", ";".join(repr(float(v)) for v in vec))
    return ref, port


def test_ivf_tier_index_matches_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_TIER", "ivf")
    monkeypatch.setenv("TPUMS_ANN_NLIST", "32")
    monkeypatch.setenv("TPUMS_ANN_NPROBE", "6")
    rows = _clustered(6000, 8, seed=8)
    ref_t, port_t = _tables(rows)
    ref = RefIndex(ref_t, "-I")
    port = DeviceFactorIndex(port_t, "-I", device="cpu")
    q = _clustered(12, 8, seed=9)
    for k in (1, 20, 100):
        assert port.topk_many(q, k) == ref.topk_many(q, k)
        assert port.topk(q[0], k) == ref.topk(q[0], k)
    assert port._ann is not None and port.prefers_frames
    assert port._obs_ann_recall.value == port._ann.recall_probe
    # an in-place row update is re-ranked from the live matrix
    for t in (ref_t, port_t):
        t.put("it5-I", ";".join(["4.0"] * 8))
    assert port.topk_many(q, 5) == ref.topk_many(q, 5)
    assert port.full_builds == 1 and port.inplace_updates == 1


def test_auto_gate_degrades_to_exact(monkeypatch):
    rows = _clustered(2000, 8, seed=5)
    _, port_t = _tables(rows)
    monkeypatch.setenv("TPUMS_TOPK_TIER", "auto")
    # below the size floor: no IVF tier is built
    idx = DeviceFactorIndex(port_t, "-I", device="cpu")
    idx.topk(np.ones(8, dtype=np.float32), 5)
    assert idx._ann is None and not idx.prefers_frames
    # past the floor but failing the recall gate: exact too
    monkeypatch.setenv("TPUMS_ANN_MIN_ROWS", "1000")
    monkeypatch.setenv("TPUMS_ANN_RECALL_MIN", "1.01")
    idx2 = DeviceFactorIndex(port_t, "-I", device="cpu")
    idx2.topk(np.ones(8, dtype=np.float32), 5)
    assert idx2._ann is None
    # and holding the gate: the IVF tier serves
    monkeypatch.setenv("TPUMS_ANN_RECALL_MIN", "0.0")
    idx3 = DeviceFactorIndex(port_t, "-I", device="cpu")
    idx3.topk(np.ones(8, dtype=np.float32), 5)
    assert idx3._ann is not None


def test_failed_ivf_build_serves_exact(monkeypatch, capsys):
    monkeypatch.setenv("TPUMS_TOPK_TIER", "ivf")

    def broken(*a, **kw):
        raise RuntimeError("no room for the lists")

    monkeypatch.setattr(IVFIndex, "build", broken)
    rows = _clustered(500, 4, seed=2)
    _, port_t = _tables(rows)
    idx = DeviceFactorIndex(port_t, "-I", device="cpu")
    res = idx.topk(np.ones(4, dtype=np.float32), 3)
    assert len(res) == 3 and idx._ann is None
    assert "IVF build failed (serving exact)" in capsys.readouterr().err


def test_cuda_build_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFIndex.build(_clustered(100, 4, seed=1), nlist=8)
