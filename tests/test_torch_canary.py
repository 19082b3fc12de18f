"""The port's live model-quality canary (``flink_ms_tpu_torch/obs/watch.py``
``ModelQualityCanary``) against the JAX package's on the CPU: over one stub
client the two canaries give equal probe results and publish equal gauges;
over a live port serving job the canary's MSE is the offline
``compute_mse`` of the same payloads, exactly."""

import numpy as np
import pytest

from flink_ms_tpu.obs import metrics as RM
from flink_ms_tpu.obs.watch import ModelQualityCanary as RefCanary
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.eval.mse import compute_mse
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs.watch import ModelQualityCanary as PortCanary

GAUGES = ("tpums_model_live_mse", "tpums_probe_coverage",
          "tpums_model_staleness_seconds")


class _StubClient:
    """``query_states`` over a dict of factor payloads, logging its calls."""

    def __init__(self, table):
        self.table = table
        self.calls = []

    def query_states(self, name, keys):
        self.calls.append((name, list(keys)))
        return [self.table.get(k) for k in keys]


def _table(rng, n_users=30, n_items=25, k=4, missing=()):
    rows = {f"{u}-U": ";".join(repr(float(x)) for x in rng.normal(size=k))
            for u in range(n_users)}
    rows.update({f"{i}-I": ";".join(repr(float(x))
                                    for x in rng.normal(size=k))
                 for i in range(n_items)})
    for key in missing:
        rows.pop(key)
    return rows


def _gauges(mod):
    snap = {g["name"]: g["value"] for g in mod.get_registry().snapshot()
            ["gauges"] if g["name"] in GAUGES}
    return snap


@pytest.mark.parametrize("max_probe", [512, 40])
def test_canary_probes_and_gauges_equal_the_reference(max_probe):
    rng = np.random.default_rng(0)
    table = _table(rng, missing=("3-U", "7-I"))
    users = rng.integers(0, 32, 300)
    items = rng.integers(0, 27, 300)
    ratings = rng.uniform(1.0, 5.0, 300)
    ref_client, port_client = _StubClient(table), _StubClient(table)
    ref = RefCanary(users, items, ratings, lambda: ref_client,
                    max_probe=max_probe)
    port = PortCanary(users, items, ratings, lambda: port_client,
                      max_probe=max_probe)
    for now in (100.0, 105.0, 130.0):
        if now == 130.0:  # a factor changes: the staleness clock resets
            for c in (ref_client, port_client):
                c.table[f"{port.users[0]}-U"] = "1.0;0.0;0.0;0.0"
        want, got = ref.probe(now=now), port.probe(now=now)
        assert got == want
        assert _gauges(PM) == _gauges(RM)
    assert port_client.calls == ref_client.calls
    assert 0 < got["coverage"] < 1 and got["n_skipped"] > 0
    assert got["staleness_s"] == 0.0 and port.probes == 3
    assert _gauges(PM)["tpums_model_live_mse"] == got["mse"]


def test_canary_refuses_like_the_reference():
    for cls in (RefCanary, PortCanary):
        with pytest.raises(ValueError, match="mismatch"):
            cls([1, 2], [1], [1.0], None)
        with pytest.raises(ValueError, match="empty"):
            cls([], [], [], None)


def test_from_ratings_file_builds_the_reference_slice(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "heldout.csv"
    users, items = rng.integers(0, 9, 50), rng.integers(0, 9, 50)
    ratings = rng.uniform(1, 5, 50)
    with open(path, "w") as f:
        f.write("user,item,rating\n")
        for u, i, r in zip(users, items, ratings):
            f.write(f"{u},{i},{float(r)!r}\n")
    kw = dict(max_probe=16, field_delimiter=",")
    ref = RefCanary.from_ratings_file(str(path), None, **kw)
    port = PortCanary.from_ratings_file(str(path), None, **kw)
    for a in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a))
    assert len(port.ratings) == 16 and port.state_name == "ALS_MODEL"


def test_canary_over_a_live_port_job_equals_offline_mse(tmp_path):
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                                   make_backend,
                                                   parse_als_record)
    from flink_ms_tpu_torch.serve.journal import Journal

    rng = np.random.default_rng(0)
    n, dim = 40, 4
    uf, itf = rng.normal(size=(n, dim)), rng.normal(size=(n, dim))
    journal = Journal(str(tmp_path / "bus"), "models")
    journal.append([F.format_als_row(u, "U", uf[u]) for u in range(n)]
                   + [F.format_als_row(i, "I", itf[i]) for i in range(n)])
    job = ServingJob(journal, ALS_STATE, parse_als_record,
                     make_backend("memory", None), host="127.0.0.1", port=0,
                     poll_interval_s=0.01, device="cpu",
                     snapshots=False).start()
    try:
        assert job.wait_ready(60)
        users = rng.integers(0, 40, size=60)
        items = rng.integers(0, 40, size=60)
        ratings = np.einsum("nd,nd->n", uf[users], itf[items]) \
            + rng.normal(0.0, 0.1, size=60)
        with QueryClient("127.0.0.1", job.port, timeout_s=30) as c:
            canary = PortCanary(users, items, ratings, c)
            probe = canary.probe(now=100.0)
            offline, n_off, _ = compute_mse(
                users, items, ratings,
                lambda k: PortCanary._parse(job.table.get(k)))
    finally:
        job.stop()
    assert probe["mse"] == offline
    assert probe["n_scored"] == n_off == 60
    assert probe["coverage"] == 1.0 and probe["staleness_s"] == 0.0
