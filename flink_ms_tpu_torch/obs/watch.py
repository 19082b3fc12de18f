"""Live model-quality canary of the fleet watch loop.

Own copy of ``ModelQualityCanary`` from ``flink_ms_tpu/obs/watch.py``: a
held-out ratings slice scored against the LIVE fleet through
``eval.mse.compute_mse`` (the offline evaluator's grouping and skip
semantics), published as three gauges in the process metrics registry:
``tpums_model_live_mse`` (the autopilot's drift signal,
``serve/autopilot.py``), ``tpums_probe_coverage`` and
``tpums_model_staleness_seconds``.

The watch loop around it (``FleetWatcher``: scrape, retain, evaluate the
rules, publish alerts) and its CLI are not ported yet (ROADMAP.md,
Queue 1, item 'Observability'); a caller publishes an alert summary with
``serve.registry.publish_alerts`` as the watcher would.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional

import numpy as np

from .metrics import get_registry

__all__ = ["ModelQualityCanary"]

# matches serve/consumer.py ALS_STATE: a string, not an import, so the obs
# layer stays importable without the serving stack
_DEFAULT_STATE = "ALS_MODEL"


class ModelQualityCanary:
    """Live held-out-quality prober.

    Holds a probe slice of ratings (an evenly-strided sample of what the
    caller provides, capped at ``max_probe`` so a probe is a handful of
    MGETs, not an eval job), scores it against the live fleet through
    ``eval.mse.compute_mse`` — the SAME grouping/skip semantics as the
    offline evaluator, so live and offline MSE on one slice are the
    identical statistic — and publishes three gauges:

    - ``tpums_model_live_mse``: the probe's MSE (absent until something
      scores);
    - ``tpums_probe_coverage``: scored fraction of the probe slice (a
      coverage collapse means keys vanished — a bad rollout looks like
      this before quality numbers move);
    - ``tpums_model_staleness_seconds``: seconds since the fetched
      factors last CHANGED (fingerprint of the raw payloads) — the
      online-update loop's liveness, measured from the serving side.

    ``client`` is anything with ``query_states(name, keys)`` (QueryClient,
    HAShardedClient, ElasticClient) or a zero-arg factory returning one
    (resolved lazily, so the canary can be built before the fleet is up).
    """

    def __init__(self, users, items, ratings,
                 client, state_name: str = _DEFAULT_STATE,
                 max_probe: int = 512):
        users = np.asarray(users)
        items = np.asarray(items)
        ratings = np.asarray(ratings, dtype=np.float64)
        if not (len(users) == len(items) == len(ratings)):
            raise ValueError("users/items/ratings length mismatch")
        if len(ratings) == 0:
            raise ValueError("empty probe slice")
        if len(ratings) > max_probe:
            idx = np.linspace(0, len(ratings) - 1, max_probe).astype(int)
            users, items, ratings = users[idx], items[idx], ratings[idx]
        self.users, self.items, self.ratings = users, items, ratings
        self.state_name = state_name
        self._client_or_factory = client
        self._client = None
        self._fingerprint: Optional[str] = None
        self._fingerprint_ts: Optional[float] = None
        self.probes = 0
        self.last: Optional[dict] = None

    def _resolve_client(self):
        if self._client is None:
            c = self._client_or_factory
            self._client = c if hasattr(c, "query_states") else c()
        return self._client

    @staticmethod
    def _parse(payload: Optional[str]):
        if payload is None:
            return None
        # serving values are the factor payload "f1;f2;..."
        return np.asarray([float(t) for t in payload.split(";") if t])

    def probe(self, now: Optional[float] = None) -> dict:
        """One probe round -> ``{"mse", "n_scored", "n_skipped",
        "coverage", "staleness_s", "ts"}``; also sets the three gauges."""
        from ..eval.mse import compute_mse

        now = time.time() if now is None else now
        client = self._resolve_client()
        fetched: List[str] = []

        def lookup_many(keys):
            payloads = client.query_states(self.state_name, list(keys))
            fetched.extend(p for p in payloads if p is not None)
            return [self._parse(p) for p in payloads]

        def lookup(key):
            return lookup_many([key])[0]

        mse, n_scored, n_skipped = compute_mse(
            self.users, self.items, self.ratings, lookup,
            lookup_many=lookup_many)
        coverage = n_scored / len(self.ratings)
        fp = hashlib.sha1(
            "\n".join(sorted(fetched)).encode()).hexdigest() \
            if fetched else None
        if fp != self._fingerprint:
            self._fingerprint = fp
            self._fingerprint_ts = now
        staleness = (now - self._fingerprint_ts
                     if self._fingerprint_ts is not None else 0.0)
        reg = get_registry()
        if mse is not None:
            reg.gauge("tpums_model_live_mse").set(mse)
        reg.gauge("tpums_probe_coverage").set(coverage)
        reg.gauge("tpums_model_staleness_seconds").set(staleness)
        self.probes += 1
        self.last = {"mse": mse, "n_scored": n_scored,
                     "n_skipped": n_skipped, "coverage": coverage,
                     "staleness_s": staleness, "ts": now}
        return self.last

    @classmethod
    def from_ratings_file(cls, path: str, client,
                          state_name: str = _DEFAULT_STATE,
                          max_probe: int = 512,
                          field_delimiter: str = "tab"
                          ) -> "ModelQualityCanary":
        """Build the probe slice from a ratings file (the same reader the
        trainers/evaluators use)."""
        from ..core import formats as F
        users, items, ratings = F.read_ratings(
            path, field_delimiter=field_delimiter, ignore_first_line=True)
        return cls(users, items, ratings, client, state_name=state_name,
                   max_probe=max_probe)
