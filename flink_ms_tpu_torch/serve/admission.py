"""Per-tenant admission control and priority-aware load shedding.

Own copy of ``flink_ms_tpu/serve/admission.py``, unchanged in behaviour:
the port's lookup server calls it on every request.

The overload story for a multi-tenant fleet: every query verb passes an
admission check at the server's dispatch choke point
(``serve/server.py:_dispatch_parts``) before any handler work happens.
Each tenant draws from its own token bucket; a request that finds the
bucket empty is answered ``E\\tover quota`` — a perfectly ordinary error
reply that every client since the seed protocol already parses — instead
of queueing behind in-quota traffic.

Shedding is priority-aware: the expensive scoring verbs (TOPK/TOPKV) are
refused first.  A slice of every bucket (``reserve_frac``) is reserved
for the cheap point-lookup verbs, so as a tenant's bucket drains its
TOPK traffic starts bouncing while GET/MGET keep being admitted until
the bucket is truly empty — "shed TOPK before GET", mechanically.

Tenancy rides the wire exactly like trace ids (``obs/tracing.py``): an
optional trailing ``tn=<tenant>`` field on tab-protocol requests, popped
here before any verb handler sees the fields.  Clients that never set a
tenant send byte-identical requests.  On the B2 binary plane the record
layout has no room for extra fields, so the tenant binds to the
*connection* at HELLO time (``HELLO\\tB2\\ttn=<tenant>``).

The ops surface (HEALTH/METRICS/PING/HELLO) is never admitted-checked:
an overloaded fleet must stay observable, or the autoscaler and the
shedder stop acting on the same numbers.

Everything here is pure bookkeeping — no sockets, no threads of its own —
so the bucket math is unit-testable with an injected clock
(``tests/test_admission.py``).

Env knobs (all read by ``AdmissionController.from_env``):

- ``TPUMS_ADMIT_QPS``: default per-tenant admit rate (tokens/s).  Unset
  or <= 0 means tenants without an explicit quota are unlimited.
- ``TPUMS_ADMIT_TENANT_QPS``: per-tenant overrides, ``"a=100,b=50"``.
- ``TPUMS_ADMIT_BURST_S``: bucket depth in seconds of rate (default 1.0).
- ``TPUMS_ADMIT_RESERVE``: fraction of each bucket reserved for
  high-priority verbs (default 0.5).
- ``TPUMS_TENANT`` (client side): ambient tenant name stamped on requests.

Admission is OFF (every request admitted, zero hot-path cost beyond one
``None`` check) unless at least one rate knob is set.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics

# wire field for the tenant header (tab plane + extended B2 HELLO); the
# same opt-in trailing-field convention as obs/tracing.TID_FIELD
TENANT_FIELD = "tn="

# the reject reply: startswith("E") so every existing client treats it as
# a request error; the marker substring is what the SLO layer keys on to
# attribute sheds
SHED_REPLY = "E\tover quota"
SHED_MARKER = "over quota"

# bucket name for requests that carry no tenant field at all
DEFAULT_TENANT = "default"

# verbs subject to admission: the query surface.  HEALTH/METRICS/PING and
# protocol negotiation must survive overload (the shedder and autoscaler
# read the same fleet the clients overload).
ADMITTED_VERBS = frozenset({"GET", "MGET", "TOPK", "TOPKV", "DOT", "COUNT"})

# shed-first verbs: device-bound scoring.  Admitted only while the bucket
# holds more than its reserved slice.
LOW_PRIORITY_VERBS = frozenset({"TOPK", "TOPKV"})


def pop_tenant(parts: List[str]) -> Optional[str]:
    """Pop a trailing ``tn=<tenant>`` field off already-split request
    fields -> tenant name or None.  Mirrors ``obs/tracing.pop_tid``: the
    field is strictly trailing and strictly opt-in, so untenanted traffic
    is untouched (and byte-identical on the wire)."""
    if len(parts) >= 2 and parts[-1].startswith(TENANT_FIELD):
        return parts.pop()[len(TENANT_FIELD):] or None
    return None


class TokenBucket:
    """Classic token bucket with an injectable clock (monotonic seconds).

    ``try_take(cost, floor)`` admits only if the bucket still holds at
    least ``floor`` tokens AFTER the take — the floor is how verb
    priority is expressed (low-priority verbs pass a nonzero floor and
    therefore bounce first as the bucket drains)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)  # start full: a fresh tenant gets burst
        self.stamp = time.monotonic() if now is None else now

    def _refill(self, now: float) -> None:
        if now > self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def try_take(self, cost: float = 1.0, floor: float = 0.0,
                 now: Optional[float] = None) -> bool:
        self._refill(time.monotonic() if now is None else now)
        if self.tokens - cost < floor - 1e-12:
            return False
        self.tokens -= cost
        return True

    def level(self, now: Optional[float] = None) -> float:
        self._refill(time.monotonic() if now is None else now)
        return self.tokens


def _parse_tenant_rates(spec: str) -> Dict[str, float]:
    """``"a=100,b=50"`` -> {"a": 100.0, "b": 50.0} (bad pairs skipped)."""
    out: Dict[str, float] = {}
    for pair in (spec or "").split(","):
        pair = pair.strip()
        if not pair or "=" not in pair:
            continue
        name, _, rate_s = pair.partition("=")
        try:
            rate = float(rate_s)
        except ValueError:
            continue
        if name.strip():
            out[name.strip()] = rate
    return out


class AdmissionController:
    """Per-tenant token buckets + priority shedding, one instance per
    server.  Thread-safe (the server dispatches from many handler
    threads); the single lock is held only for the O(1) bucket math.

    A tenant's rate resolves as: explicit ``tenant_qps`` entry, else
    ``default_qps``; a resolved rate <= 0 means unlimited (no bucket is
    even created — the common single-tenant deployment pays one dict
    lookup per request)."""

    def __init__(
        self,
        default_qps: float = 0.0,
        tenant_qps: Optional[Dict[str, float]] = None,
        burst_s: float = 1.0,
        reserve_frac: float = 0.5,
    ):
        self.default_qps = float(default_qps)
        self.tenant_qps = dict(tenant_qps or {})
        self.burst_s = max(float(burst_s), 1e-3)
        self.reserve_frac = min(max(float(reserve_frac), 0.0), 1.0)
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0
        # instrument caches keyed by label value (bounded by tenant/verb
        # cardinality, not request count)
        self._shed_counters: Dict[Tuple[str, str], object] = {}
        self._gauges: Dict[str, Tuple[object, object]] = {}

    @classmethod
    def from_env(cls, env=None) -> Optional["AdmissionController"]:
        """Build from ``TPUMS_ADMIT_*`` -> controller, or None when no
        rate knob is set (admission off; the server skips the check)."""
        env = os.environ if env is None else env
        try:
            default_qps = float(env.get("TPUMS_ADMIT_QPS", "0") or 0)
        except ValueError:
            default_qps = 0.0
        tenant_qps = _parse_tenant_rates(
            env.get("TPUMS_ADMIT_TENANT_QPS", ""))
        if default_qps <= 0 and not tenant_qps:
            return None
        try:
            burst_s = float(env.get("TPUMS_ADMIT_BURST_S", "1.0") or 1.0)
        except ValueError:
            burst_s = 1.0
        try:
            reserve = float(env.get("TPUMS_ADMIT_RESERVE", "0.5") or 0.5)
        except ValueError:
            reserve = 0.5
        return cls(default_qps=default_qps, tenant_qps=tenant_qps,
                   burst_s=burst_s, reserve_frac=reserve)

    # -- instruments -------------------------------------------------------

    def _shed_counter(self, tenant: str, verb: str):
        key = (tenant, verb)
        c = self._shed_counters.get(key)
        if c is None:
            c = obs_metrics.get_registry().counter(
                "tpums_admission_shed_total", tenant=tenant, verb=verb)
            self._shed_counters[key] = c
        return c

    def _tenant_gauges(self, tenant: str):
        g = self._gauges.get(tenant)
        if g is None:
            reg = obs_metrics.get_registry()
            g = (reg.gauge("tpums_admission_tokens", tenant=tenant),
                 reg.gauge("tpums_admission_pressure", tenant=tenant))
            self._gauges[tenant] = g
        return g

    # -- the check ---------------------------------------------------------

    def rate_for(self, tenant: str) -> float:
        return self.tenant_qps.get(tenant, self.default_qps)

    def admit(self, tenant: Optional[str], verb: str,
              cost: float = 1.0, now: Optional[float] = None) -> bool:
        """One admission decision.  Non-query verbs and unlimited tenants
        are always admitted; otherwise the tenant's bucket is charged,
        with the reserve floor applied to low-priority verbs."""
        if verb not in ADMITTED_VERBS:
            return True
        name = tenant or DEFAULT_TENANT
        rate = self.rate_for(name)
        if rate <= 0:
            return True
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None:
                bucket = TokenBucket(rate, burst=rate * self.burst_s,
                                     now=now)
                self._buckets[name] = bucket
            floor = (bucket.burst * self.reserve_frac
                     if verb in LOW_PRIORITY_VERBS else 0.0)
            ok = bucket.try_take(cost, floor=floor, now=now)
            tokens = bucket.tokens
            burst = bucket.burst
            if ok:
                self.admitted += 1
            else:
                self.shed += 1
        if obs_metrics.metrics_enabled():
            tokens_g, pressure_g = self._tenant_gauges(name)
            tokens_g.set(tokens)
            # pressure in [0, 1]: how drained the bucket is — the same
            # number the fleet scrape surfaces to the autoscaler
            pressure_g.set(1.0 - tokens / burst if burst > 0 else 0.0)
            if not ok:
                self._shed_counter(name, verb).inc()
        return ok

    def levels(self, now: Optional[float] = None) -> Dict[str, float]:
        """Current token level per known tenant (tests/introspection)."""
        with self._lock:
            return {name: b.level(now) for name, b in self._buckets.items()}
