"""Declarative alert rules over the watch store (``obs/tsdb.py``).

Own copy of ``flink_ms_tpu/obs/rules.py``, whole: the same rule fields,
evaluators, transitions, attribution and default rule set, so the same
series give the same transitions in either package and a rules file
loads to the same rules.

The SRE-style alerting discipline, sized down to one process:

- **threshold** rules compare a query over a series (``latest`` / ``rate``
  / ``derivative`` / ``quantile`` / ``drop`` — window-max minus latest,
  the shape of "a replica vanished") against a bound;
- **absence** rules fire when a series goes quiet for longer than the
  bound — covers both a stalled exporter and a scrape loop that died;
- **burn_rate** rules implement the multi-window error-budget pattern: a
  FAST window (pages quickly on a cliff) and a SLOW window (filters
  blips) must BOTH burn the budget faster than ``burn_multiple`` before
  the rule trips, which is what makes page-severity alerts actionable
  instead of noisy;
- ``for_s`` hold-down: the condition must hold continuously before the
  alert transitions pending -> firing (Prometheus ``for:``);
- flap suppression: ``flap_max`` fire/resolve cycles inside
  ``flap_window_s`` latch the alert firing with ``suppressed=True`` so a
  boundary-riding signal produces one page, not a pager storm;
- every transition is emitted as an ``alert_firing`` /
  ``alert_resolved`` tracing event, so the incident timeline and the
  Dapper-style request log land in the same ring/JSONL stream.

Attribution reuses the SLO report's machinery: ``attribute_alerts`` maps
each firing to the nearest disruptive event (kill, cutover, rollout,
autoscale decision) within the attribution window —
``unattributed == 0`` is the chaos gate, meaning nothing paged that the
run cannot explain.

Rules files are JSON (``load_rules``): ``{"rules": [{...}, ...]}`` or a
bare list, field names matching ``Rule``'s constructor.  ``default_rules``
ships the fleet baseline: replica drop + unreachable pages, scrape
staleness, server error burn rate, and the model-drift threshold over the
canary's ``tpums_model_live_mse``.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from . import tracing
from .slo import DEFAULT_ATTRIBUTION_WINDOW_S, _attribute_time
from .tsdb import SeriesStore

__all__ = ["Rule", "RulesEngine", "load_rules", "default_rules",
           "attribute_alerts", "SEVERITY_LEVEL", "severity_name"]

SEVERITY_LEVEL = {"info": 1, "warn": 2, "page": 3}


def severity_name(level: float) -> Optional[str]:
    for name, lv in SEVERITY_LEVEL.items():
        if lv == int(level):
            return name
    return None


_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclass
class Rule:
    """One declarative alert rule.  ``kind`` selects the evaluator:

    - ``threshold``: measure ``series`` via ``mode`` (``latest`` | ``rate``
      | ``derivative`` | ``quantile`` over ``window_s``, quantile ``q``;
      ``drop`` = window-max minus latest) and compare ``op value``;
    - ``absence``: fire when ``series`` has been silent > ``value``
      seconds (a never-seen series counts its silence from engine start);
    - ``burn_rate``: error-budget burn from ``errors_series`` /
      ``requests_series`` increases — fires only when BOTH
      ``fast_window_s`` and ``slow_window_s`` burn >= ``burn_multiple``
      times the budget implied by ``availability_target``.
    """
    name: str
    kind: str = "threshold"
    series: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    op: str = ">"
    value: float = 0.0
    mode: str = "latest"
    window_s: float = 60.0
    q: float = 99.0
    for_s: float = 0.0
    severity: str = "warn"
    # burn-rate fields
    requests_series: str = ""
    errors_series: str = ""
    availability_target: float = 0.999
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_multiple: float = 14.4
    # flap suppression
    flap_max: int = 3
    flap_window_s: float = 120.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("threshold", "absence", "burn_rate"):
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.severity not in SEVERITY_LEVEL:
            raise ValueError(f"rule {self.name!r}: unknown severity "
                             f"{self.severity!r}")
        if self.kind == "threshold" and self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.kind == "burn_rate" and not (
                self.requests_series and self.errors_series):
            raise ValueError(f"rule {self.name!r}: burn_rate needs "
                             "requests_series and errors_series")

    # -- measurement ------------------------------------------------------

    def measure(self, store: SeriesStore, now: float,
                engine_start: float) -> Optional[dict]:
        """-> {"measured": float, "breach": bool, ...detail} or None when
        the rule has no data to judge (no data is never a breach for
        threshold/burn rules; absence is the rule FOR no data)."""
        if self.kind == "absence":
            stale = store.staleness_s(self.series, now=now, **self.labels)
            if stale is None:
                # never seen: silent since the engine started watching
                stale = max(now - engine_start, 0.0)
            return {"measured": stale, "breach": stale > self.value}
        if self.kind == "burn_rate":
            budget = max(1.0 - self.availability_target, 1e-9)
            burns = {}
            for label, win in (("fast", self.fast_window_s),
                               ("slow", self.slow_window_s)):
                req = store.increase(self.requests_series, win, now=now,
                                     **self.labels)
                err = store.increase(self.errors_series, win, now=now,
                                     **self.labels)
                if req <= 0:
                    burns[label] = 0.0
                else:
                    burns[label] = (err / req) / budget
            breach = (burns["fast"] >= self.burn_multiple
                      and burns["slow"] >= self.burn_multiple)
            return {"measured": min(burns["fast"], burns["slow"]),
                    "breach": breach, "burn_fast": burns["fast"],
                    "burn_slow": burns["slow"]}
        # threshold
        if self.mode == "latest":
            measured = store.latest(self.series, **self.labels)
        elif self.mode == "rate":
            measured = store.rate(self.series, self.window_s, now=now,
                                  **self.labels)
        elif self.mode == "derivative":
            measured = store.derivative(self.series, self.window_s,
                                        now=now, **self.labels)
        elif self.mode == "quantile":
            measured = store.quantile(self.series, self.q, self.window_s,
                                      now=now, **self.labels)
        elif self.mode == "drop":
            peak = store.window_max(self.series, self.window_s, now=now,
                                    **self.labels)
            cur = store.latest(self.series, **self.labels)
            measured = (peak - cur) if (peak is not None
                                        and cur is not None) else None
        else:
            raise ValueError(f"rule {self.name!r}: unknown mode "
                             f"{self.mode!r}")
        if measured is None:
            return None
        return {"measured": float(measured),
                "breach": _OPS[self.op](float(measured), self.value)}

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "series": self.series or None,
                "severity": self.severity, "value": self.value,
                "for_s": self.for_s}


class _AlertState:
    """Per-rule pending/firing state machine + flap history."""

    __slots__ = ("state", "pending_since", "firing_since", "measured",
                 "detail", "cycles", "suppressed")

    def __init__(self):
        self.state = "ok"            # ok | pending | firing
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.measured: Optional[float] = None
        self.detail: dict = {}
        self.cycles: Deque[float] = deque(maxlen=64)  # resolve timestamps
        self.suppressed = False


class RulesEngine:
    """Evaluate a rule set against a ``SeriesStore`` on every watch tick.

    ``evaluate`` returns the tick's TRANSITIONS (fired/resolved dicts) and
    appends them to ``history`` — the incident timeline.  ``active``/
    ``summary`` expose current state for gauges, HEALTH hints and the
    registry alert record."""

    def __init__(self, rules: Sequence[Rule],
                 now: Optional[float] = None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError("duplicate rule names")
        self.rules = list(rules)
        self.started_at = time.time() if now is None else now
        self.history: List[dict] = []
        self._state: Dict[str, _AlertState] = {
            r.name: _AlertState() for r in self.rules}

    # -- evaluation -------------------------------------------------------

    def evaluate(self, store: SeriesStore,
                 now: Optional[float] = None) -> List[dict]:
        now = time.time() if now is None else now
        transitions: List[dict] = []
        for rule in self.rules:
            st = self._state[rule.name]
            res = rule.measure(store, now, self.started_at)
            breach = bool(res and res["breach"])
            if res is not None:
                st.measured = res["measured"]
                st.detail = {k: v for k, v in res.items()
                             if k not in ("breach",)}
            if breach:
                if st.state == "ok":
                    st.state = "pending"
                    st.pending_since = now
                if st.state == "pending" and \
                        now - st.pending_since >= rule.for_s:
                    st.state = "firing"
                    st.firing_since = now
                    transitions.append(self._transition(
                        "alert_firing", rule, st, now))
            else:
                if st.state == "firing":
                    # a flap cycle is recorded only while un-latched:
                    # once suppressed, every clear tick would otherwise
                    # refill the window and the latch could never drain
                    if not st.suppressed:
                        st.cycles.append(now)
                    if self._flapping(rule, st, now):
                        # latch: stay firing, mark suppressed once
                        if not st.suppressed:
                            st.suppressed = True
                            transitions.append(self._transition(
                                "alert_suppressed", rule, st, now))
                    else:
                        # resolve — including un-latching a suppressed
                        # flap once its window has gone quiet
                        st.state = "ok"
                        st.firing_since = None
                        st.pending_since = None
                        st.suppressed = False
                        transitions.append(self._transition(
                            "alert_resolved", rule, st, now))
                elif st.state == "pending":
                    st.state = "ok"
                    st.pending_since = None
        self.history.extend(transitions)
        for tr in transitions:
            tracing.event(tr["kind"], rule=tr["rule"],
                          severity=tr["severity"],
                          measured=tr.get("measured"))
        return transitions

    def _flapping(self, rule: Rule, st: _AlertState, now: float) -> bool:
        recent = [t for t in st.cycles if now - t <= rule.flap_window_s]
        return len(recent) >= rule.flap_max

    def _transition(self, kind: str, rule: Rule, st: _AlertState,
                    now: float) -> dict:
        tr = {"ts": now, "kind": kind, "rule": rule.name,
              "severity": rule.severity, "measured": st.measured,
              "value": rule.value if rule.kind != "burn_rate"
              else rule.burn_multiple}
        if st.suppressed:
            tr["suppressed"] = True
        for k, v in st.detail.items():
            if k != "measured":
                tr[k] = v
        return tr

    # -- state ------------------------------------------------------------

    def active(self) -> List[dict]:
        """Currently-firing alerts (suppressed flaps included — they are
        still real conditions, just deduplicated)."""
        out = []
        for rule in self.rules:
            st = self._state[rule.name]
            if st.state == "firing":
                out.append({"rule": rule.name, "severity": rule.severity,
                            "since": st.firing_since,
                            "measured": st.measured,
                            "suppressed": st.suppressed,
                            "description": rule.description})
        return out

    def summary(self) -> dict:
        """Compact state for gauges / HEALTH hints / registry records."""
        alerts = self.active()
        max_sev = max((SEVERITY_LEVEL[a["severity"]] for a in alerts),
                      default=0)
        return {"firing": len(alerts),
                "max_severity": severity_name(max_sev) if max_sev else None,
                "max_severity_level": max_sev,
                "alerts": alerts}


# ---------------------------------------------------------------------------
# attribution — the incident timeline gate
# ---------------------------------------------------------------------------

def attribute_alerts(transitions: Sequence[dict],
                     timeline: Sequence[dict],
                     window_s: float = DEFAULT_ATTRIBUTION_WINDOW_S
                     ) -> dict:
    """Attribute each ``alert_firing`` transition to the nearest disruptive
    timeline event (same machinery and window as the SLO report's breach
    attribution).  ``unattributed`` counts firings with NO explaining
    event — the chaos gate requires it to be zero for page severity."""
    attributed: List[dict] = []
    unattributed = 0
    unattributed_page = 0
    for tr in transitions:
        if tr.get("kind") != "alert_firing":
            continue
        cause = _attribute_time(tr["ts"], timeline, (), window_s)
        entry = dict(tr)
        entry["attributed_to"] = cause
        if cause is None:
            unattributed += 1
            if tr.get("severity") == "page":
                unattributed_page += 1
        attributed.append(entry)
    return {"alerts": attributed, "unattributed": unattributed,
            "unattributed_page": unattributed_page,
            "window_s": window_s}


# ---------------------------------------------------------------------------
# rule sets
# ---------------------------------------------------------------------------

def load_rules(path: str) -> List[Rule]:
    """Parse a JSON rules file: ``{"rules": [{...}]}`` or a bare list of
    rule objects whose keys match ``Rule``'s fields."""
    with open(path) as f:
        doc = json.load(f)
    items = doc.get("rules", []) if isinstance(doc, dict) else doc
    if not isinstance(items, list):
        raise ValueError(f"{path}: expected a list or {{'rules': [...]}}")
    return [Rule(**item) for item in items]


def default_rules() -> List[Rule]:
    """The fleet baseline.  Replica loss pages on the DROP shape (a
    SIGKILL'd same-host replica is pid-dead and reaped from the registry
    listing almost immediately, so 'unreachable' alone can miss it — the
    replica COUNT falling below its window peak is the robust signal)."""
    return [
        Rule(name="replica_drop", kind="threshold",
             series="tpums_watch_replicas_total", mode="drop",
             window_s=60.0, op=">=", value=1.0, for_s=0.0,
             severity="page",
             description="live replica count fell below its 60s peak"),
        Rule(name="replicas_unreachable", kind="threshold",
             series="tpums_watch_unreachable_replicas", mode="latest",
             op=">=", value=1.0, for_s=0.0, severity="page",
             description="registered replica not answering METRICS"),
        Rule(name="scrape_stalled", kind="absence",
             series="tpums_watch_replicas_total", value=15.0,
             severity="warn",
             description="watch scrape loop has gone quiet"),
        Rule(name="server_error_burn", kind="burn_rate",
             requests_series="tpums_server_requests_total",
             errors_series="tpums_server_errors_total",
             availability_target=0.999, fast_window_s=60.0,
             slow_window_s=300.0, burn_multiple=14.4, for_s=0.0,
             severity="page",
             description="error budget burning at page rate in both "
                         "fast and slow windows"),
        Rule(name="model_drift", kind="threshold",
             series="tpums_model_live_mse", mode="latest",
             op=">", value=2.0, for_s=0.0, severity="warn",
             description="live held-out MSE above drift threshold"),
        # newer-plane baselines: sustained CAS retries mean update
        # workers are losing races to the ingest writer (LWW re-put
        # churn), seqlock read retries mean hot-row write contention on
        # the lock-free read path, and follower lag is the staleness
        # bound georepl promises readers
        Rule(name="arena_cas_retry_storm", kind="threshold",
             series="tpums_arena_cas_retry_total", mode="rate",
             window_s=60.0, op=">", value=100.0, for_s=30.0,
             severity="warn",
             description="arena CAS retries sustained above 100/s — "
                         "update plane losing races to the ingest writer"),
        Rule(name="arena_read_retry_storm", kind="threshold",
             series="tpums_arena_read_retries_total", mode="rate",
             window_s=60.0, op=">", value=1000.0, for_s=30.0,
             severity="warn",
             description="seqlock read retries sustained above 1000/s — "
                         "hot-row write contention on the lock-free path"),
        Rule(name="georepl_follower_lag", kind="threshold",
             series="tpums_georepl_lag_seconds", mode="latest",
             op=">", value=30.0, for_s=30.0, severity="page",
             description="follower region trailing its leader by >30s"),
        # continuous-profiling plane: a CPU regression pages,
        # and the page carries profdiff's top-delta frames (the watcher
        # diffs its previous profiler snapshot against the current one),
        # closing the chain alert -> stage -> frames
        Rule(name="process_cpu_regression", kind="threshold",
             series="tpums_process_cpu_seconds_total", mode="rate",
             window_s=60.0, op=">", value=0.9, for_s=30.0,
             severity="warn",
             description="process burning >0.9 CPU cores sustained — "
                         "see attached profile_top_frames"),
    ]
