"""Tail-latency forensics: span spills -> causal trees -> critical-path
self-times -> automated slow-vs-fast diffing.

Own copy of ``flink_ms_tpu/obs/forensics.py``, whole.  The port's spans
write the reference's event schema, so either package's report over the
same spill files is the same dict.

The tracing layer (``obs.tracing``) leaves span records behind — client
RPCs, server replies (both planes), microbatch queue-wait/device stages,
fan-out legs, update-plane apply/publish/visible — each carrying
``tid``/``sid``/``psid``/``t0``/``dur_s``.  This module turns those flat
JSONL spills into answers to "why is p99 40x p50?":

- ``collect`` gathers spill files fleet-wide (paths or globs, rotated
  siblings included) plus optionally the in-process ring.
- ``assemble`` groups events per trace id and links spans into trees via
  ``psid`` (spans whose parent never landed become roots — spills are
  best-effort, trees must tolerate missing interior nodes).
- ``critical_path`` attributes each trace's wall time to stages by SELF
  time: a span's duration minus its children's (clipped at zero), so a
  server span that spent 9 of its 10ms inside a device-dispatch child
  charges 1ms to itself and 9ms to the child.
- ``diff_slow_fast`` splits traces into the slow tail (>= ``slow_q``
  quantile of total duration) and the median band, averages per-stage
  self-time in each, and ranks stages by the delta — "stage X contributes
  N µs to the tail" as data, not speculation.
- ``incident_context`` packages exemplar tids + their critical paths for
  the watch plane to attach to a firing latency alert.

CLI::

    python -m flink_ms_tpu_torch.obs.forensics '/tmp/spill.jsonl*' --top 5
    python -m flink_ms_tpu_torch.obs.forensics spill.jsonl --json

Stage naming: ``kind`` alone for client/update spans, ``kind:VERB`` for
server replies (so a slow TOPKV is distinguishable from a slow GET).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from . import tracing as _tracing


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def expand_paths(paths: Sequence[str]) -> List[str]:
    """Expand globs and add rotated siblings (``path.1``..) of literal
    paths, de-duplicated in first-seen order."""
    out: List[str] = []
    seen = set()
    for p in paths:
        hits = sorted(_glob.glob(p)) if any(ch in p for ch in "*?[") \
            else [p]
        for h in hits:
            for cand in [h] + sorted(_glob.glob(h + ".[0-9]*")):
                if cand not in seen:
                    seen.add(cand)
                    out.append(cand)
    return out


def collect(paths: Sequence[str],
            include_ring: bool = False) -> List[dict]:
    """Load every event from the given spill files/globs (malformed lines
    skipped, missing files tolerated), time-ordered.  Publishes
    ``tpums_forensics_last_collect_ts`` so ``fleet_signals`` can report
    forensics staleness."""
    events: List[dict] = []
    for path in expand_paths(paths):
        try:
            events.extend(_tracing.load_events(path))
        except OSError:
            continue
    if include_ring:
        events.extend(_tracing.recent_events())
    events.sort(key=lambda e: e.get("ts", 0.0))
    reg = _metrics.get_registry()
    reg.gauge("tpums_forensics_last_collect_ts").set(time.time())
    reg.gauge("tpums_forensics_events").set(len(events))
    return events


# ---------------------------------------------------------------------------
# tree assembly
# ---------------------------------------------------------------------------

def stage_name(ev: dict) -> str:
    kind = str(ev.get("kind", "?"))
    verb = ev.get("verb")
    return f"{kind}:{verb}" if verb else kind


def _span_bounds(ev: dict) -> Tuple[float, float]:
    """(t0, t_end) for a span event; t0 falls back to ts - dur for spills
    that predate the t0 field."""
    dur = float(ev.get("dur_s") or 0.0)
    t0 = ev.get("t0")
    if t0 is None:
        t0 = float(ev.get("ts", 0.0)) - dur
    return float(t0), float(t0) + dur


class TraceTree:
    """One trace's spans linked parent->child.  ``spans`` maps sid ->
    event; ``children`` maps sid -> [sid]; ``roots`` are spans whose
    parent is absent (missing interior spans promote their subtrees to
    roots rather than dropping them)."""

    __slots__ = ("tid", "spans", "children", "roots", "annotations")

    def __init__(self, tid: str):
        self.tid = tid
        self.spans: Dict[str, dict] = {}
        self.children: Dict[str, List[str]] = {}
        self.roots: List[str] = []
        self.annotations: List[dict] = []  # point events (no sid/dur)

    def total_s(self) -> float:
        """Wall extent of the trace: last span end minus first span start
        (NOT the sum of durations — concurrent fan-out legs overlap)."""
        if not self.spans:
            return 0.0
        starts, ends = zip(*(_span_bounds(e) for e in self.spans.values()))
        return max(0.0, max(ends) - min(starts))

    def self_times(self) -> Dict[str, float]:
        """stage -> summed SELF seconds across this trace's spans."""
        out: Dict[str, float] = {}
        for sid, ev in self.spans.items():
            dur = float(ev.get("dur_s") or 0.0)
            child_dur = sum(
                float(self.spans[c].get("dur_s") or 0.0)
                for c in self.children.get(sid, ()))
            self_s = max(0.0, dur - child_dur)
            stage = stage_name(ev)
            out[stage] = out.get(stage, 0.0) + self_s
        return out

    def render(self, indent: str = "  ") -> str:
        """Human tree: one line per span, children indented under
        parents, ordered by start time."""
        lines: List[str] = [f"trace {self.tid}  "
                            f"({self.total_s() * 1e3:.3f} ms, "
                            f"{len(self.spans)} spans)"]

        def walk(sid: str, depth: int) -> None:
            ev = self.spans[sid]
            dur = float(ev.get("dur_s") or 0.0)
            extra = ""
            if ev.get("queue_wait_s") is not None:
                extra += f" queue={float(ev['queue_wait_s']) * 1e6:.0f}us"
            if ev.get("plane"):
                extra += f" [{ev['plane']}]"
            lines.append(f"{indent * (depth + 1)}{stage_name(ev)}  "
                         f"{dur * 1e6:.0f}us{extra}")
            for c in sorted(self.children.get(sid, ()),
                            key=lambda s: _span_bounds(self.spans[s])[0]):
                walk(c, depth + 1)

        for r in sorted(self.roots,
                        key=lambda s: _span_bounds(self.spans[s])[0]):
            walk(r, 0)
        return "\n".join(lines)


def assemble(events: Iterable[dict]) -> Dict[str, TraceTree]:
    """Group events by tid and link spans into trees.  An event is a span
    iff it carries ``sid``; duplicate sids keep the longer duration (a
    retried spill write, not two spans)."""
    trees: Dict[str, TraceTree] = {}
    for ev in events:
        tid = ev.get("tid")
        if not tid:
            continue
        tree = trees.get(tid)
        if tree is None:
            tree = trees[tid] = TraceTree(tid)
        sid = ev.get("sid")
        if not sid:
            if ev.get("dur_s") is None:
                tree.annotations.append(ev)
            continue
        old = tree.spans.get(sid)
        if old is None or float(ev.get("dur_s") or 0.0) > float(
                old.get("dur_s") or 0.0):
            tree.spans[sid] = ev
    for tree in trees.values():
        for sid, ev in tree.spans.items():
            psid = ev.get("psid")
            if psid and psid in tree.spans and psid != sid:
                tree.children.setdefault(psid, []).append(sid)
            else:
                tree.roots.append(sid)
    return trees


# ---------------------------------------------------------------------------
# critical path + slow/fast diff
# ---------------------------------------------------------------------------

def critical_path(tree: TraceTree, top: int = 0) -> List[dict]:
    """Ranked stage self-times for ONE trace: where its wall time went."""
    total = tree.total_s()
    rows = [{"stage": st, "self_s": round(s, 9),
             "share": round(s / total, 4) if total > 0 else 0.0}
            for st, s in tree.self_times().items()]
    rows.sort(key=lambda r: -r["self_s"])
    return rows[:top] if top else rows


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def diff_slow_fast(trees: Dict[str, TraceTree],
                   slow_q: float = 0.9,
                   fast_band: Tuple[float, float] = (0.25, 0.75)
                   ) -> dict:
    """Split traces into the slow tail (total duration >= the ``slow_q``
    quantile) and the median band (``fast_band`` quantiles), average each
    stage's self-time within each set, and rank stages by the delta.

    Returns::

        {"n_traces", "slow_n", "fast_n", "slow_mean_s", "fast_mean_s",
         "quantiles": {"p50", "p90", "p99"},
         "stages": [{"stage", "slow_self_s", "fast_self_s", "delta_s",
                     "delta_share"}, ...],   # delta-ranked, worst first
         "slow_tids": [tid, ...]}            # slowest first
    """
    totals = sorted(((t.total_s(), tid) for tid, t in trees.items()),
                    key=lambda p: p[0])
    vals = [v for v, _ in totals]
    out = {"n_traces": len(totals), "slow_n": 0, "fast_n": 0,
           "slow_mean_s": 0.0, "fast_mean_s": 0.0,
           "quantiles": {"p50": round(_quantile(vals, 0.5), 9),
                         "p90": round(_quantile(vals, 0.9), 9),
                         "p99": round(_quantile(vals, 0.99), 9)},
           "stages": [], "slow_tids": []}
    if len(totals) < 4:  # not enough traces to split meaningfully
        return out
    slow_cut = _quantile(vals, slow_q)
    lo_cut = _quantile(vals, fast_band[0])
    hi_cut = _quantile(vals, fast_band[1])
    slow = [tid for v, tid in totals if v >= slow_cut]
    fast = [tid for v, tid in totals if lo_cut <= v <= hi_cut
            and v < slow_cut]
    if not slow or not fast:
        return out

    def mean_stages(tids: List[str]) -> Tuple[Dict[str, float], float]:
        acc: Dict[str, float] = {}
        tot = 0.0
        for tid in tids:
            tot += trees[tid].total_s()
            for st, s in trees[tid].self_times().items():
                acc[st] = acc.get(st, 0.0) + s
        n = float(len(tids))
        return {st: s / n for st, s in acc.items()}, tot / n

    slow_means, slow_total = mean_stages(slow)
    fast_means, fast_total = mean_stages(fast)
    gap = max(slow_total - fast_total, 1e-12)
    stages = []
    for st in set(slow_means) | set(fast_means):
        d = slow_means.get(st, 0.0) - fast_means.get(st, 0.0)
        stages.append({"stage": st,
                       "slow_self_s": round(slow_means.get(st, 0.0), 9),
                       "fast_self_s": round(fast_means.get(st, 0.0), 9),
                       "delta_s": round(d, 9),
                       "delta_share": round(d / gap, 4)})
    stages.sort(key=lambda r: -r["delta_s"])
    slow_set = set(slow)
    out.update({
        "slow_n": len(slow), "fast_n": len(fast),
        "slow_mean_s": round(slow_total, 9),
        "fast_mean_s": round(fast_total, 9),
        "stages": stages,
        "slow_tids": [tid for _, tid in reversed(totals)
                      if tid in slow_set],
    })
    return out


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def report(paths: Sequence[str],
           slow_q: float = 0.9,
           include_ring: bool = False,
           top: int = 10) -> dict:
    """Collect -> assemble -> diff, as one JSON-ready dict."""
    events = collect(paths, include_ring=include_ring)
    trees = assemble(events)
    diff = diff_slow_fast(trees, slow_q=slow_q)
    slowest = []
    for tid in diff["slow_tids"][:3]:
        slowest.append({"tid": tid,
                        "total_s": round(trees[tid].total_s(), 9),
                        "critical_path": critical_path(trees[tid],
                                                       top=5)})
    return {"events": len(events), "traces": len(trees),
            "slow_q": slow_q, "diff": {**diff,
                                       "stages": diff["stages"][:top]},
            "slowest": slowest}


def render_human(rep: dict) -> str:
    """The report as a terminal summary — ranked "stage X contributes
    N µs to the tail" lines plus the slowest trace's critical path."""
    d = rep["diff"]
    q = d["quantiles"]
    lines = [
        f"forensics: {rep['traces']} traces / {rep['events']} events  "
        f"p50={q['p50'] * 1e3:.3f}ms p90={q['p90'] * 1e3:.3f}ms "
        f"p99={q['p99'] * 1e3:.3f}ms",
    ]
    if not d["stages"]:
        lines.append("  (not enough traces for a slow-vs-fast split)")
        return "\n".join(lines)
    lines.append(
        f"slow tail (n={d['slow_n']}, mean "
        f"{d['slow_mean_s'] * 1e3:.3f}ms) vs median band "
        f"(n={d['fast_n']}, mean {d['fast_mean_s'] * 1e3:.3f}ms):")
    for i, st in enumerate(d["stages"], 1):
        if st["delta_s"] <= 0:
            break
        lines.append(
            f"  #{i} {st['stage']}: +{st['delta_s'] * 1e6:.0f}us "
            f"({st['delta_share'] * 100:.0f}% of the gap; "
            f"slow {st['slow_self_s'] * 1e6:.0f}us vs "
            f"fast {st['fast_self_s'] * 1e6:.0f}us)")
    for s in rep.get("slowest", [])[:1]:
        lines.append(f"slowest trace {s['tid']} "
                     f"({s['total_s'] * 1e3:.3f}ms):")
        for row in s["critical_path"]:
            lines.append(f"    {row['stage']}: "
                         f"{row['self_s'] * 1e6:.0f}us "
                         f"({row['share'] * 100:.0f}%)")
    return "\n".join(lines)


def incident_context(exemplar_tids: Sequence[str],
                     trees: Optional[Dict[str, TraceTree]] = None,
                     paths: Optional[Sequence[str]] = None,
                     max_tids: int = 4) -> dict:
    """Forensics payload for a firing latency alert: the exemplar tids the
    histogram retained plus each one's critical path (when its spans are
    collectable).  ``trees`` wins over ``paths``; with neither, falls back
    to the in-process ring."""
    if trees is None:
        events = collect(paths or [], include_ring=True)
        trees = assemble(events)
    tids = [t for t in dict.fromkeys(exemplar_tids) if t][:max_tids]
    paths_out = []
    for tid in tids:
        tree = trees.get(tid)
        if tree is not None and tree.spans:
            paths_out.append({"tid": tid,
                              "total_s": round(tree.total_s(), 9),
                              "critical_path": critical_path(tree, top=4)})
    return {"exemplar_tids": tids, "critical_path": paths_out}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_ms_tpu_torch.obs.forensics",
        description="Assemble span spills into trees and diff the slow "
                    "tail against the median band.")
    ap.add_argument("paths", nargs="+",
                    help="span spill files or globs (rotated .N siblings "
                         "are picked up automatically)")
    ap.add_argument("--slow-quantile", type=float, default=0.9,
                    help="tail cut for the slow set (default 0.9)")
    ap.add_argument("--top", type=int, default=10,
                    help="stages to keep in the ranked diff")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--tree", metavar="TID",
                    help="render one trace's span tree and exit")
    args = ap.parse_args(argv)
    if args.tree:
        trees = assemble(collect(args.paths))
        tree = trees.get(args.tree)
        if tree is None:
            print(f"no spans for tid {args.tree}", file=sys.stderr)
            return 1
        print(tree.render())
        return 0
    rep = report(args.paths, slow_q=args.slow_quantile, top=args.top)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print(render_human(rep))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
