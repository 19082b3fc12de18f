"""Profile regression diff — forensics' stage ranking applied to frames.

Own copy of ``flink_ms_tpu/obs/profdiff.py``, whole: pure dict algebra,
so its results equal the reference's dict for dict.

``forensics.diff_slow_fast`` splits traces into slow/fast sets and ranks
*stages* by ``delta_s`` with ``delta_share = delta / gap``; this module
applies the identical discipline to two *profiles* (base vs current
snapshots from ``obs/profiler.py``): per-frame SELF-time — the leaf
frame of each folded stack owns that stack's seconds — is totalled per
set, frames are ranked by the delta, and each row carries its share of
the total regression gap.  The watch plane attaches the top rows to
CPU-regression and quantile pages (``profile_top_frames``), closing the
chain *alert → stage (forensics) → frames (profdiff)*.

Self-time is deliberately frame-keyed, not stack-keyed: a function that
got hot shows ONE row regardless of how many call paths reach it, which
is what a pager wants.  Per-stage attribution survives in
``by_stage`` for the drill-down.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["self_times", "diff_profiles", "top_frames", "format_diff"]


def self_times(profile: dict) -> Dict[str, float]:
    """Fold a profile's stacks to per-frame SELF seconds: the leaf frame
    of each ``stage;frame;...;leaf`` key owns the full weight.  A bare
    one-segment key (shouldn't happen, but artifacts are hand-editable)
    self-attributes to itself."""
    out: Dict[str, float] = {}
    for key, s in (profile.get("stacks") or {}).items():
        leaf = key.rsplit(";", 1)[-1]
        out[leaf] = out.get(leaf, 0.0) + float(s)
    return out


def _stage_self_times(profile: dict) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for key, s in (profile.get("stacks") or {}).items():
        parts = key.split(";")
        stage = parts[0] if len(parts) > 1 else "-"
        leaf = parts[-1]
        per = out.setdefault(stage, {})
        per[leaf] = per.get(leaf, 0.0) + float(s)
    return out


def diff_profiles(base: dict, cur: dict,
                  min_delta_s: float = 0.0) -> dict:
    """Rank frames by self-time delta between two profiles.

    Returns::

        {"base_total_s", "cur_total_s", "gap_s",
         "frames": [{"frame", "base_self_s", "cur_self_s", "delta_s",
                     "delta_share"}, ...],   # delta-ranked, worst first
         "by_stage": {stage: [same rows], ...}}

    ``delta_share`` is each frame's fraction of the total regression gap
    (``cur_total - base_total``), exactly as forensics shares the
    slow-fast gap across stages.  When the totals shrank or held flat
    the share denominator falls back to the largest single positive
    delta, so "what grew most" still ranks sanely."""
    b = self_times(base)
    c = self_times(cur)
    base_total = sum(b.values())
    cur_total = sum(c.values())
    gap = cur_total - base_total
    deltas = {f: c.get(f, 0.0) - b.get(f, 0.0) for f in set(b) | set(c)}
    denom = gap if gap > 1e-12 else max(
        [d for d in deltas.values() if d > 0.0], default=1e-12)
    frames = []
    for f, d in deltas.items():
        if abs(d) < min_delta_s and min_delta_s > 0.0:
            continue
        frames.append({"frame": f,
                       "base_self_s": round(b.get(f, 0.0), 9),
                       "cur_self_s": round(c.get(f, 0.0), 9),
                       "delta_s": round(d, 9),
                       "delta_share": round(d / denom, 4)})
    frames.sort(key=lambda r: -r["delta_s"])

    by_stage: Dict[str, List[dict]] = {}
    sb = _stage_self_times(base)
    sc = _stage_self_times(cur)
    for stage in set(sb) | set(sc):
        pb, pc = sb.get(stage, {}), sc.get(stage, {})
        rows = []
        for f in set(pb) | set(pc):
            d = pc.get(f, 0.0) - pb.get(f, 0.0)
            rows.append({"frame": f,
                         "base_self_s": round(pb.get(f, 0.0), 9),
                         "cur_self_s": round(pc.get(f, 0.0), 9),
                         "delta_s": round(d, 9),
                         "delta_share": round(d / denom, 4)})
        rows.sort(key=lambda r: -r["delta_s"])
        by_stage[stage] = rows

    return {"base_total_s": round(base_total, 9),
            "cur_total_s": round(cur_total, 9),
            "gap_s": round(gap, 9),
            "frames": frames,
            "by_stage": by_stage}


def top_frames(base: dict, cur: dict, n: int = 5) -> List[dict]:
    """The page attachment: the ``n`` worst-regressing frames, positive
    deltas only (a frame that got CHEAPER never explains a CPU page)."""
    rep = diff_profiles(base, cur)
    return [r for r in rep["frames"] if r["delta_s"] > 0][:n]


def format_diff(rep: dict, n: int = 10) -> str:
    lines = [f"profile diff: total {rep['base_total_s']:.4f}s -> "
             f"{rep['cur_total_s']:.4f}s (gap {rep['gap_s']:+.4f}s)"]
    for i, row in enumerate(rep["frames"][:n], 1):
        if row["delta_s"] <= 0:
            break
        lines.append(
            f"  #{i} {row['frame']}: {row['delta_s'] * 1e3:+.1f}ms "
            f"({row['delta_share'] * 100:.0f}% of the gap; "
            f"{row['base_self_s'] * 1e3:.1f}ms -> "
            f"{row['cur_self_s'] * 1e3:.1f}ms self)")
    return "\n".join(lines)
