"""Continuous sampling profiler — the "which *code* burns the time" layer.

Own copy of ``flink_ms_tpu/obs/profiler.py``, whole.  Frame keys are
``module.function``, so a frame of the port reads
``flink_ms_tpu_torch.…``; the stages, weights, wire line and folded text
are the reference's.  On a CUDA member a thread that spins in a device
sync burns CPU and is sampled; one parked in a blocking wait is not.

The forensics plane (obs/forensics.py) names the slow *stage* of a traced
request; this module names the slow *frames*, Google-Wide-Profiling
style: always-on, low-overhead, fleet-merged.

A timer-driven sampler thread walks ``sys._current_frames()`` at
``TPUMS_PROF_HZ`` (default ~47 Hz — deliberately co-prime with common
periodic work so the sampler cannot phase-lock with a 10/20/50 Hz loop)
and aggregates **folded stacks**: one key per unique call path,
``stage;mod.func;mod.func;...`` root→leaf, weighted by sample count.
The leading ``stage`` segment is the innermost active span stage on the
sampled thread (the span stack publishes its stage kinds into a
cross-thread registry — ``tracing.thread_stages``), so a profile answers
"inside ``server_reply``, which frames burn the time?".  Threads outside
any span key under ``-``.

These are **CPU** profiles: a thread whose per-thread CPU clock
(``/proc/self/task/<tid>/stat``) did not advance since the previous tick
is parked (recv/sleep/poll) and is not counted — otherwise every idle
serving thread accrues samples at full hz and the hot frames drown.
``TPUMS_PROF_IDLE=1`` switches to wall-clock semantics (count every
live thread), which is also the automatic fallback where /proc is
unavailable.

Everything downstream treats a profile as a plain dict::

    {"ts": ..., "hz": 47.0, "samples": N, "wall_s": ..., "unit": "seconds",
     "stacks": {"stage;frame;frame": seconds, ...}, "meta": {...}}

with stack weights in SECONDS (count/hz on the Python plane; the native
plane reports its per-verb ``CLOCK_THREAD_CPUTIME_ID`` self-time directly
in seconds under synthetic ``native;<verb>`` stacks), so Python and C++
cost merge into one fleet profile: ``merge_profiles`` is an associative
fold (sum per-key seconds — exactly ``metrics.merge_snapshots``'s
discipline), and ``scrape.scrape_fleet_profiles`` applies it across every
registry endpoint's ``PROFILE`` verb.

Artifacts and scrapes:

- rotated folded-stack artifacts: when ``TPUMS_PROF_DIR`` is set, the
  sampler flushes ``profile.folded`` (keep-K rotation, ``TPUMS_PROF_KEEP``)
  every ``TPUMS_PROF_FLUSH_S`` seconds — flamegraph.pl-compatible
  collapsed format, one ``stack weight_us`` line each;
- the ``PROFILE`` wire verb (both server planes) ships the snapshot as
  one ``P\\t<json>`` line — the METRICS pattern applied to profiles;
- each flush also publishes ``tpums_prof_samples_total`` and the process
  CPU counter ``tpums_process_cpu_seconds_total`` into the metrics
  registry, which is what the watch plane's CPU rules alert on (and the
  alert page then carries ``profdiff``'s top-delta frames).

``TPUMS_PROF=0`` is the kill switch; the reference holds its hot-path
cost to GET p50 overhead <= 3% (``scripts/obs_overhead_ab.py``, ABAB).

CLI::

    python -m flink_ms_tpu_torch.obs.profiler --flamegraph [FILE]  # folded text
    python -m flink_ms_tpu_torch.obs.profiler --diff BASE CURRENT  # ranked delta
    python -m flink_ms_tpu_torch.obs.profiler --fleet              # merged scrape
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["SamplingProfiler", "prof_stage", "prof_enabled", "prof_hz",
           "get_profiler", "ensure_started", "stop_profiler",
           "profiler_active",
           "merge_profiles", "profile_to_folded", "folded_to_profile",
           "load_profile", "parse_profile_reply", "scrape_profile",
           "CPU_SECONDS_SERIES", "SAMPLES_SERIES", "main"]

DEFAULT_HZ = 47.0
DEFAULT_FLUSH_S = 10.0
DEFAULT_KEEP = 3
DEFAULT_MAX_STACKS = 8192
DEFAULT_DEPTH = 48

ARTIFACT_NAME = "profile.folded"
UNTRACED_STAGE = "-"
OVERFLOW_KEY = UNTRACED_STAGE + ";(overflow)"

# series names shared with rules/watch/scrape — the CPU alert rule keys on
# the counter, and the alert page attaches profdiff's top frames to it
CPU_SECONDS_SERIES = "tpums_process_cpu_seconds_total"
SAMPLES_SERIES = "tpums_prof_samples_total"


def _env_float(name: str, default: float, lo: float) -> float:
    try:
        return max(float(os.environ.get(name, "") or default), lo)
    except ValueError:
        return default


def _env_int(name: str, default: int, lo: int) -> int:
    try:
        return max(int(os.environ.get(name, "") or default), lo)
    except ValueError:
        return default


def prof_enabled() -> bool:
    """``TPUMS_PROF=0`` is the kill switch; anything else (including
    unset) leaves the always-on profiler on."""
    return os.environ.get("TPUMS_PROF", "1").strip() != "0"


def prof_hz() -> float:
    return _env_float("TPUMS_PROF_HZ", DEFAULT_HZ, 1.0)


class prof_stage:
    """``with prof_stage("stage"):`` — mark this thread's samples with a
    stage name WITHOUT requiring an active trace (benches, workers, the
    server dispatch choke point).  Span enter/exit does the same thing
    implicitly for traced requests."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self) -> "prof_stage":
        _tracing.push_stage(self.kind)
        return self

    def __exit__(self, *exc) -> None:
        _tracing.pop_stage()


def _thread_cpu_ticks(native_id: int) -> Optional[int]:
    """utime+stime jiffies for one kernel thread, USER_HZ granularity
    (``/proc/self/task/<tid>/stat`` fields 14+15 — parsed after the last
    ``)`` because comm may contain anything).  None when /proc is absent;
    the sampler then falls back to wall-clock semantics for that thread."""
    try:
        with open(f"/proc/self/task/{native_id}/stat", "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        tail = data.rpartition(b")")[2].split()
        return int(tail[11]) + int(tail[12])
    except (ValueError, IndexError):
        return None


def _frame_name(frame) -> str:
    mod = frame.f_globals.get("__name__", "?")
    return f"{mod}.{frame.f_code.co_name}"


def _fold(frame, depth: int) -> str:
    """Fold one thread's live frame chain into ``root;...;leaf``."""
    names: List[str] = []
    while frame is not None and len(names) < depth:
        names.append(_frame_name(frame))
        frame = frame.f_back
    names.reverse()
    return ";".join(names)


def _process_cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class SamplingProfiler:
    """The always-on sampler.  One daemon thread; every period it walks
    ``sys._current_frames()`` (its own thread excluded), keys each
    thread's folded stack by the thread's active span stage, and bumps
    the count.  ``snapshot()`` converts counts to seconds (count/hz) —
    the cross-plane unit."""

    def __init__(self, hz: Optional[float] = None,
                 artifact_dir: Optional[str] = None,
                 flush_s: Optional[float] = None):
        self.hz = prof_hz() if hz is None else max(float(hz), 1.0)
        self.artifact_dir = (
            artifact_dir if artifact_dir is not None
            else (os.environ.get("TPUMS_PROF_DIR", "").strip() or None))
        self.flush_s = (_env_float("TPUMS_PROF_FLUSH_S", DEFAULT_FLUSH_S,
                                   0.05)
                        if flush_s is None else max(float(flush_s), 0.05))
        self.max_stacks = _env_int("TPUMS_PROF_MAX_STACKS",
                                   DEFAULT_MAX_STACKS, 16)
        self.depth = _env_int("TPUMS_PROF_DEPTH", DEFAULT_DEPTH, 4)
        # CPU profile semantics: a thread whose per-thread CPU clock did
        # not advance since the previous tick is parked (recv, sleep,
        # poll) and is NOT counted — otherwise every idle serving thread
        # accrues samples at full hz and drowns the hot frames.
        # TPUMS_PROF_IDLE=1 switches to wall-clock (count everything).
        self.include_idle = (
            os.environ.get("TPUMS_PROF_IDLE", "0").strip() == "1")
        self._cpu_ticks: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._stacks: Dict[str, int] = {}
        self.samples = 0          # thread-samples accumulated
        self.ticks = 0            # sampler wakeups
        self.started_at: Optional[float] = None
        self._published_samples = 0
        self._published_cpu = _process_cpu_s()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ---------------------------------------------------------

    def sample_once(self) -> int:
        """One synchronous sampling pass -> threads sampled.  Public so
        tests can pin attribution deterministically (no timer race)."""
        me = threading.get_ident()
        sampler_ident = (self._thread.ident
                         if self._thread is not None else None)
        stages = _tracing.thread_stages()
        natives: Dict[int, int] = {}
        if not self.include_idle:
            for t in threading.enumerate():
                if t.ident is not None and t.native_id is not None:
                    natives[t.ident] = t.native_id
        frames = sys._current_frames()
        n = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == me or ident == sampler_ident:
                    continue
                if not self.include_idle:
                    nid = natives.get(ident)
                    ticks = (_thread_cpu_ticks(nid)
                             if nid is not None else None)
                    if ticks is not None:
                        prev = self._cpu_ticks.get(ident)
                        self._cpu_ticks[ident] = ticks
                        if prev is not None and ticks <= prev:
                            continue    # no CPU burned since last tick
                stage = stages.get(ident, UNTRACED_STAGE)
                key = stage + ";" + _fold(frame, self.depth)
                if key not in self._stacks and \
                        len(self._stacks) >= self.max_stacks:
                    key = OVERFLOW_KEY
                self._stacks[key] = self._stacks.get(key, 0) + 1
                n += 1
            self.samples += n
            self.ticks += 1
            if len(self._cpu_ticks) > 2 * len(frames) + 64:
                self._cpu_ticks = {i: v for i, v in self._cpu_ticks.items()
                                   if i in frames}   # drop dead threads
        # help the GC: the frames dict pins every thread's live frame
        del frames
        return n

    def _run(self) -> None:
        period = 1.0 / self.hz
        next_t = time.monotonic() + period
        last_flush = time.monotonic()
        while not self._stop.is_set():
            delay = next_t - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
                if self._stop.is_set():
                    break
            next_t += period
            now = time.monotonic()
            if next_t < now:       # fell behind (suspend, 1-core squeeze):
                next_t = now + period  # re-anchor, don't burst-catch-up
            try:
                self.sample_once()
            except Exception:      # sampling must never kill the process
                pass
            if now - last_flush >= self.flush_s:
                last_flush = now
                try:
                    self.flush()
                except Exception:
                    pass

    # -- lifecycle --------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        self.started_at = time.time()
        self._published_cpu = _process_cpu_s()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpums-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        try:
            self.flush()
        except Exception:
            pass

    # -- snapshots / artifacts --------------------------------------------

    def snapshot(self, meta: Optional[dict] = None) -> dict:
        """The profile dict (stack weights in seconds).  Associatively
        mergeable via ``merge_profiles``."""
        with self._lock:
            stacks = dict(self._stacks)
            samples = self.samples
        scale = 1.0 / self.hz
        return {
            "ts": time.time(),
            "hz": self.hz,
            "enabled": self.running,
            "samples": samples,
            "wall_s": (round(time.time() - self.started_at, 3)
                       if self.started_at else 0.0),
            "unit": "seconds",
            "stacks": {k: round(c * scale, 6) for k, c in stacks.items()},
            "meta": dict(meta or {}),
        }

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.samples = 0
            self.ticks = 0
        self.started_at = time.time()

    def flush(self) -> None:
        """Publish registry counters + (when configured) rotate out the
        folded artifact.  Called on the sampler's flush cadence and on
        ``stop()``."""
        reg = _metrics.get_registry()
        with self._lock:
            samples = self.samples
            distinct = len(self._stacks)
        delta = samples - self._published_samples
        if delta > 0:
            reg.counter(SAMPLES_SERIES).inc(delta)
            self._published_samples = samples
        cpu = _process_cpu_s()
        cpu_delta = cpu - self._published_cpu
        if cpu_delta > 0:
            reg.counter(CPU_SECONDS_SERIES).inc(cpu_delta)
            self._published_cpu = cpu
        reg.gauge("tpums_prof_distinct_stacks").set(distinct)
        if self.artifact_dir:
            self._write_artifact()

    def _write_artifact(self) -> None:
        os.makedirs(self.artifact_dir, exist_ok=True)
        path = os.path.join(self.artifact_dir, ARTIFACT_NAME)
        keep = _env_int("TPUMS_PROF_KEEP", DEFAULT_KEEP, 0)
        # keep-K rotation (the tracing spill's discipline): the newest
        # complete snapshot is always ARTIFACT_NAME, older flushes age
        # through .1 .. .K
        if os.path.exists(path):
            if keep == 0:
                try:
                    os.remove(path)
                except OSError:
                    pass
            else:
                for i in range(keep - 1, 0, -1):
                    src = f"{path}.{i}"
                    if os.path.exists(src):
                        try:
                            os.replace(src, f"{path}.{i + 1}")
                        except OSError:
                            pass
                try:
                    os.replace(path, f"{path}.1")
                except OSError:
                    pass
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(profile_to_folded(self.snapshot()))
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# module-global profiler (the serving stack's shared instance)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[SamplingProfiler] = None


def get_profiler() -> Optional[SamplingProfiler]:
    return _global


def profiler_active() -> bool:
    """Hot-path guard: is the process profiler collecting right now?
    Call sites that mark stages per-request (the server dispatch choke
    point) gate on this so the profiler-off configuration pays one
    module-global read, nothing more."""
    prof = _global
    return prof is not None and prof._thread is not None


def ensure_started() -> Optional[SamplingProfiler]:
    """Start (or return) the process-wide profiler; None when the
    ``TPUMS_PROF=0`` kill switch is set.  Idempotent — every ServingJob/
    EdgeProxy start funnels through here, first caller wins."""
    global _global
    if not prof_enabled():
        return None
    with _global_lock:
        if _global is None:
            _global = SamplingProfiler()
        if not _global.running:
            _global.start()
        return _global


def stop_profiler() -> None:
    """Stop and drop the process-wide profiler (tests)."""
    global _global
    with _global_lock:
        prof, _global = _global, None
    if prof is not None:
        prof.stop()


# ---------------------------------------------------------------------------
# profile algebra: merge / folded round-trip / wire form
# ---------------------------------------------------------------------------

def merge_profiles(profiles: Sequence[dict]) -> dict:
    """Associative fold over profile dicts: per-key seconds and sample
    counts SUM, ``ts`` is the newest, ``wall_s`` the longest, ``hz`` kept
    when uniform (0 marks a mixed/merged-plane profile — native entries
    carry no sampling rate).  Exactly ``merge_snapshots``'s stance:
    merge(merge(a,b),c) == merge(a,merge(b,c)) key-for-key."""
    stacks: Dict[str, float] = {}
    samples = 0
    ts = 0.0
    wall = 0.0
    hzs = set()
    planes: List[str] = []
    for p in profiles:
        if not isinstance(p, dict):
            continue
        for k, v in (p.get("stacks") or {}).items():
            stacks[k] = round(stacks.get(k, 0.0) + float(v), 6)
        samples += int(p.get("samples") or 0)
        ts = max(ts, float(p.get("ts") or 0.0))
        wall = max(wall, float(p.get("wall_s") or 0.0))
        hzs.add(float(p.get("hz") or 0.0))
        mp = p.get("meta") or {}
        if mp.get("plane"):
            planes.append(str(mp["plane"]))
        # merged profiles carry "planes" (plural) — propagate so the
        # fold stays associative over already-merged inputs
        planes.extend(str(x) for x in (mp.get("planes") or []))
    return {
        "ts": ts,
        "hz": hzs.pop() if len(hzs) == 1 else 0.0,
        "samples": samples,
        "wall_s": wall,
        "unit": "seconds",
        "stacks": stacks,
        "meta": {"merged": len([p for p in profiles
                                if isinstance(p, dict)]),
                 "planes": sorted(set(planes))},
    }


def profile_to_folded(profile: dict) -> str:
    """flamegraph.pl collapsed format: ``stack weight`` per line, weight
    in integer MICROSECONDS (the folded format wants integers; at 47 Hz a
    single sample is ~21277 us, so nothing truncates to zero)."""
    lines = []
    for key in sorted(profile.get("stacks") or {}):
        us = int(round(float(profile["stacks"][key]) * 1e6))
        if us > 0:
            lines.append(f"{key} {us}")
    return "\n".join(lines) + ("\n" if lines else "")


def folded_to_profile(text: str) -> dict:
    """Parse collapsed format back to a profile dict (seconds)."""
    stacks: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, weight = line.rpartition(" ")
        if not stack:
            continue
        try:
            us = float(weight)
        except ValueError:
            continue
        stacks[stack] = round(stacks.get(stack, 0.0) + us / 1e6, 6)
    return {"ts": 0.0, "hz": 0.0, "samples": 0, "wall_s": 0.0,
            "unit": "seconds", "stacks": stacks, "meta": {}}


def load_profile(path: str) -> dict:
    """Read a profile artifact: JSON (a snapshot dict, possibly the
    ``P\\t`` wire line) or folded text — both load to the same shape."""
    with open(path) as f:
        text = f.read()
    stripped = text.strip()
    if stripped.startswith("P\t"):
        stripped = stripped[2:]
    if stripped.startswith("{"):
        doc = json.loads(stripped)
        if not isinstance(doc, dict) or "stacks" not in doc:
            raise ValueError(f"{path}: not a profile JSON")
        return doc
    return folded_to_profile(text)


def parse_profile_reply(line: str) -> Optional[dict]:
    """``P\\t<json>`` -> profile dict, None on anything else (old servers
    answer ``E\\tbad request`` — a fleet scrape treats that as 'plane has
    no profiler', not an error)."""
    if not line.startswith("P\t"):
        return None
    try:
        doc = json.loads(line[2:])
    except ValueError:
        return None
    return doc if isinstance(doc, dict) and "stacks" in doc else None


def scrape_profile(host: str, port: int, timeout_s: float = 2.0
                   ) -> Optional[dict]:
    """One PROFILE round-trip (the METRICS scrape pattern — raw tab
    socket, one line back)."""
    import socket

    host = host or "localhost"
    if host == "0.0.0.0":
        host = "localhost"
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout_s) as sock:
            sock.sendall(b"PROFILE\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = sock.recv(1 << 16)
                if not chunk:
                    break
                buf += chunk
    except OSError:
        return None
    return parse_profile_reply(buf.decode("utf-8", "replace").strip())


def profile_reply_line(meta: Optional[dict] = None) -> str:
    """The server side of the PROFILE verb: the process profiler's
    snapshot as one ``P\\t<json>`` line.  With the profiler off/killed the
    reply still parses (enabled false, empty stacks) so round-trip parity
    holds in every configuration."""
    prof = _global
    if prof is not None:
        snap = prof.snapshot(meta=meta)
    else:
        snap = {"ts": time.time(), "hz": prof_hz(), "enabled": False,
                "samples": 0, "wall_s": 0.0, "unit": "seconds",
                "stacks": {}, "meta": dict(meta or {})}
    return "P\t" + json.dumps(snap, separators=(",", ":"), default=str)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _top_lines(profile: dict, n: int = 20) -> Iterable[str]:
    total = sum(profile.get("stacks", {}).values()) or 1.0
    rows = sorted(profile.get("stacks", {}).items(),
                  key=lambda kv: -kv[1])[:n]
    for key, s in rows:
        yield f"{100.0 * s / total:6.2f}%  {s:10.4f}s  {key}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_ms_tpu_torch.obs.profiler",
        description="continuous profiling plane: folded stacks, fleet "
                    "merge, regression diff")
    ap.add_argument("--flamegraph", nargs="?", const="-", metavar="FILE",
                    help="render FILE (JSON or folded; default: scrape "
                         "the live fleet) as collapsed folded stacks")
    ap.add_argument("--diff", nargs=2, metavar=("BASE", "CURRENT"),
                    help="rank frames by delta-share between two profile "
                         "artifacts (obs/profdiff.py)")
    ap.add_argument("--fleet", action="store_true",
                    help="scrape every registry endpoint's PROFILE verb "
                         "and print the merged profile")
    ap.add_argument("--json", action="store_true",
                    help="emit JSON instead of human-readable text")
    ap.add_argument("--out", metavar="FILE",
                    help="also write the result (folded for profiles, "
                         "JSON for diffs) to FILE")
    args = ap.parse_args(argv)

    if args.diff:
        from . import profdiff
        base = load_profile(args.diff[0])
        cur = load_profile(args.diff[1])
        rep = profdiff.diff_profiles(base, cur)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=2)
        if args.json:
            print(json.dumps(rep, indent=2))
        else:
            print(f"# gap {rep['gap_s']:+.4f}s "
                  f"(base {rep['base_total_s']:.4f}s -> "
                  f"current {rep['cur_total_s']:.4f}s)")
            for row in rep["frames"][:20]:
                print(f"{100.0 * row['delta_share']:6.1f}%  "
                      f"{row['delta_s']:+10.4f}s  {row['frame']}")
        return 0

    if args.fleet or args.flamegraph == "-" or args.flamegraph is None:
        from .scrape import scrape_fleet_profiles
        result = scrape_fleet_profiles()
        profile = result["fleet"]
        if not result["scraped"]:
            print("no PROFILE-speaking replicas in the registry",
                  file=sys.stderr)
    else:
        profile = load_profile(args.flamegraph)

    folded = profile_to_folded(profile)
    if args.out:
        with open(args.out, "w") as f:
            f.write(folded)
    if args.json:
        print(json.dumps(profile, indent=2, default=str))
    elif args.flamegraph is not None:
        sys.stdout.write(folded)
    else:
        print(f"# {profile.get('samples', 0)} samples, "
              f"{len(profile.get('stacks', {}))} stacks, "
              f"wall {profile.get('wall_s', 0)}s")
        for line in _top_lines(profile):
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
