#!/usr/bin/env python3
"""The rehearsal of ``chip_smoke.py`` phase 21 (c) in a process of its own,
with or without the profiling that phase 21 (c) runs beside it, or with
its open loop split over several client processes, to tell what holds
its open loop back.

Each run is ``run_rehearsal`` at the reference CLI's defaults at rank 50
(``chip_smoke.OBS_REHEARSAL``: 12 s at 120/240/480 q/s, 4 client threads,
the live autoscaler, a kill, the watch loop, 8 push subscribers) over a
2 x 2 group of ``--device`` members, in a fresh process per run:

- ``plain``: no profiler anywhere (``TPUMS_PROF=0`` in this process and
  every member) and no scrape of the members' profiles;
- ``profiled``: as phase 21 (c) runs it, a wall-clock profiler
  (``TPUMS_PROF_IDLE=1``) in every member and in this process, and a
  thread that scrapes every member's PROFILE each second;
- ``split<N>``: the same 2 x 2 group (the rehearsal's liveness, no
  profiler), and N client processes at once, each the workload CLI's
  attach mode (``python -m flink_ms_tpu_torch.obs.workload --group``)
  at 1/N of the schedule's rates with 4 threads of its own and a seed of
  its own.  Attach mode runs no kill, no autoscaler, no watch loop and
  no subscriber, and has no journal for UPDATE (which would fail at
  once): the clients offer the default mix's query verbs at their rates
  in the full schedule (``SPLIT_MIX``, 82% of 120/240/480 q/s), so
  ``split1`` is the baseline of the ``split`` arms, not ``plain``.

``--threads`` overrides the engine's client threads (4), ``--edge`` puts
that many proxies in front of the group (phase 22 (d)), ``--mix`` sets the
verb weights of ``plain`` and ``profiled`` (``GET=55,MGET=15,...``; the
default mix when not given).  Each run prints
one JSON line: achieved q/s, the schedule's largest lag, the run's
seconds, respawns, and per verb the p99 from the intended send and the
service p99 (from the actual send; for ``split<N>`` the largest of the N
clients').

    python3 scripts/rehearsal_ab.py [--variant plain|profiled|splitN]
        [--device cuda] [--users 40000] [--threads 4] [--edge 0]
        [--mix GET=55,...] [--runs plain,plain@cpu,split1,split4,...]

``--runs`` runs each named variant in turn, each in a child process; a
name may end in ``@DEVICE`` for that run's members (``plain@cpu``).
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the default mix (obs/workload.py DEFAULT_VERB_WEIGHTS) but UPDATE
SPLIT_MIX = {"GET": 55.0, "MGET": 15.0, "TOPK": 8.0, "TOPKV": 4.0}
SPLIT_GROUP = "rehearsal-ab"


def split_commands(n, kw, device, out_dir, group=SPLIT_GROUP) -> list:
    """The N workload CLIs of a ``split<N>`` run: each in attach mode at
    1/N of ``kw``'s rates scaled to the query verbs' share of the
    default mix, its own seed and report file."""
    from flink_ms_tpu_torch.obs.workload import DEFAULT_VERB_WEIGHTS

    share = sum(SPLIT_MIX.values()) / sum(DEFAULT_VERB_WEIGHTS.values())
    mix = ",".join(f"{v}={w:g}" for v, w in SPLIT_MIX.items())
    return [[sys.executable, "-m", "flink_ms_tpu_torch.obs.workload",
             "--group", group, "--users", str(kw["users"]),
             "--durationS", f"{kw['duration_s']:g}",
             "--baseQps", repr(kw["base_qps"] * share / n),
             "--peakQps", repr(kw["peak_qps"] * share / n),
             "--burstQps", repr(kw["burst_qps"] * share / n),
             "--threads", str(kw["threads"]), "--seed", str(i),
             "--mix", mix, "--device", device,
             "--out", os.path.join(out_dir, f"report-{i}.json")]
            for i in range(n)]


def merge_reports(reports) -> dict:
    """The N clients' reports as one run: the sum of their rates (each
    client's ops over its own loop), the ops over the span from the first
    client's start to the last one's end, the largest lag, and per verb
    the largest p99s."""
    wls = [r["workload"] for r in reports]
    span = max(w["t_end"] for w in wls) - min(w["t_start"] for w in wls)
    done = sum(w["completed"] for w in wls)
    rate = sum(w["achieved_qps"] or 0.0 for w in wls)
    verbs = {}
    for r in reports:
        for v, s in r["verbs"].items():
            m = verbs.setdefault(v, {})
            for key in ("p99_ms", "service_p99_ms", "service_p50_ms"):
                if s.get(key) is not None:
                    m[key] = max(m.get(key, s[key]), s[key])
    return {"achieved_qps": round(rate, 1),
            "span_qps": round(done / span, 1) if span > 0 else None,
            "max_sched_lag_s": max(w["max_sched_lag_s"] for w in wls),
            "duration_s": round(span, 3), "completed": done,
            "scheduled": sum(w["scheduled"] for w in wls),
            "client_qps": [w["achieved_qps"] for w in wls],
            "ok": all(r["ok"] for r in reports),
            "errors": sum(r["errors"]["total"] for r in reports),
            "verbs": dict(sorted(verbs.items()))}


def split_run(args, kw, n) -> dict:
    """A 2 x 2 group of ``--device`` members over the rehearsal's seeded
    journal, and ``n`` workload CLIs against it at once."""
    from flink_ms_tpu_torch.obs import workload
    from flink_ms_tpu_torch.serve.elastic import ScaleController

    base = tempfile.mkdtemp(prefix="tpums_rehearsal_ab_")
    os.environ.update({"TPUMS_HEARTBEAT_S": "0.25",
                       "TPUMS_REPLICA_TTL_S": "1.5",
                       "TPUMS_REGISTRY_DIR": os.path.join(base, "registry")})
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    journal = workload._seed_journal(base, "models", kw["users"], kw["dim"],
                                     0)
    ctl = ScaleController(SPLIT_GROUP, journal.dir, "models",
                          port_dir=os.path.join(base, "ports"),
                          ready_timeout_s=180,
                          extra_args=["--updatePlane", "true",
                                      "--pollInterval", "0.02"],
                          device=args.device)
    procs = []
    try:
        ctl.scale_to(kw["shards"], replicas=kw["replication"])
        cmds = split_commands(n, kw, args.device, base)
        procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL) for c in cmds]
        for p in procs:
            p.wait(timeout=600)
        reports = []
        for c in cmds:
            with open(c[c.index("--out") + 1]) as f:
                reports.append(json.load(f))
        respawns = sum(sup.respawns for sup in ctl.supervisors.values())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        ctl.stop(drop_topology=True)
        shutil.rmtree(base, ignore_errors=True)
    return dict(merge_reports(reports), respawns=respawns)


def one_run(args) -> dict:
    sys.path.insert(0, ROOT)
    split = re.fullmatch(r"split(\d+)", args.variant)
    if args.variant == "profiled":
        os.environ["TPUMS_PROF_IDLE"] = "1"
    else:
        os.environ["TPUMS_PROF"] = "0"
    import chip_smoke
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.obs.workload import VerbMix, run_rehearsal

    kw = dict(chip_smoke.OBS_REHEARSAL, users=args.users)
    kw["threads"] = args.threads
    head = {"variant": args.variant, "device": args.device,
            "users": args.users, "threads": args.threads, "edge": args.edge}
    if split:
        t0 = time.perf_counter()
        got = split_run(args, kw, int(split.group(1)))
        return dict(head, clients=int(split.group(1)),
                    seconds=round(time.perf_counter() - t0, 3), **got)
    if args.edge:
        kw["edge"] = args.edge
    if args.mix:
        kw["verb_weights"] = VerbMix.from_string(args.mix).to_dict()
        head["mix"] = kw["verb_weights"]
    dur = kw.pop("duration_s")
    stop, members = threading.Event(), {}
    poller = None
    if args.variant == "profiled":
        PP.ensure_started()
        poller = threading.Thread(target=chip_smoke.fleet_profile_poller,
                                  args=(stop, members), daemon=True)
        poller.start()
    t0 = time.perf_counter()
    try:
        rep = run_rehearsal(
            warm_s=dur * 2 / 12, ramp_s=dur * 3 / 12, burst_s=dur * 4 / 12,
            cool_s=dur * 3 / 12, seed=0, device=args.device, **kw)
    finally:
        seconds = time.perf_counter() - t0
        stop.set()
        if poller is not None:
            poller.join(timeout=10)
    wl = rep["workload"]
    respawns = sum(1 for e in rep["timeline"]
                   if e.get("kind") == "replica_respawn")
    return dict(head, seconds=round(seconds, 3),
                achieved_qps=wl["achieved_qps"],
                max_sched_lag_s=wl["max_sched_lag_s"],
                duration_s=wl["duration_s"], respawns=respawns,
                ok=rep["ok"], errors=rep["errors"]["total"],
                verbs={v: {"p99_ms": s.get("p99_ms"),
                           "service_p99_ms": s.get("service_p99_ms"),
                           "service_p50_ms": s.get("service_p50_ms")}
                       for v, s in sorted(rep["verbs"].items())},
                profiled_members=len(members))


def variant(name) -> str:
    if name in ("plain", "profiled") or re.fullmatch(r"split[1-9]\d*", name):
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r}: plain, profiled or split<N>")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", type=variant, default="plain")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=40_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--edge", type=int, default=0)
    ap.add_argument("--mix", default=None)
    ap.add_argument("--runs", default=None)
    args = ap.parse_args(argv)
    if args.runs:
        for run in args.runs.split(","):
            name, _, device = run.partition("@")
            cmd = [sys.executable, os.path.abspath(__file__), "--variant",
                   variant(name), "--device", device or args.device,
                   "--users", str(args.users), "--threads",
                   str(args.threads), "--edge", str(args.edge)]
            if args.mix:
                cmd += ["--mix", args.mix]
            subprocess.run(cmd, cwd=ROOT, check=True)
        return 0
    print(json.dumps(one_run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
