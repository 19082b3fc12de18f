#!/usr/bin/env python3
"""The rehearsal of ``chip_smoke.py`` phase 21 (c) in a process of its own,
with or without the profiling that phase 21 (c) runs beside it, to tell
what holds its open loop back.

Each run is ``run_rehearsal`` at the reference CLI's defaults at rank 50
(``chip_smoke.OBS_REHEARSAL``: 12 s at 120/240/480 q/s, 4 client threads,
the live autoscaler, a kill, the watch loop, 8 push subscribers) over a
2 x 2 group of ``--device`` members, in a fresh process per run:

- ``plain``: no profiler anywhere (``TPUMS_PROF=0`` in this process and
  every member) and no scrape of the members' profiles;
- ``profiled``: as phase 21 (c) runs it, a wall-clock profiler
  (``TPUMS_PROF_IDLE=1``) in every member and in this process, and a
  thread that scrapes every member's PROFILE each second.

``--threads`` overrides the engine's client threads (4), ``--edge`` puts
that many proxies in front of the group (phase 22 (d)).  Each run prints
one JSON line: achieved q/s, the schedule's largest lag, the run's
seconds, respawns, and per verb the p99 from the intended send and the
service p99 (from the actual send).

    python3 scripts/rehearsal_ab.py [--variant plain|profiled]
        [--device cuda] [--users 40000] [--threads 4] [--edge 0]
        [--runs plain,profiled,...]

``--runs`` runs each named variant in turn, each in a child process.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(args) -> dict:
    sys.path.insert(0, ROOT)
    if args.variant == "plain":
        os.environ["TPUMS_PROF"] = "0"
    else:
        os.environ["TPUMS_PROF_IDLE"] = "1"
    import chip_smoke
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.obs.workload import run_rehearsal

    kw = dict(chip_smoke.OBS_REHEARSAL, users=args.users)
    kw["threads"] = args.threads
    if args.edge:
        kw["edge"] = args.edge
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
    return {"variant": args.variant, "device": args.device,
            "users": args.users, "threads": args.threads,
            "edge": args.edge, "seconds": round(seconds, 3),
            "achieved_qps": wl["achieved_qps"],
            "max_sched_lag_s": wl["max_sched_lag_s"],
            "duration_s": wl["duration_s"], "respawns": respawns,
            "ok": rep["ok"], "errors": rep["errors"]["total"],
            "verbs": {v: {"p99_ms": s.get("p99_ms"),
                          "service_p99_ms": s.get("service_p99_ms"),
                          "service_p50_ms": s.get("service_p50_ms")}
                      for v, s in sorted(rep["verbs"].items())},
            "profiled_members": len(members)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=("plain", "profiled"),
                    default="plain")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=40_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--edge", type=int, default=0)
    ap.add_argument("--runs", default=None)
    args = ap.parse_args(argv)
    if args.runs:
        for variant in args.runs.split(","):
            cmd = [sys.executable, os.path.abspath(__file__), "--variant",
                   variant, "--device", args.device, "--users",
                   str(args.users), "--threads", str(args.threads),
                   "--edge", str(args.edge)]
            subprocess.run(cmd, cwd=ROOT, check=True)
        return 0
    print(json.dumps(one_run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
