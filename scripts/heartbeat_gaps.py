#!/usr/bin/env python3
"""Gaps between a fleet member's registry heartbeats while members replay a
seeded journal under load, in either package.

A 2-shard x 2-replica elastic group (the rehearsal's: every member with
the co-located update plane) replays ``obs/workload.py``'s seeded journal
of ``--users`` users and as many items at rank ``--dim``, at the
rehearsal's liveness (``TPUMS_HEARTBEAT_S`` 0.25, ``TPUMS_REPLICA_TTL_S``
1.5).  Once it is ready, ``--threads`` clients send GET and TOPK (the
first TOPK of a member builds its top-k index); after ``--killAfterS``
one member is SIGKILLed and respawned by its supervisor, and the load
goes on for ``--afterKillS`` more seconds.  A thread of this process
reads every registry entry each 5 ms and keeps each new ``heartbeat``
stamp.  It prints, for each member, its writes, its processes (one more
than its respawns) and its five largest gaps between stamps, then one
JSON line.  A gap that spans a kill is the kill's, not a late heartbeat:
it is reported apart.

    python3 scripts/heartbeat_gaps.py [--package port|reference]
        [--device cuda|cpu] [--users 40000] [--dim 50] [--threads 4]
        [--killAfterS 3] [--afterKillS 20] [--root DIR]
        [--stallDumps DIR] [--checkPointInterval MS]

``--root`` runs the package of another checkout (an unpacked ``git
archive`` of an earlier commit) for a comparison in one call.  The
reference package runs on the CPU only.  ``--stallDumps DIR`` starts, in
every member, ``chip_smoke.py``'s stall watchdog (a ``sitecustomize`` on
``PYTHONPATH``, armed by ``TPUMS_STALL_DIR``): when the member's threads
cannot run for 0.3 s, or its heartbeat is 0.3 s overdue, every thread's
stack is written to ``DIR/stall-<pid>.txt``, showing what held them back,
with the member's largest gap between heartbeats.
``--checkPointInterval MS`` sets the members' checkpoint interval (the
job's default is 60 s), so that their checkpoints, each a flush of the
member's arena, fall inside the load.
"""

import argparse
import json
import os
import random
import signal
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stall_watchdog() -> str:
    """``chip_smoke.STALL_WATCHDOG`` of this checkout (phase 22 runs the
    same watchdog in every process)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_watchdog", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STALL_WATCHDOG


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "reference"),
                    default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=40_000)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--killAfterS", type=float, default=3.0)
    ap.add_argument("--afterKillS", type=float, default=20.0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--stallDumps", default=None)
    ap.add_argument("--checkPointInterval", type=int, default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    os.environ.setdefault("TPUMS_HEARTBEAT_S", "0.25")
    os.environ.setdefault("TPUMS_REPLICA_TTL_S", "1.5")
    base = tempfile.mkdtemp(prefix="tpums_heartbeat_gaps_")
    os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(base, "registry")
    if args.stallDumps:
        site = os.path.join(base, "site")
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(stall_watchdog())
        os.makedirs(args.stallDumps, exist_ok=True)
        os.environ["TPUMS_STALL_DIR"] = os.path.abspath(args.stallDumps)
        os.environ["PYTHONPATH"] = site + os.pathsep + os.environ[
            "PYTHONPATH"]
    kw = {}
    if args.package == "reference":
        if args.device != "cpu":
            print("the reference package runs on the CPU only",
                  file=sys.stderr)
            return 2
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["TPUMS_TOPK_SHARDED"] = "0"
        pkg = "flink_ms_tpu"
    else:
        pkg = "flink_ms_tpu_torch"
        kw["device"] = args.device
    import importlib

    workload = importlib.import_module(f"{pkg}.obs.workload")
    elastic = importlib.import_module(f"{pkg}.serve.elastic")
    registry = importlib.import_module(f"{pkg}.serve.registry")
    t0 = time.perf_counter()
    journal = workload._seed_journal(base, "models", args.users, args.dim, 0)
    seed_s = time.perf_counter() - t0
    reg = os.environ["TPUMS_REGISTRY_DIR"]
    os.makedirs(reg, exist_ok=True)
    seen, stop = {}, threading.Event()

    def poll():
        while not stop.is_set():
            now = time.time()
            for name in os.listdir(reg):
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(reg, name)) as f:
                        e = json.load(f)
                except (OSError, ValueError):
                    continue
                if not isinstance(e, dict) or "heartbeat" not in e \
                        or "job_id" not in e:
                    continue
                stamps = seen.setdefault(e["job_id"], [])
                if not stamps or stamps[-1][0] != e["heartbeat"]:
                    stamps.append((e["heartbeat"], e.get("pid"), now))
            time.sleep(0.005)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    ctl = elastic.ScaleController(
        "hbgaps", journal.dir, "models", port_dir=os.path.join(base, "ports"),
        ready_timeout_s=600,
        extra_args=["--updatePlane", "true", "--pollInterval", "0.02"]
        + ([] if args.checkPointInterval is None else
           ["--checkPointInterval", str(args.checkPointInterval)]), **kw)
    counts, errors, t_kill = [0], [], None
    try:
        t0 = time.perf_counter()
        ctl.scale_to(2, replicas=2)
        ready_s = time.perf_counter() - t0

        def load(idx):
            rng = random.Random(idx)
            with elastic.ElasticClient("hbgaps", timeout_s=30) as c:
                while not stop.is_set():
                    u = rng.randrange(args.users)
                    try:
                        if rng.random() < 0.3:
                            c.topk("ALS_MODEL", str(u), 10)
                        else:
                            c.query_state("ALS_MODEL", f"{u}-U")
                        counts[0] += 1
                    except Exception as e:
                        errors.append(repr(e))
                    time.sleep(0.005)

        loaders = [threading.Thread(target=load, args=(i,), daemon=True)
                   for i in range(args.threads)]
        for t in loaders:
            t.start()
        time.sleep(args.killAfterS)
        victim = ctl.active_supervisor.procs[(0, 0)]
        t_kill = time.time()
        victim.send_signal(signal.SIGKILL)
        time.sleep(args.afterKillS)
    finally:
        stop.set()
        poller.join(timeout=10)
        ctl.stop(drop_topology=True)
    out = {"package": args.package, "device": args.device,
           "users": args.users, "dim": args.dim, "seed_s": round(seed_s, 3),
           "ready_s": round(ready_s, 3), "queries": counts[0],
           "errors": len(errors), "members": {}}
    for job, stamps in sorted(seen.items()):
        gaps, kill_gap = [], None
        for (a, pa, _), (b, pb, _) in zip(stamps, stamps[1:]):
            if pa != pb and t_kill is not None and a <= t_kill <= b:
                kill_gap = b - a
            else:
                gaps.append(b - a)
        pids = len({pid for _, pid, _ in stamps})
        top = sorted(gaps, reverse=True)[:5]
        out["members"][job] = {"writes": len(stamps),
                               "respawns": pids - 1,
                               "max_gaps_s": [round(g, 3) for g in top],
                               "kill_gap_s": (round(kill_gap, 3)
                                              if kill_gap else None)}
        print(f"{job}: {len(stamps)} writes, {pids - 1} respawns, largest "
              f"gaps {[round(g, 3) for g in top]} s"
              + (f", the kill's {kill_gap:.3f} s" if kill_gap else ""))
    out["max_gap_s"] = max((g for m in out["members"].values()
                            for g in m["max_gaps_s"]), default=None)
    out["respawns"] = sum(m["respawns"] for m in out["members"].values())
    ttl = registry.replica_ttl_s()
    print(f"{args.package} ({args.device}): {args.users} users x rank "
          f"{args.dim}; ready {ready_s:.2f}s; {counts[0]} queries, "
          f"{len(errors)} errors; largest gap {out['max_gap_s']} s against "
          f"a {ttl} s TTL; {out['respawns']} respawns for 1 kill")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
