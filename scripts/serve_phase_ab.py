#!/usr/bin/env python3
"""The serving phases of ``chip_smoke.py`` (10 and 11, with phases 1-9
that run before them in the same process) for two checkouts, to compare
their serving numbers within one run.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 scripts/serve_phase_ab.py --root A --root B --root B --root A

For each DIR, in the order given, a process of its own imports DIR's
``chip_smoke.py`` and runs its ``main`` up to the end of phase 11 (a
script that has phases after 11 is stopped where phase 12 would start;
one that ends at 11 runs whole).  After phase 11 the same process
repeats two of its one-shot serving measurements ``--samples`` times
(default 20): the batcher's 256 queries from 32 threads over phase 4's
model, and the 1M-row exact arm's p50 at B = 1 and queries/s at B = 32,
each through the package in DIR.  Each run's whole log is written to
``<out>/serve_ab_<n>.log`` (``--out``, default ``build/scratch/serve_ab``,
which git ignores).  The script prints the card line, then
one JSON line per run with the numbers read from its log: ALS sec/iter
(phase 4), SVM sec/round (phase 7), the serving phases' p50s, p99 and
queries/s, and the median, min and max of the repeated samples.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# key -> (pattern of a chip_smoke log line, its groups' names)
NUMBERS = {
    "als": (r"main default: ([\d.]+) sec/iter", ("sec_per_iter",)),
    "svm": (r"svm main: ([\d.]+) sec/round", ("sec_per_round",)),
    "topk_ml20m": (r"256 TOPK k=10 unbatched p50 ([\d.]+) ms, p99 ([\d.]+) ms",
                   ("p50_ms", "p99_ms")),
    "batcher_ml20m": (r"serve batched, 32 threads: ([\d.]+) queries/s",
                      ("qps",)),
    "exact_1m": (r"scale exact 1000000: p50 at B=1 ([\d.]+) ms .*?, "
                 r"([\d.]+) queries/s at B=32", ("p50_ms", "qps")),
    "exact_10m": (r"scale exact 10000000: p50 at B=1 ([\d.]+) ms .*?, "
                  r"([\d.]+) queries/s at B=32", ("p50_ms", "qps")),
    "ivf_10m": (r"scale ivf 10000000: p50 at B=1 ([\d.]+) ms .*?, "
                r"([\d.]+) queries/s at B=32", ("p50_ms", "qps")),
    "ivf_build": (r"scale ivf 10000000 x 16: build ([\d.]+)s", ("s",)),
}


class _Stop(Exception):
    pass


def batcher_handler(S, model, dev):
    """A handler over ``model`` as phase 10 builds one, warmed by one
    unbatched query -> (handler, user ids, phase 10's 256 query rows)."""
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    table = ModelTable()
    table.put_many(
        [(f"{u}-U", S.payload_of(r)) for u, r in
         zip(model.user_ids, model.user_factors.cpu().numpy())]
        + [(f"{i}-I", S.payload_of(r)) for i, r in
           zip(model.item_ids, model.item_factors.cpu().numpy())])
    handler = make_als_topk_handler(table, device=dev)
    u_ids = [str(u) for u in model.user_ids]
    qu = S.np.random.default_rng(0).integers(0, len(u_ids), 256)
    handler.batching = False
    handler(u_ids[qu[0]], S.TOPK_K)
    handler.batching = True
    return handler, u_ids, qu


def batcher_qps(S, handler, u_ids, qu) -> float:
    """Phase 10's batcher measurement once: the TOPK queries ``qu`` from 32
    threads -> queries/s."""
    barrier = threading.Barrier(32)

    def worker(t):
        barrier.wait()
        for j in range(t, len(qu), 32):
            handler(u_ids[qu[j]], S.TOPK_K)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(32)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return len(qu) / (time.perf_counter() - t0)


def exact_1m(S, torch, index, queries):
    """Phase 11's 1M exact measurement once -> (p50 ms at B = 1, queries/s
    at B = 32), as ``chip_smoke.scale_times`` takes them."""
    p50, _ = S.latency_ms(lambda j: index.topk(queries[j % len(queries)],
                                               S.SCALE_K), 200)
    frames = [queries[(32 * j) % 480:][:32] for j in range(33)]
    index.topk_many(frames[0], S.SCALE_K)
    t0 = time.perf_counter()
    for f in frames[1:]:
        index.topk_many(f, S.SCALE_K)
    return p50, 32 * 32 / (time.perf_counter() - t0)


def one(root: str, samples: int) -> int:
    """Run ``root``'s chip_smoke.main through phase 11 in this process,
    then repeat the batcher and the 1M exact measurements."""
    sys.path.insert(0, root)
    import chip_smoke as S

    if not os.path.abspath(S.__file__).startswith(root):
        raise SystemExit(f"imported {S.__file__}, not the script in {root}")
    serve, scale = S.serve_phase, S.serve_scale_phase

    def serve_phase(torch, run, *a):
        serve(torch, run, *a)
        handler, u_ids, qu = batcher_handler(S, run["model"], a[-1])
        for n in range(samples):
            S.log(f"[ab] batcher sample {n}: "
                  f"{batcher_qps(S, handler, u_ids, qu):.1f} queries/s")

    def serve_scale_phase(torch, dev):
        out = scale(torch, dev)
        rows, queries = S.make_catalog(S.SCALE_EXACT_ROWS, S.SCALE_D)
        index, _ = S.scale_index(torch, rows, [str(i) for i in
                                               range(len(rows))],
                                 dev, {"TPUMS_TOPK_TIER": "exact"})
        for n in range(samples):
            p50, qps = exact_1m(S, torch, index, queries)
            S.log(f"[ab] exact 1M sample {n}: p50 {p50:.4f} ms, "
                  f"{qps:.1f} queries/s")
        return out

    S.serve_phase, S.serve_scale_phase = serve_phase, serve_scale_phase
    if hasattr(S, "staged_phase"):
        def stop(*a, **kw):
            raise _Stop

        S.staged_phase = stop
    try:
        return S.main()
    except _Stop:
        S.log("stopped after phase 11")
        return 0


SAMPLES = {
    "batcher": (r"\[ab\] batcher sample \d+: ([\d.]+) queries/s", ("qps",)),
    "exact_1m": (r"\[ab\] exact 1M sample \d+: p50 ([\d.]+) ms, ([\d.]+) "
                 r"queries/s", ("p50_ms", "qps")),
}


def numbers(log: str) -> dict:
    out = {}
    for key, (pattern, names) in NUMBERS.items():
        m = re.search(pattern, log)
        if m:
            out[key] = {n: float(v) for n, v in zip(names, m.groups())}
    for key, (pattern, names) in SAMPLES.items():
        found = re.findall(pattern, log)
        for i, name in enumerate(names):
            vals = [float(v if len(names) == 1 else v[i]) for v in found]
            if vals:
                out[f"samples_{key}_{name}"] = {
                    "n": len(vals), "median": statistics.median(vals),
                    "min": min(vals), "max": max(vals)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="a checkout's root (repeatable; default: this one)")
    ap.add_argument("--samples", type=int, default=20,
                    help="repeats of the batcher and 1M exact measurements")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "scratch",
                                                  "serve_ab"),
                    help="directory of the runs' logs")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(os.path.abspath(args.one), args.samples)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if card.returncode != 0:
        print("nvidia-smi found no card", file=sys.stderr)
        return 2
    print(card.stdout.strip().splitlines()[0], flush=True)
    os.makedirs(args.out, exist_ok=True)
    rc = 0
    for n, root in enumerate(args.root or [ROOT]):
        root = os.path.abspath(root)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root, "--samples", str(args.samples)],
                           capture_output=True, text=True)
        log = r.stdout + r.stderr
        with open(os.path.join(args.out, f"serve_ab_{n}.log"), "w") as f:
            f.write(log)
        rc = rc or r.returncode
        print(json.dumps({"run": n, "root": root, "rc": r.returncode,
                          **numbers(log)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
