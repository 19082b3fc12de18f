#!/usr/bin/env python3
"""Run ``chip_smoke.py --geo-only`` (phase 22 alone) several times, each
beside a chosen load of this script's own processes, so that phase 22
(a)'s replication lag is read on a quiet host and on one made slow on
purpose.

    python3 scripts/geo_lag_runs.py [--runs plain,load8,...] [--out DIR]
        [--timeout S]

An arm is ``plain`` (nothing beside the run), ``load<N>`` (N processes
that spin in Python for the whole run), ``io<N>`` (N processes that each
append 4 KiB to a file of their own and ``fsync`` it, over and over, on
the filesystem of the run's temporary files, where phase 22 keeps its
journals), or several of these joined by ``+`` (``load8+io4``); an arm
that ends in ``@DIR`` runs ``DIR/chip_smoke.py`` (another tree, such as
the parent commit unpacked by ``git archive``) in place of this tree's.
Each run's log goes to ``<out>/geo_<i>.log`` (``<out>`` is
``build/scratch/geo_lag`` unless given); the script prints, for each
run, its exit code, its seconds, (a)'s lag line and the line that takes
(a)'s window apart, then the card line, and one JSON object of every
run last.  A run that fails (a)'s bound exits 1 and the next run still
starts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN = "while True:\n    pass\n"
FSYNC = """
import os, tempfile
fd, path = tempfile.mkstemp(prefix="geo_lag_io_")
os.unlink(path)
block = b"x" * 4096
n = 0
while True:
    os.write(fd, block)
    os.fsync(fd)
    n += 1
    if n % 256 == 0:
        os.ftruncate(fd, 0)
        os.lseek(fd, 0, 0)
"""


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def load_of(arm: str) -> list:
    """An arm -> the code of each process to run beside the run."""
    if arm == "plain":
        return []
    out = []
    for part in arm.split("+"):
        m = re.fullmatch(r"(load|io)(\d+)", part)
        if m is None:
            raise SystemExit(f"unknown arm {arm!r}: plain, load<N>, io<N> "
                             "or several joined by +")
        out += [SPIN if m.group(1) == "load" else FSYNC] * int(m.group(2))
    return out


def one_run(i: int, arm: str, out: str, timeout_s: float) -> dict:
    load, _, root = arm.partition("@")
    root = os.path.join(ROOT, root) if root else ROOT
    spinners = [subprocess.Popen([sys.executable, "-c", code])
                for code in load_of(load)]
    path = os.path.join(out, f"geo_{i}.log")
    t0 = time.perf_counter()
    try:
        with open(path, "w") as f:
            # a session of its own, so that a run cut by the time limit is
            # ended with every process it started
            run = subprocess.Popen(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--geo-only"], cwd=root, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
            try:
                rc = run.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                rc = 124
            finally:
                try:
                    os.killpg(run.pid, signal.SIGKILL)
                except OSError:
                    pass
                run.wait()
    finally:
        for p in spinners:
            p.kill()
        for p in spinners:
            p.wait()
    seconds = time.perf_counter() - t0
    with open(path, errors="replace") as f:
        text = f.read()
    lines = {k: next((ln for ln in text.splitlines() if k in ln), None)
             for k in ("lag under forwarded SGD", "window taken apart",
                       "geo phase:", "FAIL")}
    p99 = re.search(r"p99 ([0-9.]+) ms over", lines["lag under forwarded SGD"]
                    or "")
    return {"run": i, "arm": arm, "rc": rc, "seconds": round(seconds, 1),
            "lag_p99_ms": float(p99.group(1)) if p99 else None,
            "log": os.path.relpath(path, ROOT), "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="plain,load8")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "scratch",
                                                  "geo_lag"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    arms = [a for a in args.runs.split(",") if a]
    for a in arms:
        load_of(a.partition("@")[0])
    os.makedirs(args.out, exist_ok=True)
    got = []
    for i, arm in enumerate(arms, 1):
        r = one_run(i, arm, args.out, args.timeout)
        got.append(r)
        print(f"run {i} ({arm}): rc {r['rc']}, {r['seconds']} s, lag p99 "
              f"{r['lag_p99_ms']} ms", flush=True)
        for ln in r["lines"].values():
            if ln:
                print("  " + ln, flush=True)
    print(card_line())
    print(json.dumps({"runs": [{k: v for k, v in r.items() if k != "lines"}
                               for r in got]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
