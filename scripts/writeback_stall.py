#!/usr/bin/env python3
"""What a fleet member's large file writes do to another process's small
ones: the latency of a registry-style heartbeat write (a JSON file
written beside and ``os.replace``d over the entry, as
``serve/registry.py`` ``register`` does) while N processes each write
back an arena-sized file at once, as a fleet's members do at their
snapshot at ready and at their first checkpoint.

Each variant starts ``--procs`` writer processes of ``--mb`` MB each and,
in this process, a thread that rewrites a heartbeat entry every 10 ms and
times each write:

- ``copy``: the snapshot's copy (``Arena.sparse_copy_to``: ``pwrite`` of
  8 MB blocks into a new file), then one ``fsync`` (``quiesce_copy``);
- ``copy_serial``: the same, but the writers take turns through an
  ``flock`` on one lock file around the write and its ``fsync``;
- ``copy_chunked``: ``fdatasync`` after every ``--chunkMb`` MB, then the
  last ``fsync``;
- ``mmap``: every page of a mapping of the file dirtied (an arena after
  its replay), then ``fsync`` of the file (``Arena.flush``);
- ``mmap_serial``: the same through the ``flock``;
- ``idle``: no writer, the heartbeat writes alone for 2 s.

It prints one JSON line a variant: the variant's seconds, each writer's
seconds in its writes and in its syncs, and the heartbeat writes' count,
p50, p99 and largest latency and how many took 0.3 s or more.

    python3 scripts/writeback_stall.py [--procs 6] [--mb 275]
        [--chunkMb 32] [--variants idle,copy,copy_serial,...] [--dir DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

WRITER = r'''
import fcntl, json, mmap, os, sys, time
path, mb, chunk_mb, mode, lock = sys.argv[1:6]
size, block = int(mb) << 20, 8 << 20
data = os.urandom(block)
t = {"write": 0.0, "sync": 0.0}
lk = None
if lock != "-":
    lk = os.open(lock, os.O_RDWR | os.O_CREAT, 0o644)
if mode == "mmap":
    # the replay's writes come before the checkpoint, and outside the lock
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
    os.ftruncate(fd, size)
    mm = mmap.mmap(fd, size)
    t0 = time.perf_counter()
    for off in range(0, size, block):
        mm[off:off + block] = data[:min(block, size - off)]
    t["write"] = time.perf_counter() - t0
if lk is not None:
    fcntl.flock(lk, fcntl.LOCK_EX)
t_start = time.time()
if mode == "mmap":
    t0 = time.perf_counter()
    os.fsync(fd)
    t["sync"] = time.perf_counter() - t0
else:
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
    done = 0
    for off in range(0, size, block):
        t0 = time.perf_counter()
        done += os.pwrite(fd, data[:min(block, size - off)], off)
        t["write"] += time.perf_counter() - t0
        if mode == "chunked" and done % (int(chunk_mb) << 20) == 0:
            t0 = time.perf_counter()
            os.fdatasync(fd)
            t["sync"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    os.fsync(fd)
    t["sync"] += time.perf_counter() - t0
t["window"] = [t_start, time.time()]
if lk is not None:
    fcntl.flock(lk, fcntl.LOCK_UN)
os.close(fd)
print(json.dumps(t))
'''

MODES = {"copy": ("copy", False), "copy_serial": ("copy", True),
         "copy_chunked": ("chunked", False), "mmap": ("mmap", False),
         "mmap_serial": ("mmap", True)}


def heartbeat_writes(d, stop, out):
    """Rewrite one registry-style entry every 10 ms; each write's
    (start time, seconds)."""
    path, tmp = os.path.join(d, "entry.json"), os.path.join(d, "entry.tmp")
    while not stop.is_set():
        t0 = time.perf_counter()
        with open(tmp, "w") as f:
            json.dump({"job_id": "probe", "pid": os.getpid(),
                       "heartbeat": time.time()}, f)
        os.replace(tmp, path)
        out.append((time.time(), time.perf_counter() - t0))
        time.sleep(0.01)


def run(variant, args, d) -> dict:
    lat, stop = [], threading.Event()
    beat = threading.Thread(target=heartbeat_writes, args=(d, stop, lat),
                            daemon=True)
    t0 = time.perf_counter()
    beat.start()
    writers = []
    if variant == "idle":
        time.sleep(2.0)
    else:
        mode, serial = MODES[variant]
        lock = os.path.join(d, "writeback.lock") if serial else "-"
        procs = [subprocess.Popen(
            [sys.executable, "-c", WRITER, os.path.join(d, f"w{i}.dat"),
             str(args.mb), str(args.chunkMb), mode, lock],
            stdout=subprocess.PIPE, text=True) for i in range(args.procs)]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            writers.append(json.loads(out))
    seconds = time.perf_counter() - t0
    stop.set()
    beat.join(timeout=30)
    for name in os.listdir(d):
        os.unlink(os.path.join(d, name))
    ms = sorted(s * 1e3 for _, s in lat)

    def pct(q):
        return round(ms[min(int(q * len(ms)), len(ms) - 1)], 3) if ms \
            else None

    return {"variant": variant, "procs": 0 if variant == "idle"
            else args.procs, "mb": args.mb, "seconds": round(seconds, 3),
            "write_s": [round(w["write"], 3) for w in writers],
            "sync_s": [round(w["sync"], 3) for w in writers],
            "heartbeat_writes": len(ms), "p50_ms": pct(0.5),
            "p99_ms": pct(0.99), "max_ms": round(ms[-1], 3) if ms else None,
            "over_300ms": sum(1 for m in ms if m >= 300.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--mb", type=int, default=275)
    ap.add_argument("--chunkMb", type=int, default=32)
    ap.add_argument("--variants",
                    default="idle,copy,copy_serial,copy_chunked,mmap,"
                            "mmap_serial")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    d = tempfile.mkdtemp(prefix="tpums_writeback_", dir=args.dir)
    try:
        for variant in args.variants.split(","):
            if variant != "idle" and variant not in MODES:
                ap.error(f"unknown variant {variant!r}")
            print(json.dumps(run(variant, args, d)), flush=True)
    finally:
        os.rmdir(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
