#!/usr/bin/env python3
"""Time ``import torch`` in fresh Python processes, two ways: with this
environment as it is (where ``PYTHONDONTWRITEBYTECODE`` is set and the
installed torch ships no bytecode, each process compiles torch anew),
and with bytecode written and read under a prefix in the checkout, as
``chip_smoke.py``'s ``cache_bytecode`` sets it for every process of a
run (the first process writes it, the later ones read it).

    python3 scripts/torch_import_times.py [--runs N]

Prints each process's seconds to import torch (and, where CUDA is
available, to its first tensor on the card), the card line, and one
JSON object of both ways' times last.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = os.path.join(ROOT, "build", "pycache", "import-times")

CHILD = r"""
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
first = None
if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
print(json.dumps({"import_s": t1 - t0, "first_tensor_s": first}))
"""


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def timed(env, runs) -> list:
    out = []
    for _ in range(runs):
        got = subprocess.run([sys.executable, "-c", CHILD], env=env,
                             capture_output=True, text=True, timeout=300,
                             check=True)
        out.append(json.loads(got.stdout.strip().splitlines()[-1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    as_is = dict(os.environ)
    cached = {k: v for k, v in os.environ.items()
              if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = PREFIX
    shutil.rmtree(PREFIX, ignore_errors=True)
    try:
        res = {"as_is": timed(as_is, args.runs),
               "cached": timed(cached, args.runs)}
    finally:
        shutil.rmtree(PREFIX, ignore_errors=True)
    res["PYTHONDONTWRITEBYTECODE"] = os.environ.get("PYTHONDONTWRITEBYTECODE")
    for way in ("as_is", "cached"):
        for n, r in enumerate(res[way]):
            print(f"[import] {way} process {n}: import torch "
                  f"{r['import_s']:.3f}s, first tensor on the card "
                  + (f"{r['first_tensor_s']:.3f}s"
                     if r["first_tensor_s"] is not None else "n/a"))
    print(card_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
