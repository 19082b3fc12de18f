#!/usr/bin/env python3
"""Host and per-call times of the SVM kernel wrappers, for two checkouts.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 scripts/svm_wrapper_times.py [--root DIR ...]

For each DIR (default: this checkout), in the order given, a process of
its own imports ``flink_ms_tpu_torch`` from DIR, builds its two SVM
kernels and times ``margin_gather``, ``scatter_add_dw`` and
``scatter_add_dw(..., row_scale=)`` on random inputs of the RCV1 shape
that ``chip_smoke.py`` trains (C 8,192 x H 86 x L 70, d 47,236): the
host's ms per call (``chip_smoke.host_ms``), the ms with one CUDA event
pair per call, and the device ms over runs of 10 calls
(``chip_smoke.event_ms``, as phase 9 times them).  It prints the card
line and one JSON line per DIR.  Give two checkouts as A B B A to compare
them within one run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def one(root: str) -> dict:
    import torch

    sys.path.insert(0, root)
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    if not SK.__file__.startswith(root):
        raise SystemExit(f"imported {SK.__file__}, not the package in {root}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    C, H, L, d = S.SVM_K, -(-S.SVM_N // S.SVM_K), S.SVM_NNZ, S.SVM_D
    idx = torch.randint(0, d, (C, H, L), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.rand((C, H, L), generator=gen, device=dev)
    alpha = torch.rand((C, H), generator=gen, device=dev)
    w = torch.randn(d, generator=gen, device=dev)
    contrib = val * alpha[:, :, None]
    calls = {
        "margin_gather": lambda: SK.margin_gather(w, idx, val),
        "scatter_add_dw": lambda: SK.scatter_add_dw(idx, contrib, d),
        "scatter_add_dw[row_scale]": lambda: SK.scatter_add_dw(
            idx, val, d, row_scale=alpha),
    }
    out = {"root": root}
    for name, fn in calls.items():
        out[name] = {"host_ms": S.host_ms(torch, fn),
                     "ms": S.event_ms(fn, reps=20),
                     "device_ms": S.event_ms(fn, reps=5, calls=10)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="a checkout's root (repeatable; default: this one)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(os.path.abspath(args.one))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    print(S.card_line(), flush=True)
    for root in args.root or [ROOT]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
