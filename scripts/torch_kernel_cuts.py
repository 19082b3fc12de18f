#!/usr/bin/env python3
"""Where the time of the port's two ALS kernels goes, on one CUDA card.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 scripts/torch_kernel_cuts.py

It builds variants of ``flink_ms_tpu_torch/csrc/gather_assembly.cu`` and
``csrc/cholesky_solve.cu``, each with one part cut out or one constant
changed, into ``build/scratch/cuts/``, then times every variant (median of
CUDA-event timed calls) on the user and the item half-sweep of the ML-20M
shape that ``chip_smoke.py`` trains (its seeded ratings, two iterations
from its init).  A cut changes what the kernel computes; the times say
what each part costs, not what any result is.  Prints the card line, the
registers and spills of the main instances, and one line per side and
kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from flink_ms_tpu_torch.ops import _build  # noqa: E402
from flink_ms_tpu_torch.ops import als as TA  # noqa: E402
from flink_ms_tpu_torch.ops import cholesky as CH  # noqa: E402
from flink_ms_tpu_torch.ops import gather_assembly as GA  # noqa: E402

OUT = os.path.join(ROOT, "build", "scratch", "cuts")
NEVER = "p.alpha == 12345.f"  # a run-time false the compiler cannot fold

FMA = "    if (active) {\n      for (int c = 0; c < cn; ++c) {"
GATHER = "    if (cn > 0) {\n      T* st = ring"
# (name, [(text, replacement), ...]) for csrc/gather_assembly.cu
ASSEMBLY = [
    ("base", []),
    ("no_fma", [(FMA, FMA.replace("active", NEVER))]),
    ("no_gather", [(GATHER, GATHER.replace("cn > 0", f"cn > 0 && {NEVER}"))]),
    ("no_fma_gather", [(FMA, FMA.replace("active", NEVER)),
                       (GATHER, GATHER.replace("cn > 0",
                                               f"cn > 0 && {NEVER}"))]),
    ("no_store", [("  for (int bt = 0; bt < nt; ++bt) {",
                   f"  for (int bt = 0; bt < nt && {NEVER}; ++bt) {{")]),
    # half the shared-memory reads of the multiply-add loop
    ("q_from_p", [("        load_vec<TS>(st + c * RS + tq * SPT, yq);",
                   "#pragma unroll\n        for (int t = 0; t < TS; ++t) "
                   "yq[t] = yp[t] * 0.5f;")]),
    ("ring4", [("constexpr int kStages = 3; ", "constexpr int kStages = 4; ")]),
    ("chunk16", [("constexpr int kChunk = 8; ", "constexpr int kChunk = 16; ")]),
]
FACTOR = "    for (int j = 0; j < KP; j += 2) {\n      if (j >= k) break;"
BACK = "    for (int j = KP - 1; j >= 0; --j) {\n      if (j >= k) continue;"
# for csrc/cholesky_solve.cu; "kp56" is the base library at KP = 56
SOLVE = [
    ("base", []),
    ("no_factor", [(FACTOR, FACTOR.replace("j >= k)", "j >= k || k > 0)"))]),
    ("no_back", [(BACK, BACK.replace("j >= k)", "j >= k || k > 0)"))]),
    # half the broadcast loads of the trailing update
    ("half_bcast", [("const float4*>(cv0 + c4);",
                     "const float4*>(cv0 + (c4 & ~7));"),
                    ("const float4*>(cv1 + c4);",
                     "const float4*>(cv1 + (c4 & ~7));")]),
    ("three_blocks", [("KP <= 56 ? 4 : 3)", "3)")]),
]


ARGTYPES = {  # the C entries' arguments (ops/gather_assembly.py, cholesky.py)
    "gather_assembly": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "cholesky_solve": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def build(kind, name, cuts):
    src = open(os.path.join(_build.CSRC, f"{kind}.cu")).read()
    for text, repl in cuts:
        if text not in src:
            raise SystemExit(f"{kind} {name}: the source no longer has "
                             f"{text!r}")
        src = src.replace(text, repl)
    path = os.path.join(OUT, f"{kind}_{name}")
    with open(path + ".cu", "w") as f:
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         path + ".so", path + ".cu"], stderr=subprocess.PIPE, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    print(S.card_line(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    procs = {("gather_assembly", n): build("gather_assembly", n, c)
             for n, c in ASSEMBLY}
    procs.update({("cholesky_solve", n): build("cholesky_solve", n, c)
                  for n, c in SOLVE})
    libs = {}
    for (kind, name), proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {kind} {name}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif ("IfLi10ELb0" in entry or "Li52E" in entry) and (
                    "registers" in line or "spill" in line):
                print(f"{kind} {name}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{kind}_{name}.so"))
        fn = getattr(lib, "gather_assembly_f32" if kind == "gather_assembly"
                     else "cholesky_solve_f32")
        fn.argtypes, fn.restype = ARGTYPES[kind], ctypes.c_int
        libs[(kind, name)] = lib
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def assemble(lib, y, idx, val):
        r, w = idx.shape
        k = y.shape[1]
        A = torch.empty((r, k, k), device=dev)
        b = torch.empty((r, k), device=dev)
        plan = GA.assembly_plan(k, 4)
        ys = GA.slot_table(y, plan.ts)
        err = lib.gather_assembly_f32(
            ys.data_ptr(), 0, y.shape[0], k, idx.data_ptr(), val.data_ptr(),
            r, w, 0, 40.0, A.data_ptr(), b.data_ptr(), plan.ts, plan.g,
            plan.rows_per_block, stream)
        assert err == 0, err

    def solve(lib, A, b, kp):
        x = torch.empty_like(b)
        err = lib.cholesky_solve_f32(A.data_ptr(), b.data_ptr(),
                                     x.data_ptr(), b.shape[0], b.shape[1],
                                     kp, stream)
        assert err == 0, err

    users, items, ratings = S.synth_ratings(S.N_USERS, S.N_ITEMS, S.NNZ, 0)
    problem = TA.prepare_blocked(users, items, ratings, 1)
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, S.RANK, gen).numpy(),
            TA.init_factors(problem.n_items, S.RANK, gen).numpy())
    cfg = TA.ALSConfig(num_factors=S.RANK, iterations=1, lambda_=S.LAMBDA)
    fit_fn, args = TA.compile_fit(problem, cfg, dev, init=init)
    uf, itf = fit_fn(2, *args)
    n_u = 2 * len(problem.u.widths) + 1
    for side, table, flat in (("user", itf, args[2:2 + n_u]),
                              ("item", uf, args[2 + n_u:])):
        buckets = [(flat[2 * j], flat[2 * j + 1])
                   for j in range(len(flat) // 2)]
        times = []
        for name, _ in ASSEMBLY:
            lib = libs[("gather_assembly", name)]
            ms = S.event_ms(lambda: [assemble(lib, table, i, v)
                                     for i, v in buckets], reps=5)
            times.append(f"{name} {ms:.3f}")
        print(f"assembly {side} half-sweep ms: " + ", ".join(times),
              flush=True)
        A, b = TA._assemble_normal_eqs(table, buckets, False, 40.0,
                                       torch.float32)
        cnt = flat[-1]
        A.diagonal(dim1=-2, dim2=-1).add_(
            (S.LAMBDA * cnt + torch.where(cnt > 0, 0.0, 1.0))[:, None])
        kp = CH.solve_plan(S.RANK)
        times = []
        for name, _ in SOLVE:
            lib = libs[("cholesky_solve", name)]
            ms = S.event_ms(lambda: solve(lib, A, b, kp), reps=10)
            times.append(f"{name} {ms:.3f}")
        lib = libs[("cholesky_solve", "base")]
        ms = S.event_ms(lambda: solve(lib, A, b, 56), reps=10)
        times.append(f"kp56 {ms:.3f}")
        print(f"solve {side} half-sweep ms (kp {kp}): " + ", ".join(times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
