#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one CUDA card.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 scripts/torch_kernel_cuts.py [--only als|svm]
        [--old-csrc DIR]

It builds variants of the kernels' sources, each with one part cut out or
one constant changed, into ``build/scratch/cuts/``, then times every
variant (median of CUDA-event timed calls):

- ALS: ``flink_ms_tpu_torch/csrc/gather_assembly.cu`` and
  ``csrc/cholesky_solve.cu`` on the user and the item half-sweep of the
  ML-20M shape that ``chip_smoke.py`` trains (its seeded ratings, two
  iterations from its init);
- SVM: ``csrc/svm_scatter_add.cu`` and ``csrc/svm_margin_gather.cu`` on
  the RCV1-shaped layout that ``chip_smoke.py`` trains (its seeded data,
  K 8,192), with a random w and Δα.  ``--old-csrc DIR`` also builds the
  earlier, scalar designs of the two SVM sources (a grid-stride
  scatter-add with one 4-byte load per atomic, one warp per row in the
  margin gather) from DIR, the ``csrc`` directory of a checkout of a
  commit that has them, with their own cuts, and times them beside the
  current ones.

A cut changes what the kernel computes; the times say what each part
costs, not what any result is.  Prints the card line, the registers and
spills of the main instances, and one line per side and kernel.
"""

from __future__ import annotations

import argparse
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
from flink_ms_tpu_torch.ops import svm as TS  # noqa: E402
from flink_ms_tpu_torch.ops import svm_kernels as SK  # noqa: E402

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


# a run-time false in both SVM sources
D_NEVER = "d == -7"
# the earlier, scalar SVM sources (``--old-csrc``); "no_loads" stands
# hashed bins below RCV1's d and a contribution of 1 in for the loads
OLD_SMEM_LOOP = ("    const int f = idx[e];\n"
                 "    if (f >= 0 && f < d) atomicAdd(&acc[f], contrib[e]);\n"
                 "  }\n  __syncthreads();")
# with its bins left at zero a block would flush none of them: these
# variants flush every bin, as the base does at RCV1's density
OLD_EVERY_BIN = ("    if (v != 0.f) atomicAdd(&out[f], v);",
                 "    atomicAdd(&out[f], v);")
SVM_OLD = {
    "svm_scatter_add": [
        ("base", []),
        ("no_flush", [("    if (v != 0.f) atomicAdd(&out[f], v);",
                       f"    if (v != 0.f && {D_NEVER}) "
                       "atomicAdd(&out[f], v);")]),
        # the loads summed into a register, written once under a false
        ("no_smem_atomics", [
            ("  const long long stride = (long long)gridDim.x * blockDim.x;\n"
             "  for (long long e = (long long)blockIdx.x * blockDim.x + "
             "threadIdx.x; e < n;\n       e += stride) {\n" + OLD_SMEM_LOOP,
             "  const long long stride = (long long)gridDim.x * blockDim.x;\n"
             "  float sink = 0.f;\n"
             "  for (long long e = (long long)blockIdx.x * blockDim.x + "
             "threadIdx.x; e < n;\n       e += stride) {\n"
             "    const int f = idx[e];\n"
             "    if (f >= 0 && f < d) sink += contrib[e];\n"
             f"  }}\n  if ({D_NEVER}) acc[0] = sink;\n  __syncthreads();"),
            OLD_EVERY_BIN]),
        ("no_loads", [
            (OLD_SMEM_LOOP,
             "    const int f = (int)((unsigned)e * 2654435761u >> 17);\n"
             "    atomicAdd(&acc[f], 1.f);\n  }\n  __syncthreads();"),
            OLD_EVERY_BIN]),
    ],
    "svm_margin_gather": [
        ("base", []),
        ("no_gather", [("    if (f >= 0 && f < d) acc += __ldg(w + f) * v;",
                        "    if (f >= 0 && f < d) acc += v;")]),
    ],
}
# the current SVM sources
FOLD = ("      (long long)gridDim.x * blockDim.x, [&](int f, float v) {\n"
        "        if ((unsigned)f < (unsigned)d) atomicAdd(acc + f, v);\n"
        "      });\n  __syncthreads();")
EVERY_BIN = ("    if (v != 0.f) atomicAdd(out + f, v);",
             "    atomicAdd(out + f, v);")
LOADS = "      a = __ldcs(iv + v);\n      b = __ldcs(vv + v);"


def source_span(kind, first, last):
    """The text of csrc/<kind>.cu from the line that starts with `first`
    through the line that starts with `last`."""
    lines = open(os.path.join(_build.CSRC, f"{kind}.cu")).read().split("\n")
    a = next(i for i, x in enumerate(lines) if x.startswith(first))
    b = next(i for i, x in enumerate(lines) if i > a and x.startswith(last))
    return "\n".join(lines[a:b + 1])


ROW_OF = source_span("svm_scatter_add", "  long long r = (long long)((double)",
                     "  return r;")
ROW_SUMS = source_span("svm_margin_gather",
                       "      const unsigned e = (unsigned)l * kLine",
                       "      carry_row = __shfl_sync(")
SVM_NEW = {
    "svm_scatter_add": [
        ("base", []),
        ("no_flush", [("    if (v != 0.f) atomicAdd(out + f, v);",
                       f"    if (v != 0.f && {D_NEVER}) "
                       "atomicAdd(out + f, v);")]),
        ("no_smem_atomics", [
            ("  __syncthreads();\n  for_each_entry<kScaled>(",
             "  __syncthreads();\n  float sink = 0.f;\n"
             "  for_each_entry<kScaled>("),
            (FOLD, FOLD.replace("atomicAdd(acc + f, v)", "sink += v").replace(
                "  __syncthreads();",
                f"  if ({D_NEVER}) acc[0] = sink;\n  __syncthreads();")),
            EVERY_BIN]),
        # hashed bins below RCV1's d and a contribution of 1 for the loads
        ("no_loads", [
            (LOADS,
             "      a = make_int4((int)((unsigned)v * 2654435761u >> 17),"
             " (int)((unsigned)v * 2246822519u >> 17), (int)((unsigned)v * "
             "3266489917u >> 17), (int)((unsigned)v * 668265263u >> 17));\n"
             "      b = make_float4(1.f, 1.f, 1.f, 1.f);"),
            EVERY_BIN]),
        # the row of each vector by a 32-bit division (exact below 2^32
        # entries, as at RCV1), and the row scale not loaded
        ("row_u32", [(ROW_OF, "  return (long long)((unsigned)e / "
                              "(unsigned)L);")]),
        ("no_scale_loads", [("float s = __ldg(scale + r);",
                             "float s = (float)(r & 7);"),
                            ("s = __ldg(scale + ++r);",
                             "s = (float)(++r & 7);")]),
    ],
    "svm_margin_gather": [
        ("base", []),
        ("no_gather", [("? (kSharedW ? ws[i] : __ldg(w + i)) * p[q]",
                        "? p[q]")]),
        # w read through L1 and L2 although it fits shared memory
        ("w_in_l1", [("  if (shared_w)\n    e = vec",
                      f"  if (shared_w && {D_NEVER})\n    e = vec")]),
        # the loads and gathers summed per lane, no row sums
        ("no_rows", [
            ("  const unsigned uL = (unsigned)L;",
             "  const unsigned uL = (unsigned)L;\n  float sink = 0.f;"),
            (ROW_SUMS, "      sink += p[0] + p[1] + p[2] + p[3];"),
            ("  }\n}\n\ntemplate <bool kSharedW, bool kVec>",
             f"  }}\n  if ({D_NEVER}) out[0] = sink;\n}}\n\n"
             "template <bool kSharedW, bool kVec>")]),
        # the next line's loads issued after this line's row sums
        ("no_prefetch", [("      load_line(l + 1, nf, np);\n", ""),
                         ("#pragma unroll\n      for (int q = 0; q < 4; ++q) "
                          "f[q] = nf[q], p[q] = np[q];",
                          "      load_line(l + 1, f, p);")]),
    ],
}


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {  # the C entries' arguments (ops/gather_assembly.py, cholesky.py)
    "gather_assembly": [
        _P, _I, _LL, _I, _P, _P, _LL, _I, _I, ctypes.c_float, _P, _P, _I, _I,
        _I, _P],
    "cholesky_solve": [_P, _P, _P, _LL, _I, _I, _P],
}
ENTRY = {"gather_assembly": "gather_assembly_f32",
         "cholesky_solve": "cholesky_solve_f32",
         "svm_scatter_add": "scatter_add_f32",
         "svm_margin_gather": "margin_gather_f32"}
# the SVM C entries (ops/svm_kernels.py), and the earlier ones
ARGTYPES_NEW = {
    "svm_scatter_add": [_P, _P, _P, _LL, _I, _LL, _I, _I, _I, _P, _P],
    "svm_margin_gather": [_P, _LL, _P, _P, _LL, _I, _I, _I, _I, _I, _P, _P]}
ARGTYPES_OLD = {"svm_scatter_add": [_P, _P, _LL, _LL, _P, _P],
                "svm_margin_gather": [_P, _LL, _P, _P, _LL, _I, _P, _P]}


def build(kind, name, cuts, csrc=_build.CSRC, tag=""):
    src = open(os.path.join(csrc, f"{kind}.cu")).read()
    for text, repl in cuts:
        if text not in src:
            raise SystemExit(f"{kind} {name}: the source no longer has "
                             f"{text!r}")
        src = src.replace(text, repl)
    path = os.path.join(OUT, f"{kind}{tag}_{name}")
    with open(path + ".cu", "w") as f:
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", path + ".so", path + ".cu"],
        stderr=subprocess.PIPE, text=True)


def finish(procs, argtypes):
    """Wait for the builds; print the registers and spills of the main
    instances; -> {(kind, name): the C entry}."""
    fns = {}
    for (kind, name, tag), proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {kind}{tag} {name}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif ("IfLi10ELb0" in entry or "Li52E" in entry
                  or kind.startswith("svm")) and (
                    "registers" in line or "spill" in line):
                print(f"{kind}{tag} {name}: "
                      f"{line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{kind}{tag}_{name}.so"))
        fn = getattr(lib, ENTRY[kind])
        fn.argtypes = argtypes(kind, tag)
        fn.restype = ctypes.c_int
        fns[(kind, name, tag)] = fn
    return fns


def als_cuts() -> None:
    procs = {("gather_assembly", n, ""): build("gather_assembly", n, c)
             for n, c in ASSEMBLY}
    procs.update({("cholesky_solve", n, ""): build("cholesky_solve", n, c)
                  for n, c in SOLVE})
    fns = finish(procs, lambda kind, tag: ARGTYPES[kind])
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def assemble(fn, y, idx, val):
        r, w = idx.shape
        k = y.shape[1]
        A = torch.empty((r, k, k), device=dev)
        b = torch.empty((r, k), device=dev)
        plan = GA.assembly_plan(k, 4)
        ys = GA.slot_table(y, plan.ts)
        err = fn(ys.data_ptr(), 0, y.shape[0], k, idx.data_ptr(),
                 val.data_ptr(), r, w, 0, 40.0, A.data_ptr(), b.data_ptr(),
                 plan.ts, plan.g, plan.rows_per_block, stream)
        assert err == 0, err

    def solve(fn, A, b, kp):
        x = torch.empty_like(b)
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
                 b.shape[1], kp, stream)
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
            fn = fns[("gather_assembly", name, "")]
            ms = S.event_ms(lambda: [assemble(fn, table, i, v)
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
            fn = fns[("cholesky_solve", name, "")]
            ms = S.event_ms(lambda: solve(fn, A, b, kp), reps=10)
            times.append(f"{name} {ms:.3f}")
        fn = fns[("cholesky_solve", "base", "")]
        ms = S.event_ms(lambda: solve(fn, A, b, 56), reps=10)
        times.append(f"kp56 {ms:.3f}")
        print(f"solve {side} half-sweep ms (kp {kp}): " + ", ".join(times),
              flush=True)


def checked(fn, *args):
    def call():
        err = fn(*args)
        assert err == 0, err
    return call


def svm_call(kind, tag, fn, stream, w, idx, val, contrib, dalpha, rows, n,
             L, d, out_d, out_rows):
    """-> {form: a call of the C entry at the RCV1 shape}."""
    p = [t.data_ptr() for t in (w, idx, val, contrib, dalpha, out_d,
                                out_rows)]
    if tag:  # the earlier entries
        if kind == "svm_scatter_add":
            return {"": checked(fn, p[1], p[3], n, d, p[5], stream)}
        return {"": checked(fn, p[0], d, p[1], p[2], rows, L, p[6], stream)}
    limits = SK._device_limits(w.get_device())
    if kind == "svm_scatter_add":
        plan = SK.scatter_plan(n, d, *limits)
        return {f"[{form}]": checked(fn, p[1], src, scale, n, L, d,
                                     int(plan.shared), plan.blocks,
                                     plan.threads, p[5], stream)
                for form, src, scale in (("contrib", p[3], None),
                                         ("row_scale", p[2], p[4]))}
    plan = SK.margin_plan(rows, L, d, *limits)
    return {"": checked(fn, p[0], d, p[1], p[2], rows, L, plan.tile_rows,
                        int(plan.shared_w), plan.blocks, plan.threads, p[6],
                        stream)}


def svm_cuts(old_csrc) -> None:
    designs = [("", _build.CSRC, SVM_NEW)]
    if old_csrc:
        designs.insert(0, ("_old", old_csrc, SVM_OLD))
    procs = {}
    for tag, csrc, cuts in designs:
        for kind, variants in cuts.items():
            for name, c in variants:
                procs[(kind, name, tag)] = build(kind, name, c, csrc, tag)
    fns = finish(procs, lambda kind, tag: (ARGTYPES_OLD[kind] if tag
                                           else ARGTYPES_NEW[kind]))
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    data = S.synth_rcv1(S.SVM_N, S.SVM_D, S.SVM_NNZ, seed=0)
    problem = TS.prepare_svm_blocked(data, S.SVM_K)
    idx = torch.from_numpy(problem.idx).to(dev)
    val = torch.from_numpy(problem.val).to(dev)
    C, H, L = idx.shape
    rows, n, d = C * H, idx.numel(), S.SVM_D
    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn(d, generator=gen, device=dev)
    dalpha = torch.rand((C, H), generator=gen, device=dev)
    contrib = val * dalpha[:, :, None]
    out_d = torch.empty(d, device=dev)
    out_rows = torch.empty((C, H), device=dev)
    for tag, _, cuts in designs:
        for kind, variants in cuts.items():
            times = []
            for name, _ in variants:
                fn = fns[(kind, name, tag)]
                call = svm_call(kind, tag, fn, stream, w, idx, val, contrib,
                                dalpha, rows, n, L, d, out_d, out_rows)
                for form, f in call.items():
                    ms = S.event_ms(f, reps=10, calls=5)
                    times.append(f"{name}{form} {ms:.4f}")
            print(f"{kind}{tag or ''} RCV1 ms: " + ", ".join(times),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("als", "svm"))
    ap.add_argument("--old-csrc", help="csrc directory of the earlier, "
                    "scalar SVM sources, timed beside the current ones")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    print(S.card_line(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    if args.only != "svm":
        als_cuts()
    if args.only != "als":
        svm_cuts(args.old_csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
