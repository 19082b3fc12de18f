#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: blocked ALS training and
CoCoA SVM training, each through its hand-written CUDA kernels.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing lines of its own (``[smoke] ...``):

1. card   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build  — all four CUDA kernels built by nvcc from
            ``flink_ms_tpu_torch/csrc``, in parallel;
3. checks — each ALS kernel held against its plain torch version on the card:
            the batched Cholesky solve for k in {1,3,8,16,50,64,100,128} at
            a ragged n through both entry layouts (and against a float64
            solve), the bucket assembly on every ML-20M-shape bucket of both
            sides (explicit, implicit, bf16 table);
4. main   — ``als_fit``'s sweep at the ML-20M shape (138,493 users x 26,744
            items, 20M uniform ratings from seed 0, rank 50, lambda 0.1)
            through both kernels, first as a user calls it, then in the
            fused assembly+solve mode (the solve's per-chunk entry), from
            the same init: sec/iter (1 vs N iterations, median), train RMSE
            after 1, 2, 3 iterations of ``als_fit``, and each kernel's
            launch count on that path alone; then each side's half-sweep
            from the trained factors, with the kernel and with the plain
            assembly, against a float64 assembly and solve; and one
            iteration under torch.profiler for the device's idle share;
5. times  — at the main path's shapes, each kernel's median time beside its
            bound, its plain version's time and a library yardstick;
6. SVM checks — the margin gather and the Δw scatter-add against their
            plain versions: at the RCV1 shape, at ragged shapes (L = 1,
            L = 33, row counts off the block, duplicate ids, zero pads), and
            the scatter-add through both of its branches (RCV1's d in shared
            memory, news20.binary's d = 1,355,191 in device memory);
7. SVM main — CoCoA training at the RCV1 shape of ``bench_sections.py``
            (700,000 x 47,236, 70 nnz per row, 5% label flips, K 8,192,
            86 local steps, add mode, sigma' 8, lambda 1e-4) on the gram
            engine through both kernels: sec/round (1 vs 10 rounds, median
            of 3), set-up seconds, the hinge+reg objective after 1 and 10
            rounds of ``svm_fit``, each kernel's launch count on that
            path alone, and two rounds under torch.profiler for the
            device's idle share;
8. SVM cross-checks — at n 50,000 and K 512, the gram engine (both
            kernels) against the scatter engine (no kernel), and a
            4 + 3 + 3-round segmented fit against a 10-round one;
9. SVM times — each SVM kernel at the RCV1 shape beside its bound, its
            plain version and a library yardstick.

It then prints one JSON line of the kernels, the card line, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero, and
without CUDA (or without the package beside this file) it exits non-zero
before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N_USERS, N_ITEMS, NNZ, RANK, LAMBDA = 138_493, 26_744, 20_000_000, 50, 0.1
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit):
# HBM3 bandwidth and non-tensor f32 rate.  TF32 is excluded by the parity
# contract, so the f32 rate bounds the arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SECTOR = 32  # bytes: the unit in which the card reads device memory

# CoCoA SVM at the RCV1 shape and settings of bench_sections.py:89-120
SVM_N, SVM_D, SVM_NNZ, SVM_FLIP = 700_000, 47_236, 70, 0.05
SVM_K, SVM_ROUNDS, SVM_SIGMA, SVM_LAMBDA = 8192, 10, 8.0, 1e-4
SVM_SMALL_N, SVM_SMALL_K = 50_000, 512  # the cross-checks' reduced scale
NEWS20_D = 1_355_191  # news20.binary's features: past shared memory
# the repo's cross-engine tolerance (tests/test_svm.py:275)
SVM_RTOL, SVM_ATOL = 2e-4, 1e-6
# the JAX package's hinge+reg objective after 10 rounds of this workload
# (bench_sections.py run_svm_section, recorded in BENCH_DETAIL_r05.json);
# the port draws other step indices, so it is held within 1%
SVM_REF_OBJECTIVE = 0.938597


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def synth_ratings(n_users, n_items, nnz, seed=0):
    """Uniform synthetic ratings: a copy of ``bench.py`` ``synth_ratings``
    (its default, uniform branch)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, nnz)
    items = rng.integers(0, n_items, nnz)
    ratings = rng.uniform(1.0, 5.0, nnz)
    return users, items, ratings


def synth_rcv1(n, d, nnz_row, seed=0, flip_p=SVM_FLIP):
    """RCV1-binary-shaped synthetic data: a copy of ``bench_sections.py``
    ``synth_rcv1`` (its default 5% label flips), as the port's
    ``SparseData``."""
    from flink_ms_tpu_torch.core.formats import SparseData

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz_row), dtype=np.int64)
    val = rng.normal(size=(n, nnz_row)) / np.sqrt(nnz_row)
    w_true = rng.normal(size=d)
    y = np.sign(np.einsum("nl,nl->n", val, w_true[idx]))
    y[y == 0] = 1
    if flip_p > 0:
        y = np.where(rng.uniform(size=n) < flip_p, -y, y)
    return SparseData(
        labels=y,
        indptr=np.arange(0, (n + 1) * nnz_row, nnz_row),
        indices=idx.ravel(),
        values=val.ravel(),
        n_features=d,
    )


def margin_gather_bytes(rows: int, L: int, d: int) -> int:
    """Bytes the margin gather must move: int32 idx and f32 val of every
    slot read once, the f32 weight vector read once, the f32 margin of
    every row written once."""
    return rows * L * 8 + d * 4 + rows * 4


def scatter_add_bytes(n: int, d: int) -> int:
    """Bytes the Δw scatter-add must move: int32 idx and f32 contrib of
    every entry read once, the f32 (d,) sum written once."""
    return n * 8 + d * 4


def lower_triangle_bytes(n: int, k: int) -> int:
    """Bytes of the sectors that hold the lower triangles (diagonal
    included) of n row-major k x k f32 matrices stored back to back: the
    least an SPD solve must read of A.  The layout repeats every `period`
    matrices, a whole number of sectors, so the count is exact."""
    mat = k * k * 4
    period = SECTOR // math.gcd(mat, SECTOR)

    def sectors(m: int) -> int:
        if m == 0:
            return 0
        rows = np.arange(k)
        start = (np.arange(m)[:, None] * mat + rows * k * 4).reshape(-1)
        end = start + np.tile((rows + 1) * 4, m)  # exclusive
        first, last = start // SECTOR, (end - 1) // SECTOR
        # row ranges ascend without overlapping, so two of them can share
        # only the sector where one ends and the next begins
        shared = int(np.count_nonzero(first[1:] == last[:-1]))
        return int((last - first + 1).sum()) - shared

    return (n // period * sectors(period) + sectors(n % period)) * SECTOR


def assembly_flops(nnz: int, k: int) -> int:
    """Operations the assembly needs for `nnz` real ratings: A is
    symmetric, so k(k+1)/2 multiply-adds for its lower triangle and k for
    b per rating; pads add nothing and need none."""
    return nnz * (k * (k + 1) + 2 * k)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def device_busy(torch, label, fn, top=5) -> None:
    """Run fn() once under torch.profiler and log its wall time (ended by
    torch.cuda.synchronize), the device time of every kernel, memset and
    copy in it, the device's idle share, and the `top` kernels by device
    time.  The profiler's own cost per operation lengthens the host's
    launch loop, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        log(f"profile {label}: wall {wall * 1e3:.3f} ms; device time not "
            f"measured (the profiler recorded no device activity)")
        return
    heavy = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    log(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}; top by device time: " + "; ".join(
            f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in heavy))


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale else diff


def phase_checks(torch, CH, GA, TA, problem, dev_args, dev):
    """Phase 3: each kernel against its plain version on the card."""
    rng = np.random.default_rng(1)
    for k in (1, 3, 8, 16, 50, 64, 100, 128):
        n = 1000 + k  # ragged against the warps per block
        G = rng.standard_normal((n, k, k)).astype(np.float32)
        A = G @ G.transpose(0, 2, 1) + 5.0 * np.eye(k, dtype=np.float32)
        b = rng.standard_normal((n, k)).astype(np.float32)
        x64 = np.linalg.solve(A.astype(np.float64),
                              b.astype(np.float64)[..., None])[..., 0]
        At = torch.from_numpy(A).to(dev)
        bt = torch.from_numpy(b).to(dev)
        plain = CH.cholesky_solve_plain(At, bt)
        for layout in ("lane_major", "batch_major"):
            x = CH.cholesky_solve_batched(At, bt, layout=layout)
            torch.cuda.synchronize()
            xn = x.cpu().numpy()
            over = np.max(np.abs(xn - x64) / (2e-4 + 2e-3 * np.abs(x64)))
            rel = rel_err(x, plain)
            log(f"check cholesky k={k} n={n} layout={layout}: "
                f"err/tol vs f64 {over:.4f} (rtol 2e-3, atol 2e-4), "
                f"kernel vs plain {rel:.3e} (limit 1e-4 of max|x|)")
            check(np.isfinite(xn).all() and over <= 1.0,
                  f"cholesky k={k} {layout} off the f64 solve")
            check(rel <= 1e-4, f"cholesky k={k} {layout} off its plain version")

    uf0, itf0 = dev_args[0], dev_args[1]
    n_u = 2 * len(problem.u.widths) + 1
    sides = (("user", itf0, dev_args[2:2 + n_u]),
             ("item", uf0, dev_args[2 + n_u:]))
    worst = 0.0
    for side, table, flat in sides:
        for implicit, ydt in ((False, torch.float32), (True, torch.float32),
                              (False, torch.bfloat16)):
            y_all = table.to(ydt)
            for j in range(len(flat) // 2):
                idx, val = flat[2 * j], flat[2 * j + 1]
                A1, b1 = GA.fused_bucket_assembly(y_all, idx, val,
                                                  torch.float32, implicit)
                torch.cuda.synchronize()
                A2, b2 = GA.bucket_assembly_plain(y_all, idx, val,
                                                  torch.float32, implicit)
                ea, eb = rel_err(A1, A2), rel_err(b1, b2)
                worst = max(worst, ea, eb)
                check(bool(torch.isfinite(A1).all()) and ea <= 1e-5
                      and eb <= 1e-5,
                      f"assembly {side} bucket {j} (w={idx.shape[1]}) "
                      f"implicit={implicit} {ydt}: A {ea:.3e}, b {eb:.3e}")
                check(bool((A1 == A1.transpose(1, 2)).all()),
                      f"assembly {side} bucket {j}: A not symmetric")
                del A1, b1, A2, b2
            log(f"check assembly {side} side, {len(flat) // 2} buckets, "
                f"implicit={implicit}, table {ydt}: max rel err "
                f"{worst:.3e} (limit 1e-5 of max|A|, max|b|)")


def time_fit(torch, fit_fn, dev_args, iters=5, repeats=3):
    """Steady-state sec/iter: the same sweep timed at 1 and at `iters`
    iterations, each run ending in torch.cuda.synchronize; the difference
    isolates per-iteration cost from fixed overhead.  Median over
    `repeats`.  -> (sec_per_iter, iterations run, the last run's (user,
    item) factor tables in slot order)."""
    ran = 0
    out = None

    def run(trip):
        nonlocal ran, out
        t0 = time.perf_counter()
        out = fit_fn(trip, *dev_args)
        torch.cuda.synchronize()
        ran += trip
        return time.perf_counter() - t0

    run(1), run(iters)  # warm-up
    while run(iters) < 0.5 and iters < 64:
        iters *= 2
    samples = []
    for _ in range(repeats):
        t1 = run(1)
        tn = run(iters)
        samples.append(max((tn - t1) / (iters - 1), 1e-9))
    return float(np.median(samples)), ran, out


FUSED_ENV = {"FLINK_MS_ALS_FUSED": "1",
             # 512 MiB of (C, k, k) systems per chunk: the big buckets of
             # both sides are cut, so the solve's per-chunk entry runs
             "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": str(512 << 20)}


def main_path(torch, TA, CH, GA, problem, fit, ratings_t, init, dev):
    """Phase 4: the sweep at the ML-20M shape through both kernels, first
    as ``als_fit`` runs by default, then in the fused assembly+solve mode,
    from the same seeded init.  Each path starts with both launch counts
    at 0 and reads them when it ends.  The sweep reads the mode at each
    call, so one ``compile_fit`` serves both timings."""
    users, items, ratings = ratings_t
    fit_fn, dev_args = fit
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    runs = {}
    for label, env in (("default", {}), ("fused", FUSED_ENV)):
        os.environ.update(env)
        try:
            CH.LAUNCHES = 0
            GA.LAUNCHES = 0
            sec, ran, (uf, itf) = time_fit(torch, fit_fn, dev_args)
            rmses, models = [], []
            for it in (1, 2, 3):
                cfg = TA.ALSConfig(num_factors=RANK, iterations=it,
                                   lambda_=LAMBDA)
                models.append(TA.als_fit(users, items, ratings, cfg, dev,
                                         problem=problem, init=init))
                rmses.append(TA.rmse(models[-1], users, items, ratings, dev))
                ran += it
            torch.cuda.synchronize()
            n_chol, n_asm = CH.LAUNCHES, GA.LAUNCHES
        finally:
            for key in env:
                del os.environ[key]
        log(f"main {label}: {sec:.6f} sec/iter (median of 3, 1 vs N "
            f"iterations); train RMSE after 1,2,3 iterations {rmses}; "
            f"launches over {ran} iterations: cholesky {n_chol}, "
            f"assembly {n_asm}")
        check(all(np.isfinite(rmses)) and rmses[0] > rmses[1] > rmses[2],
              f"{label}: train RMSE not finite and decreasing: {rmses}")
        if env:
            # one assembly launch per row chunk, each chunk solved at once;
            # more chunks than buckets means the per-chunk entry ran
            check(n_asm > n_buckets * ran and n_chol == n_asm,
                  f"{label}: {n_asm} assembly and {n_chol} solve launches "
                  f"for {ran} iterations of {n_buckets} buckets")
        else:
            check(n_chol == 2 * ran and n_asm == n_buckets * ran,
                  f"{label}: {n_chol} solve and {n_asm} assembly launches "
                  f"for {ran} iterations; expected {2 * ran} and "
                  f"{n_buckets * ran} ({n_buckets} buckets)")
        check(bool((uf[-1] == 0).all()) and bool((itf[-1] == 0).all()),
              f"{label}: a dummy slot's factor row is not zero")
        runs[label] = {"sec_per_iter": sec, "rmse": rmses, "uf": uf,
                       "itf": itf, "model": models[-1],
                       "launches": {"cholesky": n_chol, "assembly": n_asm}}
    # Chunks split the row axis only and each row is its own system, so
    # the two paths must agree entry by entry
    a, b = runs["fused"]["model"], runs["default"]["model"]
    for name, x, y in (("user", a.user_factors, b.user_factors),
                       ("item", a.item_factors, b.item_factors)):
        elem = ((x - y).abs() / (1e-5 + 1e-3 * y.abs())).max().item()
        log(f"main: {name} factors after 3 iterations, fused vs default: "
            f"component-wise {elem:.4f} of rtol 1e-3 / atol 1e-5, max "
            f"|diff| {(x - y).abs().max().item():.3e}")
        check(elem <= 1.0, f"the two paths' {name} factors disagree")
    return runs


def f64_check(torch, TA, GA, flat, y, side, rows=2000):
    """One half-sweep's solutions, with the plain and the kernel assembly,
    against float64 assembly and solve of the same systems, on the first
    `rows` rows of each bucket; also the systems' condition numbers."""
    counts = flat[-1]
    off = 0
    worst = {"plain": 0.0, "kernel": 0.0}
    conds = []
    for j in range(len(flat) // 2):
        idx, val = flat[2 * j][:rows], flat[2 * j + 1][:rows]
        cnt = counts[off:off + idx.shape[0]]
        off += int(flat[2 * j].shape[0])
        A64, b64 = GA.bucket_assembly_plain(y.double(), idx, val.double(),
                                            torch.float64)
        A64.diagonal(dim1=-2, dim2=-1).add_(LAMBDA * cnt.double()[:, None])
        x64 = torch.linalg.solve(A64, b64)
        conds.append(torch.linalg.cond(A64))
        for mode, assemble in (("plain", GA.bucket_assembly_plain),
                               ("kernel", GA.fused_bucket_assembly)):
            A, b = assemble(y, idx, val)
            x = TA._solve_factors(A, b, cnt, LAMBDA, True).double()
            err = ((x - x64).norm(dim=1) / x64.norm(dim=1)).max().item()
            worst[mode] = max(worst[mode], err)
    cond = torch.cat(conds)
    log(f"accuracy {side} half-sweep vs float64 ({cond.numel()} systems): "
        f"condition number median {cond.median().item():.1f}, max "
        f"{cond.max().item():.1f}; max row-wise error |x - x64| / |x64| "
        f"plain assembly {worst['plain']:.3e}, kernel assembly "
        f"{worst['kernel']:.3e} (limit 1e-3)")
    check(max(worst.values()) <= 1e-3,
          f"{side} half-sweep off its float64 solution: {worst}")


def phase_times(torch, TA, CH, GA, flat, itf):
    """Phase 5: each kernel at the main path's shapes (the user
    half-sweep, from the trained item factors) beside its bound, its plain
    version and a library yardstick.  -> JSON entries without launches."""
    k = RANK
    buckets = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
    counts = flat[-1]
    entries = []

    # -- bucket assembly: every user bucket, one launch each -----------------
    def asm_kernel():
        return [GA.fused_bucket_assembly(itf, i, v, torch.float32)
                for i, v in buckets]

    def asm_plain():
        return [GA.bucket_assembly_plain(itf, i, v) for i, v in buckets]

    def asm_library():
        out = []
        for i, v in buckets:
            y = torch.index_select(itf, 0, i.reshape(-1)).reshape(
                i.shape[0], i.shape[1], k)
            out.append((torch.einsum("rwk,rwl->rkl", y, y),
                        torch.einsum("rwk,rw->rk", y, v)))
        return out

    got, want = asm_kernel(), asm_plain()
    asm_err = max(max((a - c).abs().max().item(), (b - d).abs().max().item())
                  for (a, b), (c, d) in zip(got, want))
    del got, want
    nnz_pad = sum(int(i.numel()) for i, _ in buckets)
    nnz = int(counts.double().sum().item())  # this run's real ratings
    rows = sum(int(i.shape[0]) for i, _ in buckets)
    asm_flops = assembly_flops(nnz, k)
    # the table, idx and val as given (pads included) read once; A and b
    # written once
    asm_bytes = (itf.numel() * 4 + nnz_pad * 8 + rows * (k * k + k) * 4)
    asm = {
        "name": "fused_bucket_assembly", "route": "cuda",
        "source": "flink_ms_tpu_torch/csrc/gather_assembly.cu",
        "replaces": "flink_ms_tpu/ops/gather_assembly.py:97",
        "max_abs_err": asm_err,
        "ms": event_ms(asm_kernel, reps=5),
        "plain_ms": event_ms(asm_plain, reps=3),
        "library_ms": event_ms(asm_library, reps=3),
    }
    asm_ops_ms = asm_flops / PEAK_F32_FLOPS * 1e3
    asm_bytes_ms = asm_bytes / PEAK_BYTES_PER_S * 1e3
    asm["bound_ms"] = max(asm_ops_ms, asm_bytes_ms)
    asm["bound_by"] = "operations" if asm_ops_ms >= asm_bytes_ms else "bytes"
    entries.append(asm)
    log(f"times assembly, user half-sweep ({len(buckets)} buckets, "
        f"{rows} rows, nnz {nnz}, nnz_pad {nnz_pad}, "
        f"{asm_flops / 1e9:.2f} GFLOP, "
        f"{asm_bytes / 1e9:.3f} GB): kernel {asm['ms']:.3f} ms, plain "
        f"{asm['plain_ms']:.3f} ms, library {asm['library_ms']:.3f} ms, "
        f"bound {asm['bound_ms']:.3f} ms ({asm['bound_by']})")

    # -- batched solve: the user half-sweep's regularized systems -----------
    A, b = TA._assemble_normal_eqs(itf, buckets, False, 40.0, torch.float32)
    diag = LAMBDA * counts + torch.where(counts > 0, 0.0, 1.0)
    A.diagonal(dim1=-2, dim2=-1).add_(diag[:, None])
    n = int(b.shape[0])
    x_k = CH.cholesky_solve_batched(A, b)
    x_p = CH.cholesky_solve_plain(A, b)
    torch.cuda.synchronize()
    chol_err = (x_k - x_p).abs().max().item()
    check(rel_err(x_k, x_p) <= 1e-4,
          f"solve at the main path's shape off its plain version "
          f"({rel_err(x_k, x_p):.3e})")
    del x_k, x_p

    def chol_library():
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)

    # A's lower triangle, all an SPD solve reads of it, b read, x written
    chol_bytes = lower_triangle_bytes(n, k) + 2 * n * k * 4
    chol_flops = n * (k ** 3 / 3.0 + 2.0 * k * k)
    chol = {
        "name": "cholesky_solve_batched", "route": "cuda",
        "source": "flink_ms_tpu_torch/csrc/cholesky_solve.cu",
        "replaces": "flink_ms_tpu/ops/cholesky_pallas.py:40",
        "max_abs_err": chol_err,
        "ms": event_ms(lambda: CH.cholesky_solve_batched(A, b), reps=10),
        "plain_ms": event_ms(lambda: CH.cholesky_solve_plain(A, b), reps=3),
        "library_ms": event_ms(chol_library, reps=3),
    }
    c_ops_ms = chol_flops / PEAK_F32_FLOPS * 1e3
    c_bytes_ms = chol_bytes / PEAK_BYTES_PER_S * 1e3
    chol["bound_ms"] = max(c_ops_ms, c_bytes_ms)
    chol["bound_by"] = "operations" if c_ops_ms >= c_bytes_ms else "bytes"
    entries.insert(0, chol)
    log(f"times cholesky, user half-sweep (n={n}, k={k}, "
        f"{chol_bytes / 1e9:.3f} GB, {chol_flops / 1e9:.2f} GFLOP): kernel "
        f"{chol['ms']:.3f} ms, plain {chol['plain_ms']:.3f} ms, library "
        f"{chol['library_ms']:.3f} ms, bound {chol['bound_ms']:.3f} ms "
        f"({chol['bound_by']})")
    return entries


def item_side_times(torch, TA, CH, GA, flat, uf):
    """The same two kernels on the item half-sweep (log lines only)."""
    buckets = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
    ms = event_ms(lambda: [GA.fused_bucket_assembly(uf, i, v)
                           for i, v in buckets], reps=5)
    plain = event_ms(lambda: [GA.bucket_assembly_plain(uf, i, v)
                              for i, v in buckets], reps=3)
    A, b = TA._assemble_normal_eqs(uf, buckets, False, 40.0, torch.float32)
    A.diagonal(dim1=-2, dim2=-1).add_(
        (LAMBDA * flat[-1] + torch.where(flat[-1] > 0, 0.0, 1.0))[:, None])
    chol = event_ms(lambda: CH.cholesky_solve_batched(A, b), reps=10)
    log(f"times item half-sweep ({len(buckets)} buckets, n={b.shape[0]}): "
        f"assembly kernel {ms:.3f} ms, plain {plain:.3f} ms; cholesky "
        f"kernel {chol:.3f} ms")


def svm_layout(torch, gen, dev, C, H, L, d):
    """Random (C, H, L) int32 ids and f32 values on the card, with a
    duplicate id in every row (L > 1) and zero pad slots (id 0, value 0)
    at the tails of some rows, and a random f32 w (d,)."""
    idx = torch.randint(0, d, (C, H, L), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.randn((C, H, L), generator=gen, device=dev)
    if L > 1:
        idx[..., 1] = idx[..., 0]
    lens = torch.randint(0, L + 1, (C, H, 1), generator=gen, device=dev)
    tail = torch.arange(L, device=dev) >= lens
    idx[tail] = 0
    val[tail] = 0.0
    w = torch.randn(d, generator=gen, device=dev)
    return w, idx, val


def svm_checks(torch, SK, dev):
    """Phase 6: both SVM kernels against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(3)
    max_d = SK.scatter_shared_max_d(dev)
    log(f"svm scatter-add: shared-memory branch up to d = {max_d}")
    check(SVM_D <= max_d < NEWS20_D,
          f"d = {SVM_D} must take the shared branch and d = {NEWS20_D} the "
          f"global one; the shared branch ends at {max_d}")
    rows_pb = -(-SVM_N // SVM_K)
    # (C, H, L, d): the RCV1 shape, then ragged ones: one slot per row,
    # L = 33, row counts off the 8-row block, a single row
    margin_shapes = [(SVM_K, rows_pb, SVM_NNZ, SVM_D), (5, 37, 1, 11),
                     (7, 13, 33, 1000), (1001, 3, 70, SVM_D), (1, 1, 70, 300),
                     (3, 5, 2, 3)]
    for C, H, L, d in margin_shapes:
        w, idx, val = svm_layout(torch, gen, dev, C, H, L, d)
        got = SK.margin_gather(w, idx, val)
        torch.cuda.synchronize()
        rel = rel_err(got, SK.margin_gather_plain(w, idx, val))
        log(f"check margin_gather C={C} H={H} L={L} d={d}: kernel vs plain "
            f"{rel:.3e} (limit 1e-5 of max|out|)")
        check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
              f"margin_gather C={C} H={H} L={L} d={d} off its plain version")
    # (C, H, L, d): RCV1 (shared), ragged small ones (shared), 96,320
    # entries into 64 bins (contended), news20's d at a reduced n (global)
    scatter_shapes = [(SVM_K, rows_pb, SVM_NNZ, SVM_D), (5, 37, 1, 11),
                      (7, 13, 33, 1000), (16, 86, 70, 64),
                      (2000, 86, 70, NEWS20_D),
                      (9, 11, 33, NEWS20_D)]
    for C, H, L, d in scatter_shapes:
        _, idx, contrib = svm_layout(torch, gen, dev, C, H, L, d)
        got = SK.scatter_add_dw(idx, contrib, d)
        torch.cuda.synchronize()
        rel = rel_err(got, SK.scatter_add_plain(idx, contrib, d))
        branch = "shared" if d <= max_d else "global"
        log(f"check scatter_add_dw C={C} H={H} L={L} d={d} ({branch} "
            f"branch): kernel vs plain {rel:.3e} (limit 1e-5 of max|out|)")
        check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
              f"scatter_add_dw C={C} H={H} L={L} d={d} off its plain version")


def time_rounds(torch, fit, dev_args, rounds, repeats=3):
    """Steady-state sec/round: the same fit at 1 and at `rounds` rounds,
    each ended by torch.cuda.synchronize, the difference over rounds - 1,
    median of `repeats`.  -> (sec_per_round, rounds run)."""
    ran = 0

    def run(trip):
        nonlocal ran
        t0 = time.perf_counter()
        fit(trip, *dev_args)
        torch.cuda.synchronize()
        ran += trip
        return time.perf_counter() - t0

    run(1), run(rounds)  # warm-up
    samples = []
    for _ in range(repeats):
        t1 = run(1)
        tn = run(rounds)
        samples.append(max((tn - t1) / (rounds - 1), 1e-9))
    return float(np.median(samples)), ran


def svm_config(TS, problem, **kw):
    return TS.SVMConfig(iterations=SVM_ROUNDS,
                        local_iterations=problem.rows_per_block,
                        regularization=SVM_LAMBDA, mode="add",
                        sigma_prime=SVM_SIGMA, **kw)


def svm_main(torch, TS, SK, dev):
    """Phase 7: CoCoA at the RCV1 shape through both kernels.  The launch
    counts are set to 0 just before the path and read just after it.
    -> (the path's launch counts, the inputs of phase 9)."""
    t0 = time.perf_counter()
    data = synth_rcv1(SVM_N, SVM_D, SVM_NNZ, seed=0)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = TS.prepare_svm_blocked(data, SVM_K)
    prep_s = time.perf_counter() - t0
    cfg = svm_config(TS, problem)
    inner = TS._resolve_inner(problem, cfg)
    log(f"svm setup: {data.n_examples} x {data.n_features}, "
        f"{len(data.indices)} nnz, K {SVM_K}, {problem.rows_per_block} rows "
        f"per chain, L {problem.idx.shape[-1]}; synth {synth_s:.2f}s, "
        f"prepare_svm_blocked {prep_s:.2f}s (host, untimed); engine {inner}")
    check(inner == "gram", f"the auto engine chose {inner}, not gram")

    for key in SK.LAUNCHES:
        SK.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    fit, dev_args = TS.compile_svm_fit(problem, cfg, dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    # the Gram tensor built once more, alone, to time the build
    t0 = time.perf_counter()
    del dev_args[-1]
    dev_args.append(TS.build_gram(dev_args[1], dev_args[2], SVM_D))
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    sec, ran = time_rounds(torch, fit, dev_args, SVM_ROUNDS)
    objs = []
    for rounds in (1, SVM_ROUNDS):
        model = TS.svm_fit(data, dataclasses.replace(cfg, iterations=rounds),
                           dev, problem=problem)
        objs.append(model.hinge_loss(data, SVM_LAMBDA))
        ran += rounds
    torch.cuda.synchronize()
    launches = dict(SK.LAUNCHES)
    log(f"svm main: {sec:.6f} sec/round (median of 3, 1 vs {SVM_ROUNDS} "
        f"rounds); set-up: upload + Gram build {compile_s:.3f}s, Gram build "
        f"alone {gram_s:.3f}s; hinge+reg objective after 1 and "
        f"{SVM_ROUNDS} rounds {objs}; launches over {ran} rounds: "
        f"margin_gather {launches['margin_gather']}, scatter_add_dw "
        f"{launches['scatter_add_dw']}")
    check(all(np.isfinite(objs)) and objs[1] < 1.0 and objs[1] < objs[0],
          f"objective not finite, below 1.0 and falling: {objs}")
    ref_gap = abs(objs[1] - SVM_REF_OBJECTIVE) / SVM_REF_OBJECTIVE
    log(f"svm objective after {SVM_ROUNDS} rounds vs the JAX package's "
        f"{SVM_REF_OBJECTIVE}: relative gap {ref_gap:.3e} (limit 1e-2)")
    check(ref_gap <= 1e-2, "the objective is off the JAX package's")
    check(launches == {"margin_gather": ran, "scatter_add_dw": ran},
          f"{launches} launches for {ran} rounds; expected one of each per "
          f"round")
    device_busy(torch, "svm 2 rounds", lambda: fit(2, *dev_args))
    w, alpha = fit(SVM_ROUNDS, *dev_args)
    return launches, {"sec_per_round": sec, "objective": objs,
                      "idx": dev_args[1], "val": dev_args[2], "w": w,
                      "alpha": alpha}


def svm_cross_checks(torch, TS, dev):
    """Phase 8: at a reduced scale, the gram engine through both kernels
    against the scatter engine, which runs none, and a segmented fit
    against one long one."""
    data = synth_rcv1(SVM_SMALL_N, SVM_D, SVM_NNZ, seed=1)
    problem = TS.prepare_svm_blocked(data, SVM_SMALL_K)

    def over(got, want):
        return ((got - want).abs() / (SVM_ATOL + SVM_RTOL * want.abs())
                ).max().item()

    w = {inner: torch.from_numpy(TS.svm_fit(
        data, svm_config(TS, problem, inner=inner), dev,
        problem=problem).weights) for inner in ("gram", "scatter")}
    e_engine = over(w["gram"], w["scatter"])
    fit, dev_args = TS.compile_svm_fit(
        problem, svm_config(TS, problem, inner="gram"), dev)
    w_one, a_one = fit(SVM_ROUNDS, *dev_args)
    w_s, a_s = dev_args[0], dev_args[5]
    for start, n in ((0, 4), (4, 3), (7, 3)):
        args = list(dev_args)
        args[0], args[5] = w_s, a_s
        w_s, a_s = fit(n, *args, start=start)
    e_seg = max(over(w_s, w_one), over(a_s, a_one))
    log(f"svm cross-check n={SVM_SMALL_N} K={SVM_SMALL_K}: gram engine "
        f"(kernels) vs scatter engine {e_engine:.4f} of rtol {SVM_RTOL} / "
        f"atol {SVM_ATOL}, max|w| {w['scatter'].abs().max().item():.4f}; "
        f"4+3+3 rounds vs {SVM_ROUNDS} rounds (w and alpha) {e_seg:.4f}, "
        f"max |diff| {(w_s - w_one).abs().max().item():.3e}")
    check(e_engine <= 1.0, "the gram and the scatter engine disagree")
    check(e_seg <= 1.0, "the segmented fit disagrees with the one-shot fit")


def svm_times(torch, SK, main):
    """Phase 9: each SVM kernel at the RCV1 shape, from the trained w and
    alpha, beside its bound, its plain version and a library yardstick.
    -> JSON entries without launches."""
    import torch.nn.functional as Fn

    idx, val, w, alpha = main["idx"], main["val"], main["w"], main["alpha"]
    C, H, L = idx.shape
    rows, n, d = C * H, idx.numel(), w.numel()
    entries = []

    def entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes,
              flops):
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": library_ms}
        log(f"times {name} at the RCV1 shape ({n} entries, "
            f"{nbytes / 1e9:.4f} GB, {flops / 1e6:.1f} MFLOP): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']})")
        entries.append(e)

    def library_margin():
        return Fn.embedding_bag(idx.view(-1, L), w.view(-1, 1),
                                per_sample_weights=val.view(-1, L),
                                mode="sum").view(C, H)

    got = SK.margin_gather(w, idx, val)
    want = SK.margin_gather_plain(w, idx, val)
    lib = library_margin()
    torch.cuda.synchronize()
    check(rel_err(lib, want) <= 1e-5, "embedding_bag yardstick off the plain "
          "margin gather")
    entry("margin_gather", "flink_ms_tpu_torch/csrc/svm_margin_gather.cu",
          "flink_ms_tpu/ops/svm_kernels.py:44",
          (got - want).abs().max().item(),
          event_ms(lambda: SK.margin_gather(w, idx, val), reps=20),
          event_ms(lambda: SK.margin_gather_plain(w, idx, val), reps=5),
          event_ms(library_margin, reps=5),
          margin_gather_bytes(rows, L, d), 2 * n)
    del got, want, lib

    # the trained alpha stands in for a round's Δα
    contrib = val * alpha[:, :, None]
    got = SK.scatter_add_dw(idx, contrib, d)
    want = SK.scatter_add_plain(idx, contrib, d)
    torch.cuda.synchronize()
    plain_ms = event_ms(lambda: SK.scatter_add_plain(idx, contrib, d), reps=5)
    # the plain version is the library call, index_add_, so one time
    # serves both
    entry("scatter_add_dw", "flink_ms_tpu_torch/csrc/svm_scatter_add.cu",
          "flink_ms_tpu/ops/svm_kernels.py:86",
          (got - want).abs().max().item(),
          event_ms(lambda: SK.scatter_add_dw(idx, contrib, d), reps=20),
          plain_ms, plain_ms, scatter_add_bytes(n, d), n)
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] CUDA is not available: nothing to drive",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flink_ms_tpu_torch.ops import _build
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log("build: " + ", ".join(
        f"{name} {r['seconds']:.2f}s{' (cached)' if r['cached'] else ''}"
        for name, r in built.items())
        + f"; {time.perf_counter() - t0:.2f}s wall, in parallel")

    t0 = time.perf_counter()
    users, items, ratings = synth_ratings(N_USERS, N_ITEMS, NNZ, seed=0)
    problem = TA.prepare_blocked(users, items, ratings, 1)
    nnz_pad = {s: sum(r * w for r, w in zip(getattr(problem, s).rows,
                                            getattr(problem, s).widths))
               for s in "ui"}
    log(f"setup: {problem.n_users} users x {problem.n_items} items, "
        f"{problem.nnz} ratings; prepare_blocked "
        f"{time.perf_counter() - t0:.1f}s (host, untimed); buckets "
        f"user {len(problem.u.widths)} (nnz_pad {nnz_pad['u']}), item "
        f"{len(problem.i.widths)} (nnz_pad {nnz_pad['i']})")

    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, RANK, gen).numpy(),
            TA.init_factors(problem.n_items, RANK, gen).numpy())
    cfg = TA.ALSConfig(num_factors=RANK, iterations=1, lambda_=LAMBDA)
    fit_fn, dev_args = TA.compile_fit(problem, cfg, dev, init=init)
    phase_checks(torch, CH, GA, TA, problem, dev_args, dev)

    runs = main_path(torch, TA, CH, GA, problem, (fit_fn, dev_args),
                     (users, items, ratings), init, dev)
    final = runs["default"]
    device_busy(torch, "als 1 iteration, default path",
                lambda: fit_fn(1, *dev_args))
    n_u = 2 * len(problem.u.widths) + 1
    f64_check(torch, TA, GA, dev_args[2:2 + n_u], final["itf"], "user")
    f64_check(torch, TA, GA, dev_args[2 + n_u:], final["uf"], "item")
    entries = phase_times(torch, TA, CH, GA, dev_args[2:2 + n_u], final["itf"])
    item_side_times(torch, TA, CH, GA, dev_args[2 + n_u:], final["uf"])
    # `launches` is the main path's own count; each path's count beside it
    for e, key in zip(entries, ("cholesky", "assembly")):
        e["launches"] = final["launches"][key]
        e["launches_by_path"] = {label: run["launches"][key]
                                 for label, run in runs.items()}

    svm_checks(torch, SK, dev)
    svm_launches, svm_run = svm_main(torch, TS, SK, dev)
    svm_cross_checks(torch, TS, dev)
    for e in svm_times(torch, SK, svm_run):
        e["launches"] = svm_launches[e["name"]]
        e["launches_by_path"] = {"svm_rcv1": svm_launches[e["name"]]}
        entries.append(e)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{key: e[key] for key in keys}
                                  for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
