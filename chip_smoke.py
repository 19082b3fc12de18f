#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: blocked ALS training and
CoCoA SVM training, each through its hand-written CUDA kernels, and top-k
serving of the trained ALS model.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing lines of its own (``[smoke] ...``):

1. card   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build  — all four CUDA sources built by nvcc from
            ``flink_ms_tpu_torch/csrc``, in parallel;
3. checks — each ALS kernel held against its plain torch version on the card:
            the batched Cholesky solve for k in {1,3,8,16,50,64,100,128} at
            n = 1000 + k and n = 5, on a row-offset slice of a larger batch,
            through both entry layouts (and against a float64 solve), and
            its refusals (non-contiguous A, float64, k = 129); the bucket
            assembly at ragged shapes (rating lists of 1, 31, 33, 1,120; k
            from 1 to 128; indices outside the table; f32 and bf16 tables;
            both modes; out= views at a row offset) and on every
            ML-20M-shape bucket of both sides (explicit, implicit, bf16);
4. main   — ``als_fit``'s sweep at the ML-20M shape (138,493 users x 26,744
            items, 20M uniform ratings from seed 0, rank 50, lambda 0.1)
            through both kernels, first as a user calls it, then in the
            fused assembly+solve mode (the solve's per-chunk entry), from
            the same init: sec/iter (1 vs N iterations, median), train RMSE
            after 1, 2, 3 iterations of ``als_fit``, and each kernel's
            launch count on that path alone; then each side's half-sweep
            from the trained factors, with the kernel and with the plain
            assembly, against a float64 assembly and solve; and one
            iteration under torch.profiler for the device's idle share,
            which must show no concatenation;
5. times  — at the main path's shapes, each kernel's median time beside its
            bound, its plain version's time and a library yardstick: the
            solve and the assembly on the user half-sweep, the solve's
            batch-major entry on one fused-path chunk, and both kernels on
            the item half-sweep with their bounds;
6. SVM checks — the margin gather and the Δw scatter-add, in its plain
            form and its row-scale form, against their plain versions: at
            the RCV1 shape and at ragged ones (L in {1, 2, 3, 5, 33, 70,
            71}, row counts off every tile and stage, duplicate ids, zero
            pads, rows all padding, indices outside [0, d), views off the
            16-byte grid), and both kernels through both of their branches
            (d at the shared-memory limit and one above it, RCV1's d in
            shared memory, news20.binary's d = 1,355,191 in device
            memory);
7. SVM main — CoCoA training at the RCV1 shape of ``bench_sections.py``
            (700,000 x 47,236, 70 nnz per row, 5% label flips, K 8,192,
            86 local steps, add mode, sigma' 8, lambda 1e-4) on the gram
            engine through both kernels (the scatter-add in its row-scale
            form): sec/round (1 vs 10 rounds, median of 3), set-up
            seconds, the hinge+reg objective after 1 and 10
            rounds of ``svm_fit``, each kernel's launch count on that
            path alone, and two rounds under torch.profiler for the
            device's idle share;
8. SVM cross-checks — at n 50,000 and K 512, the gram engine (both
            kernels) against the scatter engine (no kernel), and a
            4 + 3 + 3-round segmented fit against a 10-round one;
9. SVM times — each SVM kernel at the RCV1 shape beside its bound, its
            plain version and a library yardstick: the margin gather, the
            scatter-add on a materialised contribution and in its
            row-scale form, and the elementwise pass that form replaces;
10. serve — phase 4's ML-20M model in the port's ``ModelTable`` and served
            through ``make_als_topk_handler`` (no new kernel: a matrix
            product and a top-k): the first TOPK and its build, 256 TOPK
            (k 10, seed 0) unbatched with p50/p99 against a float64 top-k
            (one of them under torch.profiler), how a score's rounding
            depends on the rows of its product, the same queries through
            the batcher from 32 threads (equal replies, queries/s), 16
            TOPKV equal to their TOPK twins, 1,000 item rows rewritten in
            place (no rebuild), one new item through a background rebuild
            within 30 s, and the offline MSE of the model on its 20M
            ratings equal to phase 4's RMSE^2 at rtol 1e-4;
11. serve scale — the reference's retrieval benchmark arms at full size
            on the clustered catalog of ``scripts/ann_profile.py``, width
            16, k 100: 1M rows on the exact tier (p50 at B = 1, queries/s
            at B = 32, 64 lists against float64) and 10M rows on the IVF
            tier (nlist 4096, nprobe 64; it must be built) beside the
            exact tier: build seconds, dropped rows, recall probe, recall
            of 512 mixture queries (printed beside the 0.95 contract, not
            gated), p50 and queries/s, the IVF ids of 64 queries against a
            float64 re-rank of the same shortlists (the gate), and the auto
            tier serving exact under its recall gate and IVF above it.
            Every p50 is printed beside the exact scan's bytes bound, and
            one frame of each tier at B = 1 and 32 runs under
            torch.profiler.

Each kernel's ``ms`` is the median over calls timed one CUDA event pair
each, the wrapper's host work included where it outlasts the device's;
``device_ms`` is the device time over runs of 10 calls back to back.

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


def make_catalog(n: int, d: int, seed: int = 0):
    """Clustered item factors and user-like queries: a copy of
    ``scripts/ann_profile.py`` ``make_catalog``.  Items are a mixture of
    gaussians (items cluster by taste dimension); the 512 queries are
    smooth mixtures of cluster directions (users straddle tastes)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(16, min(256, n // 2000))
    cents = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_clusters, size=n)
    rows = cents[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.6
    w = rng.dirichlet(np.ones(4), size=512).astype(np.float32)
    picks = rng.integers(0, n_clusters, size=(512, 4))
    queries = np.einsum("qm,qmd->qd", w, cents[picks]).astype(np.float32)
    queries += rng.normal(size=queries.shape).astype(np.float32) * 0.2
    return rows, queries


def topk_agrees(cols, s64, k: int, rtol: float = 1e-5):
    """Whether a served top-k list, as the columns `cols` of the float64
    scores `s64` of its query, is their float64 top-k: k distinct columns
    whose scores, rank by rank, equal the float64 order statistics within
    `rtol` of the largest of them.  So the ids equal the float64 ones
    except where float64 scores lie that close together, as the k-th and
    (k+1)-th may.  -> (agrees, ids exactly equal)."""
    k = min(k, len(s64))
    top = np.argpartition(-s64, k - 1)[:k]
    want = top[np.lexsort((top, -s64[top]))]
    cols = list(cols)
    if len(cols) != k or len(set(cols)) != k:
        return False, False
    tol = rtol * np.abs(s64[want]).max()
    agrees = bool(np.all(np.abs(s64[cols] - s64[want]) <= tol))
    return agrees, cols == want.tolist()


def margin_gather_bytes(rows: int, L: int, d: int) -> int:
    """Bytes the margin gather must move: int32 idx and f32 val of every
    slot read once, the f32 weight vector read once, the f32 margin of
    every row written once."""
    return rows * L * 8 + d * 4 + rows * 4


def scatter_add_bytes(n: int, d: int, scale_rows: int = 0) -> int:
    """Bytes the Δw scatter-add must move: int32 idx and f32 values of
    every entry read once, the f32 row scale of each of `scale_rows` rows
    read once (the row_scale form), the f32 (d,) sum written once."""
    return n * 8 + scale_rows * 4 + d * 4


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


def assembly_bytes(rows: int, nnz_pad: int, table_numel: int, k: int) -> int:
    """Bytes the assembly must move: the f32 table, idx and val as given
    (pads included) read once; A and b of every row written once."""
    return table_numel * 4 + nnz_pad * 8 + rows * (k * k + k) * 4


def solve_bytes(n: int, k: int) -> int:
    """Bytes an SPD solve must move: A's lower triangle, b read, x
    written."""
    return lower_triangle_bytes(n, k) + 2 * n * k * 4


def solve_flops(n: int, k: int) -> float:
    return n * (k ** 3 / 3.0 + 2.0 * k * k)


def bound(flops: float, nbytes: float):
    """(the least ms the card could take, "operations" or "bytes"): the
    larger of the operations at the f32 rate and the bytes at the memory
    rate."""
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 1, calls: int = 1) -> float:
    """Median time of ``fn()`` in ms: one CUDA event pair around `calls`
    calls back to back, over `calls`.  With calls = 1 (each kernel's
    ``ms``) the time includes the host's work between the events when that
    outlasts the device's; a run of calls (``device_ms``) lets the host
    queue ahead of the device."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return float(np.median(times))


def host_ms(torch, fn, calls: int = 50) -> float:
    """The host's time per ``fn()`` call in ms, over `calls` calls issued
    back to back while the device works through them (the device's queue
    is not full, so the host never waits)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def device_busy(torch, label, fn, top=5) -> list:
    """Run fn() once under torch.profiler and log its wall time (ended by
    torch.cuda.synchronize), the device time of every kernel, memset and
    copy in it, the device's idle share, and the `top` kernels by device
    time.  The profiler's own cost per operation lengthens the host's
    launch loop, so the idle share is an upper bound.  -> the names of
    every operation and kernel recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    every = prof.key_averages()
    events = [e for e in every if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        log(f"profile {label}: wall {wall * 1e3:.3f} ms; device time not "
            f"measured (the profiler recorded no device activity)")
        return [e.key for e in every]
    heavy = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    log(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}; top by device time: " + "; ".join(
            f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in heavy))
    return [e.key for e in every]


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale else diff


def solve_checks(torch, CH, dev):
    """The batched solve against its plain version and a float64 solve,
    through both entry layouts, on a row-offset slice of a larger batch, at
    batch sizes off the warps per block and below the persistent grid; and
    the wrapper's refusals."""
    rng = np.random.default_rng(1)
    for k in (1, 3, 8, 16, 50, 64, 100, 128):
        for n in (1000 + k, 5):
            G = rng.standard_normal((n + 3, k, k)).astype(np.float32)
            A = G @ G.transpose(0, 2, 1) + 5.0 * np.eye(k, dtype=np.float32)
            b = rng.standard_normal((n + 3, k)).astype(np.float32)
            x64 = np.linalg.solve(A[3:].astype(np.float64),
                                  b[3:].astype(np.float64)[..., None])[..., 0]
            # rows 3.. of the batch: A starts off the allocation's alignment
            At = torch.from_numpy(A).to(dev)[3:]
            bt = torch.from_numpy(b).to(dev)[3:]
            plain = CH.cholesky_solve_plain(At, bt)
            for layout in ("lane_major", "batch_major"):
                x = CH.cholesky_solve_batched(At, bt, layout=layout)
                torch.cuda.synchronize()
                xn = x.cpu().numpy()
                over = np.max(np.abs(xn - x64) / (2e-4 + 2e-3 * np.abs(x64)))
                rel = rel_err(x, plain)
                log(f"check cholesky k={k} n={n} (offset 3, "
                    f"kp {CH.solve_plan(k)}) layout={layout}: err/tol vs f64 "
                    f"{over:.4f} (rtol 2e-3, atol 2e-4), kernel vs plain "
                    f"{rel:.3e} (limit 1e-4 of max|x|)")
                check(np.isfinite(xn).all() and over <= 1.0,
                      f"cholesky k={k} n={n} {layout} off the f64 solve")
                check(rel <= 1e-4,
                      f"cholesky k={k} n={n} {layout} off its plain version")
    A = torch.eye(4, device=dev).expand(3, 4, 4).contiguous()
    b = torch.ones(3, 4, device=dev)
    refusals = {"a non-contiguous A": (A.transpose(1, 2), b),
                "float64": (A.double(), b.double()),
                "k = 129": (torch.eye(129, device=dev)[None],
                            torch.ones(1, 129, device=dev))}
    for what, (a, bb) in refusals.items():
        try:
            CH.cholesky_solve_batched(a, bb)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure(f"the CUDA solve took {what}")
    log(f"check cholesky refusals: {', '.join(refusals)} raise")


def assembly_ragged_checks(torch, GA, dev):
    """The assembly against its plain version at ragged shapes: rating
    lists of 1, 31, 33 and 1,120, k from 1 to 128, pads of every length,
    an index past the table and one below it (zero rows), f32 and bf16
    tables, both modes, and out= views at a row offset of a larger
    tensor (rows outside them untouched)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    S, r = 5000, 67  # 67 rows: off every plan's rows per block
    worst = 0.0
    for w in (1, 31, 33, 1120):
        for k in (1, 8, 50, 64, 100, 128):
            y32 = torch.randn((S, k), generator=gen, device=dev)
            y32[-1] = 0.0  # the dummy slot the pads point at
            idx = torch.randint(0, S - 1, (r, w), generator=gen, device=dev,
                                dtype=torch.int32)
            val = torch.rand((r, w), generator=gen, device=dev) * 4 + 1
            lens = torch.randint(0, w + 1, (r, 1), generator=gen, device=dev)
            pad = torch.arange(w, device=dev) >= lens
            idx[pad] = S - 1
            val[pad] = 0.0
            idx[1, 0] = S + 7   # past the table: a zero row
            idx[2, w - 1] = -3  # below it: a zero row
            # the plain version reads a table with one more zero row, at
            # which both outside indices point
            idx_p = torch.where((idx < 0) | (idx >= S), S, idx)
            for ydt in (torch.float32, torch.bfloat16):
                y = y32.to(ydt)
                y_p = torch.cat([y, torch.zeros((1, k), dtype=ydt,
                                                device=dev)])
                for implicit in (False, True):
                    A = torch.full((r + 4, k, k), float("nan"), device=dev)
                    b = torch.full((r + 4, k), float("nan"), device=dev)
                    GA.fused_bucket_assembly(y, idx, val, implicit=implicit,
                                             out=(A[3:3 + r], b[3:3 + r]))
                    Ap, bp = GA.bucket_assembly_plain(y_p, idx_p, val,
                                                      implicit=implicit)
                    torch.cuda.synchronize()
                    ea = rel_err(A[3:3 + r], Ap)
                    eb = rel_err(b[3:3 + r], bp)
                    worst = max(worst, ea, eb)
                    what = (f"assembly w={w} k={k} {ydt} implicit={implicit} "
                            f"({GA.assembly_plan(k, y.element_size())})")
                    check(ea <= 1e-5 and eb <= 1e-5,
                          f"{what}: A {ea:.3e}, b {eb:.3e} off its plain "
                          f"version")
                    check(bool((A[3:3 + r] == A[3:3 + r].transpose(1, 2))
                               .all()), f"{what}: A not symmetric")
                    check(bool(torch.isnan(A[:3]).all()
                               and torch.isnan(A[3 + r:]).all()
                               and torch.isnan(b[:3]).all()
                               and torch.isnan(b[3 + r:]).all()),
                          f"{what}: wrote outside its out= views")
    log(f"check assembly ragged: w in (1, 31, 33, 1120), k in (1, 8, 50, 64, "
        f"100, 128), f32 and bf16 tables, both modes, out= views at row 3 of "
        f"{r + 4}: max rel err {worst:.3e} (limit 1e-5 of max|A|, max|b|)")


def phase_checks(torch, CH, GA, TA, problem, dev_args, dev):
    """Phase 3: each kernel against its plain version on the card."""
    solve_checks(torch, CH, dev)
    assembly_ragged_checks(torch, GA, dev)
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
            CH.BATCH_MAJOR_LAUNCHES = 0
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
            n_bm = CH.BATCH_MAJOR_LAUNCHES
        finally:
            for key in env:
                del os.environ[key]
        log(f"main {label}: {sec:.6f} sec/iter (median of 3, 1 vs N "
            f"iterations); train RMSE after 1,2,3 iterations {rmses}; "
            f"launches over {ran} iterations: cholesky {n_chol} (of them "
            f"batch-major {n_bm}), assembly {n_asm}")
        check(all(np.isfinite(rmses)) and rmses[0] > rmses[1] > rmses[2],
              f"{label}: train RMSE not finite and decreasing: {rmses}")
        if env:
            # one assembly launch per row chunk, each chunk solved at once;
            # more chunks than buckets means the per-chunk entry ran
            check(n_asm > n_buckets * ran and n_chol == n_asm and n_bm > 0,
                  f"{label}: {n_asm} assembly and {n_chol} solve launches "
                  f"({n_bm} batch-major) for {ran} iterations of "
                  f"{n_buckets} buckets")
        else:
            check(n_chol == 2 * ran and n_asm == n_buckets * ran
                  and n_bm == 0,
                  f"{label}: {n_chol} solve and {n_asm} assembly launches "
                  f"for {ran} iterations; expected {2 * ran} and "
                  f"{n_buckets * ran} ({n_buckets} buckets)")
        check(bool((uf[-1] == 0).all()) and bool((itf[-1] == 0).all()),
              f"{label}: a dummy slot's factor row is not zero")
        runs[label] = {"sec_per_iter": sec, "rmse": rmses, "uf": uf,
                       "itf": itf, "model": models[-1],
                       "launches": {"cholesky": n_chol, "assembly": n_asm,
                                    "cholesky_batch_major": n_bm}}
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
    asm_bytes = assembly_bytes(rows, nnz_pad, itf.numel(), k)
    asm = {
        "name": "fused_bucket_assembly", "route": "cuda",
        "source": "flink_ms_tpu_torch/csrc/gather_assembly.cu",
        "replaces": "flink_ms_tpu/ops/gather_assembly.py:97",
        "max_abs_err": asm_err,
        "ms": event_ms(asm_kernel, reps=5),
        "device_ms": event_ms(asm_kernel, reps=3, calls=10),
        "plain_ms": event_ms(asm_plain, reps=3),
        "library_ms": event_ms(asm_library, reps=3),
    }
    asm["bound_ms"], asm["bound_by"] = bound(asm_flops, asm_bytes)
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

    chol_bytes, chol_flops = solve_bytes(n, k), solve_flops(n, k)
    chol = {
        "name": "cholesky_solve_batched", "route": "cuda",
        "source": "flink_ms_tpu_torch/csrc/cholesky_solve.cu",
        "replaces": "flink_ms_tpu/ops/cholesky_pallas.py:40",
        "max_abs_err": chol_err,
        "ms": event_ms(lambda: CH.cholesky_solve_batched(A, b), reps=10),
        "device_ms": event_ms(lambda: CH.cholesky_solve_batched(A, b),
                              reps=3, calls=10),
        "plain_ms": event_ms(lambda: CH.cholesky_solve_plain(A, b), reps=3),
        "library_ms": event_ms(chol_library, reps=3),
    }
    chol["bound_ms"], chol["bound_by"] = bound(chol_flops, chol_bytes)
    entries.insert(0, chol)
    log(f"times cholesky, user half-sweep (n={n}, k={k}, "
        f"{chol_bytes / 1e9:.3f} GB, {chol_flops / 1e9:.2f} GFLOP): kernel "
        f"{chol['ms']:.3f} ms, plain {chol['plain_ms']:.3f} ms, library "
        f"{chol['library_ms']:.3f} ms, bound {chol['bound_ms']:.3f} ms "
        f"({chol['bound_by']})")

    # -- the batch-major entry: one fused-path row chunk of the user side ---
    C = min(int(FUSED_ENV["FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES"])
            // (3 * k * k * 4), n)  # rows per chunk (ops/als.py)
    Ac, bc = A[:C], b[:C]
    x_k = CH.cholesky_solve_batched(Ac, bc, layout="batch_major")
    x_p = CH.cholesky_solve_plain(Ac, bc)
    torch.cuda.synchronize()
    check(rel_err(x_k, x_p) <= 1e-4, "batch-major solve off its plain version")
    bm = {"name": "cholesky_solve_batched[batch_major]", "route": "cuda",
          "source": "flink_ms_tpu_torch/csrc/cholesky_solve.cu",
          "replaces": "flink_ms_tpu/ops/cholesky_pallas.py:97",
          "max_abs_err": (x_k - x_p).abs().max().item(),
          "ms": event_ms(lambda: CH.cholesky_solve_batched(
              Ac, bc, layout="batch_major"), reps=10),
          "device_ms": event_ms(lambda: CH.cholesky_solve_batched(
              Ac, bc, layout="batch_major"), reps=3, calls=10),
          "plain_ms": event_ms(lambda: CH.cholesky_solve_plain(Ac, bc),
                               reps=3),
          "library_ms": event_ms(lambda: torch.cholesky_solve(
              bc[..., None], torch.linalg.cholesky(Ac)), reps=3)}
    bm["bound_ms"], bm["bound_by"] = bound(solve_flops(C, k),
                                           solve_bytes(C, k))
    entries.insert(1, bm)
    log(f"times cholesky batch-major entry, one fused-path chunk (n={C}, "
        f"k={k}): kernel {bm['ms']:.3f} ms, plain {bm['plain_ms']:.3f} ms, "
        f"library {bm['library_ms']:.3f} ms, bound {bm['bound_ms']:.4f} ms "
        f"({bm['bound_by']})")
    return entries


def item_side_times(torch, TA, CH, GA, flat, uf):
    """The same two kernels on the item half-sweep, with their bounds (log
    lines only)."""
    k = RANK
    buckets = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
    ms = event_ms(lambda: [GA.fused_bucket_assembly(uf, i, v)
                           for i, v in buckets], reps=5)
    plain = event_ms(lambda: [GA.bucket_assembly_plain(uf, i, v)
                              for i, v in buckets], reps=3)
    A, b = TA._assemble_normal_eqs(uf, buckets, False, 40.0, torch.float32)
    A.diagonal(dim1=-2, dim2=-1).add_(
        (LAMBDA * flat[-1] + torch.where(flat[-1] > 0, 0.0, 1.0))[:, None])
    chol = event_ms(lambda: CH.cholesky_solve_batched(A, b), reps=10)
    rows = sum(int(i.shape[0]) for i, _ in buckets)
    nnz = int(flat[-1].double().sum().item())
    nnz_pad = sum(int(i.numel()) for i, _ in buckets)
    a_b, a_by = bound(assembly_flops(nnz, k),
                      assembly_bytes(rows, nnz_pad, uf.numel(), k))
    c_b, c_by = bound(solve_flops(int(b.shape[0]), k),
                      solve_bytes(int(b.shape[0]), k))
    log(f"times item half-sweep ({len(buckets)} buckets, n={b.shape[0]}, "
        f"nnz {nnz}, nnz_pad {nnz_pad}): assembly kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {a_b:.3f} ms ({a_by}); cholesky kernel "
        f"{chol:.3f} ms, bound {c_b:.4f} ms ({c_by})")


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


def at_offset(torch, t, offset):
    """A contiguous copy of t that starts `offset` elements into its
    allocation, off the 16-byte grid for offset % 4 != 0."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def svm_checks(torch, SK, dev):
    """Phase 6: both SVM kernels, and the scatter-add in both its forms
    (values alone, values with a row scale), against their plain versions.
    Every shape has rows whose slots are all padding and indices outside
    [0, d) (the kernels skip them; the plain versions, which cannot take
    them, get id 0 and value 0 there)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    max_d = SK.scatter_shared_max_d(dev)
    log(f"svm scatter-add and margin gather: shared-memory branch up to "
        f"d = {max_d}")
    check(SVM_D <= max_d < NEWS20_D,
          f"d = {SVM_D} must take the shared branch and d = {NEWS20_D} the "
          f"global one; the shared branch ends at {max_d}")
    rows_pb = -(-SVM_N // SVM_K)
    # (C, H, L, d, offsets of idx and val): the RCV1 shape; 259 rows (off
    # every tile of 64 or 128 rows, and the last tile's lines ragged) at
    # each L;
    # rows off the tile at RCV1's L and d; a single row; 96,320 entries
    # into 64 bins (contended); d at the shared limit and one above it;
    # news20.binary's d; views off the 16-byte grid, idx and val alike and
    # idx alone
    shapes = [(SVM_K, rows_pb, SVM_NNZ, SVM_D, 0, 0)]
    shapes += [(7, 37, L, 1000, 0, 0) for L in (1, 2, 3, 5, 33, 70, 71)]
    shapes += [(1001, 3, 70, SVM_D, 0, 0), (1, 1, 70, 300, 0, 0),
               (3, 5, 2, 3, 0, 0), (16, 86, 70, 64, 0, 0),
               (5, 37, 71, max_d, 0, 0), (5, 37, 33, max_d + 1, 0, 0),
               (2000, 86, 70, NEWS20_D, 0, 0), (9, 11, 33, NEWS20_D, 0, 0),
               (7, 37, 70, 1000, 1, 1), (7, 37, 5, 1000, 1, 0),
               (5, 37, 3, max_d + 1, 1, 1), (5, 37, 70, max_d + 1, 2, 0)]
    worst = 0.0
    for C, H, L, d, oi, ov in shapes:
        w, idx, val = svm_layout(torch, gen, dev, C, H, L, d)
        idx[0] = 0  # chain 0: every row padding
        val[0] = 0.0
        idx[-1, 0, 0] = d + 5
        idx[-1, -1, -1] = -3
        scale = torch.randn((C, H), generator=gen, device=dev)
        outside = (idx < 0) | (idx >= d)
        idx_p = torch.where(outside, 0, idx)
        val_p = torch.where(outside, 0.0, val)
        idx, val = at_offset(torch, idx, oi), at_offset(torch, val, ov)
        branch = "shared" if d <= max_d else "global"
        runs = (("margin_gather", SK.margin_gather(w, idx, val),
                 SK.margin_gather_plain(w, idx_p, val_p)),
                ("scatter_add_dw", SK.scatter_add_dw(idx, val, d),
                 SK.scatter_add_plain(idx_p, val_p, d)),
                ("scatter_add_dw[row_scale]",
                 SK.scatter_add_dw(idx, val, d, row_scale=scale),
                 SK.scatter_add_plain(idx_p, val_p, d, scale)))
        torch.cuda.synchronize()
        errs = []
        for name, got, want in runs:
            rel = rel_err(got, want)
            worst = max(worst, rel)
            errs.append(f"{name} {rel:.3e}")
            check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
                  f"{name} C={C} H={H} L={L} d={d} offsets ({oi}, {ov}) "
                  f"off its plain version: {rel:.3e}")
        log(f"check svm C={C} H={H} L={L} d={d} ({branch} branch, offsets "
            f"{oi}, {ov}): kernel vs plain " + ", ".join(errs)
            + " (limit 1e-5 of max|out|)")
    log(f"check svm: {len(shapes)} shapes, max rel err {worst:.3e}")


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
        f"margin_gather {launches['margin_gather']}, scatter_add_dw with a "
        f"row scale {launches['scatter_add_dw[row_scale]']} and on a "
        f"contribution {launches['scatter_add_dw']}")
    check(all(np.isfinite(objs)) and objs[1] < 1.0 and objs[1] < objs[0],
          f"objective not finite, below 1.0 and falling: {objs}")
    ref_gap = abs(objs[1] - SVM_REF_OBJECTIVE) / SVM_REF_OBJECTIVE
    log(f"svm objective after {SVM_ROUNDS} rounds vs the JAX package's "
        f"{SVM_REF_OBJECTIVE}: relative gap {ref_gap:.3e} (limit 1e-2)")
    check(ref_gap <= 1e-2, "the objective is off the JAX package's")
    # every scatter-add of the path takes the round's Δα as its row scale:
    # none runs on a (C, H, L) contribution
    check(launches == {"margin_gather": ran, "scatter_add_dw": 0,
                       "scatter_add_dw[row_scale]": ran},
          f"{launches} launches for {ran} rounds; expected one margin "
          f"gather and one scatter-add per round, every scatter-add with "
          f"its row scale")
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

    def kernel_ms(fn):
        """(ms with one event pair per call, device ms over runs of 10
        calls, the host's ms per call)."""
        return (event_ms(fn, reps=20), event_ms(fn, reps=5, calls=10),
                host_ms(torch, fn))

    def entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes,
              flops):
        bound_ms, bound_by = bound(flops, nbytes)
        ms, device_ms, host = ms
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "device_ms": device_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"times {name} at the RCV1 shape ({n} entries, "
            f"{nbytes / 1e9:.4f} GB, {flops / 1e6:.1f} MFLOP): kernel "
            f"{ms:.4f} ms one call per event pair ({ms / bound_ms:.2f}x "
            f"bound), device {device_ms:.4f} ms over runs of 10 calls "
            f"({device_ms / bound_ms:.2f}x), host {host:.4f} ms per call; "
            f"plain {plain_ms:.4f} ms, library {library}, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
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
          kernel_ms(lambda: SK.margin_gather(w, idx, val)),
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
          kernel_ms(lambda: SK.scatter_add_dw(idx, contrib, d)),
          plain_ms, plain_ms, scatter_add_bytes(n, d), n)
    contrib_ms = entries[-1]["ms"], entries[-1]["device_ms"]
    del got, want, contrib

    # the gram engine's form: the values and the (C, H) Δα; no one torch
    # call scatter-adds a product, so it has no library yardstick
    got = SK.scatter_add_dw(idx, val, d, row_scale=alpha)
    want = SK.scatter_add_plain(idx, val, d, alpha)
    torch.cuda.synchronize()
    entry("scatter_add_dw[row_scale]",
          "flink_ms_tpu_torch/csrc/svm_scatter_add.cu",
          "flink_ms_tpu/ops/svm_kernels.py:86",
          (got - want).abs().max().item(),
          kernel_ms(lambda: SK.scatter_add_dw(idx, val, d, row_scale=alpha)),
          event_ms(lambda: SK.scatter_add_plain(idx, val, d, alpha), reps=5),
          None, scatter_add_bytes(n, d, rows), 2 * n)
    del got, want
    mul_ms = (event_ms(lambda: val * alpha[:, :, None], reps=20),
              event_ms(lambda: val * alpha[:, :, None], reps=5, calls=10))
    for label, i in (("one call per event pair", 0),
                     ("device time over runs of 10 calls", 1)):
        key = ("ms", "device_ms")[i]
        log(f"times the round's Δw at the RCV1 shape, {label}: the "
            f"elementwise pass val * alpha[:, :, None] the row-scale form "
            f"replaces {mul_ms[i]:.4f} ms, with the contrib form's kernel "
            f"{mul_ms[i] + contrib_ms[i]:.4f} ms; the row-scale form alone "
            f"{entries[-1][key]:.4f} ms")
    return entries


TOPK_K = 10          # phase 10's replies
UPDATE_ROWS = 1000   # item rows phase 10 rewrites in place
SCALE_K = 100        # phase 11's, as the reference's retrieval benchmark
SCALE_D = 16
SCALE_EXACT_ROWS, SCALE_IVF_ROWS = 1_000_000, 10_000_000
IVF_ENV = {"TPUMS_TOPK_TIER": "ivf", "TPUMS_ANN_NLIST": "4096",
           "TPUMS_ANN_NPROBE": "64"}
RECALL_CONTRACT = 0.95  # the reference's TPUMS_ANN_RECALL_MIN default


def parse_reply(reply: str):
    """``item:score;...`` -> ([item, ...], [score, ...])."""
    pairs = [tok.rpartition(":") for tok in reply.split(";") if tok]
    return [p[0] for p in pairs], [float(p[2]) for p in pairs]


def payload_of(row) -> str:
    """A factor row as the table stores it, ``f1;f2;...``; each float32
    written as the shortest decimal of its double, so it parses back to
    the same float32."""
    return ";".join(map(repr, row.tolist()))


def with_env(env: dict, fn):
    """fn() with the environment variables `env` set, restored after."""
    prior = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def latency_ms(fn, calls: int):
    """(p50, p99) in ms of `calls` calls of fn(), each timed on the host
    clock; every call ends with its results on the host."""
    times = []
    for j in range(calls):
        t0 = time.perf_counter()
        fn(j)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50)), float(np.percentile(times, 99))


def serve_phase(torch, run, ratings_t, rmse3, dev):
    """Phase 10: the ML-20M model of phase 4 served through the normal
    entry point, ``make_als_topk_handler``, its replies held against a
    float64 top-k of the same factors; the batcher, TOPKV, in-place row
    updates, a background rebuild for a new item, and the offline MSE."""
    import tempfile
    import threading

    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.eval import mse as MSE
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    model = run["model"]
    uf = model.user_factors.cpu().numpy()
    itf = model.item_factors.cpu().numpy().copy()  # rewritten below
    u_ids = [str(u) for u in model.user_ids]
    i_ids = [str(i) for i in model.item_ids]
    col_of = {i: c for c, i in enumerate(i_ids)}
    t0 = time.perf_counter()
    table = ModelTable()
    table.put_many([(f"{u}-U", payload_of(r)) for u, r in zip(u_ids, uf)]
                   + [(f"{i}-I", payload_of(r)) for i, r in zip(i_ids, itf)])
    fill_s = time.perf_counter() - t0
    handler = make_als_topk_handler(table, device=dev)
    index = handler.index
    handler.batching = False
    rng = np.random.default_rng(0)
    qu = rng.integers(0, len(u_ids), 256)
    t0 = time.perf_counter()
    handler(u_ids[qu[0]], TOPK_K)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index._snapshot_rows()
    parse_s = time.perf_counter() - t0
    check(index.full_builds == 1 and index._ann is None
          and index.device == dev, "the first TOPK did not build one exact "
          "index on the card")

    replies = [None] * len(qu)

    def unbatched(j):
        replies[j] = handler(u_ids[qu[j]], TOPK_K)

    p50, p99 = latency_ms(unbatched, len(qu))
    s64 = uf[qu].astype(np.float64) @ itf.astype(np.float64).T
    agree = exact = 0
    for j, reply in enumerate(replies):
        ok, same = topk_agrees([col_of[i] for i in parse_reply(reply)[0]],
                               s64[j], TOPK_K)
        agree += ok
        exact += same
    bound = itf.nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"serve ML-20M ({len(u_ids)} users x {len(i_ids)} items, rank "
        f"{itf.shape[1]}): table filled in {fill_s:.2f}s; first TOPK "
        f"{first_s:.3f}s (build: table snapshot parse {parse_s:.3f}s + "
        f"upload); {len(qu)} TOPK k={TOPK_K} unbatched p50 {p50:.4f} ms, "
        f"p99 {p99:.4f} ms (exact scan bytes bound {bound:.6f} ms); "
        f"against a float64 top-k: {agree} agree, {exact} with equal ids")
    check(agree == len(qu), f"{len(qu) - agree} TOPK replies off the float64 "
          f"top-k")
    if dev.type == "cuda":
        device_busy(torch, "one unbatched TOPK, ML-20M",
                    lambda: handler(u_ids[qu[1]], TOPK_K))

    # why the exact tier scores every query in a product of at least 8
    # rows: the rounding of a row's scores by the product's row count
    m = index._matrix
    qs = torch.from_numpy(uf[qu[:32]]).to(dev)
    by_frame = {b: torch.cat([qs[lo:lo + b] @ m.T for lo in range(0, 32, b)])
                for b in (1, 2, 4, 8, 16, 32)}
    log("serve score rounding by rows per product, elements of 32 x "
        f"{m.shape[0]} scores that differ from the 8-row product's: "
        + ", ".join(f"{b} rows {(s != by_frame[8]).sum().item()}"
                    for b, s in by_frame.items()))
    del by_frame

    handler.batching = True
    batched = [None] * len(qu)
    n_threads = 32
    barrier = threading.Barrier(n_threads)

    def worker(t):
        barrier.wait()
        for j in range(t, len(qu), n_threads):
            batched[j] = handler(u_ids[qu[j]], TOPK_K)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    b = handler.batcher
    same = sum(x == y for x, y in zip(batched, replies))
    log(f"serve batched, {n_threads} threads: {len(qu) / wall:.1f} queries/s "
        f"({wall * 1e3:.1f} ms for {len(qu)}); {b.dispatches} dispatches, "
        f"largest batch {b.max_batch_seen}, {b.inline_singles} inline; "
        f"{same} of {len(qu)} replies equal the unbatched ones")
    check(not any(t.is_alive() for t in threads), "a batched query hung")
    check(same == len(qu), "batched replies differ from the unbatched ones")

    vec_same = sum(handler.by_vector(table.get(f"{u_ids[qu[j]]}-U"), TOPK_K)
                   == replies[j] for j in range(16))
    log(f"serve TOPKV: {vec_same} of 16 equal their TOPK twins")
    check(vec_same == 16, "TOPKV replies differ from TOPK")

    # UPDATE_ROWS item rows rewritten, one of them made the best for user 0
    handler.batching = False
    u0 = qu[0]
    check(UPDATE_ROWS < index.apply_cap, "the update must fit one query's cap")
    rows = rng.choice(len(i_ids), UPDATE_ROWS, replace=False)
    new = (rng.normal(size=(UPDATE_ROWS, itf.shape[1])) * 0.05).astype(
        np.float32)
    new[0] = uf[u0] * 4.0
    itf[rows] = new
    builds, inplace = index.full_builds, index.inplace_updates
    table.put_many([(f"{i_ids[r]}-I", payload_of(v))
                    for r, v in zip(rows, new)])
    t0 = time.perf_counter()
    ids = parse_reply(handler(u_ids[u0], TOPK_K))[0]
    upd_ms = (time.perf_counter() - t0) * 1e3
    s64 = uf[qu[:16]].astype(np.float64) @ itf.astype(np.float64).T
    after = sum(topk_agrees([col_of[i] for i in parse_reply(
        handler(u_ids[u], TOPK_K))[0]], s64[j], TOPK_K)[0]
        for j, u in enumerate(qu[:16]))
    log(f"serve updates: {UPDATE_ROWS} item rows put; the next TOPK took "
        f"{upd_ms:.3f} ms, in-place updates "
        f"+{index.inplace_updates - inplace}, full builds "
        f"+{index.full_builds - builds}; top item {ids[0]} (the "
        f"rewritten best {i_ids[rows[0]]}); {after} of 16 replies agree with "
        f"a float64 top-k of the new factors")
    check(ids[0] == i_ids[rows[0]] and index.full_builds == builds
          and index.inplace_updates - inplace == UPDATE_ROWS and after == 16,
          "the row updates were not applied in place")

    new_id = "99999999"
    table.put(f"{new_id}-I", payload_of(uf[u0] * 8.0))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 30:
        ids = parse_reply(handler(u_ids[u0], TOPK_K))[0]
        if ids[0] == new_id:
            break
        time.sleep(0.01)
    swap_s = time.perf_counter() - t0
    log(f"serve new item: visible after {swap_s:.3f}s, full builds "
        f"+{index.full_builds - builds}")
    check(ids[0] == new_id and index.full_builds == builds + 1,
          "the new item did not land through one background rebuild in 30 s")
    handler.close()

    users, items, ratings = ratings_t
    with tempfile.TemporaryDirectory() as d:
        paths = (os.path.join(d, "uf"), os.path.join(d, "itf"))
        F.write_als_model(paths[0], model.user_ids, F.USER, uf)
        F.write_als_model(paths[1], model.item_ids, F.ITEM,
                          model.item_factors.cpu().numpy())
        t0 = time.perf_counter()
        mse, n_scored, n_skipped = MSE._compute_mse_offline_batched(
            users, items, ratings, MSE._load_model_tables(",".join(paths)),
            device=dev)
        mse_s = time.perf_counter() - t0
    gap = abs(mse - rmse3 ** 2) / rmse3 ** 2
    log(f"serve offline MSE of the trained model on its {n_scored} training "
        f"ratings ({n_skipped} skipped): {mse!r} in {mse_s:.2f}s, phase 4's "
        f"RMSE^2 {rmse3 ** 2!r}, relative gap {gap:.3e} (limit 1e-4)")
    check(n_scored == len(ratings) and gap <= 1e-4,
          "the offline MSE is not phase 4's train RMSE^2")
    return {"p50_ms": p50, "p99_ms": p99, "qps": len(qu) / wall}


def scale_index(torch, rows, ids, dev, env):
    """A bulk-loaded ``DeviceFactorIndex`` under `env` -> (index, build
    seconds)."""
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import DeviceFactorIndex

    def build():
        t0 = time.perf_counter()
        index = DeviceFactorIndex(ModelTable(), "-I", device=dev)
        index.bulk_load(ids, rows)
        return index, time.perf_counter() - t0

    return with_env(env, build)


def scale_times(torch, index, queries, label, bytes_ms):
    """p50 at B = 1 and queries per second at B = 32, through the index's
    own entry points."""
    p50, _ = latency_ms(lambda j: index.topk(queries[j % len(queries)],
                                             SCALE_K), 200)
    frames = [queries[(32 * j) % 480:][:32] for j in range(33)]
    index.topk_many(frames[0], SCALE_K)
    t0 = time.perf_counter()
    for f in frames[1:]:
        index.topk_many(f, SCALE_K)
    qps = 32 * 32 / (time.perf_counter() - t0)
    log(f"scale {label}: p50 at B=1 {p50:.4f} ms (exact scan bytes bound "
        f"{bytes_ms:.6f} ms), {qps:.1f} queries/s at B=32")
    if index.device.type == "cuda":
        for b in (1, 32):
            device_busy(torch, f"{label} one frame of B={b}",
                        lambda: index.topk_many(frames[1][:b], SCALE_K))
    return p50, qps


def exact_check(rows, queries, results, label):
    """Each served top-k list against a float64 top-k of the catalog."""
    agree = exact = 0
    rows64 = rows.astype(np.float64)
    for lo in range(0, len(queries), 8):
        s64 = queries[lo:lo + 8].astype(np.float64) @ rows64.T
        for j in range(s64.shape[0]):
            ok, same = topk_agrees([int(i) for i, _ in results[lo + j]],
                                   s64[j], SCALE_K)
            agree += ok
            exact += same
    log(f"scale {label}: {len(queries)} top-{SCALE_K} lists against a float64 "
        f"top-k: {agree} agree, {exact} with equal ids")
    check(agree == len(queries), f"{label}: top-k off the float64 top-k")


def serve_scale_phase(torch, dev):
    """Phase 11: the two arms of the reference's retrieval benchmark at full
    size on its clustered catalog, factor width 16: 1M rows on the exact
    tier, 10M on the IVF tier beside the exact one."""
    from flink_ms_tpu_torch.serve.topk import topk_lowest_first

    rows, queries = make_catalog(SCALE_EXACT_ROWS, SCALE_D)
    ids = [str(i) for i in range(len(rows))]
    index, build_s = scale_index(torch, rows, ids, dev,
                                 {"TPUMS_TOPK_TIER": "exact"})
    check(index._ann is None, "the exact arm built an IVF tier")
    log(f"scale exact {len(rows)} x {SCALE_D}: bulk_load {build_s:.3f}s")
    out = {"exact_1m": scale_times(torch, index, queries,
                                   f"exact {len(rows)}",
                                   rows.nbytes / PEAK_BYTES_PER_S * 1e3)}
    exact_check(rows, queries[:64], index.topk_many(queries[:64], SCALE_K),
                f"exact {len(rows)}")
    del index

    rows, queries = make_catalog(SCALE_IVF_ROWS, SCALE_D)
    ids = [str(i) for i in range(len(rows))]
    bytes_ms = rows.nbytes / PEAK_BYTES_PER_S * 1e3
    ivf, build_s = scale_index(torch, rows, ids, dev, IVF_ENV)
    ann = ivf._ann
    check(ann is not None, "the IVF tier was not built at 10M rows")
    log(f"scale ivf {len(rows)} x {SCALE_D}: build {build_s:.3f}s (upload, "
        f"k-means, assignment, lists, recall probe), nlist {ann.nlist}, "
        f"nprobe {ann.nprobe}, list_len {ann.list_len}, dropped "
        f"{ann.dropped}, recall_probe {ann.recall_probe}")
    exact, exact_build_s = scale_index(torch, rows, ids, dev,
                                       {"TPUMS_TOPK_TIER": "exact"})
    log(f"scale exact {len(rows)}: bulk_load {exact_build_s:.3f}s")
    hits = 0
    for lo in range(0, len(queries), 32):
        for r, g in zip(exact.topk_many(queries[lo:lo + 32], SCALE_K),
                        ivf.topk_many(queries[lo:lo + 32], SCALE_K)):
            hits += len({i for i, _ in r} & {i for i, _ in g})
    recall = hits / (len(queries) * SCALE_K)
    log(f"scale ivf recall@{SCALE_K} of {len(queries)} mixture queries "
        f"against the exact scan: {recall} (the reference's contract "
        f"{RECALL_CONTRACT}; printed, not gated)")
    out["ivf_10m"] = scale_times(torch, ivf, queries, f"ivf {len(rows)}",
                                 bytes_ms)
    out["exact_10m"] = scale_times(torch, exact, queries,
                                   f"exact {len(rows)}", bytes_ms)
    exact_check(rows, queries[:64], exact.topk_many(queries[:64], SCALE_K),
                f"exact {len(rows)}")
    del exact

    # the correctness gate: the IVF ids against a float64 re-rank of the
    # same shortlists, from the same postings and probes
    q = queries[:64]
    got = ivf.topk_many(q, SCALE_K)
    probe = topk_lowest_first(
        torch.from_numpy(q).to(dev) @ ann.centroids.T, ann.nprobe)[1]
    cand = ann.postings[probe].reshape(len(q), -1).cpu().numpy()
    agree = exact_ids = 0
    for j in range(len(q)):
        c = cand[j][cand[j] >= 0]
        s64 = rows[c].astype(np.float64) @ q[j].astype(np.float64)
        pos = {int(r): p for p, r in enumerate(c)}
        ok, same = topk_agrees([pos[int(i)] for i, _ in got[j]], s64, SCALE_K)
        agree += ok
        exact_ids += same
    log(f"scale ivf: {len(q)} top-{SCALE_K} lists against a float64 re-rank "
        f"of the same shortlists: {agree} agree, {exact_ids} with equal ids")
    check(agree == len(q), "IVF ids off the float64 re-rank of the shortlists")
    recall_probe = ann.recall_probe
    del ivf, ann

    for gate, want_ivf in ((recall_probe + 0.01, False),
                           (recall_probe - 0.01, True)):
        auto, _ = scale_index(torch, rows, ids, dev, {
            **IVF_ENV, "TPUMS_TOPK_TIER": "auto",
            "TPUMS_ANN_RECALL_MIN": repr(gate)})
        log(f"scale auto tier, recall gate {gate:.4f}: serves "
            f"{'ivf' if auto._ann is not None else 'exact'} (recall probe "
            f"{auto._obs_ann_recall.value})")
        check((auto._ann is not None) == want_ivf,
              f"auto tier at gate {gate} did not serve "
              f"{'ivf' if want_ivf else 'exact'}")
        del auto
    return out


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
    names = device_busy(torch, "als 1 iteration, default path",
                        lambda: fit_fn(1, *dev_args))
    cats = sorted({n for n in names if n == "aten::cat" or "CatArray" in n})
    log(f"profile: concatenations in one default-path iteration: {cats}")
    check(not cats, "the default path still concatenates the buckets' A")
    n_u = 2 * len(problem.u.widths) + 1
    f64_check(torch, TA, GA, dev_args[2:2 + n_u], final["itf"], "user")
    f64_check(torch, TA, GA, dev_args[2 + n_u:], final["uf"], "item")
    entries = phase_times(torch, TA, CH, GA, dev_args[2:2 + n_u], final["itf"])
    item_side_times(torch, TA, CH, GA, dev_args[2 + n_u:], final["uf"])
    # `launches` is the count on the kernel's own path (the batch-major
    # entry runs on the fused path only); each path's count beside it
    for e, key, path in zip(entries,
                            ("cholesky", "cholesky_batch_major", "assembly"),
                            ("default", "fused", "default")):
        e["launches"] = runs[path]["launches"][key]
        e["launches_by_path"] = {label: run["launches"][key]
                                 for label, run in runs.items()}

    svm_checks(torch, SK, dev)
    svm_launches, svm_run = svm_main(torch, TS, SK, dev)
    svm_cross_checks(torch, TS, dev)
    # the scatter-add's contrib form (the TPU kernel's function) runs on no
    # path since the gram engine passes its row scale: its launches are 0
    for e in svm_times(torch, SK, svm_run):
        e["launches"] = svm_launches[e["name"]]
        e["launches_by_path"] = {"svm_rcv1": svm_launches[e["name"]]}
        entries.append(e)

    serve_phase(torch, final, (users, items, ratings), final["rmse"][2], dev)
    serve_scale_phase(torch, dev)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
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
