#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card: blocked ALS training and
CoCoA SVM training, each through its hand-written CUDA kernels, top-k
serving of the trained ALS model, staged ALS with resume, the SVM's opt-in
modes, the model generators, the autopilot's retrain, the multi-rank
paths over ``torch.distributed``, the serving job in a process of its
own, the serving fleet, the arena and native store, the closed loop
(blue/green rollout around the autopilot's retrain on the card),
observability (the continuous profiler, forensics, the watch loop and the
rehearsal workload engine), geo-replication with the edge proxy, and the
SVM's serving loop.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

or, on a machine with two or more cards, for phase 16 (d) alone (the
kernels' build, then the NCCL runs):

    python3 chip_smoke.py --multi-gpu

or phase 21 alone on seeded random rows at the served model's shape,
then its rehearsal again at each user count given:

    python3 chip_smoke.py --obs-only [USERS ...]

or phase 22 alone on such rows:

    python3 chip_smoke.py --geo-only

or the scale envelope, BASELINE.json's 10M x 1M synthetic ratings (100M
of them) at rank 64 through the fused assembly-and-solve path, after its
half scale (5M x 500k, 50M ratings):

    python3 chip_smoke.py --scale-only

Phases, each printing lines of its own (``[smoke] ...``):

1. card   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build  — all four CUDA sources built by nvcc from
            ``flink_ms_tpu_torch/csrc``, in parallel, and the native
            library by g++ from ``flink_ms_tpu_torch/native``;
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
            plain version and a library yardstick (``embedding_bag``,
            ``index_add_``, and for the row-scale form one
            ``torch.sparse.mm`` of Xᵀ built once as CSR by Δα): the
            margin gather, the scatter-add on a materialised contribution
            and in its row-scale form, and the elementwise pass that form
            replaces;
10. serve — phase 4's ML-20M model in the port's ``ModelTable`` and served
            through ``make_als_topk_handler`` (no new kernel: a matrix
            product and a top-k): the first TOPK and its build, 256 TOPK
            (k 10, seed 0) unbatched with p50/p99 against a float64 top-k
            (one of them under torch.profiler), how a score's rounding
            depends on the rows of its product and on a row's place in
            it, ``topk_many`` frames of 1, 3, 8, 9, 24 and 33 queries
            equal to ``topk`` bit for bit, the same queries through
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
            torch.profiler;
12. staged ALS — ``als_fit(temporary_path=...)`` at phase 4's ML-20M shape
            and init: 2 staged iterations, then a 3-iteration call that
            must print the resume line and run one, equal to phase 4's
            straight 3-iteration fit at rtol 1e-3 / atol 1e-5; each staged
            iteration's wall time (``StepTimer``) beside the unstaged
            sec/iter, the snapshot's bytes, its write and the factors'
            copy to the host alone, and both kernels' launches;
13. SVM modes — at phase 7's RCV1 shape, on data made anew,
            ``FLINK_MS_SVM_STEP=onehot`` (run as the dynamic step),
            ``FLINK_MS_SVM_DW=sorted`` and ``presorted`` (one presorted
            layout, built on the card): ms/round (1 vs 10 rounds, median of
            3) beside the default's, set-up, the objective after 10 rounds,
            the launches per mode (no scatter-add in a sorted mode), two
            rounds of each under torch.profiler; the one-hot step bit for
            bit the dynamic step's, the sorted modes within rtol 2e-4 /
            atol 1e-6 of direct Δw and of each other;
14. generators — the ALS model generator at the ML-20M model's shape on
            the card (one process) and in 4 worker processes: rows/s, ids,
            every row parsed, the one-process rows equal to the card's
            draws replayed and num's moments; the SVM model generator at
            RCV1's 47,236 features: zero share and the weights' range;
15. retrain — the autopilot's retrain on phase 4's 20M ratings, rank 50, 4
            iterations, cold and warm from phase 4's model: seconds, rows,
            the candidate journal's bytes, write seconds and read-back, the
            held-out MSE of each (the warm one must be lower), and both
            kernels' launches;
16. multi-GPU — (a) a process group of one rank over NCCL: ALS at the
            ML-20M shape through ``all_gather`` and SVM at the RCV1 shape
            through ``all_reduce``, bit for bit phases 4 and 7; (b) 2 ranks
            over gloo, both on this card (NCCL refuses two ranks on one
            GPU), spawned by ``launch_local``: ALS at the ML-20M shape, 3
            iterations, against phase 4's fit at rtol 3e-3 / atol 3e-5
            (``D_RTOL``), each rank's half-sweeps against float64, the fused
            path, a staged run cut after 1 iteration and resumed with rank 0
            the one writer, the routed exchange on a sparse catalog (1M x 1M,
            2M ratings, where auto routes) bit for bit the gathered one, SVM
            at the RCV1 shape with 4,096 of the 8,192 chains a rank against
            phase 7's w at rtol 2e-4 / atol 1e-6, and each rank's launches;
            its times are labelled "gloo, one card shared", a check and not
            a speed figure; the ranks start after phase 9 and run beside
            phases 23 to 13 and (a), so those phases' times are taken
            beside them; (c) the sharded
            exact tier on phase 11's 1M
            catalog as 2 row slices on this card: the exact tier's ids on 64
            queries, scores within 1e-5, p50 and queries/s; (d) with two or
            more cards only, over NCCL on 1, 2 and 4 ranks of one card each:
            ALS ML-20M sec/iter and SVM RCV1 ms/round with each fit against
            D = 1's, and the sharded tier on the 10M catalog over 2 and 4
            cards; with one card it prints that (d) needs more;
17. serving job — steps 3-8 of ``scripts/e2e_demo.sh`` on phase 4's
            model through the port's CLIs: the factor files, the MEAN rows,
            ``als_producer`` (165,239 rows), ``als_consumer --device cuda
            --stateBackend fs`` as a subprocess resolved through the job
            registry (seconds to ready, ingest rows/s); 256 TOPK over the
            wire equal byte for byte to the in-process
            ``make_als_topk_handler`` and to a float64 top-k, TOPKV, GET and
            MGET, p50/p99 of 300 sequential TOPK, ``als_predict_random``
            for 500 queries (its CSV's p50/p99); the live MSE of 25,000
            training ratings (seed 7) equal to the offline ``--model`` MSE
            at rtol 1e-5; ``online.sgd`` on 12,500 fresh ratings (seed 1,
            batch 256): updates/s, seconds until the job's offset and its
            index catch up, 64 sampled keys serving their last journal row,
            64 updated users' TOPK equal to a float64 top-k of the served
            rows, the live MSE after; then SIGTERM and a restart from the
            checkpoint that replays only the tail, serving the same COUNT,
            MGET and TOPK replies.  The job runs with the snapshot plane at
            its default (on): the snapshot it publishes at ready (rows,
            bytes, seconds) and at checkpoints; the restart's bootstrap
            source as the reference's overlay decides it, and a second
            restart with the checkpoint moved away, from the snapshot
            alone.  The push plane: 256 TOPK subscriptions (k 10, each the
            user's served row) and 64 KEY subscriptions over one B2
            ``su=1`` connection, one TOPK subscription over tab; 12 journal
            batches of 100 rewritten item rows, then every folded TOPK
            subscription equal to a pull TOPKV of its query and to a
            float64 top-k, every KEY subscription equal to GET, the
            sequence audit at 0 missed and 0 duplicates, a RESUME replay,
            a RESUME of an unknown id and UNSUB; the subscriptions stay
            live through the SGD load (deltas, dispatches, selectivity,
            update->push latency, the audit again).  Compaction: the
            model published twice into a topic of 16 MiB segments, folded
            by ``python -m flink_ms_tpu_torch.serve.compact``, and a cold
            job on each topic answering with the same bytes;
18. fleet — phase 17's published topic served by ``--device`` worker
            processes on the arena table (their default): 2 sharded
            workers (routing, fan-out TOPK, a SIGKILL and a restart from
            the checkpoint), 2 shards x 2 replicas under an open-loop
            stream through a replica's SIGKILL, an elastic group 2 -> 4 ->
            2 under the stream, and the co-located update plane through a
            live 2 -> 4 cutover and at 4 shards, audited;
19. arena — the arena and the native store on the same topic: (a) a
            one-of-one fleet member on the arena answering 256 TOPK from
            its index on the card, equal to the dict job's by items and
            f32 rounding, the arena's size and resident bytes, wire TOPK
            p50/p99; (b) ``--nativeServer true`` over that arena: GET,
            MGET and B2 GET p50/p99, host-scored TOPKV against (a)'s
            lists; (e) an ``arena/1`` snapshot published by hard link and
            by copy, and a member bootstrapped from it; (c)
            ``--stateBackend rocksdb --nativeServer true`` (a
            ``NativeStateBackend``, the native ingest path) and a restart
            from the store; (d) the update plane at 4 shards on arena
            members with the in-place CAS: updates/s, publish ->
            queryable p50/p99, CAS swaps against re-puts, both audits at 0
            lost and 0 doubled, the duplicate-free rows equal to one
            ``SGDStep`` run;
20. loop — the closed loop on the same topic, every member a ``--device``
            process on the arena: (a) the port's ``RolloutController``
            rolls the topic out as generation 1 of group ``loop`` (1 x 1,
            row floor 165,239, an MSE probe of 256 held-out ratings gated
            at the served rows' own offline MSE); (b) 500,000 ratings of
            5,000 users x 2,000 items (seed 26; each served row moved by
            N(0, 0.3 std), plus N(0, 0.05)) through the update plane's 16
            input partitions; (c) one ``AutopilotController.tick()`` at
            rank 50 and the reference's defaults under GETs at 300 q/s
            open loop: each step's seconds, the window, ``train_s``, both
            ALS kernels' launches on the tick alone (``autopilot_tick``),
            both held-out MSEs (the candidate must win), generation 2's
            cutover, GET p50/p99 by window, 0 failed queries; (d)
            ``ModelQualityCanary`` through the group's ``ElasticClient``:
            its ``tpums_model_live_mse`` equals the offline
            ``compute_mse`` of the candidate at rtol 1e-5, coverage 1.0;
            (e) a ``model_drift`` alert record: the next tick rolls back
            to generation 3, whose 256 TOPK replies equal generation 1's
            byte for byte, a member's HEALTH carries the alert, and a
            further tick does nothing (the latch); (f) 100,000 more
            ratings (seed 27), then ``python -m
            flink_ms_tpu_torch.serve.autopilot --once`` in a process of
            its own takes the lease, resumes the state record and
            windows only the new ratings; (g) per-tenant admission, the
            group spawned with ``TPUMS_ADMIT_TENANT_QPS=abuse=50``: for
            6 s the 300 q/s in-quota GETs beside the tenant at 200 q/s
            (half GET, half TOPK k 10): in-quota availability >= 0.999,
            the tenant's replies served or shed and nothing else, its
            admitted requests within its buckets' tokens, TOPK shed at
            least as often as GET, no shed TOPK scored by a member's
            index, HEALTH and METRICS answered throughout, the fleet's
            ``shed_per_s`` and ``admission_pressure`` above 0;
21. obs   — observability on the same topic, every member a ``--device``
            process on the arena: (a) a member with the continuous
            profiler (its default) under 500 sequential TOPK, 5,000 SGD
            ratings (seed 28) published into its journal and 32 TOPK
            push subscriptions: PROFILE parsed (samples > 0, the server's
            request path among the sampled frames), the window's top 10
            stacks and the host CPU shares of the server's request path,
            the push engine and the update path, then TOPK p50/p99 in 4
            blocks of 100 against a member with ``TPUMS_PROF=0`` (not
            gated); (b) 500 traced fan-out TOPK into 2 shards, every
            process appending to one ``TPUMS_TRACE`` file: all 500 trees
            with a client span and both shards' ``server_reply``, the
            slowest tree's critical path and the slow/fast diff; (d) the
            forensics (equal to the in-process report), ``watch --once``
            and ``profiler --fleet`` CLIs, each a process of its own, at
            once; (c) ``run_rehearsal(device="cuda")`` at the reference
            CLI's defaults with 20,000 users at rank 50 (cut from
            ML-20M's 138,493) at its own 1.5 s replica TTL, the watch
            loop, 8 push subscribers, a kill and the live autoscaler: the
            report valid, no unattributed error or page, every scheduled
            op run, the kill detected, no respawn but the kill's; each
            breach with its attribution, per-verb p50/p99, push p99, the
            card's memory at its peak, and the wall-clock profiles
            (``TPUMS_PROF_IDLE=1``) of the members and of this process
            with what their threads wait on;
22. geo   — geo-replication and the edge proxy on the same topic at the
            rehearsal's liveness (heartbeat 0.25 s, TTL 1.5 s): (a) home
            region ``us`` (2 shards x 2 replicas) and follower ``eu`` (2
            x 1) fed by a ``JournalReplicator``: the follower journal
            byte-equal to home's at the same offsets, 256 single TOPK
            from eu equal to us's and to a float64 top-k, replication
            lag p99 under 250 ms under ``GeoWriteForwarder`` SGD,
            ``st=`` 0.000, growing across a partition, 0.000 healed; (b)
            two proxies in front of us: GET, MGET, TOPK, TOPKV and COUNT
            through them on tab and B2 equal to a direct client's,
            coalesce hits, hedges past a SIGSTOPped replica, a proxy's
            SIGKILL with no client error and push subscriptions through
            it with no missed or duplicate delta, a proxy in eu with a
            staleness bound going home under a partition, GET and TOPK
            p50/p99 through the proxy beside direct; (c) the whole us
            region SIGKILLed under eu's reads: eu promoted within 5 s,
            no read error, the forwarder's next rating applied in eu;
            (d) phase 21 (c)'s rehearsal with 2 proxies in front of its
            group, its schedule cut from 12 s to 4 s and its users to
            10,000, without profilers,
            on (c)'s gates, and the proxy tier's fleet signals, in its
            process from before (a) to after (c) (its rehearsal from the
            end of (a)'s lag read, which the reference's drill reads
            alone).  Every process of the
            phase runs a stall watchdog: each member's largest gap
            between heartbeats, every stall of 0.3 s or more and every
            late heartbeat with its threads' top frames; the phase fails
            on a respawn but (d)'s kill's, a heartbeat taken as expired,
            a client that found no live member of a shard, or a crash,
            one as a process exits included (its line names the threads
            alive at its exit and what its stderr said last);
23. arms  — run after phase 9, on its inputs: the training configurations
            phases 4 and 7 leave out, each with sec/iter or ms/round, its
            quality and each kernel's launches on it alone: implicit ALS
            (alpha 40, ``als_implicit``: the Hu-Koren-Volinsky objective
            not rising over 1, 2, 3 iterations, each side's half-sweep
            against float64, the objective after 3 against the plain
            versions' fit and the JAX package's fit of the same problem),
            bf16 exchange (``als_bf16``: train RMSE beside phase 4's,
            against the plain versions' fit and the JAX package's), and
            the SVM's avg mode, the CLI's default (``svm_avg``: the
            objective falling below 1.0, and one round x K equal to one
            add round with sigma' 1 bit for bit under the presorted dw,
            within rtol 2e-4 / atol 1e-6 with the default);
24. SVM serve — phase 7's trained w written as
            ``svm_train`` writes it, flat and range-partitioned (range
            1,000), both parsed back bit for bit; published by the
            producer's CLI and served by two consumer CLIs that map no
            CUDA library; 1,000 of phase 7's rows queried four ways (flat
            MGET for all; flat GET per feature through
            ``client.svm_predict``, range GET per bucket and range MGET
            for 100), each value against the host's float64 X·w, and the
            card's ``margin_gather`` margins against them; the reference
            section's 1,000 queries timed the four ways (p50/p99; the GET
            loops over 200), and both latency CLIs' CSVs.

From the end of phase 9 to the start of phase 17 the run takes three
lanes at once: this process runs phases 23, 10, 12, 13 and 16, with 16
(b)'s ranks started at the lanes' start, and two spawned processes run
phases 24 and 11, and 15 and 14 (``Beside``); each prints its phases'
``clock:`` lines, and their times are taken beside one another.  Every
process of the run writes and reads compiled modules under
``build/pycache`` (``cache_bytecode``).

``--scale-only`` prints for each size rows/s of generation,
``prepare_blocked`` seconds, sec/iter (1 vs 3 iterations, median of 3),
the device's peak memory beside the A tensor that never exists, the
host's peak RSS, train RMSE after 1 and 2 iterations, each side's
half-sweep against float64, and both kernels' launches (the batch-major
entry's among them); then a ``kernels`` line, its launches labelled
``als_scale``, with each kernel's time on one chunk of the full size.

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
import shutil
import subprocess
import sys
import threading
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

# phase 23 (the arms of phases 4 and 7 they do not run):
# bench.py:656 derives the implicit configuration from the ML-20M one
ALS_ALPHA = 40.0
# The JAX package's fits of phase 4's own problem and init (ml20m_problem),
# each from the init on one CPU device (``JAX_PLATFORMS=cpu python3
# scripts/jax_reference_constants.py --ml20m``: JAX 0.9.0, 8 cores, 287 s,
# 10.5 GB of peak RSS): the explicit train RMSE after 1, 2 and 3
# iterations, which phase 4's paths are held to, and after 3 iterations
# the implicit objective (alpha 40, ``implicit_objective``) and the
# bf16-exchange train RMSE, which phase 23's arms are held to
ML20M_EXPLICIT_RMSE = (1.1427387293522493, 1.1384124290440771,
                       1.1285329981848478)
ML20M_IMPLICIT_OBJECTIVE = 1255325568.241007
ML20M_BF16_RMSE = 1.1285314272773506
# the limits on the card's relative gaps to them, about 10 times the
# largest reading (NVIDIA H100 80GB HBM3, 700.00 W): the explicit RMSEs
# read 2.6e-10, 1.3e-9 and 7.8e-10 on both paths, the implicit objective
# 3.4e-10, the bf16 RMSE 4.3e-7.  The CPU rehearsal's smaller problem
# (tests/test_torch_chip_smoke_arms.py) is held to the anchor's limits
EXPLICIT_JAX_RTOL = 1e-8
IMPLICIT_JAX_RTOL = 3e-9
BF16_JAX_RTOL = 4e-6
# the anchor problem: ML-20M's users and items / 10, its ratings / 100, at
# rank 50 (seed 0, the init drawn as phase 4's), the CPU parity check of
# the port against the JAX package in tier 1
# (tests/test_torch_chip_smoke_arms.py).  Its constants are the JAX
# package's fits of it, 3 iterations from the port's init
# (``JAX_PLATFORMS=cpu python scripts/jax_reference_constants.py``): the
# implicit objective (``implicit_objective``) and the bf16-exchange train
# RMSE
ANCHOR_USERS, ANCHOR_ITEMS, ANCHOR_NNZ = 13_849, 2_674, 200_000
ANCHOR_IMPLICIT_OBJECTIVE = 5028492.197202164
ANCHOR_BF16_RMSE = 0.34800286587665413
# the JAX package's docstring on bf16 exchange: train RMSE +1.4e-5 at the
# ML-20M shape, measured on a TPU (printed as its claim, not a limit)
BF16_TPU_CLAIM = 1.4e-5
# phase 23's limits on relative gaps to the plain versions' fits, and the
# anchor's in tier 1, about 10 times the largest reading each gap had: on
# the card (NVIDIA H100 80GB HBM3, 700.00 W) the implicit fit read 7.0e-11
# off the plain versions' fit, the bf16 fit 3.0e-9; on a CPU the anchor at
# rank 50 read 4.5e-9 (implicit) and 2.3e-6 (bf16), and at the rehearsal's
# rank 8 (tests/test_torch_chip_smoke_arms.py) 7.9e-8 and 6.6e-9
IMPLICIT_PLAIN_RTOL, IMPLICIT_ANCHOR_RTOL = 1e-9, 1e-6
BF16_PLAIN_RTOL, BF16_ANCHOR_RTOL = 3e-8, 5e-5
# the JAX package's hinge+reg objective after 10 avg rounds of phase 7's
# RCV1 problem, from one CPU run of its ``svm_fit`` (JAX 0.9.0, 8 cores);
# ``scripts/jax_reference_constants.py --svm-avg`` is that computation but
# not the run that gave this value.  The port draws other step indices, so
# it is printed beside the port's and not held to it
SVM_AVG_REF_OBJECTIVE = 0.9999050


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def child_env(extra=None) -> dict:
    """This process's environment for a child that imports the repo's
    modules (the repo root first on its path)."""
    return dict(os.environ, **(extra or {}), PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))


# set in this process's environment when the script starts, so that every
# process it starts carries it, also one whose parent died before it
RUN_MARK = "CHIP_SMOKE_RUN"


# compiled bytecode of every module the run imports, kept under the
# checkout: an installation whose packages carry none, run with
# PYTHONDONTWRITEBYTECODE set, compiles torch anew in every process that
# imports it (on the card's host about 1 s of a 7-8 s import,
# scripts/torch_import_times.py), and the run starts dozens of them
PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "pycache")


def cache_bytecode() -> None:
    """Write and read compiled modules under ``PYCACHE``, in this process
    and every process it starts; not in a directory that holds no port
    (the script alone writes nothing beside itself)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "flink_ms_tpu_torch")):
        return
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE


# multiprocessing's helper processes: each ends by itself when its parent
# does
MP_HELPERS = ("multiprocessing.resource_tracker", "multiprocessing.forkserver")


def own_processes(helpers: bool = True, exclude=()) -> dict:
    """{pid: command line} of the live processes this run started: those
    whose environment carries this run's ``RUN_MARK`` and this process's
    descendants, this process itself and zombies left out, and
    multiprocessing's helpers too unless ``helpers``; the processes of
    ``exclude`` (pids) and their descendants left out too."""
    me = os.getpid()
    mark = os.environ.get(RUN_MARK)
    tag = f"{RUN_MARK}={mark}".encode() if mark else None
    parent, marked, cmd = {}, set(), {}
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == me:
            continue
        pid = int(name)
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                stat = f.read()
            # the fields after the command's closing parenthesis
            fields = stat[stat.rindex(b")") + 2:].split()
            if fields[0] == b"Z":
                continue
            parent[pid] = int(fields[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd[pid] = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
            if tag is not None:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    if tag in f.read().split(b"\0"):
                        marked.add(pid)
        except (OSError, ValueError, IndexError):
            continue      # gone meanwhile, or not ours to read
    ours = below(parent, marked | {me}) - {me} - below(parent, set(exclude))
    return {p: cmd.get(p, "") for p in sorted(ours)
            if helpers or not any(h in cmd.get(p, "") for h in MP_HELPERS)}


def below(parent, roots) -> set:
    """``roots`` and every process below them, by ``parent`` ({pid: its
    parent's pid})."""
    out, grew = set(roots), bool(roots)
    while grew:
        more = {p for p, pp in parent.items() if p not in out and pp in out}
        out |= more
        grew = bool(more)
    return out


def stop_leftovers(label, say=log, grace_s: float = 5.0,
                   helpers: bool = True) -> dict:
    """Stop every process of ``own_processes(helpers)``: SIGTERM, then
    SIGKILL for those still alive after ``grace_s`` (at once for
    multiprocessing's helpers, which ignore SIGTERM) -> the ones found,
    each reported through ``say`` with its command line."""
    import signal

    found = own_processes(helpers)
    if not found:
        return found
    say(f"processes left running after {label}: {len(found)}: " + "; ".join(
        f"{pid} {cmd[:160]}" for pid, cmd in found.items()))

    def waiting():
        alive = set(found) & set(own_processes())
        return alive and not all(any(h in found[p] for h in MP_HELPERS)
                                 for p in alive)

    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in found:
            try:
                os.kill(pid, sig)
            except OSError:
                pass
        deadline = time.time() + grace_s
        while time.time() < deadline and waiting():
            time.sleep(0.05)
        for pid in found:       # reap those that were this process's own
            try:
                os.waitpid(pid, os.WNOHANG)
            except OSError:
                pass
        if not set(found) & set(own_processes()):
            break
    alive = set(found) & set(own_processes())
    say(f"stopped {len(found) - len(alive)} of them"
        + (f"; still alive: {sorted(alive)}" if alive else ""))
    return found


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


def sync(torch) -> None:
    """Wait for the card, where there is one (the phases' CPU rehearsals
    run without)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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
        sync(torch)
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


def reset_als_launches(CH, GA) -> None:
    CH.LAUNCHES = 0
    CH.BATCH_MAJOR_LAUNCHES = 0
    GA.LAUNCHES = 0
    GA.BF16_LAUNCHES = 0


def als_launches(CH, GA) -> dict:
    return {"cholesky": CH.LAUNCHES, "assembly": GA.LAUNCHES,
            "cholesky_batch_major": CH.BATCH_MAJOR_LAUNCHES}


def factors_off(a, b, rtol=1e-3, atol=1e-5) -> float:
    """max over components of |a - b| / (atol + rtol |b|): at most 1 is
    within the tolerance, by default the parity contract's rtol 1e-3 /
    atol 1e-5."""
    return ((a - b).abs() / (atol + rtol * b.abs())).max().item()


# the limit between ALS fits over D ranks and over one: D changes the
# order of each row's sums and nothing else.  Set from the H100 reading
# of 3 iterations at the ML-20M shape over 2 ranks, 1.2949 of rtol 1e-3 /
# atol 1e-5 (PERF.md §5), so that it reads about 0.43 of this limit; the
# reference's own multiblock tolerance (rtol 5e-2 / atol 5e-3,
# tests/test_als.py:195-208) read 0.0030 to 0.0032 there, and would pass
# an exchange that drops or misplaces rows
D_RTOL, D_ATOL = 3e-3, 3e-5


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
            reset_als_launches(CH, GA)
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
            launches = als_launches(CH, GA)
        finally:
            for key in env:
                del os.environ[key]
        n_chol, n_asm = launches["cholesky"], launches["assembly"]
        n_bm = launches["cholesky_batch_major"]
        log(f"main {label}: {sec:.6f} sec/iter (median of 3, 1 vs N "
            f"iterations); train RMSE after 1,2,3 iterations {rmses}; "
            f"launches over {ran} iterations: cholesky {n_chol} (of them "
            f"batch-major {n_bm}), assembly {n_asm}")
        check(all(np.isfinite(rmses)) and rmses[0] > rmses[1] > rmses[2],
              f"{label}: train RMSE not finite and decreasing: {rmses}")
        gaps = [abs(r - j) / j for r, j in zip(rmses, ML20M_EXPLICIT_RMSE)]
        log(f"main {label}: train RMSE after 1, 2, 3 iterations against the "
            f"JAX package's fits of this problem {list(ML20M_EXPLICIT_RMSE)}:"
            f" relative gaps {', '.join(f'{g:.3e}' for g in gaps)} (limit "
            f"{EXPLICIT_JAX_RTOL})")
        check(max(gaps) <= EXPLICIT_JAX_RTOL,
              f"{label}: train RMSE off the JAX package's fit")
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
                       "itf": itf, "model": models[-1], "launches": launches}
    # Chunks split the row axis only and each row is its own system, so
    # the two paths must agree entry by entry
    a, b = runs["fused"]["model"], runs["default"]["model"]
    for name, x, y in (("user", a.user_factors, b.user_factors),
                       ("item", a.item_factors, b.item_factors)):
        elem = factors_off(x, y)
        log(f"main: {name} factors after 3 iterations, fused vs default: "
            f"component-wise {elem:.4f} of rtol 1e-3 / atol 1e-5, max "
            f"|diff| {(x - y).abs().max().item():.3e}")
        check(elem <= 1.0, f"the two paths' {name} factors disagree")
    return runs


def f64_check(torch, TA, GA, flat, y, side, rows=2000, implicit=False):
    """One half-sweep's solutions, with the plain and the kernel assembly,
    against float64 assembly and solve of the same systems, on the real
    rows among the first `rows` rows of each bucket; also the systems'
    condition numbers.  Explicit: A = Σ y yᵀ + λ n I, b = Σ r y.
    Implicit: A = YᵀY + Σ α r y yᵀ + λ I, b = Σ (1 + α r) y, with YᵀY
    over the whole opposite table."""
    counts = flat[-1]
    off = 0
    worst = {"plain": 0.0, "kernel": 0.0}
    conds = []
    yty64 = y.double().T @ y.double() if implicit else None
    yty = y.T @ y if implicit else None
    for j in range(len(flat) // 2):
        idx, val = flat[2 * j][:rows], flat[2 * j + 1][:rows]
        cnt = counts[off:off + idx.shape[0]]
        off += int(flat[2 * j].shape[0])
        # a block's buckets hold as many rows as the fullest block's: its
        # pad rows (count 0) have no system to solve
        real = torch.nonzero(cnt > 0).flatten()
        if not real.numel():
            continue
        idx, val, cnt = idx[real], val[real], cnt[real]
        A64, b64 = GA.bucket_assembly_plain(y.double(), idx, val.double(),
                                            torch.float64, implicit,
                                            ALS_ALPHA)
        if implicit:
            A64 += yty64
            A64.diagonal(dim1=-2, dim2=-1).add_(LAMBDA)
        else:
            A64.diagonal(dim1=-2, dim2=-1).add_(
                LAMBDA * cnt.double()[:, None])
        x64 = torch.linalg.solve(A64, b64)
        conds.append(torch.linalg.cond(A64))
        for mode, assemble in (("plain", GA.bucket_assembly_plain),
                               ("kernel", GA.fused_bucket_assembly)):
            A, b = assemble(y, idx, val, torch.float32, implicit, ALS_ALPHA)
            if implicit:
                A += yty
            x = TA._solve_factors(A, b, cnt, LAMBDA, not implicit).double()
            err = ((x - x64).norm(dim=1) / x64.norm(dim=1)).max().item()
            worst[mode] = max(worst[mode], err)
    cond = torch.cat(conds)
    side = f"{side} implicit" if implicit else side
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
        sync(torch)
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


def svm_inputs(TS):
    """The RCV1-shaped data and its blocked problem, made anew by each
    phase that trains on them.  -> (data, problem, synth s, prepare s)."""
    t0 = time.perf_counter()
    data = synth_rcv1(SVM_N, SVM_D, SVM_NNZ, seed=0)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = TS.prepare_svm_blocked(data, SVM_K)
    return data, problem, synth_s, time.perf_counter() - t0


def svm_main(torch, TS, SK, dev):
    """Phase 7: CoCoA at the RCV1 shape through both kernels.  The launch
    counts are set to 0 just before the path and read just after it.
    -> (the path's launch counts, the inputs of phase 9)."""
    data, problem, synth_s, prep_s = svm_inputs(TS)
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
    alpha1 = fit(1, *dev_args)[1]
    repeat = torch.equal(fit(SVM_ROUNDS, *dev_args)[0], w)
    return launches, {"sec_per_round": sec, "objective": objs,
                      "idx": dev_args[1], "val": dev_args[2], "w": w,
                      "alpha": alpha, "alpha1": alpha1,
                      "w_repeat_equal": repeat, "data": data,
                      "problem": problem, "dev_args": dev_args}


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

    # the gram engine's form: the values and the (C, H) Δα.  Its library
    # yardstick is one sparse matrix-vector product, Xᵀ Δα, with Xᵀ built
    # once as CSR (d x C*H) outside the timing
    got = SK.scatter_add_dw(idx, val, d, row_scale=alpha)
    want = SK.scatter_add_plain(idx, val, d, alpha)
    row_of = torch.arange(rows, device=idx.device).repeat_interleave(L)
    xt = torch.sparse_coo_tensor(
        torch.stack([idx.reshape(-1).long(), row_of]), val.reshape(-1),
        (d, rows)).coalesce().to_sparse_csr()
    del row_of
    dalpha = alpha.reshape(-1, 1)

    def library_dw():
        return torch.sparse.mm(xt, dalpha).view(-1)

    lib = library_dw()
    torch.cuda.synchronize()
    check(rel_err(lib, want) <= 1e-5, "the sparse product yardstick off "
          "the plain row-scale scatter-add")
    entry("scatter_add_dw[row_scale]",
          "flink_ms_tpu_torch/csrc/svm_scatter_add.cu",
          "flink_ms_tpu/ops/svm_kernels.py:86",
          (got - want).abs().max().item(),
          kernel_ms(lambda: SK.scatter_add_dw(idx, val, d, row_scale=alpha)),
          event_ms(lambda: SK.scatter_add_plain(idx, val, d, alpha), reps=5),
          event_ms(library_dw, reps=5), scatter_add_bytes(n, d, rows), 2 * n)
    del got, want, lib, xt
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

    # why the exact tier scores every frame in products of exactly 8 rows
    # on the card: the rounding of a row's scores by the product's rows
    m = index._matrix
    qs = torch.from_numpy(uf[qu[:32]]).to(dev)
    by_frame = {b: torch.cat([qs[lo:lo + b] @ m.T for lo in range(0, 32, b)])
                for b in (1, 2, 4, 8, 16, 32)}
    log("serve score rounding by rows per product, elements of 32 x "
        f"{m.shape[0]} scores that differ from the 8-row product's: "
        + ", ".join(f"{b} rows {(s != by_frame[8]).sum().item()}"
                    for b, s in by_frame.items()))
    # and by a row's place in an 8-row product: each of the 32 queries at
    # row 0 of a product of 8 copies of itself
    alone = torch.cat([qs[j:j + 1].repeat(8, 1) @ m.T for j in range(32)])
    log("serve score rounding by a row's place in its 8-row product: "
        f"{(alone[::8] != by_frame[8]).sum().item()} of 32 x {m.shape[0]} "
        "elements differ from the row alone")
    del by_frame, alone
    # a query's reply is the same bits whatever frame it rides in
    frames = {}
    for b in (1, 3, 8, 9, 24, 33):
        qf = uf[qu[:b]]
        frames[b] = sum(x == y for x, y in zip(
            index.topk_many(qf, TOPK_K), [index.topk(q, TOPK_K)
                                          for q in qf]))
    log("serve frames: topk_many replies equal to topk's bit for bit, "
        "scores included: " + ", ".join(f"{n} of {b}"
                                        for b, n in frames.items()))
    check(all(n == b for b, n in frames.items()),
          "a frame's size changed a reply's bits")
    if dev.type == "cuda":
        # what scoring a frame in 8-row products costs against one
        # product of the whole frame (CUDA events, host work included)
        from flink_ms_tpu_torch.serve import topk as TK

        q32 = torch.from_numpy(uf[qu[:32]]).to(dev)
        costs = {name: event_ms(fn, reps=50) for name, fn in (
            ("lone", lambda: TK._score_frame(q32[:8], m, 1)),
            ("blocks", lambda: TK._score_frame(q32, m, 32)),
            ("one", lambda: q32 @ m.T))}
        log(f"serve frame cost: a lone query's 8-row product "
            f"{costs['lone']:.4f} ms; a 32-query frame as 4 products of 8 "
            f"rows {costs['blocks']:.4f} ms against one 32-row product "
            f"{costs['one']:.4f} ms")

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


def scale_index(torch, rows, ids, dev, env, shard_devices=None):
    """A bulk-loaded ``DeviceFactorIndex`` under `env` -> (index, build
    seconds)."""
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import DeviceFactorIndex

    def build():
        t0 = time.perf_counter()
        index = DeviceFactorIndex(ModelTable(), "-I", device=dev,
                                  shard_devices=shard_devices)
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


RETRAIN_ITERS = 4  # the reference autopilot's TPUMS_AUTOPILOT_ITERS default
RESUME_LINE = "[ALS] staging: resuming from iteration"


def median_s(torch, fn, reps=3) -> float:
    times = []
    for _ in range(reps):
        sync(torch)
        t0 = time.perf_counter()
        fn()
        sync(torch)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def staged_phase(torch, TA, CH, GA, problem, ratings_t, init, straight,
                 unstaged_sec, dev):
    """Phase 12: staged ALS (``temporary_path``) at the ML-20M shape of
    phase 4, from its init: 2 staged iterations, then a 3-iteration call
    that must resume from the second snapshot and run one; the result
    against phase 4's straight 3-iteration fit from the same init.
    -> the path's launch counts."""
    import contextlib
    import io
    import tempfile

    from flink_ms_tpu_torch.utils.profiling import StepTimer

    users, items, ratings = ratings_t
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    timer = StepTimer("als-iteration")

    def cfg(iterations):
        return TA.ALSConfig(num_factors=RANK, iterations=iterations,
                            lambda_=LAMBDA)

    with tempfile.TemporaryDirectory() as d:
        stage = os.path.join(d, "stage")
        reset_als_launches(CH, GA)
        TA.als_fit(users, items, ratings, cfg(2), dev, problem=problem,
                   init=init, temporary_path=stage, step_timer=timer)
        first = sorted(os.listdir(stage))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model = TA.als_fit(users, items, ratings, cfg(3), dev,
                               problem=problem, init=init,
                               temporary_path=stage, step_timer=timer)
        sys.stdout.write(buf.getvalue())
        sync(torch)
        launches = als_launches(CH, GA)
        last = sorted(os.listdir(stage))
        snap_bytes = os.path.getsize(os.path.join(stage, "iter_00003.npz"))
        uf = model.user_factors.cpu().numpy()
        itf = model.item_factors.cpu().numpy()
        meta = TA._staging_meta(problem, cfg(3), init)
        n = iter(range(10, 100))
        write_s = median_s(torch, lambda: TA.save_staged(
            os.path.join(d, "write"), next(n), uf, itf, meta))
        copy_s = median_s(torch, lambda: (model.user_factors.cpu(),
                                          model.item_factors.cpu()))
    ms = [t * 1e3 for t in timer.durations_s]
    log(f"staged ALS at the ML-20M shape: 2 staged iterations left {first}; "
        f"the 3-iteration call printed the resume line: "
        f"{RESUME_LINE in buf.getvalue()}; staged iterations (StepTimer, "
        f"sweep + copy to the host + snapshot write) "
        f"{', '.join(f'{t:.3f}' for t in ms)} ms, against phase 4's "
        f"unstaged {unstaged_sec * 1e3:.3f} ms/iter; {timer.summary()}")
    log(f"staged ALS snapshot: {snap_bytes} bytes ({uf.shape[0]} + "
        f"{itf.shape[0]} rows x {RANK} f32); save_staged alone "
        f"{write_s * 1e3:.3f} ms, the factors' copy to the host alone "
        f"{copy_s * 1e3:.3f} ms (medians of 3); left {last}; launches "
        f"over 3 iterations: cholesky {launches['cholesky']} (batch-major "
        f"{launches['cholesky_batch_major']}), assembly "
        f"{launches['assembly']}")
    check(f"{RESUME_LINE} 2 ({stage})" in buf.getvalue(),
          "the staged 3-iteration call did not resume from iteration 2")
    check(first == ["iter_00001.npz", "iter_00002.npz"]
          and last == ["iter_00002.npz", "iter_00003.npz"],
          f"staging left {first}, then {last}")
    check(len(timer.durations_s) == 3, f"{len(timer.durations_s)} staged "
          "iterations timed for 2 + 1")
    check(launches == {"cholesky": 6, "assembly": 3 * n_buckets,
                       "cholesky_batch_major": 0},
          f"staged launches {launches} for 3 iterations of {n_buckets} "
          f"buckets")
    for name, x, y in (("user", model.user_factors, straight.user_factors),
                       ("item", model.item_factors, straight.item_factors)):
        off = factors_off(x, y)
        log(f"staged ALS: {name} factors, resumed 2 + 1 vs straight 3 "
            f"iterations: component-wise {off:.4f} of rtol 1e-3 / atol 1e-5")
        check(off <= 1.0, f"the staged {name} factors are off the straight "
              f"fit's")
    return launches


SVM_MODES = (("onehot", {"FLINK_MS_SVM_STEP": "onehot"}),
             ("sorted", {"FLINK_MS_SVM_DW": "sorted"}),
             ("presorted", {"FLINK_MS_SVM_DW": "presorted"}))


def svm_modes_phase(torch, TS, SK, run, dev):
    """Phase 13: the gram engine's opt-in modes at the RCV1 shape of phase
    7, on data made anew here, each compiled through ``compile_svm_fit``
    under its variable: sec/round, set-up, the objective after 10 rounds
    and the launches of each kernel.  The port runs the one-hot step as
    the dynamic step and both sorted modes over the presorted layout
    (``ops/svm.py``).  The one-hot step is held bit for bit to the dynamic
    step (alpha after one round with the direct Δw; w and alpha after 10
    rounds with the presorted Δw, whose segment sum runs in a fixed
    order); the sorted modes to direct Δw and to each other at rtol 2e-4
    / atol 1e-6, and they must launch no scatter-add.  Two rounds of each
    mode run under torch.profiler on the card.  -> {mode: launches}."""
    data, problem = svm_inputs(TS)[:2]
    cfg = svm_config(TS, problem)

    def over(got, want):
        return ((got - want).abs() / (SVM_ATOL + SVM_RTOL * want.abs())
                ).max().item()

    out, res = {}, {}
    for label, env in SVM_MODES:
        def drive():
            runs_as = (TS._step_choice(), TS._dw_choice())
            for key in SK.LAUNCHES:
                SK.LAUNCHES[key] = 0
            t0 = time.perf_counter()
            fit, dev_args = TS.compile_svm_fit(problem, cfg, dev)
            sync(torch)
            setup_s = time.perf_counter() - t0
            sec, ran = time_rounds(torch, fit, dev_args, SVM_ROUNDS)
            w, alpha = fit(SVM_ROUNDS, *dev_args)
            alpha1 = fit(1, *dev_args)[1]
            sync(torch)
            launches = dict(SK.LAUNCHES)
            ran += SVM_ROUNDS + 1
            if dev.type == "cuda":
                device_busy(torch, f"svm {label} 2 rounds",
                            lambda: fit(2, *dev_args))
            return {"fit": fit, "dev_args": dev_args, "sec": sec, "ran": ran,
                    "w": w, "alpha": alpha, "alpha1": alpha1,
                    "launches": launches, "setup_s": setup_s,
                    "runs_as": runs_as}

        r = with_env(env, drive)
        model = TS.SVMModel(weights=r["w"].cpu().numpy().astype(np.float64))
        r["objective"] = model.hinge_loss(data, SVM_LAMBDA)
        sort = label != "onehot"
        log(f"svm mode {label} (runs as step {r['runs_as'][0]}, Δw "
            f"{r['runs_as'][1]}): {r['sec'] * 1e3:.3f} ms/round (median of "
            f"3, 1 vs {SVM_ROUNDS} rounds) against the default's "
            f"{run['sec_per_round'] * 1e3:.3f}; set-up (upload, Gram build"
            f"{', sorted layout on the card' if sort else ''}) "
            f"{r['setup_s']:.3f}s; "
            f"objective after {SVM_ROUNDS} rounds {r['objective']!r} (default "
            f"{run['objective'][1]!r}); w vs the default's "
            f"{over(r['w'], run['w']):.4f} of rtol {SVM_RTOL} / atol "
            f"{SVM_ATOL}, max |diff| {(r['w'] - run['w']).abs().max().item():.3e}"
            f"; launches over {r['ran']} rounds: {r['launches']}")
        out[label] = r["launches"]
        want_scatter = r["ran"] if label == "onehot" else 0
        check(r["launches"] == {"margin_gather": r["ran"],
                                "scatter_add_dw": 0,
                                "scatter_add_dw[row_scale]": want_scatter},
              f"svm mode {label}: {r['launches']} launches for {r['ran']} "
              f"rounds; expected one margin gather a round and "
              f"{want_scatter} row-scale scatter-adds")
        check(np.isfinite(r["objective"]) and over(r["w"], run["w"]) <= 1.0
              and over(r["alpha"], run["alpha"]) <= 1.0,
              f"svm mode {label}: w or alpha off the default's")
        if label == "onehot":
            check(torch.equal(r["alpha1"], run["alpha1"]),
                  "the one-hot step's alpha after one round is not the "
                  "dynamic step's bit for bit")
            # w after 10 rounds goes through the scatter-add's float
            # atomics; the bit-for-bit check of w is made below, over the
            # presorted Δw's segment sum
            log("svm mode onehot: alpha after one round equal to the "
                "dynamic step's bit for bit; phase 7's default fit run "
                f"twice gives w equal bit for bit: {run['w_repeat_equal']}")
        res[label] = r
        if label != "presorted":
            del r["fit"], r["dev_args"]
    off = max(over(res["sorted"]["w"], res["presorted"]["w"]),
              over(res["sorted"]["alpha"], res["presorted"]["alpha"]))
    log(f"svm sorted vs presorted (w and alpha): {off:.4f} of rtol "
        f"{SVM_RTOL} / atol {SVM_ATOL}")
    check(off <= 1.0, "the sorted and the presorted Δw disagree")
    # the one-hot step over the presorted layout, from the same arguments
    pre = res["presorted"]
    fit_o = with_env({"FLINK_MS_SVM_STEP": "onehot",
                      "FLINK_MS_SVM_DW": "presorted"},
                     lambda: TS._make_fit(problem, cfg, dev)[0])
    w_o, a_o = fit_o(SVM_ROUNDS, *pre["dev_args"])
    w_p, a_p = pre["fit"](SVM_ROUNDS, *pre["dev_args"])
    same = (torch.equal(w_o, pre["w"]) and torch.equal(a_o, pre["alpha"]),
            torch.equal(w_p, pre["w"]) and torch.equal(a_p, pre["alpha"]))
    log(f"svm one-hot vs dynamic step, presorted Δw, {SVM_ROUNDS} rounds: w "
        f"and alpha equal bit for bit {same[0]} (the dynamic step run again: "
        f"{same[1]})")
    check(all(same), "the one-hot step is not the dynamic step bit for bit")
    del pre["fit"], pre["dev_args"]
    return out


def gen_phase(torch, dev):
    """Phase 14: the model generators on the card.  ALS at the ML-20M
    model's shape (138,493 users, 26,744 items, rank 50, ratio, seed 0),
    one process (drawn on the card) and then 4 (numpy workers): rows,
    ids, every row parsed, and for the one-process file its values against
    the same draws replayed (ratio num / den * 50) and the moments of num
    against the uniform's; the SVM model at RCV1's 47,236 features, range
    1,000: the zero share and the weights' range."""
    import tempfile

    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.core.params import Params
    from flink_ms_tpu_torch.gen import als_model_generator as AG
    from flink_ms_tpu_torch.gen import svm_model_generator as SG

    n_rows = N_USERS + N_ITEMS
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for p in (1, 4):
            path = os.path.join(d, f"als_p{p}")
            t0 = time.perf_counter()
            AG.run(Params.from_args([
                "--device", dev.type, "--numUsers", str(N_USERS), "--numItems",
                str(N_ITEMS), "--latentFactors", str(RANK), "--parallelism",
                str(p), "--seed", "0", "--output", path]))
            gen_s = time.perf_counter() - t0
            rows = [F.parse_als_row(ln) for ln in F.iter_lines(path)]
            ids = {t: sorted(int(i) for i, typ, _ in rows if typ == t)
                   for t in (F.USER, F.ITEM)}
            mat = np.stack([v for _, _, v in rows])
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path)) if p > 1 else \
                os.path.getsize(path)
            log(f"gen ALS --parallelism {p}: {len(rows)} rows ({nbytes} "
                f"bytes) in {gen_s:.3f}s, {len(rows) / gen_s:.1f} rows/s")
            check(len(rows) == n_rows
                  and ids[F.USER] == list(range(1, N_USERS + 1))
                  and ids[F.ITEM] == list(range(1, N_ITEMS + 1))
                  and mat.shape == (n_rows, RANK) and np.isfinite(mat).all(),
                  f"gen ALS p={p}: rows, ids or widths off the contract")
            if p == 1:
                # the same draws replayed: users from seed 0, items seed 1
                nums, want = [], []
                for seed, n in ((0, N_USERS), (1, N_ITEMS)):
                    gen = torch.Generator(device=dev).manual_seed(seed)
                    for lo in range(0, n, AG._BATCH):
                        m = min(AG._BATCH, n - lo)
                        num = torch.rand((m, RANK), generator=gen, device=dev)
                        den = torch.rand((m, RANK), generator=gen, device=dev)
                        nums.append(num.cpu().numpy())
                        want.append((num / torch.clamp_min(den, 1e-12) * RANK)
                                    .double().cpu().numpy())
                nums = np.concatenate(nums).astype(np.float64)
                equal = np.array_equal(mat, np.concatenate(want))
                se = 1 / np.sqrt(12 * nums.size)
                log(f"gen ALS p=1: rows equal the replayed draws: {equal}; "
                    f"num mean {nums.mean():.6f} (uniform 0.5, 4 s.e. "
                    f"{4 * se:.6f}), variance {nums.var():.6f} (uniform "
                    f"{1 / 12:.6f})")
                check(equal, "gen ALS p=1: rows are not the card's draws")
                check(abs(nums.mean() - 0.5) <= 4 * se
                      and abs(nums.var() - 1 / 12) <= 1e-3,
                      "gen ALS p=1: num is not uniform on [0, 1)")
            else:
                q = np.percentile(mat, [25, 50, 75]) / RANK
                log(f"gen ALS p=4: quartiles / {RANK} {q.tolist()} (the "
                    f"ratio of uniforms: 0.5, 1, 2)")
                check(np.allclose(q, [0.5, 1.0, 2.0], rtol=0.01),
                      "gen ALS p=4: not the ratio of uniforms")
            out[f"als_p{p}_rows_per_s"] = len(rows) / gen_s
            del rows, mat
        path = os.path.join(d, "svm")
        t0 = time.perf_counter()
        SG.run(Params.from_args([
            "--device", dev.type, "--numFeatures", str(SVM_D), "--range",
            "1000", "--parallelism", "1", "--seed", "0", "--output", path]))
        gen_s = time.perf_counter() - t0
        rows = [F.parse_svm_range_row(ln) for ln in F.iter_lines(path)]
    w = np.array([v for _, es in rows for _, v in es])
    keys = [i for _, es in rows for i, _ in es]
    zero = float((w == 0).mean())
    nz = w[w != 0]
    log(f"gen SVM: {len(rows)} buckets of 1000 ({w.size} weights) in "
        f"{gen_s:.3f}s, {len(rows) / gen_s:.1f} rows/s; zero share {zero:.4f} "
        f"(0.5 +- 0.01); nonzero weights in [{nz.min():.6f}, {nz.max():.6f}]")
    check(len(rows) == SVM_D // 1000 + 1
          and [b for b, _ in rows] == list(range(len(rows)))
          and keys == list(range(len(keys))), "gen SVM: buckets or keys off")
    check(abs(zero - 0.5) <= 0.01, f"gen SVM: zero share {zero}")
    check(bool((np.abs(nz) < 10).all()), "gen SVM: a weight outside (-10, 10)")
    out["svm_rows_per_s"] = len(rows) / gen_s
    return out


def retrain_phase(torch, CH, GA, model, ratings_t, dev):
    """Phase 15: the autopilot's retrain on phase 4's 20M ratings as one
    window, at rank 50 and the reference's default 4 iterations: cold, and
    warm from phase 4's trained model as the incumbent.  The warm
    candidate must have the lower held-out MSE (the port's offline MSE
    over the whole held-out slice; ``compute_mse``, the reference's
    grouping, on the slice's first 1,000 users agrees with it at rtol
    1e-5, float32 sums in two orders); each
    candidate's journal is read back and equals its tables.  -> the
    path's launch counts."""
    import tempfile

    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.eval import mse as MSE
    from flink_ms_tpu_torch.serve import autopilot as AP
    from flink_ms_tpu_torch.serve.journal import Journal

    users, items, ratings = ratings_t
    incumbent = ({int(u): v for u, v in zip(
        model.user_ids, model.user_factors.cpu().numpy())},
        {int(i): v for i, v in zip(
            model.item_ids, model.item_factors.cpu().numpy())})
    mses = {}
    with tempfile.TemporaryDirectory() as work:
        reset_als_launches(CH, GA)
        for seq, (label, inc) in enumerate((("cold", ({}, {})),
                                            ("warm", incumbent))):
            t0 = time.perf_counter()
            cand = AP.retrain_candidate(
                work, "models", seq, 1, users, items, ratings, inc,
                num_factors=RANK, iterations=RETRAIN_ITERS, lambda_=LAMBDA,
                holdout_fraction=0.2, seed=42, device=dev)
            wall = time.perf_counter() - t0
            sync(torch)
            hu, hi, hr = cand["heldout"]
            tables = cand["tables"]
            t0 = time.perf_counter()
            mse, n_scored, skipped = MSE._compute_mse_offline_batched(
                hu, hi, hr, tables, device=dev)
            mse_s = time.perf_counter() - t0
            sub = np.isin(hu, np.unique(hu)[:1000])
            ref_mse, ref_n, _ = MSE.compute_mse(
                hu[sub], hi[sub], hr[sub], tables.get,
                lookup_many=lambda ks: [tables.get(k) for k in ks])
            sub_mse = MSE._compute_mse_offline_batched(
                hu[sub], hi[sub], hr[sub], tables, device=dev)[0]
            jd = cand["journal_dir"]
            jbytes = sum(os.path.getsize(os.path.join(jd, f))
                         for f in os.listdir(jd))
            t0 = time.perf_counter()
            back_u, back_i = AP.read_model_tables(jd, "models")
            read_s = time.perf_counter() - t0
            back = {f"{k}-{F.USER}": v for k, v in back_u.items()}
            back.update({f"{k}-{F.ITEM}": v for k, v in back_i.items()})
            equal = back.keys() == tables.keys() and all(
                np.array_equal(back[k], v) for k, v in tables.items())
            # the journal write alone: the same rows through a new journal
            t0 = time.perf_counter()
            j = Journal(os.path.join(work, f"rewrite-{label}"), "models")
            j.append([F.format_als_row(k.split("-")[0], k.split("-")[1], v)
                      for k, v in tables.items()])
            j.sync()
            write_s = time.perf_counter() - t0
            log(f"retrain {label} ({cand['model_id']}, warm {cand['warm']}): "
                f"{wall:.3f}s in all, train_s {cand['train_s']:.3f}s "
                f"({RETRAIN_ITERS} iterations, rank {RANK}, the train "
                f"slice's host layout included); {cand['rows']} rows; "
                f"journal {jbytes} bytes, its write alone (format, append, "
                f"sync) {write_s:.3f}s, read back in {read_s:.3f}s equal to "
                f"the tables: {equal}; held-out MSE {mse!r} over {n_scored} "
                f"ratings ({skipped} skipped) in {mse_s:.3f}s; on the first "
                f"1000 users' {ref_n}: compute_mse {float(ref_mse)!r}, offline "
                f"{float(sub_mse)!r}")
            check(equal, f"retrain {label}: the journal read back differs")
            check(cand["rows"] == N_USERS + N_ITEMS and skipped == 0
                  and n_scored == len(hr) and np.isfinite(mse),
                  f"retrain {label}: {cand['rows']} rows, {skipped} held-out "
                  f"ratings skipped")
            check(abs(ref_mse - sub_mse) <= 1e-5 * ref_mse,
                  f"retrain {label}: compute_mse and the offline MSE differ")
            check(cand["warm"] is (label == "warm"), "warm flag off")
            mses[label] = mse
            del cand, tables, back
        sync(torch)
        launches = als_launches(CH, GA)
    log(f"retrain: held-out MSE warm {mses['warm']!r} vs cold "
        f"{mses['cold']!r}; launches over 2 x {RETRAIN_ITERS} iterations: "
        f"cholesky {launches['cholesky']} (batch-major "
        f"{launches['cholesky_batch_major']}), assembly "
        f"{launches['assembly']}")
    check(mses["warm"] < mses["cold"], "the warm retrain did not beat the "
          "cold one on held-out MSE")
    check(launches["cholesky"] == 4 * RETRAIN_ITERS
          and launches["assembly"] >= 4 * RETRAIN_ITERS
          and launches["cholesky_batch_major"] == 0,
          f"retrain launches {launches}")
    return launches


# -- phase 16: multi-GPU ------------------------------------------------------

MULTI_ITERS = 3  # the ALS iterations of every multi-rank fit, phase 4's 3
# a sparse catalog where the auto exchange routes both half-sweeps at D = 2
ROUTED_USERS, ROUTED_ITEMS, ROUTED_NNZ = 1_000_000, 1_000_000, 2_000_000
GLOO_LABEL = "gloo, one card shared"
# the CPU rehearsal of phase 16 (tests/test_torch_chip_smoke.py) sets
# this: a rank then counts its kernels' plain versions as the wrappers
# count their launches on the card
REHEARSE_COUNTS = False
# the module's sizes a rank job reads: sent with the job, since a spawned
# rank imports this module afresh
JOB_SIZES = ("N_USERS", "N_ITEMS", "NNZ", "RANK", "ROUTED_USERS",
             "ROUTED_ITEMS", "ROUTED_NNZ", "SVM_N", "SVM_D", "SVM_NNZ",
             "SVM_K", "FUSED_ENV", "REHEARSE_COUNTS")


def job_spec(**kw) -> dict:
    return {"sizes": {name: globals()[name] for name in JOB_SIZES}, **kw}


def rank_time_fit(torch, fit_fn, dev_args, iters=5, repeats=3):
    """``time_fit`` with a fixed schedule: each iteration is a collective,
    so every rank runs the same iterations, none sized by its own clock.
    -> (sec_per_iter, iterations run, the last run's factor blocks)."""
    ran = 0
    out = None

    def run(trip):
        nonlocal ran, out
        sync(torch)
        t0 = time.perf_counter()
        out = fit_fn(trip, *dev_args)
        sync(torch)
        ran += trip
        return time.perf_counter() - t0

    run(1), run(iters)  # warm-up
    samples = []
    for _ in range(repeats):
        t1 = run(1)
        samples.append(max((run(iters) - t1) / (iters - 1), 1e-9))
    return float(np.median(samples)), ran, out


def count_plain_versions(TA, CH, GA, TS, SK, set_attr=setattr) -> None:
    """The CPU rehearsal's counting: each fit-side wrapper name counts as
    the wrapper counts where it launches its kernel, then runs it (its
    plain version, on CPU tensors).  ``set_attr`` installs each counting
    name (a test passes ``monkeypatch.setattr``)."""
    assembly, solve = TA.fused_bucket_assembly, TA.cholesky_solve_batched
    margin, scatter = TS.margin_gather, TS.scatter_add_dw

    def counted_assembly(y_all, *a, **kw):
        GA.LAUNCHES += 1
        GA.BF16_LAUNCHES += int(str(y_all.dtype) == "torch.bfloat16")
        return assembly(y_all, *a, **kw)

    def counted_solve(A, b, layout=None):
        CH.LAUNCHES += 1
        CH.BATCH_MAJOR_LAUNCHES += int(layout == "batch_major")
        return solve(A, b, layout=layout)

    def counted_margin(*a, **kw):
        SK.LAUNCHES["margin_gather"] += 1
        return margin(*a, **kw)

    def counted_scatter(idx, val, d, row_scale=None):
        SK.LAUNCHES["scatter_add_dw" if row_scale is None
                    else "scatter_add_dw[row_scale]"] += 1
        return scatter(idx, val, d, row_scale=row_scale)

    set_attr(TA, "fused_bucket_assembly", counted_assembly)
    set_attr(TA, "cholesky_solve_batched", counted_solve)
    set_attr(TS, "margin_gather", counted_margin)
    set_attr(SK, "margin_gather", counted_margin)
    set_attr(TS, "scatter_add_dw", counted_scatter)


def multi_rank_job(spec: dict) -> dict:
    """One rank of a phase-16 job (``launch_local`` spawns it; this module
    imports no JAX): ALS at the ML-20M shape over the ranks' blocks and
    CoCoA SVM at the RCV1 shape over their chains, each timed and trained,
    with each path's launch counts on this rank.  With ``spec["checks"]``
    also each half-sweep of this rank's block against float64, the fused
    path, a staged run cut after 1 iteration and resumed, and the routed
    exchange against the gathered one on a sparse catalog.  -> host
    numbers and, on rank 0, the trained factors and w."""
    import contextlib
    import io

    import torch

    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK
    from flink_ms_tpu_torch.parallel import distributed as pdist

    globals().update(spec["sizes"])
    if REHEARSE_COUNTS:
        count_plain_versions(TA, CH, GA, TS, SK)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    D, r = pdist.world_size(), pdist.rank()
    out = {"rank": r, "device": str(dev)}

    def cfg(iterations):
        return TA.ALSConfig(num_factors=RANK, iterations=iterations,
                            lambda_=LAMBDA)

    users, items, ratings = synth_ratings(N_USERS, N_ITEMS, NNZ, seed=0)
    t0 = time.perf_counter()
    problem = TA.prepare_blocked(users, items, ratings, D)
    prepare_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, RANK, gen).numpy(),
            TA.init_factors(problem.n_items, RANK, gen).numpy())
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    reset_als_launches(CH, GA)
    fit_fn, dev_args = TA.compile_fit(problem, cfg(MULTI_ITERS), dev,
                                      init=init)
    sec, ran, (uf_l, itf_l) = rank_time_fit(torch, fit_fn, dev_args)
    model = TA.als_fit(users, items, ratings, cfg(MULTI_ITERS), dev,
                       problem=problem, init=init)
    sync(torch)
    out["als"] = {"sec_per_iter": sec, "prepare_s": prepare_s,
                  "iterations": ran + MULTI_ITERS, "buckets": n_buckets,
                  "launches": als_launches(CH, GA)}
    if r == 0:
        out["als"]["factors"] = (model.user_factors.cpu().numpy(),
                                 model.item_factors.cpu().numpy())
    if spec["checks"]:
        n_u = 2 * len(problem.u.widths) + 1
        check(TA._exchange_plan(problem, D) == {"u": None, "i": None},
              "ML-20M's auto exchange should gather")
        for side, flat, y in (
                ("user", dev_args[2:2 + n_u], pdist.gather_blocks(itf_l)),
                ("item", dev_args[2 + n_u:], pdist.gather_blocks(uf_l))):
            f64_check(torch, TA, GA, flat, y, f"{side} block {r} of {D}")
        reset_als_launches(CH, GA)
        fused = with_env(FUSED_ENV, lambda: TA.als_fit(
            users, items, ratings, cfg(MULTI_ITERS), dev, problem=problem,
            init=init))
        sync(torch)
        out["fused"] = {"launches": als_launches(CH, GA), "off": max(
            factors_off(fused.user_factors, model.user_factors),
            factors_off(fused.item_factors, model.item_factors))}
        # staged: a run cut after its first iteration, then the full run,
        # which resumes; rank 0 alone writes
        writes = []
        save = TA.save_staged
        TA.save_staged = lambda *a, **kw: writes.append(a[1]) or save(*a,
                                                                      **kw)
        try:
            TA.als_fit(users, items, ratings, cfg(1), dev, problem=problem,
                       init=init, temporary_path=spec["stage"])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                staged = TA.als_fit(users, items, ratings, cfg(MULTI_ITERS),
                                    dev, problem=problem, init=init,
                                    temporary_path=spec["stage"])
        finally:
            TA.save_staged = save
        out["staged"] = {
            "writes": writes, "resumed": f"{RESUME_LINE} 1 (" in
            buf.getvalue(), "off": max(
                factors_off(staged.user_factors, model.user_factors),
                factors_off(staged.item_factors, model.item_factors))}
        del model, fused, staged, fit_fn, dev_args, uf_l, itf_l
        # the routed exchange, on a catalog where auto routes
        u2, i2, r2 = synth_ratings(ROUTED_USERS, ROUTED_ITEMS, ROUTED_NNZ,
                                   seed=1)
        sparse = TA.prepare_blocked(u2, i2, r2, D)
        auto = TA._exchange_plan(sparse, D)
        fits = {}
        for mode in ("routed", "gather"):
            reset_als_launches(CH, GA)
            fits[mode] = with_env(
                {"FLINK_MS_ALS_EXCHANGE_MODE": mode},
                lambda: TA.als_fit(u2, i2, r2, cfg(2), dev, problem=sparse))
            sync(torch)
            if mode == "routed":
                routed_launches = als_launches(CH, GA)
        out["routed"] = {
            "auto_routes": all(auto[s] is not None for s in "ui"),
            "net_rows": {s: auto[s].net_rows for s in "ui"
                         if auto[s] is not None},
            "gather_rows": {"u": (D - 1) * sparse.i.per_block,
                            "i": (D - 1) * sparse.u.per_block},
            "equal": torch.equal(fits["routed"].user_factors,
                                 fits["gather"].user_factors)
            and torch.equal(fits["routed"].item_factors,
                            fits["gather"].item_factors),
            "launches": routed_launches,
            "buckets": len(sparse.u.widths) + len(sparse.i.widths)}
        del fits
    del problem
    # CoCoA SVM at the RCV1 shape, K chains split over the ranks
    data, sproblem = svm_inputs(TS)[:2]
    scfg = svm_config(TS, sproblem)
    for key in SK.LAUNCHES:
        SK.LAUNCHES[key] = 0
    fit, sargs = TS.compile_svm_fit(sproblem, scfg, dev)
    sec_r, ran_r = time_rounds(torch, fit, sargs, SVM_ROUNDS)
    w = fit(SVM_ROUNDS, *sargs)[0]
    sync(torch)
    out["svm"] = {"sec_per_round": sec_r, "rounds": ran_r + SVM_ROUNDS,
                  "chains": sargs[1].shape[0], "launches": dict(SK.LAUNCHES)}
    if r == 0:
        out["svm"]["w"] = w.cpu().numpy()
    return out


def check_rank_launches(outs, label) -> None:
    """Each rank's path launched every kernel it runs, once per solve,
    bucket assembly and round."""
    for o in outs:
        a, s = o["als"], o["svm"]
        check(a["launches"] == {"cholesky": 2 * a["iterations"],
                                "assembly": a["buckets"] * a["iterations"],
                                "cholesky_batch_major": 0},
              f"{label} rank {o['rank']}: ALS launches {a['launches']} for "
              f"{a['iterations']} iterations of {a['buckets']} buckets")
        check(s["launches"] == {"margin_gather": s["rounds"],
                                "scatter_add_dw": 0,
                                "scatter_add_dw[row_scale]": s["rounds"]},
              f"{label} rank {o['rank']}: SVM launches {s['launches']} for "
              f"{s['rounds']} rounds")


def multi_world1_phase(torch, TA, CH, GA, TS, SK, problem, ratings_t, init,
                       runs, svm_w, dev):
    """Phase 16 (a): a process group of one rank, over NCCL on the card:
    ALS at the ML-20M shape through ``all_gather``, bit for bit phase 4's
    fit from the same start, and SVM at the RCV1 shape through
    ``all_reduce``.  The scatter-add kernel sums with float atomics, whose
    order varies from run to run (phase 7's own fit run twice differs), so
    the SVM is held bit for bit on the presorted Δw, which has none,
    against the same fit outside a group, and on the kernel path against
    phase 7's w at rtol 2e-4 / atol 1e-6."""
    import tempfile

    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    data, sproblem = svm_inputs(TS)[:2]
    scfg = svm_config(TS, sproblem)

    def presorted_w():
        fit, sargs = with_env({"FLINK_MS_SVM_DW": "presorted"},
                              lambda: TS.compile_svm_fit(sproblem, scfg,
                                                         dev))
        return fit(SVM_ROUNDS, *sargs)[0]

    alone = presorted_w()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(d, "rendezvous"),
            world_size=1, rank=0,
            **({"device_id": dev} if backend == "nccl" else {}))
        try:
            reset_als_launches(CH, GA)
            model = TA.als_fit(*ratings_t, TA.ALSConfig(
                num_factors=RANK, iterations=MULTI_ITERS, lambda_=LAMBDA),
                dev, problem=problem, init=init)
            sync(torch)
            als = als_launches(CH, GA)
            for key in SK.LAUNCHES:
                SK.LAUNCHES[key] = 0
            fit, sargs = TS.compile_svm_fit(sproblem, scfg, dev)
            w = fit(SVM_ROUNDS, *sargs)[0]
            sync(torch)
            svm = dict(SK.LAUNCHES)
            grouped = presorted_w()
        finally:
            dist.destroy_process_group()
    want = runs["default"]["model"]
    same_als = torch.equal(model.user_factors, want.user_factors) and \
        torch.equal(model.item_factors, want.item_factors)
    same_svm = torch.equal(grouped, alone)
    w_off = ((w - svm_w).abs() / (SVM_ATOL + SVM_RTOL * svm_w.abs())
             ).max().item()
    log(f"multi (a) world 1 over {backend}: ALS {MULTI_ITERS} iterations "
        f"bit for bit phase 4's: {same_als} (launches {als}); SVM "
        f"{SVM_ROUNDS} rounds: presorted Δw bit for bit the same fit "
        f"outside a group: {same_svm}; the kernel path's w vs phase 7's "
        f"{w_off:.4f} of rtol {SVM_RTOL} / atol {SVM_ATOL}, bit for bit "
        f"{torch.equal(w, svm_w)} (launches {svm})")
    check(same_als, "world-1 ALS differs from phase 4's fit")
    check(same_svm, "world-1 presorted SVM differs from the one-process fit")
    check(w_off <= 1.0, "world-1 SVM w off phase 7's")
    check(svm["margin_gather"] == svm["scatter_add_dw[row_scale]"]
          == SVM_ROUNDS, f"world-1 SVM launches {svm}")


def multi_gloo_phase(torch, runs, svm_w, dev):
    """Phase 16 (b): 2 ranks over gloo, both on this card: ALS at the
    ML-20M shape against phase 4's fit, the float64 half-sweep checks of
    each rank's block, the fused path, a staged run resumed with one
    writer, the routed exchange against the gathered one, and SVM at the
    RCV1 shape, K 8,192 as 2 x 4,096 chains, against phase 7's w.
    Starts the ranks and returns at once a function that waits for them,
    checks, and returns rank 0's launches per path (the run starts them
    before phase 15: their checks are exact or against fixed tolerances,
    and their times are not speed figures)."""
    import tempfile

    from flink_ms_tpu_torch.parallel.distributed import launch_local

    d = tempfile.mkdtemp(prefix="tpums_multi_gloo_")
    spec = job_spec(checks=True, stage=os.path.join(d, "stage"))
    job = {}

    def run():
        t0 = time.perf_counter()
        try:
            job["outs"] = launch_local(
                multi_rank_job, 2, (spec,), device=dev.type, backend="gloo",
                devices=[dev, dev], timeout=900)
        except BaseException as e:  # re-raised by finish()
            job["error"] = e
        job["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def finish():
        thread.join()
        try:
            if "error" in job:
                raise job["error"]
            left = sorted(os.listdir(spec["stage"]))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return multi_gloo_checks(torch, runs, svm_w, dev, job["outs"],
                                 job["s"], left)

    return finish


def multi_gloo_checks(torch, runs, svm_w, dev, outs, job_s, left) -> dict:
    """Phase 16 (b)'s lines and checks of the ranks' outputs."""
    check_rank_launches(outs, "multi (b)")
    r0 = outs[0]
    want = runs["default"]["model"]
    uf, itf = (torch.from_numpy(a).to(dev) for a in r0["als"]["factors"])
    pairs = ((uf, want.user_factors), (itf, want.item_factors))
    off = max(factors_off(a, b, D_RTOL, D_ATOL)
              for a, b in pairs)
    strict = max(factors_off(a, b) for a, b in pairs)
    w = torch.from_numpy(r0["svm"]["w"]).to(dev)
    w_off = ((w - svm_w).abs() / (SVM_ATOL + SVM_RTOL * svm_w.abs())
             ).max().item()
    for o in outs:
        log(f"multi (b) rank {o['rank']} of 2 on {o['device']} "
            f"({GLOO_LABEL}): ALS ML-20M {o['als']['sec_per_iter']:.6f} "
            f"sec/iter, prepare_blocked {o['als']['prepare_s']:.2f}s; SVM "
            f"RCV1 {o['svm']['chains']} chains a rank "
            f"{o['svm']['sec_per_round'] * 1e3:.3f} ms/round; fused vs "
            f"default {o['fused']['off']:.4f}, staged vs straight "
            f"{o['staged']['off']:.4f} of rtol 1e-3 / atol 1e-5; snapshot "
            f"writes {o['staged']['writes']}, resumed {o['staged']['resumed']}"
            f"; routed: auto routes {o['routed']['auto_routes']}, rows/rank "
            f"{o['routed']['net_rows']} vs all_gather "
            f"{o['routed']['gather_rows']}, equal to gathered bit for bit "
            f"{o['routed']['equal']}")
    log(f"multi (b) job {job_s:.1f}s ({GLOO_LABEL}; a check, not a speed "
        f"figure): ALS {MULTI_ITERS} iterations vs phase 4's D=1 fit "
        f"{off:.4f} of rtol {D_RTOL} / atol {D_ATOL} ({strict:.4f} of "
        f"rtol 1e-3 / atol 1e-5); SVM "
        f"{SVM_ROUNDS} rounds w vs "
        f"phase 7's {w_off:.4f} of rtol {SVM_RTOL} / atol {SVM_ATOL}; "
        f"staging left {left}")
    check(off <= 1.0, "2-rank ALS off phase 4's fit")
    check(w_off <= 1.0, "2-rank SVM w off phase 7's")
    check(all(o["fused"]["off"] <= 1.0 and o["staged"]["off"] <= 1.0
              and o["staged"]["resumed"] for o in outs),
          "a rank's fused or staged fit is off, or it did not resume")
    check(outs[0]["staged"]["writes"] == [1, 2, 3]
          and all(not o["staged"]["writes"] for o in outs[1:]),
          "staged snapshots not written by rank 0 alone")
    check(left == ["iter_00002.npz", "iter_00003.npz"],
          f"staging left {left}")
    check(all(o["routed"]["auto_routes"] and o["routed"]["equal"]
              for o in outs), "the routed sweep differs from the gathered "
          "one, or auto did not route")
    for o in outs:
        rl, nb = o["routed"]["launches"], o["routed"]["buckets"]
        check(rl["cholesky"] == 4 and rl["assembly"] == 2 * nb,
              f"routed rank {o['rank']}: launches {rl} for 2 iterations "
              f"of {nb} buckets")
        check(o["fused"]["launches"]["cholesky_batch_major"] > 0,
              f"fused rank {o['rank']}: no batch-major solve")
    return {"als_d2": r0["als"]["launches"],
            "als_d2_fused": r0["fused"]["launches"],
            "als_routed": r0["routed"]["launches"],
            "svm_d2": r0["svm"]["launches"]}


def multi_shard_phase(torch, dev, shard_devices, n_rows, label,
                      time_exact=False):
    """The sharded exact tier over ``shard_devices`` on the clustered
    catalog of phase 11: ids of 64 top-k lists equal the exact tier's,
    scores within 1e-5; then p50 at B = 1 and queries/s at B = 32 (with
    `time_exact`, the one-device exact tier's beside them first)."""
    from flink_ms_tpu_torch.serve.topk import ShardedMatrix

    rows, queries = make_catalog(n_rows, SCALE_D)
    ids = [str(i) for i in range(len(rows))]
    exact, _ = scale_index(torch, rows, ids, dev, {"TPUMS_TOPK_TIER":
                                                    "exact"})
    sharded, build_s = scale_index(
        torch, rows, ids, dev, {"TPUMS_TOPK_TIER": "exact",
                                "TPUMS_TOPK_SHARDED": "1"},
        shard_devices=shard_devices)
    check(isinstance(sharded._matrix, ShardedMatrix),
          f"{label}: the index did not shard")
    q = queries[:64]
    got, want = sharded.topk_many(q, SCALE_K), exact.topk_many(q, SCALE_K)
    bytes_ms = rows.nbytes / PEAK_BYTES_PER_S * 1e3
    if time_exact:
        scale_times(torch, exact, queries, f"{label}: the exact tier on "
                    f"{dev} alone", bytes_ms)
    del exact
    same = sum([i for i, _ in a] == [i for i, _ in b]
               for a, b in zip(got, want))
    err = max(abs(sa - sb) for a, b in zip(got, want)
              for (_, sa), (_, sb) in zip(a, b))
    log(f"multi {label}: {len(rows)} rows in {len(shard_devices)} slices of "
        f"{sharded._matrix.per} on {[str(d) for d in shard_devices]}, "
        f"bulk_load {build_s:.3f}s; {same} of {len(q)} top-{SCALE_K} lists "
        f"with the exact tier's ids, max |score diff| {err:.3e} (limit "
        f"1e-5)")
    check(same == len(q) and err <= 1e-5,
          f"{label}: the sharded tier is off the exact tier")
    return scale_times(torch, sharded, queries, label, bytes_ms)


def multi_nccl_phase(torch, dev, counts=(1, 2, 4)) -> dict:
    """Phase 16 (d), with two or more cards: ALS at the ML-20M shape and
    SVM at the RCV1 shape over NCCL on D = 1, 2, 4 ranks of one card each
    (as many as there are cards), each fit against D = 1's; the sharded
    tier on the 10M catalog over 2 and 4 cards."""
    from flink_ms_tpu_torch.parallel.distributed import launch_local

    cards = torch.cuda.device_count()
    spec = job_spec(checks=False, stage=None)
    out = {}
    for D in [c for c in counts if c <= cards]:
        t0 = time.perf_counter()
        outs = launch_local(multi_rank_job, D, (spec,), device="cuda",
                            backend="nccl", timeout=900)
        job_s = time.perf_counter() - t0
        check_rank_launches(outs, f"multi (d) D={D}")
        r0 = outs[0]
        out[D] = {"als_sec_per_iter": [o["als"]["sec_per_iter"]
                                       for o in outs],
                  "svm_sec_per_round": [o["svm"]["sec_per_round"]
                                        for o in outs],
                  "factors": r0["als"]["factors"], "w": r0["svm"]["w"]}
        fit_off = strict = w_off = 0.0
        if D > 1:
            base = out[counts[0]]
            pairs = [(torch.from_numpy(a), torch.from_numpy(b))
                     for a, b in zip(r0["als"]["factors"], base["factors"])]
            fit_off = max(factors_off(a, b, D_RTOL, D_ATOL) for a, b in pairs)
            strict = max(factors_off(a, b) for a, b in pairs)
            w_off = float(np.max(np.abs(r0["svm"]["w"] - base["w"]) / (
                SVM_ATOL + SVM_RTOL * np.abs(base["w"]))))
        log(f"multi (d) D={D} over NCCL, one card a rank: ALS ML-20M "
            f"sec/iter by rank {out[D]['als_sec_per_iter']}, SVM RCV1 "
            f"{r0['svm']['chains']} chains a rank, ms/round by rank "
            f"{[t * 1e3 for t in out[D]['svm_sec_per_round']]}; fit vs D=1 "
            f"ALS {fit_off:.4f} of rtol {D_RTOL} / atol {D_ATOL} "
            f"({strict:.4f} of rtol 1e-3 / atol 1e-5), SVM w {w_off:.4f} "
            f"of rtol {SVM_RTOL} / atol {SVM_ATOL}; job {job_s:.1f}s")
        check(fit_off <= 1.0 and w_off <= 1.0,
              f"D={D} fit off the D=1 fit")
    for D in (2, 4):
        if D <= cards:
            out[f"shard_{D}"] = multi_shard_phase(
                torch, dev, [torch.device("cuda", i) for i in range(D)],
                SCALE_IVF_ROWS, f"(d) sharded exact {D} cards",
                time_exact=D == 2)
    return out


def multi_gpu_only(torch, dev) -> int:
    """``--multi-gpu``: the kernels' build and phase 16 (d) alone, for a
    machine with two or more cards."""
    from flink_ms_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    check(torch.cuda.device_count() >= 2,
          "--multi-gpu needs two or more cards")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f}s")
    multi_nccl_phase(torch, dev)
    log(f"done in {time.perf_counter() - t0:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- phase 17: the serving job ------------------------------------------------

JOB_TOPK_USERS = 256      # TOPK replies held against the in-process handler
JOB_LATENCY_CALLS = 300   # sequential TOPK requests timed over the wire
JOB_HARNESS_QUERIES = 500
JOB_MSE_RATINGS = 25_000
JOB_SGD_RATINGS = 12_500
JOB_SAMPLE = 64           # keys and users checked after the updates
JOB_CHECKPOINT_MS = 20_000
JOB_WAIT_S = 300.0        # the longest any step may wait for the job
JOB_ID, JOB_TOPIC, JOB_STATE = "smoke-als-job", "als-model", "ALS_MODEL"


class ServingJobProcess:
    """``python -m flink_ms_tpu_torch.serve.als_consumer`` as a subprocess,
    resolved through the job registry; ``stop`` ends it on every path."""

    def __init__(self, work, dev, label):
        self.work, self.label = work, label
        self.log_path = os.path.join(work, f"job-{label}.log")
        cmd = [sys.executable, "-m", "flink_ms_tpu_torch.serve.als_consumer",
               "--device", "cuda" if dev.type == "cuda" else "cpu",
               "--journalDir", os.path.join(work, "journal"),
               "--topic", JOB_TOPIC, "--stateBackend", "fs",
               "--checkpointDataUri", os.path.join(work, "ckpt"),
               "--checkPointInterval", str(JOB_CHECKPOINT_MS),
               "--host", "127.0.0.1", "--port", "0", "--jobId", JOB_ID]
        if JOB_SNAPSHOT_MIN_BYTES is not None:
            cmd += ["--snapshotMinBytes", str(JOB_SNAPSHOT_MIN_BYTES)]
        env = child_env()
        self.t0 = time.perf_counter()
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=subprocess.STDOUT, env=env)
        self.client = None

    def tail(self, n=2000) -> str:
        return self.log_text()[-n:]

    def log_text(self) -> str:
        if not self._log.closed:
            self._log.flush()
        with open(self.log_path) as f:
            return f.read()

    def wait_snapshots(self, n: int) -> list:
        """The job's first ``n`` ``snapshot published`` lines, waited for."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < JOB_WAIT_S:
            check(self.proc.poll() is None,
                  f"the serving job ({self.label}) exited "
                  f"{self.proc.returncode}: {self.tail()}")
            lines = snapshot_lines(self.log_text())
            if len(lines) >= n:
                return lines
            time.sleep(0.05)
        raise SmokeFailure(f"the serving job ({self.label}) published no "
                           f"snapshot: {self.tail()}")

    def wait_ready(self):
        """-> (seconds from the process start to ready, HEALTH report)."""
        from flink_ms_tpu_torch.serve import registry
        from flink_ms_tpu_torch.serve.client import QueryClient

        deadline = time.perf_counter() + JOB_WAIT_S
        while time.perf_counter() < deadline:
            check(self.proc.poll() is None,
                  f"the serving job ({self.label}) exited "
                  f"{self.proc.returncode}: {self.tail()}")
            entry = registry.resolve(JOB_ID)
            if entry is not None and entry.get("ready"):
                if self.client is None:
                    self.client = QueryClient("127.0.0.1", entry["port"],
                                              timeout_s=60)
                health = self.client.health(JOB_STATE)
                if health["ready"]:
                    return time.perf_counter() - self.t0, health
            time.sleep(0.02)
        raise SmokeFailure(f"the serving job ({self.label}) was not ready "
                           f"in {JOB_WAIT_S} s: {self.tail()}")

    def wait_offset(self, end: int) -> float:
        """Seconds until the job's offset reaches ``end``."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < JOB_WAIT_S:
            if self.client.health(JOB_STATE)["offset"] >= end:
                return time.perf_counter() - t0
            time.sleep(0.01)
        raise SmokeFailure(f"the job did not reach offset {end}")

    def stop(self, sig=None) -> None:
        import signal

        if self.client is not None:
            self.client.close()
        if self.proc.poll() is None:
            self.proc.send_signal(sig or signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


def checkpoint_offset(ckpt_dir):
    """The journal offset of the newest complete checkpoint, or None."""
    try:
        with open(os.path.join(ckpt_dir, "latest")) as f:
            chk = f.read().strip()
        with open(os.path.join(ckpt_dir, chk, "MANIFEST.json")) as f:
            return int(json.load(f)["offset"])
    except (OSError, ValueError, KeyError):
        return None


def index_fresh_s(client, user) -> float:
    """Seconds until the job's top-k index has absorbed every row it was
    told of: each TOPK runs the index's upkeep (in-place rewrites of dirty
    rows, or a background rebuild past its backlog), and METRICS reads the
    dirty depth that upkeep found."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < JOB_WAIT_S:
        client._roundtrip(f"TOPK\t{JOB_STATE}\t{user}\t{TOPK_K}")
        depth = [g["value"] for g in client.metrics()["gauges"]
                 if g["name"] == "tpums_topk_dirty_depth"]
        if depth == [0.0]:
            return time.perf_counter() - t0
        time.sleep(0.01)
    raise SmokeFailure("the job's top-k index kept a dirty backlog")


def served_topk(client, users, k=TOPK_K):
    return [client._roundtrip(f"TOPK\t{JOB_STATE}\t{u}\t{k}") for u in users]


def float64_agree(replies, user_rows, item_rows, col_of, k=TOPK_K) -> int:
    """How many wire TOPK replies are the float64 top-k of the rows."""
    s64 = user_rows.astype(np.float64) @ item_rows.astype(np.float64).T
    return sum(topk_agrees([col_of[i] for i in parse_reply(r[2:])[0]],
                           s64[j], k)[0] for j, r in enumerate(replies))


def write_ratings_tsv(path, users, items, ratings, header=True):
    with open(path, "w") as f:
        if header:
            f.write("user\titem\trating\n")
        f.writelines(f"{u}\t{i}\t{r!r}\n"
                     for u, i, r in zip(users.tolist(), items.tolist(),
                                        ratings.tolist()))


JOB_PUSH_USERS = 256      # TOPK subscriptions over one B2 su=1 connection
JOB_PUSH_KEYS = 64        # KEY subscriptions on item rows
JOB_PUSH_BATCHES = 12     # journal batches of rewritten item rows
# item rows a batch rewrites: under the index's in-place cap
# (TPUMS_TOPK_APPLY_CAP, 1,024), so no background rebuild starts
JOB_PUSH_ROWS = 100
JOB_SEGMENT_BYTES = 16 << 20  # the compaction topic's segments
# the model directories published into the compaction topic, in turn: the
# trained rows, then the rows served after the updates.  The producer
# appends 10,000 rows at a time and a segment rolls between appends, so a
# rehearsal's small model needs a third publish to seal two segments
JOB_COMPACT_MODELS = ("model", "model-served")
JOB_SNAPSHOT_MIN_BYTES = None  # the job's default, 1 MiB


def metric_sum(snap, kind, name, **labels) -> float:
    """A counter or gauge series of a METRICS snapshot, summed over its
    label sets (those with ``labels``, when given)."""
    return sum(e["value"] for e in snap.get(kind, []) if e["name"] == name
               and all(e.get("labels", {}).get(k) == v
                       for k, v in labels.items()))


def hist_of(snap, name):
    """(bucket bounds, counts, sum) of a histogram, summed over its label
    sets; (None, None, 0.0) when it has no series yet."""
    le, counts, total = None, None, 0.0
    for e in snap["histograms"]:
        if e["name"] == name:
            c = np.asarray(e["counts"], dtype=np.int64)
            le = e["le"]
            counts = c if counts is None else counts + c
            total += e["sum"]
    return le, counts, total


def bucket_quantile(le, counts, q) -> float:
    """The upper bound of the histogram bucket that holds the q-quantile
    (16 buckets a decade: at most 15% above the true value)."""
    total = int(counts.sum()) if counts is not None else 0
    if not total:
        return float("nan")
    j = int(np.searchsorted(np.cumsum(counts), q * total))
    return float(le[j]) if j < len(le) else float("inf")


def push_window(before, after) -> dict:
    """The push engine's and the ingest loop's work between two METRICS
    snapshots of the job."""
    def delta(kind, name):
        return metric_sum(after, kind, name) - metric_sum(before, kind, name)

    le, lat1, _ = hist_of(after, "tpums_push_latency_seconds")
    _, lat0, _ = hist_of(before, "tpums_push_latency_seconds")
    lat = lat1 - lat0 if lat0 is not None else lat1
    apply_s = (hist_of(after, "tpums_ingest_apply_seconds")[2]
               - hist_of(before, "tpums_ingest_apply_seconds")[2])
    rows = delta("counters", "tpums_ingest_rows_total")
    cand = delta("counters", "tpums_push_candidates_total")
    pop = delta("counters", "tpums_push_population_total")
    return {
        "deltas": delta("counters", "tpums_push_deltas_total"),
        "batches": delta("counters", "tpums_push_batches_total"),
        "dispatches": delta("counters", "tpums_push_dispatches_total"),
        "rescored": delta("counters", "tpums_push_rescored_total"),
        "candidates": cand, "population": pop,
        "selectivity": cand / pop if pop else float("nan"),
        "latency_p50_ms": 1e3 * bucket_quantile(le, lat, 0.5),
        "latency_p99_ms": 1e3 * bucket_quantile(le, lat, 0.99),
        "ingest_rows": rows,
        "ingest_rows_per_s": rows / apply_s if apply_s > 0 else float("nan"),
    }


class PushSubscriber:
    """The push side of phase 17: one B2 ``su=1`` connection through the
    port's ``QueryClient(push=True)`` for the TOPK and KEY subscriptions,
    and one raw tab connection that opts in by sending SUBSCRIBE.  Every
    S/R reply and PUSH frame is kept for the sequence audit, and each
    subscription's materialized answer is folded as it arrives."""

    def __init__(self, port):
        import socket

        from flink_ms_tpu_torch.serve.client import QueryClient

        self.client = QueryClient("127.0.0.1", port, proto="b2", push=True,
                                  timeout_s=60)
        self.tab = socket.create_connection(("127.0.0.1", port), timeout=60)
        self._tab_file = self.tab.makefile("rb")
        self.events, self.pushes = [], []
        self.topk, self.keys = {}, {}   # sub id -> folded dict / last value
        self.query = {}                 # TOPK sub id -> its query payload
        self.replayed = 0  # PUSH frames a RESUME replayed, not new deltas
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._tab_thread = None
        self._drain_thread = None

    def _baseline(self, kind, reply, arg):
        sid = reply["sub_id"]
        with self._lock:
            self.events.append(("S", sid, reply["seq"]))
            if kind == "TOPK":
                self.query[sid] = arg
                self.topk[sid] = dict(zip(*parse_reply(reply["snapshot"])))
            else:
                self.keys[sid] = reply["snapshot"]
        return sid

    def subscribe(self, kind, arg, k=TOPK_K):
        if kind == "TOPK":
            reply = self.client.subscribe_topk(JOB_STATE, arg, k)
        else:
            reply = self.client.subscribe_key(JOB_STATE, arg)
        return self._baseline(kind, reply, arg)

    def subscribe_tab(self, arg, k=TOPK_K):
        """A TOPK subscription over tab; its pushes are read on a thread."""
        self.tab.sendall(
            f"SUBSCRIBE\t{JOB_STATE}\tTOPK\t{arg}\t{k}\n".encode())
        line = self._tab_file.readline().decode().rstrip("\n")
        check(line.startswith("S\t"), f"tab SUBSCRIBE answered {line[:80]}")
        _, sid, seq, snap = line.split("\t", 3)
        self._baseline("TOPK", {"sub_id": sid, "seq": int(seq),
                                "snapshot": snap}, arg)
        self._tab_thread = threading.Thread(target=self._read_tab,
                                            daemon=True)
        self._tab_thread.start()
        return sid

    def _read_tab(self):
        from flink_ms_tpu_torch.serve.push import parse_push

        while True:
            try:
                raw = self._tab_file.readline()
            except (OSError, ValueError):
                return
            if not raw:
                return
            self.fold(parse_push(raw.decode().rstrip("\n")))

    def fold(self, msg):
        from flink_ms_tpu_torch.serve.push import apply_delta

        sid, seq, payload = msg
        with self._lock:
            self.events.append(("P", sid, seq))
            self.pushes.append(msg)
            if sid in self.topk:
                apply_delta(self.topk[sid], payload)
            elif sid in self.keys:
                self.keys[sid] = payload

    def drain(self, timeout_s=0.02) -> int:
        """Fold what the B2 connection holds -> frames folded."""
        n = 0
        while True:
            msg = self.client.next_push(timeout_s=timeout_s)
            if msg is None:
                return n
            self.fold(msg)
            n += 1

    def settle(self, metrics_fn, quiet_s=0.2):
        """Drain until every delta the engine counted has arrived and the
        count held still for ``quiet_s``."""
        t0 = time.perf_counter()
        last, since = None, time.perf_counter()
        while time.perf_counter() - t0 < JOB_WAIT_S:
            if self._drain_thread is None:
                self.drain()
            else:
                time.sleep(0.02)
            want = metric_sum(metrics_fn(), "counters",
                              "tpums_push_deltas_total")
            with self._lock:
                got = sum(1 for e in self.events if e[0] == "P")
            if want != last:
                last, since = want, time.perf_counter()
            elif got >= want + self.replayed and \
                    time.perf_counter() - since >= quiet_s:
                return
        raise SmokeFailure("the push deltas did not all arrive")

    def start_draining(self):
        def run():
            while not self._stop.is_set():
                self.drain(timeout_s=0.1)

        self._stop.clear()
        self._drain_thread = threading.Thread(target=run, daemon=True)
        self._drain_thread.start()

    def stop_draining(self):
        self._stop.set()
        self._drain_thread.join(timeout=30)
        self._drain_thread = None

    def close(self):
        if self._drain_thread is not None:
            self.stop_draining()
        self.client.close()
        try:
            self.tab.close()
        except OSError:
            pass
        if self._tab_thread is not None:
            self._tab_thread.join(timeout=10)


def snapshot_lines(log_text):
    """(rows, offset, seconds) of each ``snapshot published`` line a
    serving job logged."""
    out = []
    for line in log_text.splitlines():
        if "] snapshot published: " in line:
            words = line.split("snapshot published: ")[1].split()
            out.append((int(words[0]), int(words[4]),
                        float(words[6].rstrip("s"))))
    return out


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def push_paced_phase(job, client, journal, table, u_ids, i_ids, items64,
                     col_of) -> tuple:
    """Phase 17's push step, paced: TOPK subscriptions for
    ``JOB_PUSH_USERS`` users over B2 ``su=1`` (each query the user's
    served ``-U`` row) and one more over tab, KEY subscriptions on
    ``JOB_PUSH_KEYS`` item rows; then ``JOB_PUSH_BATCHES`` journal batches
    of ``JOB_PUSH_ROWS`` rewritten item rows, each waited for.  Checks
    each folded TOPK subscription against a pull TOPKV of its query and a
    float64 top-k of the served rows, each KEY subscription against GET,
    the sequence audit, a RESUME inside the ring, a RESUME of an unknown
    id and UNSUB.  -> (the subscriber, still open, the served item rows
    in float64, the numbers)."""
    from flink_ms_tpu_torch.serve.push import audit_push_sequences

    t_step = time.perf_counter()
    rng = np.random.default_rng(3)
    n_items = len(i_ids)
    users = [u_ids[j] for j in rng.choice(len(u_ids), JOB_PUSH_USERS + 1,
                                          replace=False)]
    batches = [rng.choice(n_items, JOB_PUSH_ROWS, replace=False)
               for _ in range(JOB_PUSH_BATCHES)]
    rewritten = np.unique(np.concatenate(batches))
    half = JOB_PUSH_KEYS // 2
    key_items = np.concatenate([
        rng.choice(rewritten, half, replace=False),
        rng.choice(np.setdiff1d(np.arange(n_items), rewritten),
                   JOB_PUSH_KEYS - half, replace=False)])
    sub = PushSubscriber(job.client.port)
    t0 = time.perf_counter()
    for u in users[:-1]:
        sub.subscribe("TOPK", table.get(f"{u}-U"))
    key_sids = [sub.subscribe("KEY", f"{i_ids[j]}-I") for j in key_items]
    sub.subscribe_tab(table.get(f"{users[-1]}-U"))
    subscribe_s = time.perf_counter() - t0

    served = items64.copy()
    scale = 0.3 * float(np.std(items64[:n_items]))
    before = client.metrics()
    queryable = []
    t0 = time.perf_counter()
    for idx in batches:
        # each row scaled and jittered: some items enter shortlists, some
        # leave them, most move their scores
        new = (items64[idx] * rng.uniform(0.5, 1.5, (len(idx), 1))
               + rng.normal(0.0, scale, (len(idx), items64.shape[1]))
               ).astype(np.float32)
        served[idx] = new.astype(np.float64)
        t1 = time.perf_counter()
        end = journal.append([f"{i_ids[j]},I,{payload_of(v)}"
                              for j, v in zip(idx, new)])
        job.wait_offset(end)
        queryable.append(time.perf_counter() - t1)
        sub.settle(client.metrics, quiet_s=0.05)
    sub.settle(client.metrics, quiet_s=0.3)
    paced_s = time.perf_counter() - t0
    win = push_window(before, client.metrics())

    # every TOPK subscription against a pull of the same query, and a
    # float64 top-k of the served rows
    same = f64 = 0
    worst = 0.0
    for sid, query in sub.query.items():
        pulled = client._roundtrip(
            f"TOPKV\t{JOB_STATE}\t{TOPK_K}\t{query}")
        want = dict(zip(*parse_reply(pulled[2:])))
        folded = sub.topk[sid]
        same += folded == want
        if folded != want and folded.keys() == want.keys():
            worst = max(worst, max(abs(folded[i] - want[i]) for i in want))
        q64 = np.asarray(query.split(";"), np.float64)
        cols = [col_of[i] for i in sorted(folded, key=lambda i: -folded[i])]
        f64 += topk_agrees(cols, served @ q64, TOPK_K)[0]
    key_of = {sid: f"{i_ids[j]}-I" for sid, j in zip(key_sids, key_items)}
    gets = client.query_states(JOB_STATE, [key_of[s] for s in key_sids])
    keys_same = sum(sub.keys[s] == g for s, g in zip(key_sids, gets))
    audit = audit_push_sequences(sub.events)
    n_topk = len(sub.query)

    # RESUME from a cursor inside the ring: the R reply, then the missed
    # deltas replayed as they were first sent
    seqs = {}
    for kind, sid, seq in sub.events:
        if kind == "P" and sid in sub.query and sid != list(sub.query)[-1]:
            seqs[sid] = max(seqs.get(sid, 0), seq)
    rsid = max(seqs, key=seqs.get)
    last = seqs[rsid]
    check(last >= 2, f"no TOPK subscription got two deltas ({last})")
    sent = [m for m in sub.pushes if m[0] == rsid and m[1] > last - 2]
    reply = sub.client.resume_subscription(
        JOB_STATE, "TOPK", sub.query[rsid], TOPK_K, rsid, last - 2)
    with sub._lock:
        sub.events.append(("S", rsid, last - 2))
    n0 = len(sub.pushes)
    while len(sub.pushes) < n0 + 2:
        check(sub.drain(timeout_s=5.0) > 0, "RESUME replayed nothing")
    sub.replayed += 2
    replay_ok = (reply == {"mode": "replay", "sub_id": rsid,
                           "seq": last - 2}
                 and sub.pushes[n0:n0 + 2] == sent)
    # a RESUME of an id no engine minted: a fresh subscription
    ksid, kkey = key_sids[0], key_of[key_sids[0]]
    fresh = sub.client.resume_subscription(
        JOB_STATE, "KEY", kkey, 0, ksid.split("-")[0] + "-999999", 0)
    fresh_ok = (fresh["mode"] == "snapshot" and fresh["seq"] == 0
                and fresh["sub_id"] not in sub.keys
                and fresh["snapshot"] == client.query_state(JOB_STATE, kkey))
    sub._baseline("KEY", fresh, kkey)
    # UNSUB stops the deltas: the key is rewritten once more afterwards
    usid = key_sids[1]
    ukey = key_of[usid]
    sub.client.unsubscribe(usid)
    n_seen = sum(1 for m in sub.pushes if m[0] == usid)
    uj = col_of[ukey[:-2]]
    unew = (served[uj] * 1.25).astype(np.float32)
    served[uj] = unew.astype(np.float64)
    job.wait_offset(journal.append([f"{ukey[:-2]},I,{payload_of(unew)}"]))
    sub.settle(client.metrics, quiet_s=0.3)
    unsub_ok = (sum(1 for m in sub.pushes if m[0] == usid) == n_seen
                and client.query_state(JOB_STATE, ukey) == payload_of(unew))
    audit2 = audit_push_sequences(sub.events)

    out = dict(win, subscribe_s=subscribe_s, paced_s=paced_s,
               queryable_p50_s=float(np.percentile(queryable, 50)),
               topk_same=same, topk_f64=f64, keys_same=keys_same,
               missed=audit2["missed"], duplicates=audit2["duplicates"])
    log(f"job push, paced (B2 su=1 and tab): {n_topk} TOPK k={TOPK_K} "
        f"({n_topk - 1} over B2, 1 over tab) and {len(key_sids)} KEY "
        f"subscriptions in {subscribe_s:.3f}s; {JOB_PUSH_BATCHES} journal "
        f"batches of {JOB_PUSH_ROWS} rewritten item rows in {paced_s:.2f}s, "
        f"each queryable p50 {out['queryable_p50_s']:.3f}s after its "
        f"append; ingest with subscriptions live "
        f"{win['ingest_rows_per_s']:.0f} rows/s of apply time "
        f"({win['ingest_rows']:.0f} rows); engine: {win['batches']:.0f} "
        f"batches, {win['deltas']:.0f} deltas, {win['dispatches']:.0f} "
        f"topk_many dispatches, {win['rescored']:.0f} subscriptions "
        f"re-scored, selectivity {win['selectivity']:.4f} (candidates "
        f"{win['candidates']:.0f} over a population of "
        f"{win['population']:.0f}); update->push latency p50 "
        f"{win['latency_p50_ms']:.3f} ms, p99 {win['latency_p99_ms']:.3f} "
        f"ms (bucket upper bounds); {same} of {n_topk} folded TOPK "
        f"subscriptions equal a pull TOPKV of their query as (item, float) "
        f"lists (largest score gap where the items agree {worst:.3g}), "
        f"{f64} agree with a float64 top-k of the served rows; "
        f"{keys_same} of {len(key_sids)} KEY subscriptions' last value "
        f"equals GET; audit {audit['subs']} streams, "
        f"{audit['delivered']} delivered, {audit['missed']} missed, "
        f"{audit['duplicates']} duplicates; RESUME from seq {last - 2} of "
        f"{rsid} replayed seqs {last - 1}-{last} as first sent: "
        f"{replay_ok}; RESUME of an unknown id answered a fresh S "
        f"{fresh['sub_id']}: {fresh_ok}; UNSUB stopped the deltas: "
        f"{unsub_ok}; after these the audit reads {audit2['missed']} "
        f"missed, {audit2['duplicates']} duplicates "
        f"({time.perf_counter() - t_step:.1f}s)")
    check(same == n_topk, f"{n_topk - same} folded TOPK subscriptions "
          "differ from a pull of their query")
    check(f64 == n_topk, f"{n_topk - f64} folded TOPK subscriptions off "
          "the float64 top-k")
    check(keys_same == len(key_sids), "a KEY subscription's last value "
          "is not GET's")
    check(audit["missed"] == audit["duplicates"] == 0
          and audit2["missed"] == audit2["duplicates"] == 0,
          f"the push audit found holes or duplicates: {audit2}")
    check(replay_ok and fresh_ok and unsub_ok,
          f"RESUME/UNSUB: replay {replay_ok}, fresh {fresh_ok}, unsub "
          f"{unsub_ok}")
    check(win["dispatches"] > 0 and win["deltas"] > 0,
          "the paced updates pushed nothing")
    return sub, served, out


def compaction_phase(work, journal, u_ids, i_ids, dev) -> dict:
    """Phase 17's compaction step: phase 4's model published twice into a
    fresh topic by ``als_producer --segmentBytes`` (the trained rows, then
    the rows the job served after the updates), a copy folded by
    ``python -m flink_ms_tpu_torch.serve.compact --mode als``, and a cold
    ``ServingJob`` on each topic answering COUNT, 64 MGETs and 64 TOPKs
    with the same bytes."""
    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.serve import consumer as PC
    from flink_ms_tpu_torch.serve import journal as PJ
    from flink_ms_tpu_torch.serve.client import QueryClient

    w = lambda *p: os.path.join(work, *p)  # noqa: E731
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    last = {}
    for line in journal.read_lines():
        last[PC.parse_als_record(line)[0]] = line
    os.makedirs(w("model-served"))
    F.write_lines(w("model-served", "rows"), last.values())
    topic = "als-compact"
    t0 = time.perf_counter()
    for name in JOB_COMPACT_MODELS:
        pub = subprocess.run(
            [sys.executable, "-m", "flink_ms_tpu_torch.serve.als_producer",
             "--input", w(name), "--journalDir", w("full"), "--topic",
             topic, "--segmentBytes", str(JOB_SEGMENT_BYTES)],
            capture_output=True, text=True, env=env, timeout=JOB_WAIT_S)
        check(pub.returncode == 0, f"als_producer failed: {pub.stderr}")
    publish_s = time.perf_counter() - t0
    shutil.copytree(w("full"), w("folded"))
    before = dir_bytes(w("folded"))
    segments = len(os.listdir(w("folded")))
    t0 = time.perf_counter()
    fold = subprocess.run(
        [sys.executable, "-m", "flink_ms_tpu_torch.serve.compact",
         "--journalDir", w("folded"), "--topic", topic, "--mode", "als"],
        capture_output=True, text=True, env=env, timeout=JOB_WAIT_S)
    fold_s = time.perf_counter() - t0
    check(fold.returncode == 0 and "[compact] folded" in fold.stdout,
          f"the compact CLI failed: {fold.stdout} {fold.stderr}")
    after = dir_bytes(w("folded"))
    rng = np.random.default_rng(5)
    keys = ([f"{u_ids[j]}-U" for j in rng.choice(len(u_ids), 128)]
            + [f"{i_ids[j]}-I" for j in rng.choice(len(i_ids), 127)]
            + ["MEAN-I"])
    users = [u_ids[j] for j in rng.choice(len(u_ids), 64)]
    replies, ready = [], []
    for name in ("full", "folded"):
        job = PC.ServingJob(
            PJ.Journal(w(name), topic), PC.ALS_STATE, PC.parse_als_record,
            PC.MemoryStateBackend(), host="127.0.0.1", port=0,
            job_id=f"smoke-compact-{name}", snapshots=False, device=dev)
        try:
            t0 = time.perf_counter()
            job.start()
            check(job.wait_ready(JOB_WAIT_S), f"the job on {name} never "
                  "became ready")
            ready.append((time.perf_counter() - t0, job.bootstrap_seconds,
                          job.ingest_rows))
            with QueryClient("127.0.0.1", job.port, timeout_s=60) as c:
                replies.append(
                    [c._roundtrip(f"COUNT\t{JOB_STATE}")]
                    + [c._roundtrip(f"MGET\t{JOB_STATE}\t"
                                    + ",".join(keys[j:j + 4]))
                       for j in range(0, len(keys), 4)]
                    + served_topk(c, users))
        finally:
            job.stop()
    out = {"publish_s": publish_s, "bytes_before": before,
           "bytes_after": after, "fold_s": fold_s,
           "replay_full_s": ready[0][1], "replay_folded_s": ready[1][1]}
    log(f"job compaction: phase 4's model published "
        f"{len(JOB_COMPACT_MODELS)} times (the trained rows, then the "
        f"{len(last)} rows served after the updates) by "
        f"als_producer --segmentBytes {JOB_SEGMENT_BYTES} in "
        f"{publish_s:.2f}s, {segments} files; the compact CLI folded "
        f"{before} bytes to {after} in {fold_s:.2f}s (a process of its "
        f"own; it printed '{fold.stdout.strip()}'); cold ServingJob "
        f"(device {dev}) on the uncompacted topic ready in "
        f"{ready[0][0]:.2f}s (replay {ready[0][1]:.3f}s, {ready[0][2]} "
        f"rows), on the compacted one in {ready[1][0]:.2f}s (replay "
        f"{ready[1][1]:.3f}s, {ready[1][2]} rows); COUNT, 64 MGETs of 4 keys "
        f"and 64 TOPK k={TOPK_K} the same bytes: "
        f"{replies[0] == replies[1]}")
    check(after < before, "the fold did not shrink the topic")
    check(replies[0] == replies[1] and replies[0][0] == f"C\t{len(last)}",
          "the compacted topic serves other replies")
    return out


def serving_job_phase(torch, model, ratings_t, serve_p50, dev) -> dict:
    """Phase 17: the serving job of ``scripts/e2e_demo.sh`` steps 3-8 on
    phase 4's model, through the port's CLIs and a job in a subprocess:
    mean vectors, publish, serve (resolved through the registry), TOPK over
    the wire equal to the in-process handler, the latency harness, the
    live MSE equal to the offline one, online SGD closing the loop (served
    rows equal the last journal rows, TOPK equal to a float64 top-k of the
    served rows), and a restart from the checkpoint."""
    import tempfile

    from flink_ms_tpu_torch.client import als_predict_random as HARNESS
    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.core.params import Params
    from flink_ms_tpu_torch.eval import mean_vector as MEAN
    from flink_ms_tpu_torch.eval import mse as MSE
    from flink_ms_tpu_torch.online import sgd as SGD
    from flink_ms_tpu_torch.serve import journal as PJ
    from flink_ms_tpu_torch.serve import push as PUSH
    from flink_ms_tpu_torch.serve import registry
    from flink_ms_tpu_torch.serve import snapshot as PS
    from flink_ms_tpu_torch.serve.consumer import parse_als_record
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    t_phase = time.perf_counter()
    out = {}
    uf = model.user_factors.cpu().numpy()
    itf = model.item_factors.cpu().numpy()
    u_ids = [str(u) for u in model.user_ids]
    i_ids = [str(i) for i in model.item_ids]
    dev_name = "cuda" if dev.type == "cuda" else "cpu"
    prior_registry = os.environ.get("TPUMS_REGISTRY_DIR")
    jobs, subs = [], []
    with tempfile.TemporaryDirectory() as work:
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        try:
            # 1. model files, mean vectors, publish
            w = lambda *p: os.path.join(work, *p)  # noqa: E731
            os.makedirs(w("model"))
            t0 = time.perf_counter()
            F.write_als_model(w("model", "userFactors"), model.user_ids,
                              F.USER, uf)
            F.write_als_model(w("model", "itemFactors"), model.item_ids,
                              F.ITEM, itf)
            write_s = time.perf_counter() - t0
            means = [MEAN.run(Params.from_args(
                ["--type", side, "--input", w("model", f"{side}Factors"),
                 "--output", w("model", f"mean{side[0].upper()}")]))
                for side in ("user", "item")]
            t0 = time.perf_counter()
            pub = subprocess.run(
                [sys.executable, "-m", "flink_ms_tpu_torch.serve.als_producer",
                 "--input", w("model"), "--journalDir", w("journal"),
                 "--topic", JOB_TOPIC], capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=os.path.dirname(
                    os.path.abspath(__file__))), timeout=JOB_WAIT_S)
            pub_s = time.perf_counter() - t0
            check(pub.returncode == 0, f"als_producer failed: {pub.stderr}")
            journal = PJ.Journal(w("journal"), JOB_TOPIC)
            published = journal.read_lines()
            pub_end = journal.end_offset()
            n_rows = len(u_ids) + len(i_ids) + 2
            log(f"job publish: model files written in {write_s:.2f}s, MEAN "
                f"rows {means[0][:24]}... and {means[1][:24]}...; "
                f"als_producer {len(published)} rows, {pub_end} bytes in "
                f"{pub_s:.2f}s (a process of its own)")
            check(len(published) == n_rows and pub.stdout.strip().endswith(
                f"{n_rows} rows -> topic '{JOB_TOPIC}'"),
                f"published {len(published)} rows, want {n_rows}")

            # 2. the job in a subprocess, resolved through the registry
            job = ServingJobProcess(work, dev, "cold")
            jobs.append(job)
            ready_s, health = job.wait_ready()
            cold_s = health["bootstrap_seconds"]
            out.update(ready_s=ready_s, bootstrap_s=cold_s,
                       ingest_rows_per_s=n_rows / cold_s)
            log(f"job ready: {ready_s:.2f}s from the process start "
                f"(bootstrap {cold_s:.3f}s: {n_rows} rows by "
                f"{health['ingest_path']} replay, {n_rows / cold_s:.0f} "
                f"rows/s), {health['keys']} keys, offset {health['offset']}, "
                f"registry entry {registry.resolve(JOB_ID)['port']}")
            check(health["keys"] == n_rows and health["offset"] == pub_end
                  and health["bootstrap_source"] == "replay",
                  f"the job's first HEALTH {health}")
            client = job.client
            # the snapshot the job publishes at ready (on by default, as
            # in the reference), waited for so that it does not overlap
            # the timings below
            snap_rows, snap_off, snap_s = job.wait_snapshots(1)[0]
            snap_root = PS.snapshot_root(w("journal"), JOB_TOPIC)
            ready_snap = [m for m in PS.list_manifests(snap_root)
                          if m["offset"] == snap_off]
            snap_bytes = dir_bytes(ready_snap[0]["path"]) if ready_snap \
                else 0
            m0 = client.metrics()
            boot_rows = metric_sum(m0, "counters", "tpums_ingest_rows_total")
            boot_apply = hist_of(m0, "tpums_ingest_apply_seconds")[2]
            out.update(snapshot_ready_s=snap_s, snapshot_bytes=snap_bytes,
                       bootstrap_apply_rows_per_s=boot_rows / boot_apply)
            log(f"job snapshot at ready: {snap_rows} rows at offset "
                f"{snap_off}, {snap_bytes} bytes (keys, values, manifest) "
                f"in {snap_s:.3f}s, written after the ready flip; the "
                f"replay applied {boot_rows:.0f} rows at "
                f"{boot_rows / boot_apply:.0f} rows/s of apply time")
            check(snap_rows == n_rows and snap_off == pub_end
                  and snap_bytes > 0, "the snapshot at ready")

            # 3. TOPK over the wire against the in-process handler
            table = ModelTable()
            table.put_many([parse_als_record(line) for line in published])
            handler = make_als_topk_handler(table, device=dev)
            handler.batching = False
            rng = np.random.default_rng(0)
            qu = [u_ids[j] for j in rng.integers(0, len(u_ids),
                                                 JOB_TOPK_USERS)]
            t0 = time.perf_counter()
            wire = served_topk(client, qu)
            first_s = time.perf_counter() - t0
            local = [f"V\t{handler(u, TOPK_K)}" for u in qu]
            same = sum(a == b for a, b in zip(wire, local))
            col_of = {i: c for c, i in enumerate(i_ids)}
            col_of["MEAN"] = len(i_ids)
            mean_i = np.asarray([float(t) for t in means[1].split(",")[2]
                                 .split(";")])
            items64 = np.vstack([itf.astype(np.float64), mean_i])
            row_of = {u: r for r, u in enumerate(u_ids)}
            agree = float64_agree(wire, uf[[row_of[u] for u in qu]], items64,
                                  col_of)
            vec = [client._roundtrip(f"TOPKV\t{JOB_STATE}\t{TOPK_K}\t"
                                     f"{table.get(u + '-U')}")
                   for u in qu[:16]]
            keys = [f"{u}-U" for u in qu[:32]] + [f"{i}-I" for i in
                                                   i_ids[:31]] + ["MEAN-I"]
            gets = [client.query_state(JOB_STATE, k) for k in keys[:16]]
            mget = client.query_states(JOB_STATE, keys)
            check(same == len(qu), f"{len(qu) - same} wire TOPK replies "
                  "differ from the in-process handler's")
            check(agree == len(qu), f"{len(qu) - agree} wire TOPK replies "
                  "off the float64 top-k")
            check(vec == wire[:16], "TOPKV differs from TOPK over the wire")
            check(gets == [table.get(k) for k in keys[:16]]
                  and mget == [table.get(k) for k in keys],
                  "GET/MGET differ from the published rows")
            lat_users = [u_ids[j] for j in rng.integers(0, len(u_ids),
                                                        JOB_LATENCY_CALLS)]
            p50, p99 = latency_ms(lambda j: client._roundtrip(
                f"TOPK\t{JOB_STATE}\t{lat_users[j]}\t{TOPK_K}"),
                JOB_LATENCY_CALLS)
            out.update(wire_p50_ms=p50, wire_p99_ms=p99)
            t0 = time.perf_counter()
            n_h = HARNESS.run(Params.from_args(
                ["--jobId", JOB_ID, "--numQueries", str(JOB_HARNESS_QUERIES),
                 "--lowerUserId", "0", "--upperUserId", str(len(u_ids) - 1),
                 "--lowerItemId", "0", "--upperItemId", str(len(i_ids) - 1),
                 "--outputFile", w("latency.csv")]))
            harness_s = time.perf_counter() - t0
            with open(w("latency.csv")) as f:
                csv = [line.rstrip("\n").split(",") for line in f]
            ms = np.asarray([float(r[3]) for r in csv])
            out.update(harness_p50_ms=float(np.percentile(ms, 50)),
                       harness_p99_ms=float(np.percentile(ms, 99)))
            log(f"job TOPK over the wire: the first {JOB_TOPK_USERS} in "
                f"{first_s:.3f}s (the index's build included), {same} equal "
                f"to the in-process handler, {agree} agree with a float64 "
                f"top-k; 16 TOPKV equal their TOPK; GET/MGET equal the "
                f"published rows; {JOB_LATENCY_CALLS} sequential TOPK k="
                f"{TOPK_K} p50 {p50:.4f} ms, p99 {p99:.4f} ms (phase 10's "
                f"in-process p50 {serve_p50:.4f} ms); als_predict_random "
                f"{n_h} queries in {harness_s:.2f}s, its CSV's ms column "
                f"(whole ms, the reference's format) p50 "
                f"{out['harness_p50_ms']}, p99 {out['harness_p99_ms']}")
            check(n_h == JOB_HARNESS_QUERIES and len(csv) == n_h
                  and all(len(r) == 4 for r in csv),
                  "the latency harness's CSV")
            # the one job's replies phase 18 holds the fleet against: the
            # published topic, these TOPK lists and an MGET of sampled keys
            all_keys = sorted({parse_als_record(line)[0]
                               for line in published})
            fleet_keys = [all_keys[j] for j in np.random.default_rng(5)
                          .choice(len(all_keys), FLEET_MGET_KEYS,
                                  replace=False)]
            out["fleet_base"] = dict(
                published=published, users=qu, topk=wire, keys=fleet_keys,
                mget=client.query_states(JOB_STATE, fleet_keys),
                count=health["keys"], ready_s=ready_s, wire_p50_ms=p50)

            # 4. live MSE against the offline MSE of the same ratings
            users, items, ratings = ratings_t
            pick = np.random.default_rng(7).choice(len(ratings),
                                                   JOB_MSE_RATINGS,
                                                   replace=False)
            write_ratings_tsv(w("mse.tsv"), users[pick], items[pick],
                              ratings[pick])

            def live_mse(tag):
                t0 = time.perf_counter()
                v = MSE.run(Params.from_args(
                    ["--input", w("mse.tsv"), "--jobId", JOB_ID,
                     "--output", w(f"mse-{tag}.txt")]))
                return v, time.perf_counter() - t0

            live, live_s = live_mse("live")
            t0 = time.perf_counter()
            offline = MSE.run(Params.from_args(
                ["--input", w("mse.tsv"), "--model",
                 w("model", "userFactors") + "," + w("model", "itemFactors"),
                 "--device", dev_name, "--output", w("mse-offline.txt")]))
            offline_s = time.perf_counter() - t0
            gap = abs(live - offline) / offline
            out.update(mse_live=live, mse_offline=offline, mse_live_s=live_s)
            log(f"job live MSE on {JOB_MSE_RATINGS} training ratings (seed "
                f"7): {float(live)!r} in {live_s:.2f}s (one MGET a user "
                f"group, pipelined, float64 on the host); offline --model on "
                f"the card {float(offline)!r} in {offline_s:.2f}s; relative "
                f"gap {gap:.3e} (limit 1e-5)")
            check(gap <= 1e-5, "the live MSE is not the offline one")

            # 5. the push plane, paced, then live through the SGD load
            sub, push_served, paced = push_paced_phase(
                job, client, journal, table, u_ids, i_ids, items64, col_of)
            subs.append(sub)
            out.update({f"push_{k}": v for k, v in paced.items()})

            # 6. online SGD on fresh ratings, closing the loop, with the
            # subscriptions live
            rng1 = np.random.default_rng(1)
            su = rng1.integers(0, len(u_ids), JOB_SGD_RATINGS)
            si = rng1.integers(0, len(i_ids), JOB_SGD_RATINGS)
            sr = rng1.uniform(1.0, 5.0, JOB_SGD_RATINGS)
            write_ratings_tsv(w("updates.tsv"), np.asarray(u_ids)[su],
                              np.asarray(i_ids)[si], sr, header=False)
            emitted = []
            real_append = PJ.Journal.append

            def recording_append(self, lines, flush=True):
                lines = list(lines)
                emitted.extend(lines)
                return real_append(self, lines, flush)

            PJ.Journal.append = recording_append
            sub.start_draining()
            before_sgd = client.metrics()
            try:
                t0 = time.perf_counter()
                n_sgd = SGD.run(Params.from_args(
                    ["--input", w("updates.tsv"), "--mode", "once",
                     "--outputMode", "kafka", "--batchSize", "256",
                     "--journalDir", w("journal"), "--topic", JOB_TOPIC,
                     "--jobId", JOB_ID, "--learningRate", "0.05"]))
                sgd_s = time.perf_counter() - t0
            finally:
                PJ.Journal.append = real_append
            end = journal.end_offset()
            queryable_s = job.wait_offset(end)
            fresh_s = index_fresh_s(client, u_ids[0])
            out.update(sgd_updates_per_s=n_sgd / sgd_s,
                       queryable_s=queryable_s, index_fresh_s=fresh_s)
            sub.settle(client.metrics, quiet_s=0.3)
            sub.stop_draining()
            load = push_window(before_sgd, client.metrics())
            audit = PUSH.audit_push_sequences(sub.events)
            out.update({f"push_sgd_{k}": v for k, v in load.items()})
            log(f"job push under the SGD load ({n_sgd} ratings, "
                f"{len(emitted)} rows; equality not checked: these updates "
                f"dirty every item, so the index rebuilds in the background "
                f"and serves, and re-scores through, the old matrix "
                f"meanwhile): engine {load['batches']:.0f} batches, "
                f"{load['deltas']:.0f} deltas, {load['dispatches']:.0f} "
                f"topk_many dispatches, {load['rescored']:.0f} subscriptions "
                f"re-scored, selectivity {load['selectivity']:.4f} "
                f"({load['candidates']:.0f} candidates over a population of "
                f"{load['population']:.0f}); update->push latency p50 "
                f"{load['latency_p50_ms']:.3f} ms, p99 "
                f"{load['latency_p99_ms']:.3f} ms (bucket upper bounds); "
                f"ingest with subscriptions live "
                f"{load['ingest_rows_per_s']:.0f} rows/s of apply time; "
                f"audit {audit['subs']} streams, {audit['delivered']} "
                f"delivered, {audit['missed']} missed, "
                f"{audit['duplicates']} duplicates")
            check(audit["missed"] == audit["duplicates"] == 0,
                  f"the push audit under load: {audit}")
            check(load["deltas"] > 0, "the SGD load pushed nothing")
            last = dict(parse_als_record(line) for line in emitted)
            keys = sorted(last)
            krng = np.random.default_rng(2)
            sample = [keys[j] for j in krng.choice(len(keys), JOB_SAMPLE - 1,
                                                   replace=False)]
            sample.append(parse_als_record(emitted[-1])[0])  # the newest
            served = client.query_states(JOB_STATE, sample)
            held = sum(a == last[k] for k, a in zip(sample, served))
            upd_users = [k[:-2] for k in keys if k.endswith("-U")]
            upd_users = [upd_users[j] for j in krng.choice(
                len(upd_users), min(JOB_SAMPLE, len(upd_users)),
                replace=False)]
            items_served = push_served.copy()
            for k, v in last.items():
                if k.endswith("-I"):
                    items_served[col_of[k[:-2]]] = np.asarray(
                        v.split(";"), np.float64)
            user_rows = np.stack([np.asarray(
                last.get(f"{u}-U", table.get(f"{u}-U")).split(";"),
                np.float64) for u in upd_users])
            topk_after = served_topk(client, upd_users)
            fresh = float64_agree(topk_after, user_rows, items_served, col_of)
            after, after_s = live_mse("after")
            out.update(mse_after=after)
            log(f"job online SGD: {n_sgd} ratings (seed 1) in {sgd_s:.2f}s, "
                f"{n_sgd / sgd_s:.0f} updates/s, {len(emitted)} rows "
                f"appended; the job's offset reached the journal's end "
                f"{queryable_s:.3f}s after the last append, and its top-k "
                f"index had no dirty row {fresh_s:.3f}s later; {held} of "
                f"{len(sample)} sampled keys serve their last journal row "
                f"(the newest row's key among them); {fresh} of "
                f"{len(upd_users)} updated users' TOPK agree with a float64 "
                f"top-k of the served rows; live MSE after the updates "
                f"{float(after)!r} (before {float(live)!r}) in "
                f"{after_s:.2f}s")
            check(n_sgd == JOB_SGD_RATINGS and len(emitted) == 2 * n_sgd,
                  f"SGD processed {n_sgd} ratings, {len(emitted)} rows")
            check(held == len(sample), f"{len(sample) - held} served rows "
                  "differ from their last journal row")
            check(fresh == len(upd_users), f"{len(upd_users) - fresh} TOPK "
                  "replies after the updates are stale")

            # 7. restart from the checkpoint
            ckpt = w("ckpt")
            t0 = time.perf_counter()
            ck_off = None
            while time.perf_counter() - t0 < JOB_WAIT_S:
                ck_off = checkpoint_offset(ckpt)
                if ck_off is not None and ck_off >= pub_end:
                    break
                time.sleep(0.2)
            check(ck_off is not None and ck_off >= pub_end,
                  "no checkpoint past the published model")
            # a tail behind the checkpoint for the restart to replay: the
            # newest SGD rows again (the same values, so the state holds)
            tail_end = journal.append(emitted[-JOB_SAMPLE * 16:])
            job.wait_offset(tail_end)
            before = (client.count(JOB_STATE),
                      client._roundtrip(f"MGET\t{JOB_STATE}\t"
                                        + ",".join(sample)),
                      served_topk(client, upd_users[:16]))
            sub.close()
            job.stop()
            check(registry.resolve(JOB_ID) is None,
                  "the stopped job is still in the registry")
            cold_snaps = snapshot_lines(job.log_text())
            ck_off = checkpoint_offset(ckpt)  # the one the restart reads
            newest = PS.list_manifests(snap_root)[-1]["offset"]
            # the reference's overlay: a snapshot ahead of the checkpoint
            # replaces that much replay
            want_source = "snapshot" if newest > ck_off else "checkpoint"
            job = ServingJobProcess(work, dev, "restart")
            jobs.append(job)
            restart_s, health = job.wait_ready()
            client = job.client
            after_restart = (client.count(JOB_STATE),
                             client._roundtrip(f"MGET\t{JOB_STATE}\t"
                                               + ",".join(sample)),
                             served_topk(client, upd_users[:16]))
            out.update(restart_ready_s=restart_s,
                       restore_s=health["bootstrap_seconds"],
                       snapshots_at_checkpoints=len(cold_snaps) - 1)
            log(f"job restart: SIGTERM, then ready in {restart_s:.2f}s from "
                f"the process start (bootstrap {health['bootstrap_seconds']:.3f}"
                f"s from the {health['bootstrap_source']}: the checkpoint at "
                f"offset {ck_off}, the newest snapshot at {newest}, so the "
                f"reference's overlay picks the {want_source}; a tail of "
                f"{tail_end - max(ck_off, newest)} bytes replayed; the cold "
                f"replay's {cold_s:.3f}s); the cold job published "
                f"{len(cold_snaps) - 1} snapshots at checkpoints "
                f"({', '.join(f'{r} rows in {t:.3f}s' for r, _, t in cold_snaps[1:])}); "
                f"COUNT {after_restart[0]}, the sampled MGET and 16 TOPK "
                f"equal to those before: {after_restart == before}")
            check(health["bootstrap_source"] == want_source
                  and health["offset"] == tail_end,
                  f"the restarted job's HEALTH {health}, want "
                  f"{want_source}")
            check(after_restart == before,
                  "the restarted job serves other replies")

            # 8. a restart with the checkpoint gone: the newest snapshot
            # bootstraps it, and only the tail behind it replays
            job.stop()
            os.rename(ckpt, ckpt + "-aside")
            job = ServingJobProcess(work, dev, "snapshot")
            jobs.append(job)
            snap_ready_s, health = job.wait_ready()
            client = job.client
            after_snap = (client.count(JOB_STATE),
                          client._roundtrip(f"MGET\t{JOB_STATE}\t"
                                            + ",".join(sample)),
                          served_topk(client, upd_users[:16]))
            out.update(snapshot_restart_ready_s=snap_ready_s,
                       snapshot_bootstrap_s=health["bootstrap_seconds"])
            log(f"job restart from the snapshot alone (checkpoint moved "
                f"away): ready in {snap_ready_s:.2f}s from the process "
                f"start, bootstrap {health['bootstrap_seconds']:.3f}s from "
                f"the {health['bootstrap_source']} at offset {newest} (the "
                f"restart from the checkpoint {restart_s:.2f}s, bootstrap "
                f"{out['restore_s']:.3f}s; the cold replay {cold_s:.3f}s); "
                f"the same COUNT, MGET and TOPK: "
                f"{after_snap == before}")
            check(health["bootstrap_source"] == "snapshot"
                  and health["offset"] == tail_end,
                  f"the snapshot restart's HEALTH {health}")
            check(after_snap == before,
                  "the snapshot restart serves other replies")
            job.stop()

            # 9. compaction
            out.update({f"compact_{k}": v for k, v in compaction_phase(
                work, journal, u_ids, i_ids, dev).items()})
            handler.close()
        finally:
            for sub in subs:
                sub.close()
            for job in jobs:
                job.stop()
            if prior_registry is None:
                os.environ.pop("TPUMS_REGISTRY_DIR", None)
            else:
                os.environ["TPUMS_REGISTRY_DIR"] = prior_registry
    log(f"job phase: {time.perf_counter() - t_phase:.1f}s")
    return out


# -- phase 18: the serving fleet ----------------------------------------------

FLEET_MGET_KEYS = 1000      # keys every topology must serve byte for byte
FLEET_LATENCY_CALLS = 300   # sequential fan-out TOPK timed
FLEET_RATE_QPS = 300.0      # the reference bench's open-loop stream
FLEET_WINDOW_S = 1.0        # each latency window of the stream
FLEET_PARTITIONS = 16       # the update plane's default partitions
FLEET_BATCH = 256           # its default batch
FLEET_RESHARD_RATINGS = 10_000  # streamed through a live 2 -> 4 cutover
FLEET_RATINGS = 12_500      # then at 4 shards (seed 23)
FLEET_WAIT_S = 300.0        # the longest any fleet step may wait
FLEET_CHECKPOINT_MS = 2000
# the reference bench's cadence; a 5 s TTL leaves headroom for workers
# that share one card's host while they start
FLEET_ENV = {"TPUMS_HEARTBEAT_S": "0.2", "TPUMS_REPLICA_TTL_S": "5",
             "TPUMS_UPDATE_POLL_S": "0.005"}


class OpenLoopStream:
    """GETs of sampled keys at a fixed rate from one thread, through one
    fleet client; each latency is taken from the request's intended send
    time, so a stall shows as the backlog behind it (open loop).  A raise
    or a missing row is a client-visible error."""

    def __init__(self, make_client, keys, rate_qps=None, seed=1):
        import threading

        self.make_client, self.keys = make_client, keys
        self.interval = 1.0 / (rate_qps or FLEET_RATE_QPS)
        self.rng = np.random.default_rng(seed)
        self.samples, self.errors = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        t_next = time.perf_counter()
        with self.make_client() as c:
            while not self._stop.is_set():
                t, t_next = t_next, t_next + self.interval
                now = time.perf_counter()
                if t > now:
                    time.sleep(t - now)
                key = self.keys[int(self.rng.integers(len(self.keys)))]
                try:
                    err = None if c.query_state(JOB_STATE, key) is not None \
                        else "missing"
                except Exception as e:
                    err = repr(e)
                self.samples.append((t, (time.perf_counter() - t) * 1e3))
                if err is not None:
                    self.errors.append((key, err))

    def window(self, t0, t1) -> dict:
        ms = [m for t, m in self.samples if t0 <= t < t1]
        if not ms:
            return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
        return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99))}

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


def fmt_window(name, w) -> str:
    return (f"{name} {w['n']} q p50 {w['p50_ms']:.3f} / p99 "
            f"{w['p99_ms']:.3f} ms")


def fleet_baseline(published, dev, n_users, n_keys=None):
    """The one job's replies without the job: its TOPK lists of `n_users`
    sampled users and its MGET of sampled keys, from the in-process handler
    over the published rows (phase 17 holds the job's wire replies equal to
    this handler's byte for byte).  For a rehearsal of phase 18 alone."""
    from flink_ms_tpu_torch.serve.consumer import parse_als_record
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    table = ModelTable()
    table.put_many([parse_als_record(line) for line in published])
    keys = sorted(k for k, _ in table.items())
    users = [k[:-2] for k in keys if k.endswith("-U") and k != "MEAN-U"]
    rng = np.random.default_rng(0)
    users = [users[j] for j in rng.integers(0, len(users), n_users)]
    handler = make_als_topk_handler(table, device=dev)
    handler.batching = False
    topk = [f"V\t{handler(u, TOPK_K)}" for u in users]
    handler.close()
    n_keys = n_keys or FLEET_MGET_KEYS
    sample = [keys[j] for j in np.random.default_rng(5).choice(
        len(keys), n_keys, replace=False)]
    return dict(published=published, users=users, topk=topk, keys=sample,
                mget=[table.get(k) for k in sample], count=len(keys),
                ready_s=float("nan"), wire_p50_ms=float("nan"))


def fleet_worker(work, idx, n, dev_name, label, extra=(), env=None):
    """One ``flink_ms_tpu_torch.serve.sharded`` worker process (as
    ``spawn_worker_procs`` starts it, with its log kept; ``env`` added to
    this process's environment) -> (proc, port file, log path)."""
    pf = os.path.join(work, f"port-{label}-{idx}.json")
    if os.path.exists(pf):
        os.unlink(pf)
    log_path = os.path.join(work, f"worker-{label}-{idx}.log")
    env = child_env(env)
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "flink_ms_tpu_torch.serve.sharded",
             "--workerIndex", str(idx), "--numWorkers", str(n),
             "--device", dev_name, "--journalDir",
             os.path.join(work, "journal"), "--topic", JOB_TOPIC,
             "--host", "127.0.0.1", "--port", "0", "--portFile", pf,
             *extra], stdout=log_f, stderr=subprocess.STDOUT, env=env)
    return proc, pf, log_path


def wait_port_file(proc, pf, log_path) -> int:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < FLEET_WAIT_S:
        if os.path.exists(pf) and os.path.getsize(pf) > 0:
            with open(pf) as f:
                return json.load(f)["port"]
        if proc.poll() is not None:
            with open(log_path) as f:
                raise SmokeFailure(f"a fleet worker exited {proc.returncode}"
                                   f": {f.read()[-2000:]}")
        time.sleep(0.02)
    raise SmokeFailure(f"a fleet worker published no port: {log_path}")


def wait_health_ready(ports, procs=()):
    """Seconds until every worker's HEALTH reports ready -> the reports."""
    from flink_ms_tpu_torch.serve.client import QueryClient

    out = []
    t0 = time.perf_counter()
    for port in ports:
        with QueryClient("127.0.0.1", port, timeout_s=60) as c:
            while True:
                check(all(p.poll() is None for p in procs),
                      "a fleet worker exited before it was ready")
                h = c.health(JOB_STATE)
                if h["ready"]:
                    out.append(h)
                    break
                check(time.perf_counter() - t0 < FLEET_WAIT_S,
                      "the fleet was not ready in time")
                time.sleep(0.02)
    return out


def wait_until(pred, what, timeout_s=None):
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < (timeout_s or FLEET_WAIT_S),
              f"timed out waiting for {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def fleet_topk_checks(got, run, label) -> str:
    """Fan-out lists against a float64 top-k of the published rows and
    against the one job's lists: every list must agree with float64, and
    one that differs from the one job's must differ at a near tie (both
    agree with float64)."""
    agree = same = 0
    col_of, s64 = run.col_of, run.s64
    for j, lst in enumerate(got):
        cols = [col_of[item] for item, _ in lst]
        agree += topk_agrees(cols, s64[j], TOPK_K)[0]
        one_job = parse_reply(run.base["topk"][j][2:])[0]
        if [item for item, _ in lst] == one_job:
            same += 1
        else:
            check(topk_agrees([col_of[i] for i in one_job], s64[j],
                              TOPK_K)[0],
                  f"{label}: a list differs from the one job's off a tie")
    check(agree == len(got), f"{label}: {len(got) - agree} lists off the "
          "float64 top-k")
    return (f"{agree} of {len(got)} agree with a float64 top-k, {same} "
            "equal the one job's lists (any other only at a near tie)")


def metrics_hist(snapshot, name):
    """The histogram `name` of a (merged) METRICS snapshot, summed over its
    series: (le, counts, count)."""
    le, counts, n = None, None, 0
    for h in snapshot.get("histograms", []):
        if h["name"] == name:
            le = le or h["le"]
            counts = h["counts"] if counts is None else \
                [a + b for a, b in zip(counts, h["counts"])]
            n += h["count"]
    return le, counts, n


def fleet_visibility(before, after) -> dict:
    """publish -> queryable p50/p99 (ms, bucket upper bounds) of the
    update plane's visibility probes between two fleet scrapes."""
    name = "tpums_update_visibility_seconds"
    le, c1, n1 = metrics_hist(after, name)
    _, c0, n0 = metrics_hist(before, name)
    if le is None or n1 - n0 <= 0:
        return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
    counts = np.asarray(c1) - np.asarray(c0 or [0] * len(c1))
    return {"n": n1 - n0,
            "p50_ms": 1e3 * bucket_quantile(le, counts, 0.50),
            "p99_ms": 1e3 * bucket_quantile(le, counts, 0.99)}


class FleetRun:
    """What the parts of phase 18 share: a work dir whose journal holds
    the published rows, the float64 scores of the sampled users, the one
    job's replies, and every process, supervisor, controller and stream
    to stop at the end (``close``, on every path)."""

    def __init__(self, work, base, dev):
        from flink_ms_tpu_torch.serve.client import RetryPolicy
        from flink_ms_tpu_torch.serve.consumer import parse_als_record
        from flink_ms_tpu_torch.serve.journal import Journal

        self.work, self.base = work, base
        self.dev_name = "cuda" if dev.type == "cuda" else "cpu"
        self.rows = dict(parse_als_record(line)
                         for line in base["published"])
        self.item_ids = [k[:-2] for k in self.rows if k.endswith("-I")]
        self.col_of = {i: c for c, i in enumerate(self.item_ids)}
        items64 = np.stack([np.asarray(self.rows[f"{i}-I"].split(";"),
                                       np.float64) for i in self.item_ids])
        users64 = np.stack([np.asarray(self.rows[f"{u}-U"].split(";"),
                                       np.float64) for u in base["users"]])
        self.s64 = users64 @ items64.T
        self.retry = RetryPolicy(attempts=6, backoff_s=0.02,
                                 max_backoff_s=0.5)
        self.procs, self.sups, self.ctls, self.streams = [], [], [], []
        self.journal = Journal(self.path("journal"), JOB_TOPIC)
        published = base["published"]
        for s in range(0, len(published), 50_000):
            self.journal.append(published[s:s + 50_000])
        self.ctl = self.stream = self.probe = None

    def path(self, *p):
        return os.path.join(self.work, *p)

    def close(self):
        from flink_ms_tpu_torch.serve.sharded import stop_worker_procs

        for stream in self.streams:
            stream.stop()
        if self.probe is not None:
            self.probe.close()
        for ctl in self.ctls:
            ctl.stop(drop_topology=True)
        for sup in self.sups:
            sup.stop()
        stop_worker_procs(self.procs)


def fleet_sharded(run) -> dict:
    """(a) 2 workers from ``spawn_worker_procs``, fs checkpoints: counts,
    MGET, fan-out TOPK and its sweep, latency, a SIGKILL, a restart."""
    import signal

    from flink_ms_tpu_torch.serve.sharded import (ShardedQueryClient,
                                                  owner_of,
                                                  spawn_worker_procs,
                                                  stop_worker_procs)

    base, users, keys = run.base, run.base["users"], run.base["keys"]
    os.makedirs(run.path("ports"))
    t0 = time.perf_counter()
    ck_args = ["--checkpointDataUri", run.path("ckpt"),
               "--checkPointInterval", str(FLEET_CHECKPOINT_MS)]
    run.procs, ports = spawn_worker_procs(
        2, run.path("journal"), JOB_TOPIC, run.path("ports"),
        state_backend="fs", extra_args=ck_args, timeout_s=FLEET_WAIT_S,
        device=run.dev_name)
    procs = run.procs
    health = wait_health_ready(ports, procs)
    ready_s = time.perf_counter() - t0
    counts = [h["keys"] for h in health]
    want = [sum(owner_of(k, 2) == i for k in run.rows) for i in range(2)]
    client = ShardedQueryClient([("127.0.0.1", p) for p in ports],
                                timeout_s=60)
    mget = client.query_states(JOB_STATE, keys)
    t0 = time.perf_counter()
    fan = [client.topk(JOB_STATE, u, TOPK_K) for u in users]
    first_s = time.perf_counter() - t0
    fan_msg = fleet_topk_checks(fan, run, "fan-out")
    t0 = time.perf_counter()
    many = client.topk_many(JOB_STATE, users, TOPK_K)
    many_s = time.perf_counter() - t0
    many_msg = fleet_topk_checks(many, run, "topk_many")
    same_many = sum([i for i, _ in a] == [i for i, _ in b]
                    for a, b in zip(many, fan))
    rng = np.random.default_rng(3)
    lat_users = [users[j] for j in rng.integers(0, len(users),
                                                FLEET_LATENCY_CALLS)]
    p50, p99 = latency_ms(lambda j: client.topk(
        JOB_STATE, lat_users[j], TOPK_K), FLEET_LATENCY_CALLS)
    out = dict(sharded_ready_s=ready_s, fanout_p50_ms=p50, fanout_p99_ms=p99,
               topk_many_s=many_s)
    log(f"fleet (a) sharded: 2 workers ({run.dev_name}) ready {ready_s:.2f}s "
        f"after the spawn (the one job {base['ready_s']:.2f}s); COUNT "
        f"{counts} = the owner_of split {want}, sum {sum(counts)} (the one "
        f"job's {base['count']}); MGET of {len(keys)} keys equal to the one "
        f"job's: {mget == base['mget']}; {len(users)} fan-out TOPK k="
        f"{TOPK_K} in {first_s:.3f}s (the indexes' builds included): "
        f"{fan_msg}; topk_many of the same {len(users)} in one sweep "
        f"{many_s:.3f}s: {many_msg}, {same_many} equal to the sequential "
        f"fan-out; {FLEET_LATENCY_CALLS} sequential fan-out TOPK p50 "
        f"{p50:.4f} ms, p99 {p99:.4f} ms (the one job's wire p50 "
        f"{base['wire_p50_ms']:.4f} ms)")
    check(counts == want and sum(counts) == base["count"] == len(run.rows),
          f"worker counts {counts}, want {want}")
    check(mget == base["mget"], "MGET differs from the one job's")
    # a checkpoint of worker 1 to restart from, then SIGKILL it
    wait_until(lambda: os.path.exists(run.path("ckpt", "worker-1",
                                               "latest")),
               "worker 1's checkpoint")
    mine = [k for k in keys if owner_of(k, 2) == 1][:16]
    theirs = [k for k in keys if owner_of(k, 2) == 0][:16]
    before = (client.query_states(JOB_STATE, mine + theirs),
              [client.topk(JOB_STATE, u, TOPK_K) for u in users[:16]])
    procs[1].send_signal(signal.SIGKILL)
    procs[1].wait(timeout=30)
    raised = 0
    for k in mine:
        try:
            client.query_state(JOB_STATE, k)
        except (ConnectionError, OSError):
            raised += 1
    served = client.query_states(JOB_STATE, theirs)
    client.close()
    check(raised == len(mine) and served == before[0][len(mine):],
          f"after the SIGKILL {raised} of {len(mine)} of worker 1's keys "
          f"raised; worker 0 served {served == before[0][len(mine):]}")
    t0 = time.perf_counter()
    proc, pf, log_path = fleet_worker(run.work, 1, 2, run.dev_name,
                                      "restart",
                                      ["--stateBackend", "fs", *ck_args])
    procs[1] = proc
    ports[1] = wait_port_file(proc, pf, log_path)
    h1 = wait_health_ready([ports[1]], [proc])[0]
    restart_s = time.perf_counter() - t0
    client = ShardedQueryClient([("127.0.0.1", p) for p in ports],
                                timeout_s=60)
    after = (client.query_states(JOB_STATE, mine + theirs),
             [client.topk(JOB_STATE, u, TOPK_K) for u in users[:16]])
    client.close()
    out.update(sharded_restart_s=restart_s)
    log(f"fleet (a) SIGKILL of worker 1: {raised} of {len(mine)} of its keys "
        f"raise ConnectionError, worker 0's {len(theirs)} serve; the restart "
        f"ready {restart_s:.2f}s after its spawn, bootstrap "
        f"{h1['bootstrap_seconds']:.3f}s from the {h1['bootstrap_source']}, "
        f"the same MGET and 16 fan-out TOPK: {after == before}")
    check(h1["bootstrap_source"] == "checkpoint",
          f"the restarted worker's HEALTH {h1}")
    check(after == before, "the restarted worker serves other replies")
    stop_worker_procs(procs)
    run.procs = []
    return out


def fleet_ha(run) -> dict:
    """(b) ``ReplicaSupervisor`` 2 shards x 2 replicas; the open-loop
    stream before, through and after a replica's SIGKILL and respawn."""
    import signal

    from flink_ms_tpu_torch.serve import registry
    from flink_ms_tpu_torch.serve.ha import ReplicaSupervisor

    t0 = time.perf_counter()
    sup = ReplicaSupervisor(2, 2, run.path("journal"), JOB_TOPIC,
                            run.path("ports-ha"), job_group="fleet-ha",
                            check_interval_s=0.2, respawn_delay_s=0.1,
                            spawn_timeout_s=FLEET_WAIT_S,
                            device=run.dev_name)
    run.sups.append(sup)
    sup.start()
    check(sup.wait_all_ready(FLEET_WAIT_S), "the HA fleet was not ready")
    ready_s = time.perf_counter() - t0
    stream = OpenLoopStream(lambda: sup.client(retry=run.retry,
                                               timeout_s=10),
                            run.base["keys"]).start()
    run.streams.append(stream)
    t_a = time.perf_counter()
    time.sleep(FLEET_WINDOW_S)
    victim, victim_id = sup.procs[(0, 0)], sup.job_id(0, 0)
    t_kill = time.perf_counter()
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=30)

    def respawned():
        # the monitor counts the respawn once the new port file is read,
        # which may come after a small table's ready flip
        e = registry.resolve(victim_id)
        return bool(e and e.get("ready") and e["pid"] != victim.pid
                    and sup.respawns >= 1)

    wait_until(respawned, "the respawned replica")
    respawn_s = time.perf_counter() - t_kill
    t_back = time.perf_counter()
    time.sleep(FLEET_WINDOW_S)
    stream.stop()
    names = ("before", "during", "after")
    wins = [stream.window(t_a, t_kill), stream.window(t_kill, t_back),
            stream.window(t_back, time.perf_counter())]
    log(f"fleet (b) HA: 2 shards x 2 replicas ready {ready_s:.2f}s after "
        f"the supervisor's start; an open loop of GETs at "
        f"{FLEET_RATE_QPS:.0f} q/s, SIGKILL of replica s0r0: respawned and "
        f"ready {respawn_s:.2f}s later ({sup.respawns} respawn); "
        + "; ".join(fmt_window(n, x) for n, x in zip(names, wins))
        + f"; {len(stream.errors)} client-visible errors")
    check(not stream.errors, f"HA errors: {stream.errors[:3]}")
    sup.stop()
    run.sups.remove(sup)
    return dict(ha_ready_s=ready_s, ha_respawn_s=respawn_s,
                **{f"ha_{n}_p99_ms": x["p99_ms"]
                   for n, x in zip(names, wins)})


def fleet_group(run):
    """The elastic group of (c) and (d): generation 1 at 2 shards, every
    generation's workers with the co-located update plane; the open-loop
    stream started on it."""
    from flink_ms_tpu_torch.serve.elastic import (ElasticClient,
                                                  ScaleController)

    run.ctl = ScaleController(
        "fleet-el", run.path("journal"), JOB_TOPIC,
        port_dir=run.path("ports-el"), ready_timeout_s=FLEET_WAIT_S,
        device=run.dev_name,
        extra_args=["--updatePlane", "true", "--updatePartitions",
                    str(FLEET_PARTITIONS), "--updateBatch", str(FLEET_BATCH),
                    "--pollInterval", "0.005"])
    run.ctls.append(run.ctl)
    t0 = time.perf_counter()
    run.ctl.scale_to(2)
    ready_s = time.perf_counter() - t0
    run.probe = ElasticClient("fleet-el", timeout_s=60, retry=run.retry)
    run.stream = OpenLoopStream(lambda: ElasticClient(
        "fleet-el", timeout_s=10, retry=run.retry), run.base["keys"]).start()
    run.streams.append(run.stream)
    return ready_s


def fleet_elastic(run) -> dict:
    """(c) ``ScaleController`` 2 -> 4 -> 2 under the open-loop stream: the
    same payloads at every topology, each cutover's seconds, the windows,
    the generation GC."""
    from flink_ms_tpu_torch.serve import registry

    keys, want = run.base["keys"], run.base["mget"]
    ready_s = fleet_group(run)
    ctl, stream = run.ctl, run.stream
    payloads = [run.probe.query_states(JOB_STATE, keys)]
    marks, cut = [time.perf_counter()], []
    for shards in (4, 2):
        time.sleep(FLEET_WINDOW_S)
        t0 = time.perf_counter()
        marks.append(t0)
        rec = ctl.scale_to(shards)
        cut.append(time.perf_counter() - t0)
        marks.append(time.perf_counter())
        check(rec["shards"] == shards, f"the cutover to {shards}")
        payloads.append(run.probe.query_states(JOB_STATE, keys))
    time.sleep(FLEET_WINDOW_S)
    marks.append(time.perf_counter())
    names = ("gen 1 (2)", "cutover 2->4", "gen 2 (4)", "cutover 4->2",
             "gen 3 (2)")
    wins = [stream.window(a, b) for a, b in zip(marks, marks[1:])]
    drained = [e for e in ctl.events if e["kind"] == "drained"]
    live = sorted({registry.generation_of(e, ctl.group)
                   for e in registry.list_jobs()} - {None})
    log(f"fleet (c) elastic: generation 1 (2 shards) ready {ready_s:.2f}s "
        f"after scale_to; cutovers 2->4 {cut[0]:.2f}s and 4->2 "
        f"{cut[1]:.2f}s (spawn, replay, verify, publish, drain); the "
        f"{len(keys)} sampled payloads at every topology equal the one "
        f"job's: {all(p == want for p in payloads)}; "
        + "; ".join(fmt_window(n, x) for n, x in zip(names, wins))
        + f"; {len(stream.errors)} failed queries; generation GC: "
        f"{[d['gen'] for d in drained]} drained, "
        f"{sum(d['reaped'] for d in drained)} dead entries reaped, live "
        f"generations {live}")
    check(not stream.errors, f"elastic errors: {stream.errors[:3]}")
    check(all(p == want for p in payloads),
          "a topology served other payloads")
    check(live == [3], f"live generations {live}")
    return dict(elastic_ready_s=ready_s, cutover_s=cut,
                **{f"elastic_{j}_p99_ms": x["p99_ms"]
                   for j, x in enumerate(wins)})


def applied_rows(run) -> list:
    """Every row of the update plane's apply records."""
    from flink_ms_tpu_torch.serve import update_plane as UP
    from flink_ms_tpu_torch.serve.journal import Journal

    out = []
    for p in range(FLEET_PARTITIONS):
        for line in UP._read_all_lines(Journal(
                run.path("journal"), UP.apply_topic(JOB_TOPIC, p))):
            fields = line.split("\t", 3)
            if len(fields) > 3 and fields[3]:
                out.extend(fields[3].split("|"))
    return out


def fleet_updates(run) -> dict:
    """(d) the update plane on the 2-shard generation of the elastic
    group: duplicate-free ratings streamed through a live 2 -> 4 cutover
    (rows held against one ``SGDStep`` run), then ``FLEET_RATINGS`` at 4
    shards; the audit at 0 lost, 0 doubled after each."""
    import threading

    from flink_ms_tpu_torch.obs.scrape import scrape_fleet
    from flink_ms_tpu_torch.online.sgd import SGDStep
    from flink_ms_tpu_torch.serve import update_plane as UP
    from flink_ms_tpu_torch.serve.table import ModelTable

    rows, jdir = run.rows, run.path("journal")
    ucli = UP.UpdatePlaneClient(jdir, JOB_TOPIC, partitions=FLEET_PARTITIONS)
    u_all = np.asarray([int(k[:-2]) for k in rows
                        if k.endswith("-U") and k != "MEAN-U"])
    i_all = np.asarray([int(i) for i in run.item_ids if i != "MEAN"])
    rng = np.random.default_rng(22)
    n = FLEET_RESHARD_RATINGS
    dfree = list(zip(rng.choice(u_all, n, replace=False).tolist(),
                     rng.choice(i_all, n, replace=False).tolist(),
                     np.round(rng.uniform(1.0, 5.0, n), 3).tolist()))
    sent = [0]

    def produce():
        # 1,000 ratings a second, so the stream outlasts the cutover
        for s in range(0, n, 100):
            ucli.submit_many(dfree[s:s + 100])
            sent[0] += len(dfree[s:s + 100])
            time.sleep(0.1)

    def drained(total):
        return lambda: sum(UP.applied_watermarks(
            jdir, JOB_TOPIC, FLEET_PARTITIONS).values()) >= total

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    time.sleep(0.3)
    sent_before = sent[0]
    t0 = time.perf_counter()
    rec = run.ctl.scale_to(4)
    cut_s = time.perf_counter() - t0
    sent_during = sent[0] - sent_before
    producer.join(timeout=FLEET_WAIT_S)
    ucli.sync()
    wait_until(drained(n), "the reshard ratings' apply records")
    audit = UP.audit_partitions(jdir, JOB_TOPIC, FLEET_PARTITIONS)
    applied = applied_rows(run)
    table = ModelTable()
    table.put_many(list(rows.items()))
    step = SGDStep(table.get, rows["MEAN-U"], rows["MEAN-I"],
                   lookup_many=lambda ks: [table.get(k) for k in ks])
    want = []
    for s in range(0, n, FLEET_BATCH):
        want.extend(step.process_batch(dfree[s:s + FLEET_BATCH]))
    same = sorted(applied) == sorted(want)
    log(f"fleet (d) update plane, {FLEET_PARTITIONS} partitions, batch "
        f"{FLEET_BATCH}: {n} duplicate-free ratings (seed 22, distinct users "
        f"and items) at 1,000 a second: {sent_before} before the 2->4 "
        f"cutover, {sent_during} while it ran ({cut_s:.2f}s), the rest after "
        f"it; audit {audit['submitted']} submitted, {audit['lost']} lost, "
        f"{audit['duplicates']} doubled; the {len(applied)} rows of the "
        f"apply records equal one SGDStep run over the same ratings byte "
        f"for byte: {same}")
    check(rec["shards"] == 4 and sent_during > 0 and audit["lost"] == 0
          and audit["duplicates"] == 0 and audit["submitted"] == n,
          f"the reshard audit {audit}")
    check(same and len(applied) == 2 * n,
          "the plane's rows differ from one SGDStep run")

    rng = np.random.default_rng(23)
    fleet_r = list(zip(
        u_all[rng.integers(0, len(u_all), FLEET_RATINGS)].tolist(),
        i_all[rng.integers(0, len(i_all), FLEET_RATINGS)].tolist(),
        np.round(rng.uniform(1.0, 5.0, FLEET_RATINGS), 3).tolist()))
    total = n + FLEET_RATINGS
    snap0 = scrape_fleet()["fleet"]
    t0 = time.perf_counter()
    for s in range(0, FLEET_RATINGS, 2_000):
        ucli.submit_many(fleet_r[s:s + 2_000])
    ucli.sync()
    drain_s = wait_until(drained(total), "the fleet ratings' apply records")
    upd_s = time.perf_counter() - t0
    time.sleep(0.5)  # the last visibility probes land in the histograms
    vis = fleet_visibility(snap0, scrape_fleet()["fleet"])
    audit = UP.audit_partitions(jdir, JOB_TOPIC, FLEET_PARTITIONS)
    run.stream.stop()
    log(f"fleet (d) {FLEET_RATINGS} ratings (seed 23) at 4 shards: "
        f"{FLEET_RATINGS / upd_s:.0f} updates/s from the first submit to "
        f"the applied watermark ({upd_s:.2f}s; {drain_s:.2f}s after the "
        f"last submit); publish->queryable p50 {vis['p50_ms']:.3f} ms, p99 "
        f"{vis['p99_ms']:.3f} ms over {vis['n']} visibility probes (bucket "
        f"upper bounds); audit {audit['submitted']} submitted, "
        f"{audit['lost']} lost, {audit['duplicates']} doubled; the stream "
        f"through (d): {len(run.stream.errors)} failed queries")
    check(audit["lost"] == 0 and audit["duplicates"] == 0
          and audit["submitted"] == total, f"the update plane audit {audit}")
    check(not run.stream.errors,
          f"errors in (d): {run.stream.errors[:3]}")
    return dict(reshard_cutover_s=cut_s, updates_per_s=FLEET_RATINGS / upd_s,
                visibility_p50_ms=vis["p50_ms"],
                visibility_p99_ms=vis["p99_ms"])


def fleet_phase(torch, base, dev) -> dict:
    """Phase 18: the serving fleet on phase 17's published topic, every
    worker a ``--device`` process on this card: (a) 2 sharded workers
    (routing, fan-out TOPK, a SIGKILL and a restart from the checkpoint),
    (b) 2 shards x 2 replicas under a 300 q/s stream through a replica's
    SIGKILL, (c) an elastic group 2 -> 4 -> 2 under the stream, and (d)
    the co-located update plane streaming ratings through a live 2 -> 4
    cutover, then at 4 shards, audited for lost and doubled ratings."""
    import tempfile

    t_phase = time.perf_counter()
    prior = {k: os.environ.get(k)
             for k in list(FLEET_ENV) + ["TPUMS_REGISTRY_DIR"]}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        os.environ.update(FLEET_ENV)
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        run = None
        try:
            run = FleetRun(work, base, dev)
            out.update(fleet_sharded(run))
            out.update(fleet_ha(run))
            out.update(fleet_elastic(run))
            out.update(fleet_updates(run))
        finally:
            if run is not None:
                run.close()
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f}s")
    return out


# -- phase 19: the arena and the native store --------------------------------

ARENA_LATENCY_CALLS = 300     # sequential wire TOPK on the arena member
ARENA_NATIVE_CALLS = 500      # GET, MGET and B2 GET each on the native plane
ARENA_MGET_KEYS = 64          # keys of one MGET
ARENA_DFREE_RATINGS = 10_000  # duplicate-free, held against one SGDStep run
ARENA_RATINGS = 12_500        # timed at 4 shards, as phase 18 (d)


def arena_dir(run, worker=0, shards=1, replica=0, gen=0) -> str:
    """A fleet member's arena directory beside the journal."""
    return run.path("journal", f"{JOB_TOPIC}.arena-{JOB_STATE}-w{worker}"
                    f"of{shards}-r{replica}-g{gen}")


def arena_member(run, label, extra=()):
    """A one-of-one ``serve.sharded`` worker: a fleet member, so on the
    arena unless told otherwise -> (process, port, HEALTH at ready,
    seconds from its spawn to ready, its log)."""
    t0 = time.perf_counter()
    proc, pf, log_path = fleet_worker(run.work, 0, 1, run.dev_name, label,
                                      extra)
    run.procs.append(proc)
    port = wait_port_file(proc, pf, log_path)
    health = wait_health_ready([port], [proc])[0]
    return proc, port, health, time.perf_counter() - t0, log_path


def stop_member(run, proc) -> None:
    from flink_ms_tpu_torch.serve.sharded import stop_worker_procs

    stop_worker_procs([proc])
    run.procs.remove(proc)


def log_text(path) -> str:
    with open(path) as f:
        return f.read()


def arena_job(run) -> dict:
    """(a) a fleet-default member answers TOPK from its index on the card
    over the arena: the one dict job's replies by items and f32 rounding,
    the arena's geometry, wire TOPK p50/p99."""
    from flink_ms_tpu_torch.serve import arena as AR
    from flink_ms_tpu_torch.serve.client import QueryClient

    base, users = run.base, run.base["users"]
    proc, port, h, ready_s, log_path = arena_member(run, "arena")
    text = log_text(log_path)
    check("table: arena" in text, "the fleet member is not on the arena")
    reader = AR.attach_reader(arena_dir(run))
    check(reader is not None, "the member wrote no arena")
    geom = dict(size_bytes=reader.size_bytes,
                resident_bytes=reader.resident_bytes(), rows=reader.count,
                capacity=reader.capacity, stride=reader.stride,
                key_cap=reader.key_cap, generation=reader.generation)
    reader.close()
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        replies = [c._roundtrip(f"TOPK\t{JOB_STATE}\t{u}\t{TOPK_K}")
                   for u in users]
        count, mget = c.count(JOB_STATE), c.query_states(JOB_STATE,
                                                         base["keys"])
        plane = c.metrics()["meta"]["plane"]
        rng = np.random.default_rng(3)
        lat = [users[j] for j in rng.integers(0, len(users),
                                              ARENA_LATENCY_CALLS)]
        p50, p99 = latency_ms(lambda j: c._roundtrip(
            f"TOPK\t{JOB_STATE}\t{lat[j]}\t{TOPK_K}"), len(lat))
    got = [list(zip(*parse_reply(r[2:]))) for r in replies]
    msg = fleet_topk_checks(got, run, "arena TOPK")
    same, worst = 0, 0.0
    for r, b in zip(replies, base["topk"]):
        ids, sc = parse_reply(r[2:])
        bids, bsc = parse_reply(b[2:])
        if ids == bids:
            same += 1
            worst = max(worst, float(np.max(np.abs(np.subtract(sc, bsc)) /
                                            np.maximum(np.abs(bsc), 1e-30))))
    stop_member(run, proc)
    log(f"arena (a) a one-of-one fleet member ({run.dev_name}) on the "
        f"arena (its log: table: arena), plane {plane}: ready "
        f"{ready_s:.2f}s after its spawn, bootstrap "
        f"{h['bootstrap_seconds']:.3f}s from the {h['bootstrap_source']}; "
        f"arena {geom['rows']} rows, capacity {geom['capacity']}, stride "
        f"{geom['stride']}, key_cap {geom['key_cap']}, generation "
        f"{geom['generation']}, size_bytes {geom['size_bytes']}, "
        f"resident_bytes {geom['resident_bytes']}; COUNT {count} (the dict "
        f"job's {base['count']}), MGET of {len(base['keys'])} keys equal: "
        f"{mget == base['mget']}; {len(users)} TOPK k={TOPK_K}: {msg}; "
        f"{same} with the dict job's items, their scores within "
        f"{worst:.3e} relative; {len(lat)} sequential TOPK p50 {p50:.4f} "
        f"ms, p99 {p99:.4f} ms (the dict job's p50 "
        f"{base['wire_p50_ms']:.4f} ms)")
    check(plane == "python" and count == base["count"] == len(run.rows)
          and mget == base["mget"], "the arena member serves other rows")
    check(worst <= 1e-6, f"arena TOPK scores off by {worst} relative")
    return dict(replies=replies, ready_s=ready_s,
                bootstrap_s=h["bootstrap_seconds"], topk_p50_ms=p50,
                topk_p99_ms=p99, **geom)


def arena_native(run, a) -> dict:
    """(b) ``--nativeServer true`` over the same arena directory: GET,
    MGET and B2 GET p50/p99, TOPKV p50; the host-scored TOPKV lists
    against (a)'s by items and f32 rounding, near ties counted."""
    from flink_ms_tpu_torch.serve.client import QueryClient

    base, users, keys = run.base, run.base["users"], run.base["keys"]
    proc, port, h, ready_s, log_path = arena_member(
        run, "arena-native", ["--nativeServer", "true"])
    check("table: arena" in log_text(log_path),
          "the native member is not on the arena")
    rng = np.random.default_rng(4)
    get_keys = [keys[j] for j in rng.integers(0, len(keys),
                                              ARENA_NATIVE_CALLS)]
    mget_keys = [[keys[j] for j in rng.integers(0, len(keys),
                                                ARENA_MGET_KEYS)]
                 for _ in range(ARENA_NATIVE_CALLS)]
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        plane = c.metrics()["meta"]["plane"]
        count, mget = c.count(JOB_STATE), c.query_states(JOB_STATE, keys)
        get = latency_ms(lambda j: c.query_state(JOB_STATE, get_keys[j]),
                         len(get_keys))
        mg = latency_ms(lambda j: c.query_states(JOB_STATE, mget_keys[j]),
                        len(mget_keys))
        vec = [None] * len(users)

        def topkv(j):
            vec[j] = c._roundtrip(f"TOPKV\t{JOB_STATE}\t{TOPK_K}\t"
                                  f"{run.rows[users[j] + '-U']}")

        tv = latency_ms(topkv, len(users))
    with QueryClient("127.0.0.1", port, timeout_s=60, proto="b2") as c:
        b2 = latency_ms(lambda j: c.query_state(JOB_STATE, get_keys[j]),
                        len(get_keys))
    stop_member(run, proc)
    same = ties = 0
    worst = 0.0
    for j, (r, ra) in enumerate(zip(vec, a["replies"])):
        ids, sc = parse_reply(r[2:])
        aids, asc = parse_reply(ra[2:])
        check(topk_agrees([run.col_of[i] for i in ids], run.s64[j],
                          TOPK_K)[0],
              "a native TOPKV list is off the float64 top-k")
        if ids == aids:
            same += 1
            worst = max(worst, float(np.max(np.abs(np.subtract(sc, asc)) /
                                            np.maximum(np.abs(asc), 1e-30))))
        else:
            ties += 1  # agrees with float64: differs at a near tie
    log(f"arena (b) --nativeServer true over the arena: plane {plane}, "
        f"ready {ready_s:.2f}s after its spawn; COUNT {count}, MGET equal "
        f"to the dict job's: {mget == base['mget']}; {len(get_keys)} GET "
        f"p50 {get[0]:.4f} / p99 {get[1]:.4f} ms, MGET of {ARENA_MGET_KEYS} "
        f"keys p50 {mg[0]:.4f} / p99 {mg[1]:.4f} ms, B2 GET p50 "
        f"{b2[0]:.4f} / p99 {b2[1]:.4f} ms; {len(users)} TOPKV k={TOPK_K} "
        f"(host-scored) p50 {tv[0]:.4f} ms, p99 {tv[1]:.4f} ms: {same} "
        f"lists equal (a)'s from its index (scores within {worst:.3e} "
        f"relative), {ties} differ at a near tie, every list agrees with a "
        f"float64 top-k")
    check(plane == "native" and count == base["count"]
          and mget == base["mget"], "the native plane serves other rows")
    check(worst <= 1e-5, f"native TOPKV scores off by {worst} relative")
    return dict(native_get_p50_ms=get[0], native_get_p99_ms=get[1],
                native_mget_p50_ms=mg[0], native_mget_p99_ms=mg[1],
                native_b2_p50_ms=b2[0], native_b2_p99_ms=b2[1],
                native_topkv_p50_ms=tv[0], native_topkv_same=same,
                native_topkv_ties=ties)


def arena_snapshot(run) -> dict:
    """(e) ``arena/1`` publish of (a)'s arena (a hard link, then a copy),
    and a second member, on an arena of its own, bootstrapped from it."""
    from flink_ms_tpu_torch.serve import arena as AR
    from flink_ms_tpu_torch.serve import snapshot as SNAP
    from flink_ms_tpu_torch.serve.client import QueryClient

    base = run.base
    root = SNAP.snapshot_root(run.path("journal"), JOB_TOPIC)
    offset = run.journal.end_offset()
    table = AR.ArenaModelTable(8, dir=arena_dir(run))
    times, manifests = {}, {}
    try:
        check(len(table) == len(run.rows), "the arena lost rows")
        for mode in ("link", "copy"):
            table.publish_mode = mode
            t0 = time.perf_counter()
            manifests[mode] = SNAP.publish(root, table, offset, shard=0,
                                           num_shards=1, topic=JOB_TOPIC)
            times[mode] = time.perf_counter() - t0
    finally:
        table.close()
    m = manifests["copy"]
    proc, port, h, ready_s, _ = arena_member(
        run, "arena-boot", ["--replicaIndex", "1", "--jobGroup", "boot"])
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        count, mget = c.count(JOB_STATE), c.query_states(JOB_STATE,
                                                         base["keys"])
        topk = [c._roundtrip(f"TOPK\t{JOB_STATE}\t{u}\t{TOPK_K}")
                for u in base["users"][:16]]
    stop_member(run, proc)
    log(f"arena (e) arena/1 publish of {m['rows']} rows: link "
        f"{times['link']:.4f}s ({manifests['link']['arena']['bytes_copied']}"
        f" bytes written), copy {times['copy']:.3f}s ("
        f"{m['arena']['bytes_copied']} of {m['arena']['size']} bytes "
        f"written); a second member bootstrapped from the "
        f"{h['bootstrap_source']} in {h['bootstrap_seconds']:.3f}s, ready "
        f"{ready_s:.2f}s after its spawn; COUNT {count}, MGET and 16 TOPK "
        f"equal to the dict job's: {mget == base['mget']}, "
        f"{topk == base['topk'][:16]}")
    check(m["format"] == SNAP.ARENA_FORMAT and m["rows"] == len(run.rows),
          f"the arena/1 manifest {m}")
    check(h["bootstrap_source"] == "snapshot" and count == base["count"]
          and mget == base["mget"],
          f"the member did not bootstrap from the arena/1 snapshot: {h}")
    # the members' arenas are done with: keep the host's disk bounded
    shutil.rmtree(arena_dir(run, replica=1))
    shutil.rmtree(arena_dir(run))
    return dict(publish_link_s=times["link"], publish_copy_s=times["copy"],
                snapshot_bootstrap_s=h["bootstrap_seconds"],
                snapshot_ready_s=ready_s)


def arena_rocksdb(run) -> dict:
    """(c) ``--stateBackend rocksdb --nativeServer true``: the native
    store's table, ingested natively, then a restart from the store."""
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.consumer import (ServingJob, make_backend,
                                                   parse_als_record)
    from flink_ms_tpu_torch.serve.journal import Journal

    base, store = run.base, run.path("store")

    def start():
        backend = make_backend("rocksdb", store)
        check(type(backend).__name__ == "NativeStateBackend",
              f"rocksdb gave {type(backend).__name__}")
        t0 = time.perf_counter()
        job = ServingJob(Journal(run.path("journal"), JOB_TOPIC), JOB_STATE,
                         parse_als_record, backend, host="127.0.0.1",
                         port=0, native_server=True, poll_interval_s=0.01,
                         checkpoint_interval_ms=500, job_id="arena-rocksdb",
                         device=run.dev_name).start()
        check(job.wait_ready(FLEET_WAIT_S), "the rocksdb job was not ready")
        return job, time.perf_counter() - t0

    job, ready_s = start()
    try:
        path, rows = job.ingest_path, job.ingest_rows
        wait_until(lambda: job.backend.restore(job.table) == job.offset,
                   "the rocksdb checkpoint")
        with QueryClient("127.0.0.1", job.port, timeout_s=60) as c:
            count, mget = c.count(JOB_STATE), c.query_states(JOB_STATE,
                                                             base["keys"])
        n_rows = len(job.table)
        log_b, live_b = job.backend.store.log_bytes, \
            job.backend.store.live_bytes
    finally:
        job.stop()
    check(path == "native" and rows >= len(run.rows),
          f"the rocksdb job ingested on the {path} path")
    # the native COUNT counts every key of the store, the checkpoint's
    # offset marker too, as the reference's does
    check(n_rows == base["count"] and count == n_rows + 1
          and mget == base["mget"], f"the rocksdb job serves other rows: "
          f"{n_rows} rows, COUNT {count}, MGET equal {mget == base['mget']}")
    job, restart_s = start()
    try:
        with QueryClient("127.0.0.1", job.port, timeout_s=60) as c:
            count2, mget2 = c.count(JOB_STATE), c.query_states(JOB_STATE,
                                                               base["keys"])
        src, replayed = job.bootstrap_source, job.ingest_rows
    finally:
        job.stop()
    log(f"arena (c) --stateBackend rocksdb --nativeServer true: a "
        f"NativeStateBackend, ingest path {path} ({rows} rows), ready "
        f"{ready_s:.2f}s after its start; {n_rows} rows, COUNT {count}, "
        f"MGET equal: "
        f"{mget == base['mget']}; store log {log_b} bytes, live {live_b}; "
        f"the restart from the store ready in {restart_s:.3f}s from the "
        f"{src}, {replayed} rows replayed, COUNT {count2} (the rows and "
        f"the offset marker), MGET equal: "
        f"{mget2 == base['mget']}")
    check(src == "checkpoint" and replayed == 0 and count2 == count
          and mget2 == base["mget"], "the rocksdb restart replayed or lost "
          "rows")
    shutil.rmtree(store)
    return dict(rocksdb_ready_s=ready_s, rocksdb_restart_s=restart_s,
                rocksdb_log_bytes=log_b, rocksdb_live_bytes=live_b)


def arena_updates(run) -> dict:
    """(d) the co-located update plane at 4 shards on arena members with
    the in-place CAS on: duplicate-free ratings held against one
    ``SGDStep`` run, then ``ARENA_RATINGS`` timed; audits, publish ->
    queryable, CAS swaps against re-puts."""
    from flink_ms_tpu_torch.obs.scrape import scrape_fleet
    from flink_ms_tpu_torch.online.sgd import SGDStep
    from flink_ms_tpu_torch.serve import update_plane as UP
    from flink_ms_tpu_torch.serve.elastic import ScaleController
    from flink_ms_tpu_torch.serve.table import ModelTable

    rows, jdir = run.rows, run.path("journal")
    check(os.environ.get("TPUMS_ARENA_CAS", "1") != "0",
          "TPUMS_ARENA_CAS=0 turns the CAS off")
    ctl = ScaleController(
        "arena-upd", jdir, JOB_TOPIC, port_dir=run.path("ports-au"),
        ready_timeout_s=FLEET_WAIT_S, device=run.dev_name,
        extra_args=["--updatePlane", "true", "--updatePartitions",
                    str(FLEET_PARTITIONS), "--updateBatch", str(FLEET_BATCH),
                    "--pollInterval", "0.005"])
    run.ctls.append(ctl)
    t0 = time.perf_counter()
    ctl.scale_to(4)
    ready_s = time.perf_counter() - t0
    members = sorted(d for d in os.listdir(jdir)
                     if ".arena-" in d and "of4-" in d)
    ucli = UP.UpdatePlaneClient(jdir, JOB_TOPIC, partitions=FLEET_PARTITIONS)
    u_all = np.asarray([int(k[:-2]) for k in rows
                        if k.endswith("-U") and k != "MEAN-U"])
    i_all = np.asarray([int(i) for i in run.item_ids if i != "MEAN"])
    rng = np.random.default_rng(24)
    n = ARENA_DFREE_RATINGS
    dfree = list(zip(rng.choice(u_all, n, replace=False).tolist(),
                     rng.choice(i_all, n, replace=False).tolist(),
                     np.round(rng.uniform(1.0, 5.0, n), 3).tolist()))

    def drained(total):
        return lambda: sum(UP.applied_watermarks(
            jdir, JOB_TOPIC, FLEET_PARTITIONS).values()) >= total

    def cas():
        snap = scrape_fleet()["fleet"]
        return (metric_sum(snap, "counters", "tpums_arena_cas_success_total"),
                metric_sum(snap, "counters", "tpums_arena_cas_retry_total"))

    for s in range(0, n, 2_000):
        ucli.submit_many(dfree[s:s + 2_000])
    ucli.sync()
    wait_until(drained(n), "the duplicate-free ratings' apply records")
    audit1 = UP.audit_partitions(jdir, JOB_TOPIC, FLEET_PARTITIONS)
    applied = applied_rows(run)
    table = ModelTable()
    table.put_many(list(rows.items()))
    step = SGDStep(table.get, rows["MEAN-U"], rows["MEAN-I"],
                   lookup_many=lambda ks: [table.get(k) for k in ks])
    want = []
    for s in range(0, n, FLEET_BATCH):
        want.extend(step.process_batch(dfree[s:s + FLEET_BATCH]))
    same = sorted(applied) == sorted(want)
    check(audit1["lost"] == 0 and audit1["duplicates"] == 0
          and audit1["submitted"] == n, f"the update plane audit {audit1}")
    check(same and len(applied) == 2 * n,
          "the plane's rows differ from one SGDStep run")

    rng = np.random.default_rng(23)
    fleet_r = list(zip(
        u_all[rng.integers(0, len(u_all), ARENA_RATINGS)].tolist(),
        i_all[rng.integers(0, len(i_all), ARENA_RATINGS)].tolist(),
        np.round(rng.uniform(1.0, 5.0, ARENA_RATINGS), 3).tolist()))
    total = n + ARENA_RATINGS
    snap0 = scrape_fleet()["fleet"]
    cas0 = cas()
    rows0 = len(applied)
    t0 = time.perf_counter()
    for s in range(0, ARENA_RATINGS, 2_000):
        ucli.submit_many(fleet_r[s:s + 2_000])
    ucli.sync()
    drain_s = wait_until(drained(total), "the timed ratings' apply records")
    upd_s = time.perf_counter() - t0
    time.sleep(0.5)  # the last visibility probes land in the histograms
    vis = fleet_visibility(snap0, scrape_fleet()["fleet"])
    cas1 = cas()
    audit = UP.audit_partitions(jdir, JOB_TOPIC, FLEET_PARTITIONS)
    direct = len(applied_rows(run)) - rows0
    swaps, drift = cas1[0] - cas0[0], cas1[1] - cas0[1]
    ctl.stop(drop_topology=True)
    run.ctls.remove(ctl)
    for d in members:
        shutil.rmtree(os.path.join(jdir, d))
    log(f"arena (d) update plane at 4 shards on arena members ({members}), "
        f"CAS on, {FLEET_PARTITIONS} partitions, batch {FLEET_BATCH}: ready "
        f"{ready_s:.2f}s after scale_to; {n} duplicate-free ratings (seed "
        f"24): audit {audit1['submitted']} submitted, {audit1['lost']} "
        f"lost, {audit1['duplicates']} doubled, the {len(applied)} rows of "
        f"the apply records equal one SGDStep run byte for byte: {same}; "
        f"{ARENA_RATINGS} ratings (seed 23): {ARENA_RATINGS / upd_s:.0f} "
        f"updates/s ({upd_s:.2f}s; {drain_s:.2f}s after the last submit); "
        f"publish->queryable p50 {vis['p50_ms']:.3f} ms, p99 "
        f"{vis['p99_ms']:.3f} ms over {vis['n']} probes; {direct} rows "
        f"written in place: {swaps:.0f} CAS swaps, {direct - swaps:.0f} "
        f"re-puts ({drift:.0f} of them after a drifted compare); audit "
        f"{audit['submitted']} submitted, {audit['lost']} lost, "
        f"{audit['duplicates']} doubled")
    check(audit["lost"] == 0 and audit["duplicates"] == 0
          and audit["submitted"] == total, f"the update plane audit {audit}")
    check(swaps > 0, "no row was swapped in place by the CAS")
    return dict(arena_ready_4_s=ready_s, arena_updates_per_s=ARENA_RATINGS
                / upd_s, arena_visibility_p50_ms=vis["p50_ms"],
                arena_visibility_p99_ms=vis["p99_ms"], cas_swaps=swaps,
                cas_reputs=direct - swaps)


def arena_phase(torch, base, dev) -> dict:
    """Phase 19: the arena and the native store on phase 17's published
    topic, every member a ``--device`` process on this card: (a) a
    fleet-default member on the arena answering TOPK from its index, (b)
    ``--nativeServer true`` over that arena, (e) ``arena/1`` publish and a
    bootstrap from it, (c) ``--stateBackend rocksdb --nativeServer true``
    and a restart from the store, (d) the update plane at 4 shards on
    arena members with the in-place CAS."""
    import tempfile

    t_phase = time.perf_counter()
    prior = {k: os.environ.get(k)
             for k in list(FLEET_ENV) + ["TPUMS_REGISTRY_DIR", "TPUMS_TABLE"]}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        os.environ.update(FLEET_ENV)
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        os.environ.pop("TPUMS_TABLE", None)
        run = None
        try:
            run = FleetRun(work, base, dev)
            a = arena_job(run)
            out.update({k: v for k, v in a.items() if k != "replies"})
            out.update(arena_native(run, a))
            out.update(arena_snapshot(run))
            out.update(arena_rocksdb(run))
            out.update(arena_updates(run))
        finally:
            if run is not None:
                run.close()
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    log(f"arena phase: {time.perf_counter() - t_phase:.1f}s")
    return out


# -- phase 20: the closed loop -----------------------------------------------

LOOP_GROUP = "loop"
LOOP_USERS, LOOP_ITEMS = 5_000, 2_000  # the window's slice of the id space
LOOP_RATINGS = 500_000        # the window, through the update plane (seed 26)
LOOP_MORE_RATINGS = 100_000   # then for the CLI's tick (seed 27)
LOOP_PERTURB = 0.3            # each served row moves by N(0, 0.3 std)
LOOP_NOISE = 0.05             # and each rating by N(0, 0.05)
LOOP_PROBE = 256              # held-out ratings of each MSE probe
LOOP_STREAM_KEYS = 1000       # window users the open-loop GETs sample
LOOP_ALERT_TTL_S = 60.0       # the model_drift record's time to live
LOOP_DRIFT = {"firing": 1, "max_severity": "warn", "max_severity_level": 2,
              "alerts": [{"rule": "model_drift", "severity": "warn",
                          "description": "live held-out MSE above drift "
                                         "threshold"}]}


class LoopWorld:
    """Where the window's ratings come from: phase 17's served rows of
    ``LOOP_USERS`` users and ``LOOP_ITEMS`` items, each row moved once by
    N(0, ``LOOP_PERTURB`` x the std of those served factors), so the
    served model is stale on them; a rating is the dot product of the
    moved rows plus N(0, ``LOOP_NOISE``)."""

    def __init__(self, rows, seed):
        self.rng = np.random.default_rng(seed)
        ids = {side: np.asarray(sorted(int(k[:-2]) for k in rows
                                       if k.endswith(f"-{side}")
                                       and not k.startswith("MEAN")))
               for side in "UI"}
        self.users = self.rng.choice(ids["U"], LOOP_USERS, replace=False)
        self.items = self.rng.choice(ids["I"], LOOP_ITEMS, replace=False)

        def rows_of(ids_, side):
            return np.stack([np.asarray(rows[f"{x}-{side}"].split(";"),
                                        np.float64) for x in ids_])

        U, V = rows_of(self.users, "U"), rows_of(self.items, "I")
        sd = LOOP_PERTURB * float(np.std(np.concatenate([U, V]).ravel()))
        self.U = U + self.rng.normal(0.0, sd, U.shape)
        self.V = V + self.rng.normal(0.0, sd, V.shape)

    def ratings(self, n, rng=None):
        rng = self.rng if rng is None else rng
        ui = rng.integers(0, LOOP_USERS, n)
        ii = rng.integers(0, LOOP_ITEMS, n)
        r = np.einsum("nd,nd->n", self.U[ui], self.V[ii]) \
            + rng.normal(0.0, LOOP_NOISE, n)
        return self.users[ui], self.items[ii], r


class ProcessStream:
    """``OpenLoopStream`` through one ``ElasticClient`` of ``LOOP_GROUP``
    in a process of its own, so that the controller's Python in this
    process does not hold up the stream's thread: the latencies are the
    fleet's, not this interpreter's lock's.  The two processes' samples
    share one clock (``time.perf_counter`` is the system's monotonic
    clock).  ``stop`` ends the process on every path."""

    window = OpenLoopStream.window

    def __init__(self, work, keys, label="stream"):
        self.paths = {k: os.path.join(work, f"{label}.{k}")
                      for k in ("keys", "out", "stop", "ready")}
        with open(self.paths["keys"], "w") as f:
            json.dump(list(keys), f)
        env = child_env()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.stream_child(*sys.argv[1:]))",
             self.paths["keys"], self.paths["out"], self.paths["stop"],
             self.paths["ready"], str(FLEET_RATE_QPS)], env=env)
        self.samples, self.errors = [], []
        wait_until(lambda: os.path.exists(self.paths["ready"])
                   or self.proc.poll() is not None, "the stream's process")
        check(self.proc.poll() is None,
              f"the stream's process exited {self.proc.returncode}")

    def stop(self):
        if self.proc is None:
            return
        open(self.paths["stop"], "w").close()
        try:
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc = None
        with open(self.paths["out"]) as f:
            got = json.load(f)
        self.samples, self.errors = got["samples"], got["errors"]


def stream_child(keys_path, out_path, stop_path, ready_path, rate) -> int:
    """The body of a ``ProcessStream``'s process."""
    from flink_ms_tpu_torch.serve.client import RetryPolicy
    from flink_ms_tpu_torch.serve.elastic import ElasticClient

    with open(keys_path) as f:
        keys = json.load(f)
    retry = RetryPolicy(attempts=6, backoff_s=0.02, max_backoff_s=0.5)
    stream = OpenLoopStream(lambda: ElasticClient(
        LOOP_GROUP, timeout_s=10, retry=retry), keys,
        rate_qps=float(rate)).start()
    while not stream.samples:
        time.sleep(0.01)
    open(ready_path, "w").close()
    while not os.path.exists(stop_path):
        time.sleep(0.02)
    stream.stop()
    with open(out_path, "w") as f:
        json.dump({"samples": stream.samples, "errors": stream.errors}, f)
    return 0


def loop_submit(run, ratings) -> float:
    """Ratings into the update plane's 16 input partitions -> seconds."""
    from flink_ms_tpu_torch.serve.update_plane import UpdatePlaneClient

    t0 = time.perf_counter()
    ucli = UpdatePlaneClient(run.path("ratings"), "models",
                             partitions=FLEET_PARTITIONS)
    u, i, r = ratings
    triples = list(zip(u.tolist(), i.tolist(), r.tolist()))
    for s in range(0, len(triples), 50_000):
        ucli.submit_many(triples[s:s + 50_000])
    ucli.sync()
    return time.perf_counter() - t0


def loop_member(gen):
    """(host, port) of the one ready member of generation `gen`."""
    from flink_ms_tpu_torch.serve import registry
    from flink_ms_tpu_torch.serve.elastic import generation_group
    from flink_ms_tpu_torch.serve.ha import shard_group

    entries = [e for e in registry.resolve_replicas(shard_group(
        generation_group(LOOP_GROUP, gen), 0)) if e.get("ready")]
    check(len(entries) == 1,
          f"generation {gen} has {len(entries)} ready members")
    return entries[0]["host"], entries[0]["port"]


def loop_health(gen) -> dict:
    """Generation `gen`'s member's HEALTH."""
    from flink_ms_tpu_torch.serve.client import QueryClient

    host, port = loop_member(gen)
    with QueryClient(host, port, timeout_s=60) as c:
        return c.health(JOB_STATE)


def fmt_boot(h) -> str:
    return (f"its member bootstrapped from {h.get('bootstrap_source')} in "
            f"{h.get('bootstrap_seconds') or 0.0:.2f}s")


def loop_topk(gen, users) -> list:
    """Generation `gen`'s raw TOPK replies (k 10) for `users`."""
    from flink_ms_tpu_torch.serve.client import QueryClient

    host, port = loop_member(gen)
    with QueryClient(host, port, timeout_s=60) as c:
        return c.pipeline([f"TOPK\t{JOB_STATE}\t{u}\t{TOPK_K}"
                           for u in users], window=8)


def stop_loop_orphans(ctl) -> int:
    """Stop the members of generations this controller does not own (the
    CLI's rollout spawns workers that outlive it) -> how many."""
    import signal

    from flink_ms_tpu_torch.serve import registry

    pids = [e["pid"] for e in registry.list_jobs(gc=False)
            if registry.generation_of(e, LOOP_GROUP) not in
            (None, *ctl.supervisors)]
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + 30
    for pid in pids:
        while time.time() < deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.05)
        else:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    return len(pids)


def timed_steps(pilot, spans, captured):
    """Wrap the controller's steps so each records its (start, end) time;
    the candidate of ``_train`` is kept for the canary."""
    for name in ("_tail_ratings", "_seal_window", "_train", "_evaluate",
                 "_roll_out"):
        fn = getattr(pilot, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                out = _fn(*a, **kw)
            finally:
                spans[_name] = (t0, time.perf_counter())
            if _name == "_train":
                captured["candidate"] = out
            return out

        setattr(pilot, name, wrapper)


def loop_bootstrap(run, world):
    """(a) The port's ``RolloutController`` rolls phase 17's topic out as
    generation 1 of ``LOOP_GROUP``: 1 shard x 1 replica on the arena, the
    row floor every published row, the MSE probe ``LOOP_PROBE`` held-out
    ratings gated at the served rows' own offline MSE."""
    from flink_ms_tpu_torch.eval.mse import compute_mse
    from flink_ms_tpu_torch.serve.rollout import RolloutController

    rows = run.rows
    pu, pi, pr = world.ratings(LOOP_PROBE)

    def parsed(k):
        p = rows.get(k)
        return None if p is None else np.asarray(p.split(";"), np.float64)

    offline, n_off, _ = compute_mse(pu, pi, pr, parsed,
                                    lookup_many=lambda ks: [parsed(k)
                                                            for k in ks])
    offline = float(offline)
    check(n_off == LOOP_PROBE, f"the probe scored {n_off} offline")
    ctl = RolloutController(LOOP_GROUP, port_dir=run.path("ports-loop"),
                            journal_dir=run.path("journal"), topic=JOB_TOPIC,
                            ready_timeout_s=FLEET_WAIT_S,
                            device=run.dev_name)
    run.ctls.append(ctl)
    t0 = time.perf_counter()
    rec = ctl.rollout(run.path("journal"), JOB_TOPIC, model_id="seed",
                      shards=1, replicas=1, verify_min_rows=len(rows),
                      probe={"users": pu, "items": pi, "ratings": pr,
                             "max_mse": offline * (1 + 1e-9)})
    boot_s = time.perf_counter() - t0
    verified = [e for e in ctl.events if e["kind"] == "verified"]
    log(f"loop (a) bootstrap: generation {rec['gen']} of {LOOP_GROUP!r} "
        f"serves phase 17's topic ({rec['shards']} shard x "
        f"{rec['replicas']} replica, --device {run.dev_name}) in "
        f"{boot_s:.2f}s ({fmt_boot(loop_health(1))}); verified {[{k: v for k, v in e.items() if k not in ('t', 'kind')} for e in verified]}"
        f" against a row floor of {len(rows)} and the probe's offline MSE "
        f"{offline!r}")
    check(rec["gen"] == 1 and rec["model"]["model_id"] == "seed"
          and len(verified) == 2, f"the bootstrap {rec}")
    return ctl, boot_s


def loop_tick(run, ctl, pilot, world):
    """(c) One in-process tick under the open-loop GET stream (a process
    of its own): windowing, training on the card, evaluating, rolling out
    generation 2."""
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA

    keys = [f"{u}-U" for u in world.users[:LOOP_STREAM_KEYS]]
    stream = ProcessStream(run.work, keys)
    run.streams.append(stream)
    spans, captured = {}, {}
    timed_steps(pilot, spans, captured)
    t_a = time.perf_counter()
    time.sleep(FLEET_WINDOW_S)
    reset_als_launches(CH, GA)
    t_tick = time.perf_counter()
    out = pilot.tick()
    t_end = time.perf_counter()
    launches = als_launches(CH, GA)
    time.sleep(FLEET_WINDOW_S)
    stream.stop()
    cand = captured.get("candidate")
    secs = {"windowing": spans["_tail_ratings"][1] - spans["_tail_ratings"][0]
            + spans["_seal_window"][1] - spans["_seal_window"][0]}
    for phase, step in (("training", "_train"), ("evaluating", "_evaluate"),
                        ("rolling-out", "_roll_out")):
        if step in spans:
            secs[phase] = spans[step][1] - spans[step][0]
    roll = spans.get("_roll_out", (t_end, t_end))
    names = ("before", "windowing to evaluating", "cutover", "after")
    wins = [stream.window(t_a, t_tick), stream.window(t_tick, roll[0]),
            stream.window(*roll), stream.window(t_end, time.perf_counter())]
    cut = [e for e in ctl.events if e["kind"] == "cutover"]
    boot2 = fmt_boot(loop_health(2)) if out.get("rollout_gen") == 2 else ""
    log(f"loop (c) one tick in {t_end - t_tick:.2f}s: "
        + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items())
        + f"; window {out.get('new_ratings')} new ratings, "
        f"{out.get('window_rows')} rows (last write wins), version "
        f"{out.get('window_version')}; train_s {out.get('train_s')} "
        f"({pilot.iterations} iterations, rank {pilot.num_factors}, warm "
        f"{out.get('warm_start')}); held-out MSE incumbent "
        f"{out.get('incumbent_mse')!r}, candidate {out.get('candidate_mse')!r}"
        f" ({out.get('model_id')}): win {out.get('win')}; generation "
        f"{out.get('rollout_gen')} cut over in "
        f"{cut[-1]['cutover_s'] if cut else float('nan'):.2f}s ({boot2}); "
        "launches "
        f"on the tick: cholesky {launches['cholesky']} (batch-major "
        f"{launches['cholesky_batch_major']}), assembly "
        f"{launches['assembly']}; GETs at {FLEET_RATE_QPS:.0f} q/s: "
        + "; ".join(fmt_window(n, x) for n, x in zip(names, wins))
        + f"; {len(stream.errors)} failed queries")
    check(out.get("win") is True, "the candidate did not win: held-out MSE "
          f"candidate {out.get('candidate_mse')!r}, incumbent "
          f"{out.get('incumbent_mse')!r}")
    check(out.get("rollout_gen") == 2 and "rollout_error" not in out,
          f"the rollout: {out}")
    check(not stream.errors, f"loop errors: {stream.errors[:3]}")
    check(cand is not None and all(k in cand["tables"] for k in keys),
          "a streamed key is missing from the candidate")
    check(launches["cholesky"] == 2 * pilot.iterations
          and launches["assembly"] >= 2 * pilot.iterations
          and launches["cholesky_batch_major"] == 0,
          f"tick launches {launches}")
    return out, cand, launches, secs, wins, cut[-1]["cutover_s"]


def loop_canary(run, pilot, cand) -> dict:
    """(d) ``ModelQualityCanary`` over the group's ``ElasticClient`` on the
    candidate's held-out probe: the live MSE gauge is the offline
    ``compute_mse`` of the candidate's tables at rtol 1e-5."""
    from flink_ms_tpu_torch.eval.mse import compute_mse
    from flink_ms_tpu_torch.obs.metrics import get_registry
    from flink_ms_tpu_torch.obs.watch import ModelQualityCanary
    from flink_ms_tpu_torch.serve.elastic import ElasticClient

    probe = pilot._probe_slice(cand["heldout"])
    tables = cand["tables"]
    with ElasticClient(LOOP_GROUP, timeout_s=60, retry=run.retry) as client:
        canary = ModelQualityCanary(probe["users"], probe["items"],
                                    probe["ratings"], client,
                                    max_probe=LOOP_PROBE)
        t0 = time.perf_counter()
        res = canary.probe()
        probe_s = time.perf_counter() - t0
    live = get_registry().gauge("tpums_model_live_mse").value
    offline, n_off, _ = compute_mse(
        probe["users"], probe["items"], probe["ratings"], tables.get,
        lookup_many=lambda ks: [tables.get(k) for k in ks])
    offline = float(offline)
    log(f"loop (d) canary: tpums_model_live_mse {live!r} over "
        f"{res['n_scored']} held-out ratings in {probe_s:.3f}s, coverage "
        f"{res['coverage']}; offline compute_mse of the candidate "
        f"{offline!r} ({n_off} ratings): relative difference "
        f"{abs(live - offline) / offline:.3e}")
    check(res["coverage"] == 1.0 and n_off == len(probe["ratings"]),
          f"canary coverage {res['coverage']}")
    check(abs(live - offline) <= 1e-5 * abs(offline),
          f"the canary's MSE {live!r} is not the offline {offline!r}")
    return {"live_mse": live, "offline_mse": offline}


def loop_drift(run, ctl, pilot, gen1) -> dict:
    """(e) A ``model_drift`` alert record: the next tick rolls back to
    generation 3 (the seed model, its TOPK replies generation 1's byte
    for byte), a member's HEALTH carries the alert, and a further tick
    with the alert still firing does nothing (the latch)."""
    from flink_ms_tpu_torch.serve import registry

    registry.publish_alerts("fleet", LOOP_DRIFT, ttl_s=LOOP_ALERT_TTL_S)
    t0 = time.perf_counter()
    out = pilot.tick()
    rollback_s = time.perf_counter() - t0
    topo = ctl.current()
    gen3 = loop_topk(3, run.base["users"]) if out.get("rollback") == 3 \
        else []
    same = sum(a == b for a, b in zip(gen3, gen1))
    health = loop_health(topo["gen"])
    t1 = time.perf_counter()
    latch = pilot.tick()
    latch_s = time.perf_counter() - t1
    log(f"loop (e) drift: alert {out.get('drift')!r} -> rollback to "
        f"generation {out.get('rollback')} ({topo['model']['model_id']}) in "
        f"{rollback_s:.2f}s ({fmt_boot(health)}); {same} of {len(gen1)} "
        f"TOPK replies (k "
        f"{TOPK_K}) equal generation 1's byte for byte; HEALTH of its "
        f"member: alerts_firing {health.get('alerts_firing')}, "
        f"alerts_max_severity {health.get('alerts_max_severity')!r}; a "
        f"further tick with the alert firing ({latch_s:.2f}s): "
        f"{ {k: v for k, v in latch.items() if k not in ('ts', 'group')} }, "
        f"generation {ctl.current()['gen']}")
    check(out.get("drift") == "alert:model_drift" and out.get("rollback") == 3
          and topo["model"]["model_id"] == "seed", f"the rollback: {out}")
    check(same == len(gen1) and len(gen3) == len(gen1),
          f"generation 3 answers {len(gen1) - same} TOPK replies otherwise "
          "than generation 1")
    check(health.get("alerts_firing") == 1
          and health.get("alerts_max_severity") == "warn",
          f"HEALTH without the alert hint: {health}")
    check("rollback" not in latch and "drift" not in latch
          and latch.get("new_ratings") == 0 and ctl.current()["gen"] == 3,
          f"the latch: {latch}")
    registry.drop_alerts("fleet")
    return {"rollback_s": rollback_s}


def loop_cli(run, ctl, world) -> dict:
    """(f) 100,000 more ratings, then ``python -m
    flink_ms_tpu_torch.serve.autopilot --once`` in a process of its own:
    it takes the lease, resumes from ``autopilot_state.json`` and windows
    only the new ratings.  The members its rollout spawns outlive it:
    they serve (g), and the phase stops them."""
    submit_s = loop_submit(run, world.ratings(
        LOOP_MORE_RATINGS, np.random.default_rng(27)))
    cmd = [sys.executable, "-m", "flink_ms_tpu_torch.serve.autopilot",
           "--group", LOOP_GROUP, "--ratingsDir", run.path("ratings"),
           "--workDir", run.path("autopilot"), "--once",
           "--device", run.dev_name, "--numFactors", str(RANK),
           "--portDir", run.path("ports-cli"),
           "--readyTimeoutS", str(FLEET_WAIT_S)]
    env = child_env()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=4 * FLEET_WAIT_S)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the autopilot CLI exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    out = json.JSONDecoder().raw_decode(proc.stdout[proc.stdout.index("{"):])[0]
    with open(run.path("autopilot", "autopilot_state.json")) as f:
        state = json.load(f)
    log(f"loop (f) CLI: {LOOP_MORE_RATINGS} more ratings (seed 27) "
        f"submitted in {submit_s:.2f}s; python -m "
        "flink_ms_tpu_torch.serve.autopilot --once: result in "
        f"{cli_s:.2f}s from spawn; {out.get('new_ratings')} new ratings "
        f"windowed, {out.get('window_rows')} rows in window version "
        f"{out.get('window_version')}; train_s {out.get('train_s')}, "
        f"held-out MSE incumbent {out.get('incumbent_mse')!r}, candidate "
        f"{out.get('candidate_mse')!r}: win {out.get('win')}, rollout "
        f"generation {out.get('rollout_gen')}; state record: retrains "
        f"{state['retrains']}, rollouts {state['rollouts']}, rollbacks "
        f"{state['rollbacks']}")
    check(out.get("state") != "standby", "the CLI did not take the lease")
    check(out.get("new_ratings") == LOOP_MORE_RATINGS
          and "resumed_window" not in out and out.get("window_version") == 2,
          f"the CLI's tick: {out}")
    check(state["retrains"] == 2 and state["rollbacks"] == 1
          and state["window_version"] == 2, f"the state record {state}")
    return {"cli_s": cli_s, "cli_window_rows": out.get("window_rows")}


# (g): bench_sections.py:2720-2905's arm 2, an abusive tenant over its
# quota beside in-quota traffic.  Its quota rides every member's
# environment from the group's first spawn; untenanted traffic stays
# unlimited
LOOP_ABUSE_TENANT = "abuse"
LOOP_ABUSE_QUOTA = 50.0        # q/s (bench_sections.py:2755)
LOOP_ABUSE_QPS = 200.0         # offered: 4x the quota, half GET, half TOPK
LOOP_ADMIT_WINDOW_S = 6.0      # the section's window
LOOP_ADMIT_ENV = {"TPUMS_ADMIT_TENANT_QPS":
                  f"{LOOP_ABUSE_TENANT}={LOOP_ABUSE_QUOTA:g}"}
LOOP_AVAILABILITY = 0.999      # the section's in-quota target
LOOP_OPS_POLL_S = 0.2          # HEALTH and METRICS polled this often


def hist_count(snap, name, **labels) -> int:
    """Observations of a histogram, summed over its label sets (those
    with ``labels``, when given)."""
    return int(sum(sum(e["counts"]) for e in snap.get("histograms", [])
                   if e["name"] == name
                   and all(e.get("labels", {}).get(k) == v
                           for k, v in labels.items())))


class AbuseStream:
    """The abusive tenant: an open loop at ``LOOP_ABUSE_QPS`` through one
    ``ElasticClient(tenant=...)`` with the section's retry policy,
    alternating GET and TOPK (k ``TOPK_K``); each reply is served, shed
    (``E\\tover quota``) or another error, counted by verb."""

    def __init__(self, keys):
        self.keys = keys
        self.counts = {v: {"offered": 0, "served": 0, "shed": 0, "other": 0}
                       for v in ("GET", "TOPK")}
        self.others, self.sent, self.t_end = [], [], None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        from flink_ms_tpu_torch.serve.admission import SHED_MARKER
        from flink_ms_tpu_torch.serve.client import RetryPolicy
        from flink_ms_tpu_torch.serve.elastic import ElasticClient

        rng = np.random.default_rng(3)
        retry = RetryPolicy(attempts=2, backoff_s=0.01, max_backoff_s=0.1)
        interval = 1.0 / LOOP_ABUSE_QPS
        with ElasticClient(LOOP_GROUP, timeout_s=10, retry=retry,
                           tenant=LOOP_ABUSE_TENANT) as c:
            t_next, n = time.perf_counter(), 0
            while not self._stop.is_set():
                t, t_next = t_next, t_next + interval
                now = time.perf_counter()
                if t > now:
                    time.sleep(t - now)
                key = self.keys[int(rng.integers(len(self.keys)))]
                verb = ("GET", "TOPK")[n % 2]
                n += 1
                tally = self.counts[verb]
                tally["offered"] += 1
                self.sent.append(t)
                try:
                    if verb == "GET":
                        c.query_state(JOB_STATE, key)
                    else:
                        c.topk(JOB_STATE, key[:-2], TOPK_K)
                    tally["served"] += 1
                except Exception as e:
                    if SHED_MARKER in repr(e):
                        tally["shed"] += 1
                    else:
                        tally["other"] += 1
                        self.others.append((verb, key, repr(e)))
        self.t_end = time.perf_counter()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


class OpsPoller:
    """HEALTH and METRICS of each member every ``LOOP_OPS_POLL_S``, as
    the abusive tenant (a drained bucket must not shed them)."""

    def __init__(self, members):
        self.members = members
        self.ok, self.failed = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        from flink_ms_tpu_torch.serve.client import QueryClient

        clients = [QueryClient(h, p, timeout_s=10, tenant=LOOP_ABUSE_TENANT)
                   for h, p in self.members]
        try:
            while not self._stop.wait(LOOP_OPS_POLL_S):
                for c in clients:
                    try:
                        c.health(JOB_STATE)
                        c.metrics()
                        self.ok += 1
                    except Exception as e:
                        self.failed.append(repr(e))
        finally:
            for c in clients:
                c.close()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


def loop_members(gen, shards) -> list:
    """(host, port) of every ready member of generation `gen`."""
    from flink_ms_tpu_torch.serve import registry
    from flink_ms_tpu_torch.serve.elastic import generation_group
    from flink_ms_tpu_torch.serve.ha import shard_group

    return [(e["host"], e["port"]) for s in range(shards)
            for e in registry.resolve_replicas(shard_group(
                generation_group(LOOP_GROUP, gen), s)) if e.get("ready")]


def loop_admission(run, ctl, world) -> dict:
    """(g) The section's arm 2 on the group as (f) left it: for
    ``LOOP_ADMIT_WINDOW_S`` the in-quota GET stream (a process of its own)
    and the abusive tenant at 4x its quota at once.  In-quota traffic
    stays available, the tenant's replies are served or shed and nothing
    else, TOPK sheds before GET, no shed TOPK reaches a member's index
    (its per-verb count less its sheds), HEALTH and METRICS answer
    throughout, and the fleet's signals show the shedding."""
    from flink_ms_tpu_torch.obs.scrape import fleet_signals, scrape_fleet
    from flink_ms_tpu_torch.serve.admission import (
        SHED_MARKER,
        AdmissionController,
    )
    from flink_ms_tpu_torch.serve.client import QueryClient

    t_g = time.perf_counter()
    topo = ctl.current()
    members = loop_members(topo["gen"], topo["shards"])
    check(members, f"(g): generation {topo['gen']} has no ready member")
    admit = AdmissionController.from_env()
    quota = admit.rate_for(LOOP_ABUSE_TENANT)
    burst = quota * admit.burst_s

    def metrics():
        snaps = []
        for h, p in members:
            with QueryClient(h, p, timeout_s=30) as c:
                snaps.append(c.metrics())
        return snaps

    keys = [f"{u}-U" for u in world.users[:LOOP_STREAM_KEYS]]
    stream = ProcessStream(run.work, keys, label="stream-g")
    run.streams.append(stream)
    before, fleet0 = metrics(), scrape_fleet()["fleet"]
    t0 = time.perf_counter()
    poller = OpsPoller(members).start()
    abuse = AbuseStream(keys).start()
    try:
        time.sleep(LOOP_ADMIT_WINDOW_S)
    finally:
        abuse.stop()
        poller.stop()
        stream.stop()
    t1 = time.perf_counter()
    after, fleet1 = metrics(), scrape_fleet()["fleet"]
    sig = fleet_signals(fleet0, fleet1, dt_s=t1 - t0)

    def delta(fn, *a, **kw):
        return sum(fn(y, *a, **kw) - fn(x, *a, **kw)
                   for x, y in zip(before, after))

    # a fleet client's TOPK is an MGET of the user's row, then a TOPKV on
    # each shard: a TOPKV reaches the member's index unless it is shed
    verbs = ("GET", "MGET", "TOPKV")
    reached = {v: delta(hist_count, "tpums_server_latency_seconds", verb=v)
               for v in verbs}
    shed = {v: delta(metric_sum, "counters", "tpums_admission_shed_total",
                     tenant=LOOP_ABUSE_TENANT, verb=v) for v in verbs}
    scored = reached["TOPKV"] - shed["TOPKV"]
    batched = delta(lambda s: hist_of(s, "tpums_topk_batch_size")[2])
    inq = stream.samples
    inq_err = [e for _, e in stream.errors]
    avail = 1.0 - len(inq_err) / max(len(inq), 1)
    a = abuse.counts
    tot = {k: a["GET"][k] + a["TOPK"][k] for k in a["GET"]}
    # the tenant's admitted requests (its GETs served, its MGETs and
    # TOPKVs let through) against the tokens its buckets can have given
    # from the first send to the last reply
    span = abuse.t_end - abuse.sent[0] if abuse.sent else 0.0
    bound = len(members) * (quota * span + burst)
    admitted = a["GET"]["served"] + sum(reached[v] - shed[v]
                                        for v in ("MGET", "TOPKV"))
    share = {v: a[v]["shed"] / max(a[v]["offered"], 1) for v in a}
    log(f"loop (g) admission (generation {topo['gen']}, {len(members)} "
        f"member(s), TPUMS_ADMIT_TENANT_QPS "
        f"{os.environ.get('TPUMS_ADMIT_TENANT_QPS')!r}, burst {burst:g}): "
        f"a {t1 - t0:.2f}s window; serving_rollout_inquota_queries "
        f"{len(inq)}, serving_rollout_inquota_errors {len(inq_err)}, "
        f"serving_rollout_inquota_availability {avail:.6f} (target "
        f"{LOOP_AVAILABILITY}); serving_rollout_abuse_quota_qps {quota:g}, "
        f"offered {tot['offered']} at {LOOP_ABUSE_QPS:g} q/s over "
        f"{span:.2f}s, serving_rollout_abuse_served {tot['served']} "
        f"({admitted} requests admitted, bound {bound:.1f}), "
        f"serving_rollout_abuse_shed {tot['shed']}, "
        f"serving_rollout_abuse_other_errors {tot['other']}; by verb {a}; "
        f"shed share TOPK {share['TOPK']:.4f}, GET {share['GET']:.4f}; the "
        f"members' requests (less their sheds): "
        + ", ".join(f"{v} {reached[v]} ({shed[v]})" for v in verbs)
        + f"; TOPKV scored {scored} against {a['TOPK']['served']} TOPK "
        f"served over {topo['shards']} shard(s); tpums_topk_batch_size sum "
        f"+{batched:g} (inline singles are not observed there); HEALTH + "
        f"METRICS answered {poller.ok} times, {len(poller.failed)} failed; "
        f"serving_rollout_shed_per_s {sig['shed_per_s']:.2f}, "
        f"serving_rollout_admission_pressure "
        f"{sig['admission_pressure']:.4f}; (g) "
        f"{time.perf_counter() - t_g:.1f}s")
    check(avail >= LOOP_AVAILABILITY and all(SHED_MARKER in e
                                             for e in inq_err),
          f"(g): in-quota availability {avail:.6f}, errors {inq_err[:3]}")
    check(tot["served"] + tot["shed"] == tot["offered"] and not tot["other"],
          f"(g): the abusive tenant's other errors {abuse.others[:3]}")
    # every served TOPK scored once on each shard, and no other; every
    # shed one shed at its MGET or a TOPKV
    check(scored == a["TOPK"]["served"] * topo["shards"]
          and shed["MGET"] + shed["TOPKV"] == a["TOPK"]["shed"]
          and shed["GET"] == a["GET"]["shed"] and batched <= scored,
          f"(g): a shed TOPK reached the index: {scored} TOPKV scored, "
          f"{a['TOPK']['served']} TOPK served; sheds {shed}")
    check(tot["shed"] > 0 and tot["served"] <= admitted <= bound,
          f"(g): {tot['served']} served ({admitted} requests admitted) and "
          f"{tot['shed']} shed against the bound {bound:.1f}")
    check(share["TOPK"] >= share["GET"],
          f"(g): TOPK shed less than GET: {share}")
    check(poller.ok > 0 and not poller.failed,
          f"(g): HEALTH or METRICS failed: {poller.failed[:3]}")
    check(sig["shed_per_s"] > 0 and sig["admission_pressure"] > 0,
          f"(g): the fleet's signals {sig}")
    return {"inquota_availability": avail, "abuse": a,
            "shed_per_s": sig["shed_per_s"],
            "admission_pressure": sig["admission_pressure"],
            "admission_s": time.perf_counter() - t_g}


def loop_phase(torch, base, dev) -> dict:
    """Phase 20: the closed loop on phase 17's published topic, every
    member a ``--device`` process on this card: (a) a port
    ``RolloutController`` bootstraps generation 1, (b) a window of ratings
    through the update plane, (c) one ``AutopilotController.tick()`` that
    retrains on the card and rolls the candidate out under a 300 q/s GET
    stream, (d) the canary's live MSE against the offline one, (e) a
    ``model_drift`` alert rolls back, (f) the autopilot's CLI resumes the
    loop from its state record."""
    import tempfile

    from flink_ms_tpu_torch.serve.autopilot import AutopilotController

    t_phase = time.perf_counter()
    prior = {k: os.environ.get(k) for k in
             list(FLEET_ENV) + list(LOOP_ADMIT_ENV) + ["TPUMS_REGISTRY_DIR"]}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        os.environ.update(FLEET_ENV)
        os.environ.update(LOOP_ADMIT_ENV)
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        run = ctl = None
        try:
            run = FleetRun(work, base, dev)
            world = LoopWorld(run.rows, 26)
            t0 = time.perf_counter()
            window = world.ratings(LOOP_RATINGS)
            gen_s = time.perf_counter() - t0
            ctl, out["bootstrap_s"] = loop_bootstrap(run, world)
            gen1 = loop_topk(1, base["users"])
            submit_s = loop_submit(run, window)
            log(f"loop (b) window: {LOOP_RATINGS} ratings of {LOOP_USERS} "
                f"users x {LOOP_ITEMS} items (seed 26) made in {gen_s:.2f}s, "
                f"submitted into {FLEET_PARTITIONS} input partitions in "
                f"{submit_s:.2f}s")
            pilot = AutopilotController(
                LOOP_GROUP, run.path("ratings"), run.path("autopilot"),
                rollout=ctl, num_factors=RANK, partitions=FLEET_PARTITIONS,
                device=dev)
            tick, cand, out["launches"], out["tick_s"], out["get_windows"], \
                out["cutover_s"] = loop_tick(run, ctl, pilot, world)
            out.update(train_s=tick["train_s"],
                       candidate_mse=tick["candidate_mse"],
                       incumbent_mse=tick["incumbent_mse"])
            out.update(loop_canary(run, pilot, cand))
            out.update(loop_drift(run, ctl, pilot, gen1))
            pilot.release_lease()
            out.update(loop_cli(run, ctl, world))
            out.update(loop_admission(run, ctl, world))
            log(f"loop: {stop_loop_orphans(ctl)} member(s) the CLI "
                "spawned stopped")
        finally:
            if ctl is not None:
                stop_loop_orphans(ctl)
            if run is not None:
                run.close()
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    log(f"loop phase: {time.perf_counter() - t_phase:.1f}s")
    return out


OBS_TOPK_CALLS = 500     # (a)'s profiled TOPK stream; (b)'s traced fan-outs
OBS_AB_BLOCKS = 4        # TOPK blocks, TPUMS_PROF=0 and the default in turn
OBS_AB_CALLS = 100       # sequential TOPK in each block
OBS_PUSH_SUBS = 32       # TOPK subscriptions on one B2 su=1 connection
OBS_SGD_RATINGS = 5_000  # SGD ratings published into (a)'s journal (seed 28)
OBS_TOP_STACKS = 10
# the reference CLI's rehearsal defaults at the served model's width; its
# depth cut from ML-20M's 138,493 users (``_seed_journal`` writes as many
# item rows) to 20,000, the one cut phase 21 takes: at 138,493, (c) alone
# outlasts the phase's 150 s (``--obs-only 138493``), and at 40,000 the
# whole run does not fit its 1,200 s on a slow host (PERF.md, section 4)
OBS_REHEARSAL = dict(users=20_000, dim=RANK, shards=2, replication=2,
                     base_qps=120.0, peak_qps=240.0, burst_qps=480.0,
                     duration_s=12.0, threads=4, autoscale="live", kill=True,
                     watch=True, subscribers=8)
# module prefixes whose frames name a part of a member's host CPU: the
# server's request path, the push engine, the update path (the ingest of
# the published rows)
OBS_PARTS = (("server", ("flink_ms_tpu_torch.serve.server.",)),
             ("push", ("flink_ms_tpu_torch.serve.push.",)),
             ("update", ("flink_ms_tpu_torch.serve.consumer.",)))
# (c)'s members also host the update plane, and their indexes rebuild
OBS_FLEET_PARTS = OBS_PARTS + (
    ("update_plane", ("flink_ms_tpu_torch.serve.update_plane.",)),
    ("index", ("flink_ms_tpu_torch.serve.topk.",)))
# (c)'s environment beside the rehearsal's own liveness (its heartbeat
# 0.25 s, its replica TTL 1.5 s, which it sets itself): a wall-clock
# profile of every member and of this process, so that time a thread
# spends parked (on a lock, a batch, a socket) is sampled too
OBS_REHEARSAL_ENV = {"TPUMS_PROF_IDLE": "1"}
# what the time of (c)'s threads goes to, read off the wall-clock
# profiles: (role, the frames that mark a thread of it, its parts in
# order, each named by frames of which a stack must hold one; a part's
# prefix ending in "$" must be the stack's last frame)
_REPLY_LEAVES = ("socket.$", "selectors.$",
                 "flink_ms_tpu_torch.serve.client._read_reply_frame$",
                 "flink_ms_tpu_torch.serve.client._read_reply_line$")
OBS_WAIT_ROLES = (
    ("member request threads", ("flink_ms_tpu_torch.serve.server.",), (
        # the handlers block in sock.recv, a C call: their own frame is
        # the leaf
        ("reading the next request", (
            "flink_ms_tpu_torch.serve.server.handle$",
            "flink_ms_tpu_torch.serve.server._serve_binary$")),
        ("the batcher", ("flink_ms_tpu_torch.serve.microbatch.",)),
        ("the index (lock or scoring)", ("flink_ms_tpu_torch.serve.topk.",)),
        ("the registry", ("flink_ms_tpu_torch.serve.registry.",)),
        ("the request path", ("",)))),
    ("member batch dispatch", ("flink_ms_tpu_torch.serve.microbatch._run",), (
        ("the card's syncs", ("flink_ms_tpu_torch.serve.topk._sync",
                              "flink_ms_tpu_torch.serve.topk."
                              "topk_lowest_first")),
        ("index upkeep", ("flink_ms_tpu_torch.serve.topk._maintain_locked",)),
        ("waiting for queries", ("queue.$", "threading.$")),
        ("scoring on the host", ("",)))),
    ("rehearsal op threads", ("flink_ms_tpu_torch.obs.workload.worker",), (
        # the engine sleeps (a C call) until an op's intended time
        ("pacing, ahead of schedule", (
            "flink_ms_tpu_torch.obs.workload.worker$",)),
        ("the fleet's replies", _REPLY_LEAVES),
        ("the fan-out pool", ("concurrent.futures.",)),
        ("the registry (client refresh)",
         ("flink_ms_tpu_torch.serve.registry.",)),
        ("client host code", ("",)))),
    ("rehearsal fan-out pool", ("concurrent.futures.thread._worker",), (
        ("the fleet's replies", _REPLY_LEAVES),
        ("idle", ("queue.$", "threading.$")),
        ("client host code", ("",)))),
)


def profile_window(before, after) -> dict:
    """The stacks' seconds between two PROFILE snapshots of one process."""
    b = before["stacks"]
    return {k: v - b.get(k, 0.0) for k, v in after["stacks"].items()
            if v - b.get(k, 0.0) > 1e-9}


def profile_parts(stacks, parts=OBS_PARTS) -> dict:
    """Each part's share of a window's seconds: the stacks with a frame of
    its modules (a stack may count in two parts)."""
    total = sum(stacks.values()) or 1.0
    out = {}
    for name, prefixes in parts:
        out[name] = sum(v for k, v in stacks.items()
                        if any(f.startswith(prefixes)
                               for f in k.split(";")[1:])) / total
    return out


def short_stack(key, frames=4) -> str:
    """A folded key as its stage and its last ``frames`` frames."""
    parts = key.split(";")
    tail = parts[1:][-frames:]
    return parts[0] + ";" + ("…;" if len(parts) - 1 > frames else "") + \
        ";".join(tail)


def obs_members(run, spill):
    """(a)'s members, alike but for ``TPUMS_PROF=0`` in the second, and
    (b)'s two workers (every one writing ``TPUMS_TRACE=spill``), spawned
    together -> {label: (proc, port)}."""
    specs = [("prof", 0, 1, ["--jobId", "obs-prof", "--replicaIndex", "0",
                             "--jobGroup", "obs-prof"], {}),
             ("off", 0, 1, ["--jobId", "obs-off", "--replicaIndex", "1",
                            "--jobGroup", "obs-off"], {"TPUMS_PROF": "0"}),
             ("fx0", 0, 2, ["--jobId", "obs-fx-0"], {"TPUMS_TRACE": spill}),
             ("fx1", 1, 2, ["--jobId", "obs-fx-1"], {"TPUMS_TRACE": spill})]
    started = []
    for label, idx, n, extra, env in specs:
        proc, pf, log_path = fleet_worker(run.work, idx, n, run.dev_name,
                                          f"obs-{label}", extra, env)
        run.procs.append(proc)
        started.append((label, proc, pf, log_path))
    out = {}
    for label, proc, pf, log_path in started:
        out[label] = (proc, wait_port_file(proc, pf, log_path))
    wait_health_ready([p for _, p in out.values()],
                      [proc for proc, _ in out.values()])
    return out


def obs_profile(run, members, card) -> dict:
    """(a) the member's profiler under a TOPK stream, SGD rows published
    into its journal (phase 17's update -> push path) and
    ``OBS_PUSH_SUBS`` push subscriptions: PROFILE parsed, the window's top
    stacks and the parts' shares of its host CPU; then TOPK p50/p99 in
    blocks against the ``TPUMS_PROF=0`` member."""
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.online.sgd import SGDStep
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.table import ModelTable

    (_, port), (_, off_port) = members["prof"], members["off"]
    users = run.base["users"]
    sub = QueryClient("127.0.0.1", port, proto="b2", push=True,
                      timeout_s=60)
    pushes, stop = [0], threading.Event()
    for u in users[:OBS_PUSH_SUBS]:   # each the user's served row
        sub.subscribe_topk(JOB_STATE, run.rows[f"{u}-U"], TOPK_K)

    def drain():
        while not stop.is_set():
            if sub.next_push(timeout_s=0.05) is not None:
                pushes[0] += 1

    rng = np.random.default_rng(28)
    u_all = [k[:-2] for k in run.rows if k.endswith("-U") and k != "MEAN-U"]
    i_all = [i for i in run.item_ids if i != "MEAN"]
    ratings = list(zip(
        [int(u_all[j]) for j in rng.integers(0, len(u_all),
                                             OBS_SGD_RATINGS)],
        [int(i_all[j]) for j in rng.integers(0, len(i_all),
                                             OBS_SGD_RATINGS)],
        np.round(rng.uniform(1.0, 5.0, OBS_SGD_RATINGS), 3).tolist()))
    table = ModelTable()
    table.put_many(list(run.rows.items()))
    step = SGDStep(table.get, run.rows["MEAN-U"], run.rows["MEAN-I"],
                   lookup_many=lambda ks: [table.get(k) for k in ks])

    def produce():
        # batches of the update plane's size, paced so that they ride the
        # TOPK stream
        for s in range(0, OBS_SGD_RATINGS, FLEET_BATCH):
            run.journal.append(step.process_batch(
                ratings[s:s + FLEET_BATCH]))
            time.sleep(0.05)

    before = PP.scrape_profile("127.0.0.1", port, timeout_s=30)
    check(before is not None, "the member's PROFILE did not parse")
    drainer = threading.Thread(target=drain, daemon=True)
    producer = threading.Thread(target=produce, daemon=True)
    drainer.start()
    t0 = time.perf_counter()
    producer.start()
    lat = [users[j] for j in rng.integers(0, len(users), OBS_TOPK_CALLS)]
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        p50, p99 = latency_ms(lambda j: c._roundtrip(
            f"TOPK\t{JOB_STATE}\t{lat[j]}\t{TOPK_K}"), len(lat))
    producer.join(timeout=FLEET_WAIT_S)
    end = run.journal.end_offset()
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        wait_until(lambda: c.health(JOB_STATE)["offset"] >= end,
                   "the member's ingest of the SGD rows")
    window_s = time.perf_counter() - t0
    time.sleep(0.3)   # the last deltas of the last rows
    stop.set()
    drainer.join(timeout=30)
    sub.close()
    with QueryClient("127.0.0.1", port, timeout_s=60) as c:
        line = c._roundtrip("PROFILE")
    after = PP.parse_profile_reply(line)
    check(after is not None and after["enabled"] is True,
          f"PROFILE answered {line[:80]!r}")
    window = profile_window(before, after)
    total = sum(window.values())
    parts = profile_parts(window)
    top = sorted(window.items(), key=lambda kv: -kv[1])[:OBS_TOP_STACKS]
    stages = sorted({k.split(";")[0] for k in after["stacks"]})
    log(f"obs (a) profiler ({card}): a one-of-one member ({run.dev_name}); "
        f"{OBS_TOPK_CALLS} sequential TOPK p50 "
        f"{p50:.4f} ms, p99 {p99:.4f} ms under {OBS_SGD_RATINGS} SGD "
        f"ratings and {OBS_PUSH_SUBS} TOPK subscriptions ({pushes[0]} push "
        f"frames) over {window_s:.2f}s; PROFILE: {after['samples']} "
        f"samples at {after['hz']} Hz, stages {stages}; the window "
        f"{total:.4f} s of host CPU in {len(window)} stacks, shares "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    for j, (k, v) in enumerate(top, 1):
        log(f"obs (a) #{j} {v:.4f}s ({v / max(total, 1e-12):.4f}) "
            f"{short_stack(k)}")
    check(after["samples"] > 0, "the member's profiler took no sample")
    check(parts["server"] > 0, "no sample of the server's request path")
    # TOPK p50 in blocks, TPUMS_PROF=0 and the default in turn
    blocks = []
    for b in range(OBS_AB_BLOCKS):
        label, p = (("off", off_port), ("on", port))[b % 2]
        q = [users[j] for j in rng.integers(0, len(users), OBS_AB_CALLS)]
        with QueryClient("127.0.0.1", p, timeout_s=60) as c:
            c._roundtrip(f"TOPK\t{JOB_STATE}\t{q[0]}\t{TOPK_K}")
            bp50, bp99 = latency_ms(lambda j: c._roundtrip(
                f"TOPK\t{JOB_STATE}\t{q[j]}\t{TOPK_K}"), len(q))
        blocks.append((label, bp50, bp99))
    arm = {lab: float(np.mean([b[1] for b in blocks if b[0] == lab]))
           for lab in ("off", "on")}
    log(f"obs (a) TOPK p50/p99 in blocks of {OBS_AB_CALLS} ({card}): "
        + ", ".join(f"{lab} {a:.4f}/{b:.4f} ms" for lab, a, b in blocks)
        + f"; mean p50 off {arm['off']:.4f}, on {arm['on']:.4f} ms "
        f"({100 * (arm['on'] / arm['off'] - 1):+.1f}%; not gated)")
    for label in ("prof", "off"):
        stop_member(run, members.pop(label)[0])
    return dict(obs_topk_p50_ms=p50, obs_topk_p99_ms=p99,
                obs_samples=after["samples"], obs_window_cpu_s=total,
                obs_parts=parts, obs_ab=blocks)


def obs_forensics(run, members, spill, card):
    """(b) ``OBS_TOPK_CALLS`` traced fan-out TOPK into the 2-shard group,
    every process appending to one ``TPUMS_TRACE`` file: every tree
    assembled with its client span and both shards' ``server_reply``; the
    slowest tree's critical path and the slow/fast diff's stages -> (the
    spill's copy, its report, the numbers)."""
    from flink_ms_tpu_torch.obs import forensics as FX
    from flink_ms_tpu_torch.obs import tracing as PT
    from flink_ms_tpu_torch.serve.sharded import ShardedQueryClient

    ports = [members[f"fx{i}"][1] for i in range(2)]
    users = run.base["users"]
    rng = np.random.default_rng(29)
    lat = [users[j] for j in rng.integers(0, len(users), OBS_TOPK_CALLS)]
    tids = []
    client = ShardedQueryClient([("127.0.0.1", p) for p in ports],
                                timeout_s=60)
    prior = os.environ.get("TPUMS_TRACE")
    try:
        for u in users[:16]:     # untraced: the indexes' first builds
            client.topk(JOB_STATE, u, TOPK_K)
        os.environ["TPUMS_TRACE"] = spill

        def traced(j):
            tid = PT.new_trace_id()
            tids.append(tid)
            with PT.trace_span(tid):
                client.topk(JOB_STATE, lat[j], TOPK_K)

        p50, p99 = latency_ms(traced, len(lat))
    finally:
        client.close()
        if prior is None:
            os.environ.pop("TPUMS_TRACE", None)
        else:
            os.environ["TPUMS_TRACE"] = prior
    # the members go on appending their own events: (b) and (d) read a
    # copy of the spill as it stands after the traced requests
    frozen = spill + ".b"
    shutil.copyfile(spill, frozen)
    t0 = time.perf_counter()
    rep = FX.report([frozen])
    trees = FX.assemble(FX.collect([frozen]))
    report_s = time.perf_counter() - t0
    whole = 0
    for tid in tids:
        tree = trees.get(tid)
        if tree is None:
            continue
        evs = list(tree.spans.values())
        client_span = any(str(e.get("kind", "")).startswith("client_")
                          for e in evs)
        shard_ports = {e.get("port") for e in evs
                       if e.get("kind") == "server_reply"}
        whole += client_span and set(ports) <= shard_ports
    slow = rep["slowest"][0] if rep["slowest"] else None
    d = rep["diff"]
    log(f"obs (b) forensics ({card}): {OBS_TOPK_CALLS} traced fan-out TOPK "
        f"over 2 shards ({run.dev_name}) p50 {p50:.4f} ms, p99 {p99:.4f} "
        f"ms; the spill: {rep['events']} events, {rep['traces']} trees "
        f"({whole} with a client span and both shards' server_reply), "
        f"report {report_s:.2f}s; trace p50 "
        f"{d['quantiles']['p50'] * 1e3:.4f} ms, p90 "
        f"{d['quantiles']['p90'] * 1e3:.4f}, p99 "
        f"{d['quantiles']['p99'] * 1e3:.4f}; slow tail (n {d['slow_n']}, "
        f"mean {d['slow_mean_s'] * 1e3:.4f} ms) against the median band "
        f"(n {d['fast_n']}, mean {d['fast_mean_s'] * 1e3:.4f} ms): "
        + "; ".join(f"{st['stage']} {st['delta_s'] * 1e6:+.1f} us "
                    f"({st['delta_share']:.3f})" for st in d["stages"][:4]))
    if slow is not None:
        log(f"obs (b) slowest tree {slow['tid']} "
            f"{slow['total_s'] * 1e3:.4f} ms: "
            + "; ".join(f"{r['stage']} {r['self_s'] * 1e6:.1f} us "
                        f"({r['share']:.3f})"
                        for r in slow["critical_path"]))
    check(rep["traces"] == OBS_TOPK_CALLS and whole == OBS_TOPK_CALLS,
          f"{rep['traces']} trees, {whole} whole, of {OBS_TOPK_CALLS}")
    return frozen, rep, dict(obs_fanout_p50_ms=p50, obs_fanout_p99_ms=p99,
                     obs_diff_stage=d["stages"][0]["stage"]
                     if d["stages"] else None)


def tie_order(rep) -> dict:
    """A forensics report with its stages in one order: stages of equal
    delta come out of a set, in an order that differs between processes
    (string hashing is salted per process)."""
    d = dict(rep["diff"], stages=sorted(
        rep["diff"]["stages"], key=lambda r: (-r["delta_s"], r["stage"])))
    return dict(rep, diff=d)


def obs_clis(spill, rep, card) -> dict:
    """(d) the forensics, watch and profiler CLIs, each in a process of its
    own, all three at once, against (b)'s group before it stops."""
    env = child_env()
    runs = {"forensics": ["flink_ms_tpu_torch.obs.forensics", spill,
                          "--json"],
            "watch": ["flink_ms_tpu_torch.obs.watch", "--once"],
            "profiler": ["flink_ms_tpu_torch.obs.profiler", "--fleet"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", *argv], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, argv in runs.items()}
    outs = {}
    for k, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=FLEET_WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
        outs[k] = (proc.returncode, out, err)
    cli_s = time.perf_counter() - t0
    for k, (rc, out, err) in outs.items():
        check(rc == 0, f"the {k} CLI exited {rc}: {err[-1000:]}")
    check(tie_order(json.loads(outs["forensics"][1])) == tie_order(rep),
          "the forensics CLI's report differs from the in-process one")
    watch = json.loads(outs["watch"][1].split("\n# ")[0])
    head = outs["profiler"][1].splitlines()[0]
    samples = int(head.split()[1]) if head.startswith("# ") else 0
    log(f"obs (d) CLIs ({card}), 3 processes at once in {cli_s:.2f}s: "
        f"forensics --json equals the in-process report (stages of equal "
        f"delta in one order); watch --once: "
        f"{watch['ticks']} tick, {watch['firing']} firing, "
        f"{watch['fired_total']} fired, unattributed pages "
        f"{watch['unattributed_page']}, tick {watch['avg_tick_s']}s; "
        f"profiler --fleet: {head[2:]}")
    check(samples > 0, f"the fleet profile has no sample: {head!r}")
    return dict(obs_cli_s=cli_s, obs_fleet_samples=samples)


def fleet_profile_poller(stop, seen):
    """Scrape every live member's PROFILE each second until ``stop`` and
    keep each member's last answer in ``seen`` ({(job id, port):
    profile}), so a member that dies keeps the profile of its life."""
    from flink_ms_tpu_torch.obs.scrape import scrape_fleet_profiles

    while not stop.wait(1.0):
        # the rehearsal names its registry while its group is up
        if not os.environ.get("TPUMS_REGISTRY_DIR"):
            continue
        try:
            fp = scrape_fleet_profiles(timeout_s=2.0)
        except Exception:
            continue
        for r in fp["replicas"]:
            if r["profile"] is not None:
                seen[(r["job_id"], r["port"])] = r["profile"]


def wait_parts(stacks, roles=OBS_WAIT_ROLES) -> dict:
    """{role: (seconds, {part: seconds})} of a profile's stacks: a stack
    counts in the first role one of whose frames it holds, and in that
    role's first part whose frames match (``OBS_WAIT_ROLES``)."""
    def holds(frames, prefixes):
        for p in prefixes:
            if p.endswith("$"):
                if frames and frames[-1].startswith(p[:-1]):
                    return True
            elif any(f.startswith(p) for f in frames):
                return True
        return False

    out = {role: [0.0, {part: 0.0 for part, _ in parts}]
           for role, _, parts in roles}
    for key, v in stacks.items():
        frames = key.split(";")[1:]
        for role, marks, parts in roles:
            if holds(frames, marks):
                out[role][0] += v
                for part, prefixes in parts:
                    if holds(frames, prefixes):
                        out[role][1][part] += v
                        break
                break
    return {role: (t, parts) for role, (t, parts) in out.items()}


def fmt_wait_parts(parts) -> str:
    return "; ".join(
        f"{role} {t:.2f} s (" + ", ".join(
            f"{part} {v / t:.4f}" for part, v in ps.items()) + ")"
        for role, (t, ps) in parts.items() if t > 0)


# what the rehearsal sets for itself, as its CLI does (its registry under
# its own temp dir, its heartbeat and TTL), and the profilers' switches
REHEARSAL_OWN_ENV = ("TPUMS_REGISTRY_DIR", "TPUMS_HEARTBEAT_S",
                     "TPUMS_REPLICA_TTL_S", "TPUMS_UPDATE_POLL_S",
                     "TPUMS_PROF", "TPUMS_PROF_IDLE")


# what a supervisor does to its members
SUPERVISION_KINDS = ("rehearsal_kill", "replica_heartbeat_expired",
                     "replica_respawn")


def rehearsal_in_process(kw, env, out_path, go=None) -> None:
    """``run_rehearsal(**kw)`` with the environment ``env``, in the process
    it is called in (``Isolated`` spawns one for it, as the
    rehearsal's CLI is a process of its own): the report, this process's
    own profile when its profiler runs, and the first and last of the
    rehearsal's fleet scrapes, written to ``out_path`` as JSON.  With
    ``go`` (a path) it waits for that file before it begins."""
    os.environ.clear()
    os.environ.update(env)
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.obs import scrape as obs_scrape
    from flink_ms_tpu_torch.obs.workload import run_rehearsal

    while go is not None and not os.path.exists(go):
        time.sleep(0.05)

    real_scrape, fleets = obs_scrape.scrape_fleet, []

    def scrape_fleet(*a, **k):
        snap = real_scrape(*a, **k)
        fleets.append(snap["fleet"])
        return snap

    obs_scrape.scrape_fleet = scrape_fleet
    prof = PP.ensure_started()
    rep = run_rehearsal(**kw)
    own = prof.snapshot() if prof is not None else None
    PP.stop_profiler()
    # the supervisors' acts over the whole run, its start-up and teardown
    # too (the report's timeline keeps those of the open loop's window)
    from flink_ms_tpu_torch.obs import tracing

    acts = [e for e in tracing.recent_events()
            if e.get("kind") in SUPERVISION_KINDS]
    with open(out_path, "w") as f:
        json.dump({"report": rep, "own": own, "supervision": acts,
                   "fleets": fleets[:1] + fleets[-1:]}, f, default=str)


class Isolated:
    """``rehearsal_in_process(kw, env)`` in a spawned process of its own,
    started by the constructor; ``join`` -> what it wrote.  With
    ``hold`` the rehearsal waits for the file ``go`` (``Rehearsal``
    writes it).  A process that outlasts ``timeout_s`` from its start is
    killed (its members go with the run's ``stop_leftovers``)."""

    def __init__(self, kw, env, timeout_s, hold=False):
        import multiprocessing
        import tempfile

        self.timeout_s = timeout_s
        self.t0 = time.perf_counter()
        self.dir = tempfile.mkdtemp(prefix="tpums_isolated_")
        self.out = os.path.join(self.dir, "rehearsal.json")
        self.go = os.path.join(self.dir, "go") if hold else None
        self.proc = multiprocessing.get_context("spawn").Process(
            target=rehearsal_in_process, args=(kw, env, self.out, self.go))
        self.proc.start()

    def join(self) -> dict:
        try:
            self.proc.join(max(self.timeout_s - (time.perf_counter()
                                                 - self.t0), 0.0))
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
                raise SmokeFailure(
                    f"the rehearsal outlasted {self.timeout_s:.0f}s")
            check(self.proc.exitcode == 0 and os.path.exists(self.out),
                  f"the rehearsal's process exited {self.proc.exitcode}")
            with open(self.out) as f:
                return json.load(f)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


class Rehearsal:
    """(c) ``run_rehearsal`` at the served model's width, in a process of
    its own as its CLI runs, started by the constructor and checked by
    ``finish``: the reference CLI's defaults (``OBS_REHEARSAL``, at
    ``users`` users when given), the watch loop on, push subscribers, a
    kill and the live autoscaler, at the rehearsal's own liveness; the
    card's memory at its peak, the members' merged wall-clock profile
    (the last PROFILE of each, scraped through the run) and the rehearsal
    process's own (its engine, clients and watch loop), with what the
    threads of each wait on.  ``edge`` > 0 is phase 22 (d): as many
    proxies in front of the group, every client through them, the fleet
    signals of the proxy tier, and ``GEO_REHEARSAL_ENV`` (no profiler)
    for ``OBS_REHEARSAL_ENV``; ``duration_s`` stands for the schedule's
    12 s.  With ``hold`` its process starts at once but its rehearsal only
    at ``release``."""

    def __init__(self, torch, dev, card, users=None, edge=0,
                 duration_s=None, hold=False):
        import tempfile

        self.torch, self.dev, self.card, self.edge = torch, dev, card, edge
        self.label = "geo (d)" if edge else "obs (c)"
        env = GEO_REHEARSAL_ENV if edge else OBS_REHEARSAL_ENV
        kw = dict(OBS_REHEARSAL)
        if users is not None:
            kw["users"] = users
        if edge:
            kw["edge"] = edge
        dur = kw.pop("duration_s")
        if duration_s is not None:
            dur = duration_s
        kw.update(warm_s=dur * 2 / 12, ramp_s=dur * 3 / 12,
                  burst_s=dur * 4 / 12, cool_s=dur * 3 / 12, seed=0,
                  device=str(dev.type))
        self.kw = kw
        self.peak, self.stop, self.before_b = [0], threading.Event(), 0
        self.members = {}
        # the card's memory in use before the members start: this
        # process's own tensors and cache from the earlier phases
        if dev.type == "cuda":
            free, total_b = torch.cuda.mem_get_info(dev)
            self.peak[0] = self.before_b = total_b - free
        self.sampler = None
        if dev.type == "cuda":
            self.sampler = threading.Thread(target=self._sample_memory,
                                            daemon=True)
            self.sampler.start()
        # the rehearsal's own heartbeat and TTL, as its CLI makes them,
        # and `env`; its registry is named here, so that this process
        # reads its members' profiles while it runs
        child_env = {k: v for k, v in os.environ.items()
                     if k not in REHEARSAL_OWN_ENV}
        child_env.update(env)
        self.registry = tempfile.mkdtemp(prefix="tpums_rehearsal_registry_")
        child_env["TPUMS_REGISTRY_DIR"] = self.registry
        self.poller, self.saved = None, None
        if child_env.get("TPUMS_PROF", "1") != "0":
            self.saved = os.environ.get("TPUMS_REGISTRY_DIR")
            os.environ["TPUMS_REGISTRY_DIR"] = self.registry
            self.poller = threading.Thread(target=fleet_profile_poller,
                                           args=(self.stop, self.members),
                                           daemon=True)
            self.poller.start()
        self.t0 = time.perf_counter()
        self.released = not hold
        try:
            self.run = Isolated(kw, child_env, 2 * FLEET_WAIT_S,
                                **({"hold": True} if hold else {}))
        except BaseException:
            self._stop_threads()
            raise

    def _sample_memory(self):
        while not self.stop.wait(0.25):
            free, total_b = self.torch.cuda.mem_get_info(self.dev)
            self.peak[0] = max(self.peak[0], total_b - free)

    def _stop_threads(self):
        self.stop.set()
        if self.poller is not None:
            self.poller.join(timeout=10)
            if self.saved is None:
                os.environ.pop("TPUMS_REGISTRY_DIR", None)
            else:
                os.environ["TPUMS_REGISTRY_DIR"] = self.saved
        if self.sampler is not None:
            self.sampler.join(timeout=10)
        shutil.rmtree(self.registry, ignore_errors=True)

    def release(self) -> None:
        if not self.released:
            open(self.run.go, "w").close()
            self.released = True

    def abandon(self) -> None:
        """After a failure beside it: a rehearsal not yet released is
        killed (it started no member); one released runs to its end (it
        stops its own members) and is read for what it shows."""
        if not self.released:
            self.run.proc.kill()
            self.run.proc.join()
            shutil.rmtree(self.run.dir, ignore_errors=True)
            self._stop_threads()
            return
        try:
            self.finish()
        except Exception as e:
            log(f"{self.label} after the failure above: {e!r}")

    def finish(self) -> dict:
        try:
            got = self.run.join()
        finally:
            seconds = time.perf_counter() - self.t0
            self._stop_threads()
        return rehearsal_checks(got, seconds, self.label, self.kw, self.dev,
                                self.card, self.edge, self.members,
                                self.peak, self.before_b, self.sampler)


def obs_rehearsal(torch, dev, card, users=None, edge=0,
                  duration_s=None) -> dict:
    """(c) ``Rehearsal`` from its start to its checks."""
    return Rehearsal(torch, dev, card, users, edge, duration_s).finish()


def rehearsal_checks(got, seconds, label, kw, dev, card, edge, members,
                     peak, before_b, sampler) -> dict:
    """Phase 21 (c)'s (and 22 (d)'s) lines and checks of one rehearsal."""
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.obs import scrape as obs_scrape
    from flink_ms_tpu_torch.obs.slo import validate_report

    rep, own, fleets = got["report"], got["own"], got["fleets"]
    acts = got.get("supervision", [])
    problems = validate_report(rep)
    wl, alerts, push = rep["workload"], rep["alerts"], rep["push"]
    det = alerts["detection"]
    cuts = sum(1 for e in rep["timeline"]
               if e.get("kind") == "elastic_cutover")
    mem = (f"{peak[0] / 2**30:.2f} GiB ({before_b / 2**30:.2f} GiB in use "
           "before the members started)" if sampler is not None
           else "not measured")
    kinds = {}
    for e in rep["timeline"]:
        kinds[e.get("kind")] = kinds.get(e.get("kind"), 0) + 1
    respawns = kinds.get("replica_respawn", 0)
    t_first = min((e.get("ts", 0.0) for e in acts), default=0.0)
    whole = {k: sum(1 for e in acts if e.get("kind") == k)
             for k in SUPERVISION_KINDS}
    log(f"{label} rehearsal ({card}): {kw['users']} users x rank "
        f"{kw['dim']}, {kw['shards']} shards x {kw['replication']} "
        f"replicas ({dev.type})" + (f" behind {edge} proxies" if edge else "")
        + f", autoscale {kw['autoscale']}, kill, watch, "
        f"{kw['subscribers']} subscribers, {seconds:.2f}s in all: ok "
        f"{rep['ok']}; {wl['completed']} of {wl['scheduled']} ops, "
        f"achieved {wl['achieved_qps']} q/s, max lag "
        f"{wl['max_sched_lag_s']}s; errors {rep['errors']['total']} "
        f"({rep['errors']['unattributed']} unattributed); {cuts} cutovers; "
        f"{respawns} respawns at the replica TTL the rehearsal sets "
        f"(1.5 s); alerts fired {alerts['fired_total']}, unattributed pages "
        f"{alerts['unattributed_page']}, kill detection {det}; push "
        f"{push['pushes_received']} deltas, p99 {push['p99_ms']} ms "
        f"(budget {push['p99_budget_ms']}); the card's memory at its peak "
        f"{mem}")
    log(f"{label} per verb p50/p99 ms: " + "; ".join(
        f"{v} {s.get('p50_ms')}/{s.get('p99_ms')} "
        f"(service p99 {s.get('service_p99_ms')})"
        for v, s in sorted(rep["verbs"].items())))
    if own is not None and own["stacks"]:
        total = sum(own["stacks"].values())
        reads = sum(v for k, v in own["stacks"].items()
                    if "flink_ms_tpu_torch.serve.registry." in k) / total
        top = sorted(own["stacks"].items(), key=lambda kv: -kv[1])[:3]
        log(f"{label} the rehearsal process's wall-clock profile: "
            f"{own['samples']} samples, {total:.3f} s; stacks "
            f"reading the registry {reads:.4f}; waits: "
            f"{fmt_wait_parts(wait_parts(own['stacks']))}; top: "
            + "; ".join(f"{v / total:.4f} {short_stack(k)}"
                        for k, v in top))
    log(f"{label} timeline: {dict(sorted(kinds.items()))}; "
        + (f"{cuts} live cutover(s)" if cuts else
           f"no cutover: autoscale {kw['autoscale']}" if
           kw["autoscale"] != "live" else
           "the live cutover was not exercised (the autoscaler trips at "
           f"{kw['peak_qps'] / kw['shards'] * 1.3:g} q/s a shard, and "
           f"the open loop reached {wl['achieved_qps']} q/s in all)"))
    fleet = PP.merge_profiles(list(members.values()))
    if members and fleet["stacks"]:
        total = sum(fleet["stacks"].values())
        parts = profile_parts(fleet["stacks"], OBS_FLEET_PARTS)
        top = sorted(fleet["stacks"].items(), key=lambda kv: -kv[1])[:5]
        log(f"{label} the members' wall-clock profile ({len(members)} "
            f"members, the last PROFILE of each): {fleet['samples']} "
            f"samples, {total:.3f} s over {seconds:.2f}s on "
            f"{os.cpu_count()} cores; shares " + ", ".join(
                f"{k} {v:.4f}" for k, v in parts.items()) + "; waits: "
            + fmt_wait_parts(wait_parts(fleet["stacks"]))
            + " (a thread waiting for the GIL is sampled at its next Python "
            "frame: the GIL's share is not measured apart); top: "
            + "; ".join(f"{v / total:.4f} {short_stack(k)}"
                        for k, v in top))
    edge_sig = {}
    if edge and len(fleets) >= 2:
        sig = obs_scrape.fleet_signals(fleets[0], fleets[-1])
        edge_sig = {k: v for k, v in sig.items() if k.startswith("edge_")}
        log(f"{label} the proxy tier's fleet signals over the run: "
            + ", ".join(f"{k} {v}" for k, v in sorted(edge_sig.items())))
    for b in rep["breaches"]:
        cause = b.get("attributed_to")
        log(f"{label} breach {b['verb']}.{b['objective']} measured "
            f"{b['measured']} target {b['target']} -> "
            f"{cause['kind'] if cause else 'UNATTRIBUTED'}"
            + (f"/{cause.get('phase')}" if cause and cause.get("phase")
               else ""))
    loose = [f"{b['verb']}.{b['objective']}" for b in rep["breaches"]
             if not b.get("attributed_to")]
    if loose:
        # an open fault, filed in ROADMAP.md's Queue 3: the open loop
        # falls behind its schedule, the run outlasts its phases, and a
        # latency breach (placed at the run's midpoint) lands past every
        # timeline event
        log(f"{label} OPEN FAULT (ROADMAP Queue 3, 'Rehearsal at full "
            f"width'): the rehearsal's own verdict is ok {rep['ok']}, with "
            f"{len(loose)} unattributed breaches ({', '.join(loose)}); the "
            f"open loop ran {wl['duration_s']}s for a "
            f"{wl['planned_duration_s']}s schedule")
    check(not problems, f"the rehearsal's report is malformed: {problems}")
    check(rep["errors"]["unattributed"] == 0,
          f"{rep['errors']['unattributed']} unattributed errors")
    check(alerts["unattributed_page"] == 0,
          f"{alerts['unattributed_page']} unattributed pages")
    check(wl["completed"] == wl["scheduled"],
          f"{wl['completed']} of {wl['scheduled']} scheduled ops ran")
    check(det["max_s"] is not None, f"the kill was not detected: {det}")
    log(f"{label} supervision over the whole run, its start and teardown "
        f"with it: {whole}" + "".join(
            f"; {e['kind']} s{e.get('shard')}r{e.get('replica')} at "
            f"+{e.get('ts', 0.0) - t_first:.2f} s" for e in acts))
    check(respawns <= 1, f"{respawns} respawns for one kill")
    check(whole["replica_respawn"] <= whole["rehearsal_kill"]
          and not whole["replica_heartbeat_expired"],
          f"respawns beyond the kill's over the whole run: {whole}")
    dead = [e.get("error") for e in rep["errors"]["samples"]
            if any(m in str(e.get("error")) for m in TAKEN_FOR_DEAD)]
    check(not dead, f"a live member taken for dead: {dead[:3]}")
    if edge:
        check(rep["meta"].get("edge") == edge and edge_sig,
              f"the edge arm did not run: {rep['meta']}, {edge_sig}")
    return dict(obs_rehearsal_s=seconds, obs_rehearsal_ok=rep["ok"],
                obs_detection_s=det["max_s"], obs_peak_mem_b=peak[0],
                obs_respawns=respawns, obs_edge_signals=edge_sig)


def obs_phase(torch, base, dev, card) -> dict:
    """Phase 21: observability on phase 17's published topic, every member
    a ``--device`` process on this card: (a) the continuous profiler of a
    member under load, with its PROFILE verb; (b) forensics over one spill
    of traced fan-outs; (d) the forensics, watch and profiler CLIs; (c) the
    rehearsal workload engine's closed loop at full width."""
    import tempfile

    from flink_ms_tpu_torch.serve.sharded import stop_worker_procs

    t_phase = time.perf_counter()
    prior = {k: os.environ.get(k)
             for k in list(FLEET_ENV) + ["TPUMS_REGISTRY_DIR"]}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        os.environ.update(FLEET_ENV)
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        run = None
        try:
            run = FleetRun(work, base, dev)
            spill = run.path("spill.jsonl")
            t0 = time.perf_counter()
            members = obs_members(run, spill)
            log(f"obs: 4 members ({run.dev_name}) ready "
                f"{time.perf_counter() - t0:.2f}s after their spawn")
            out.update(obs_profile(run, members, card))
            frozen, rep, fx = obs_forensics(run, members, spill, card)
            out.update(fx)
            out.update(obs_clis(frozen, rep, card))
            stop_worker_procs(run.procs)
            run.procs = []
        finally:
            if run is not None:
                run.close()
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    out.update(obs_rehearsal(torch, dev, card))
    log(f"obs phase: {time.perf_counter() - t_phase:.1f}s")
    return out


def seeded_published():
    """Seeded random rows at the served model's shape (``N_USERS`` x
    ``N_ITEMS`` at ``RANK``, the MEAN rows), as phase 17 publishes them."""
    from flink_ms_tpu_torch.core import formats as F

    rng = np.random.default_rng(0)
    uf = rng.normal(0.0, 0.3, (N_USERS, RANK)).astype(np.float32)
    itf = rng.normal(0.0, 0.3, (N_ITEMS, RANK)).astype(np.float32)
    published = [F.format_als_row(u, "U", uf[u]) for u in range(N_USERS)]
    published += [F.format_als_row(i, "I", itf[i]) for i in range(N_ITEMS)]
    published += [F.format_als_row("MEAN", side, m.mean(axis=0))
                  for side, m in (("U", uf), ("I", itf))]
    return published


def obs_only(torch, dev, users) -> int:
    """Phase 21 alone, for a look at observability without the other
    phases: seeded random rows at the served model's shape (phase 17's
    165,239 rows at rank 50) stand in for phase 17's topic; then (c) again
    at each count of ``users``."""
    from flink_ms_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    native_build.build()
    base = fleet_baseline(seeded_published(), dev, JOB_TOPK_USERS)
    obs_phase(torch, base, dev, card)
    for n in users:
        obs_rehearsal(torch, dev, card, users=n)
    log(f"done in {time.perf_counter() - t0:.1f}s")
    print(card)
    return 0


GEO_GROUP = "geo"             # the serving group both regions serve
GEO_HOME, GEO_FOLLOWER = "us", "eu"
# the rehearsal CLI's liveness, which the reference's region drill runs at
# (``scripts/chaos_kill.py``'s region mode): a home region whose leases
# lapse must be promoted away from within 5 s
# and the members' journal and update-plane polls: the rehearsal's (the
# update plane's default); each poll is file operations, and at 5 ms six
# members' polls loaded the host with (d) beside them (PERF.md, section 4)
GEO_POLL_S = "0.02"
GEO_ENV = {"TPUMS_HEARTBEAT_S": "0.25", "TPUMS_REPLICA_TTL_S": "1.5",
           "TPUMS_UPDATE_POLL_S": GEO_POLL_S}
GEO_TOPK_USERS = 256          # (a) single TOPK replies, eu against us
GEO_KEYS = 256                # (b) keys and queries through the proxy
GEO_SGD_S = 3.0               # (a) forwarded SGD load while the lag is read
GEO_SGD_BATCH = 20            # ratings a forwarder batch
GEO_SGD_EVERY_S = 0.004       # the pause after each: 5,000 ratings/s
# offered, each rewriting a user and an item row: the rows a second of the
# reference's region drill (200 rows each 20 ms, ``chaos_kill.py``), not
# its appends.  The drill has one writer, 50 appends a second to home's
# topic; here the forwarder fsyncs each ratings journal a batch touches
# (535 a second on a quiet card host), and the home members' update planes
# append to home's topic once a partition a poll, about 400 times a second
# from 4 planes.  Fewer ratings arrive than are offered, 153-987 a second
# as the host is loaded (PERF.md, section 5)
GEO_LAG_P99_MS = 250.0        # the reference's contract (chaos_kill.py)
GEO_PROMOTE_S = 5.0           # ditto
GEO_STALE_BOUND_S = 0.5       # (b) the eu proxy's clients' bound
GEO_PUSH_SUBS = 6             # (b) KEY subscriptions (and one TOPK)
GEO_LOAD_S = 1.0              # (b) load before and after each fault
GEO_STOP_S = 0.8              # (b) a replica's SIGSTOP, inside its TTL
GEO_LATENCY_CALLS = 150       # (b) sequential GET and TOPK, each client
# (d): the rehearsal of phase 21 (c) with its edge arm, two proxies, and
# no profiler: (c) reads what the rehearsal's threads wait on, and the
# profilers cost its open loop a fifth of its rate on the card
# (scripts/rehearsal_ab.py, PERF.md)
GEO_REHEARSAL_EDGE = 2
GEO_REHEARSAL_ENV = {"TPUMS_PROF": "0"}
# its schedule cut from the CLI's 12 s to 4 s (the same phases at a third
# of their lengths): through the proxies the open loop ran about 4 s behind
# for each second of schedule on the card, so 12 s took 104.5 s; and its
# users from 40,000 to 10,000, as it runs beside (a)-(c): at 40,000 it took
# 136.8 s there on a slow host (PERF.md, section 4)
GEO_REHEARSAL_DURATION_S = 4.0
GEO_REHEARSAL_USERS = 10_000
# every process of phase 22 runs this watchdog: a ``sitecustomize`` on the
# PYTHONPATH of those it starts, armed by TPUMS_STALL_DIR, and the same
# code in this process.  Its thread sleeps 20 ms at a time; when it
# cannot take the GIL back within STALL_S (another thread held it, or the
# process got no CPU or was stopped), it dumps every thread's stack as it
# takes the GIL back, under the GIL.  No faulthandler timer is armed: its
# thread dumps without the GIL while the others run, and such a dump,
# fired as a SIGSTOPped member went on, killed it by SIGSEGV with nothing
# written (tests/test_torch_stall_watchdog.py; that thread blocks every
# signal, so faulthandler's own handler never runs).  It wraps the
# registry's ``register`` once the process has imported it: each
# heartbeat's start and end, kept in memory, give the
# process's largest gap between heartbeats as a reader sees them (from
# one heartbeat's stamp to the end of the next one's write), written to
# its file when it grows; a heartbeat overdue by STALL_S, or one whose
# write has taken as long, dumps every thread's stack under the GIL.
STALL_S = 0.3
STALL_WATCHDOG = r'''
import atexit, faulthandler, os, sys, threading, time


def watch_stalls(out_dir, stall_s=0.3, tick_s=0.02):
    fd = os.open(os.path.join(out_dir, "stall-%d.txt" % os.getpid()),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        # a process whose stderr is thrown away (a fleet member) keeps it
        # here, so what the C++ runtime says before an abort is read too
        if os.path.samestat(os.fstat(2), os.stat(os.devnull)):
            err = os.open(os.path.join(out_dir, "stderr-%d.txt"
                                       % os.getpid()),
                          os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            os.dup2(err, 2)
            os.close(err)
    except OSError:
        pass
    was_enabled = faulthandler.is_enabled()
    faulthandler.enable(file=fd, all_threads=True)   # a crash's stacks
    done = threading.Event()
    beat_s = float(os.environ.get("TPUMS_HEARTBEAT_S", "1"))
    beats = {"start": None, "end": None, "last_stamp": None, "max": 0.0}
    out = {"fd": fd, "lock": threading.Lock(), "hooked": None}

    def say(text):
        # nothing once stopped: the fd's number may name another file then
        with out["lock"]:
            if out["fd"] is not None:
                os.write(out["fd"], text.encode("utf-8", "replace"))

    def stacks():
        # every thread's stack, read under the GIL before anything lets it
        # go (no other thread runs Python meanwhile, so none moves or
        # ends), in faulthandler's format
        out, me = [], threading.get_ident()
        for ident, f in sys._current_frames().items():
            out.append("%s 0x%016x (most recent call first):\n" % (
                "Current thread" if ident == me else "Thread", ident))
            while f is not None:
                out.append('  File "%s", line %d in %s\n' % (
                    f.f_code.co_filename, f.f_lineno or 0,
                    f.f_code.co_name))
                f = f.f_back
            out.append("\n")
        return "".join(out)

    def hook():
        reg = sys.modules.get("flink_ms_tpu_torch.serve.registry")
        real = getattr(reg, "register", None)
        if real is None or getattr(reg.__spec__, "_initializing", False):
            return False       # not imported yet, or importing now
        if getattr(real, "watched", False):
            return True

        def register(job_id, *a, **k):
            if k.get("ttl_s") is None:
                return real(job_id, *a, **k)
            if beats["start"] is None:
                say("--- member %s\n" % job_id)
            beats["start"] = time.time()
            try:
                return real(job_id, *a, **k)
            finally:
                end = time.time()
                if beats["last_stamp"] is not None and \
                        end - beats["last_stamp"] > beats["max"] + 0.05:
                    beats["max"] = end - beats["last_stamp"]
                    say("--- heartbeat gap %.3f s ending at %.3f\n"
                        % (beats["max"], end))
                beats["last_stamp"], beats["end"] = beats["start"], end

        register.watched = True
        reg.register = register
        out["hooked"] = (reg, real, register)
        return True

    def dog():
        hooked, late = False, None
        while not done.is_set():
            t0 = time.monotonic()
            time.sleep(tick_s)
            waited = time.monotonic() - t0
            if waited > stall_s:
                # the stacks as this thread takes the GIL back
                say("--- stacks as the stall ended\n" + stacks()
                    + "--- stall %.3f s ending at %.3f\n"
                    % (waited, time.time()))
            hooked = hooked or hook()
            start, end = beats["start"], beats["end"]
            if start is None:
                continue
            now = time.time()
            # overdue: a heartbeat's write that hangs, or no heartbeat
            # begun in time after the last one's end
            age = (now - start if end is None or end < start
                   else now - end - beat_s)
            if age >= stall_s and late is None:
                late = age
                say("--- heartbeat overdue %.3f s at %.3f\n" % (age, now)
                    + stacks())
            elif age >= stall_s:
                late = max(late, age)
            elif late is not None:
                say("--- heartbeat late %.3f s ending at %.3f\n"
                    % (late, now))
                late = None

    def at_exit():
        # the interpreter is ending: a crash after this line is one of
        # the process's exit.  The threads still
        # alive are named with their frames: a thread that aborts past this
        # point has no Python state left for the crash's dump to show
        done.set()
        say("--- exit at %.3f\n" % time.time())
        frames = sys._current_frames()
        for th in threading.enumerate():
            if th.ident is None or th is t or th is threading.main_thread():
                continue
            f, at = frames.get(th.ident), []
            while f is not None and len(at) < 3:
                at.append("%s:%d %s" % (os.path.basename(
                    f.f_code.co_filename), f.f_lineno, f.f_code.co_name))
                f = f.f_back
            say("--- thread 0x%016x %s%s at %s\n" % (
                th.ident, th.name, " (daemon)" if th.daemon else "",
                " <- ".join(at) or "?"))

    def stop():
        atexit.unregister(at_exit)
        done.set()
        t.join(timeout=5)
        if out["hooked"] is not None:
            reg, real, register = out["hooked"]
            if reg.register is register:
                reg.register = real
        if was_enabled:
            faulthandler.enable(file=sys.__stderr__, all_threads=True)
        else:
            faulthandler.disable()
        with out["lock"]:
            out["fd"] = None
            os.close(fd)

    atexit.register(at_exit)
    t = threading.Thread(target=dog, name="stall-watchdog", daemon=True)
    t.start()
    return stop


if os.environ.get("TPUMS_STALL_DIR"):
    watch_stalls(os.environ["TPUMS_STALL_DIR"])
'''


class StallWatch:
    """Phase 22's watch on its processes, from ``start`` to ``stop``: the
    ``STALL_WATCHDOG`` in every process started meanwhile (a
    ``sitecustomize`` on ``PYTHONPATH``, ``TPUMS_STALL_DIR``) and in this
    one.  ``report`` reads what the watchdogs wrote: each member's largest
    gap between heartbeats and its processes (one more than its
    respawns), and every stall and late heartbeat with the top frames of
    its dump."""

    def __init__(self, work):
        self.dir = os.path.join(work, "stalls")
        self.site = os.path.join(work, "stall-site")
        self.roles = {os.getpid(): "smoke"}
        self.notes = {}        # member -> why its gap is not a fault
        self._saved, self._unwatch = {}, None
        self.t0 = time.time()

    def start(self):
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self.site, exist_ok=True)
        with open(os.path.join(self.site, "sitecustomize.py"), "w") as f:
            f.write(STALL_WATCHDOG)
        for k in ("PYTHONPATH", "TPUMS_STALL_DIR"):
            self._saved[k] = os.environ.get(k)
        # the module's own start runs only where TPUMS_STALL_DIR is set: it
        # is set after, or this process would run two watchdogs, one never
        # stopped
        os.environ.pop("TPUMS_STALL_DIR", None)
        ns = {}
        exec(compile(STALL_WATCHDOG, "stall_watchdog", "exec"), ns)
        self._unwatch = ns["watch_stalls"](self.dir, STALL_S)
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [self.site] + [p for p in [self._saved["PYTHONPATH"]] if p])
        os.environ["TPUMS_STALL_DIR"] = self.dir
        return self

    def stop(self):
        if self._unwatch is not None:
            self._unwatch()
            self._unwatch = None
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def read(self):
        """-> ({member: [(pid, largest gap s, its end's wall time)]},
        [(wall time of its end, seconds, pid, kind, top frames)]): every
        process that heartbeat a registry entry, and every stall, late
        heartbeat and crash the watchdogs wrote."""
        import glob
        import re

        def tops(dump):
            out = {}
            for frames in dump:
                if not frames or "in dog" in frames[0]:
                    continue
                # an import's frames: the first frame outside the import
                # machinery says whose import it is
                own = [f for f in frames if "<frozen " not in f]
                top = short_frame(frames[0]) + (
                    f" <- {short_frame(own[0])}"
                    if own and own[0] != frames[0] else "")
                out[top] = out.get(top, 0) + 1
            return ", ".join(f"{n}x {t}" if n > 1 else t
                             for t, n in out.items()) or "no dump"

        members, events = {}, []
        for path in sorted(glob.glob(os.path.join(self.dir, "stall-*.txt"))):
            pid = int(re.findall(r"stall-(\d+)", path)[0])
            with open(path, errors="replace") as f:
                lines = f.read().splitlines()
            member, gap, exiting = None, (0.0, None), False
            timeout, overdue, target, crash = [], [], None, None
            alive = []         # threads alive at its exit, with frames
            for line in lines:
                nums = re.findall(r"[0-9]+\.[0-9]+", line)
                if line.startswith("--- thread 0x"):
                    alive.append(line.split(" ", 3)[3])
                elif line.startswith("--- member "):
                    member = line.split(" ", 2)[2]
                    self.roles.setdefault(pid, member)
                elif line.startswith("--- heartbeat gap ") and \
                        len(nums) == 2:
                    gap = (float(nums[0]), float(nums[1]))
                elif line.startswith("--- exit at "):
                    exiting = True
                elif line.startswith("Fatal Python error"):
                    crash = (line, [], exiting)
                    target = crash[1]
                elif line.startswith("--- stacks as the stall ended"):
                    timeout = target = []
                elif line.startswith("--- heartbeat overdue "):
                    overdue = target = []
                elif line.startswith(("Thread 0x", "Current thread 0x")):
                    if target is not None:
                        target.append([])
                elif line.startswith("  File ") and target:
                    target[-1].append(line.strip())
                elif line.startswith("--- stall ") and len(nums) == 2:
                    events.append((float(nums[1]), float(nums[0]), pid,
                                   "stall", tops(timeout)))
                    timeout, target = [], None
                elif line.startswith("--- heartbeat late ") and \
                        len(nums) == 2:
                    events.append((float(nums[1]), float(nums[0]), pid,
                                   "heartbeat late", tops(overdue)))
                    overdue, target = [], None
            if crash is not None:
                where = tops(crash[1])
                if crash[2]:
                    # the thread that aborted is one of those alive then,
                    # in a call that had let the interpreter go
                    where = (f"threads alive at its exit: "
                             f"{' | '.join(alive) or 'none'}; {where}")
                err = os.path.join(self.dir, f"stderr-{pid}.txt")
                if os.path.exists(err):
                    with open(err, errors="replace") as f:
                        said = [x for x in f.read().splitlines()
                                if x.strip()]
                    if said:
                        where += f"; its stderr ended {said[-1][:200]!r}"
                events.append((os.path.getmtime(path), 0.0, pid,
                               ("crash at its exit" if crash[2] else "crash")
                               + f" ({crash[0]})", where))
            if member is not None:
                members.setdefault(member, []).append((pid,) + gap)
        return members, sorted(events)

    def report(self, label, ttl_s) -> dict:
        members, events = self.read()
        gaps = {m: max(g for _, g, _ in ps) for m, ps in members.items()}
        log(f"{label} heartbeats: {len(members)} members, each one's largest "
            "gap between registry heartbeats as a reader sees them (s; its "
            "processes past the first are respawns): " + "; ".join(
                f"{m} {gaps[m]:.3f}"
                + (f" ({self.notes[m]})" if m in self.notes else "")
                + (f", {len(ps) - 1} respawn" if len(ps) > 1 else "")
                for m, ps in sorted(members.items())))
        worst = max(((m, p) for m, ps in members.items() for p in ps),
                    key=lambda mp: mp[1][1], default=None)
        if worst is not None and worst[1][2] is not None:
            log(f"{label} the largest gap: {worst[1][1]:.3f} s of the "
                f"{ttl_s} s TTL ({worst[0]}, ending "
                f"+{worst[1][2] - self.t0:.1f} s into the phase)")
        log(f"{label} stalls of {STALL_S} s or more and late heartbeats: "
            f"{len(events)} in {len({e[2] for e in events})} processes")
        for t, sec, pid, kind, frames in events:
            role = self.roles.get(pid, "a process of the phase")
            log(f"{label} {kind} {sec:.3f} s in {pid} ({role}"
                + (f", {self.notes[role]}" if role in self.notes else "")
                + f"), ending +{t - self.t0:.1f} s: {frames}")
        # a crash fails the phase, one once the interpreter is ending too
        # (it names the threads still alive then): a process of the phase
        # exits cleanly or not at all
        return dict(heartbeat_gaps=gaps, stalls=len(events),
                    crashes=[e for e in events if e[3].startswith("crash")])


def short_frame(line) -> str:
    """'File "/a/b/c.py", line 9, in f' -> 'c.py:9 f'."""
    import re

    m = re.match(r'File "([^"]+)", line (\d+),? in (\S+)', line)
    if not m:
        return line
    return f"{os.path.basename(m.group(1))}:{m.group(2)} {m.group(3)}"


class KeptProcs(dict):
    """A supervisor's ``procs`` that keeps each process a respawn replaces,
    so that the exit code of a member that exited is read from its own
    ``Popen`` (``member_exits``); the supervisor's events and replies are
    the reference's."""

    def __init__(self, procs):
        super().__init__(procs)
        self.replaced = []     # [((shard, replica), Popen)]

    def __setitem__(self, key, proc):
        old = self.get(key)
        if old is not None and old is not proc:
            self.replaced.append((key, old))
        super().__setitem__(key, proc)


def member_exits(g) -> list:
    """Each member process a supervisor of phase 22 replaced -> a line: its
    job, pid and exit code (with the signal's name where a signal ended
    it), and the last 4 lines of the files its watchdog kept for it
    (``stall-<pid>.txt``; ``stderr-<pid>.txt``, as a member's stderr is
    thrown away)."""
    import signal

    out = []
    for ctl in g.ctls:
        for sup in ctl.supervisors.values():
            for (shard, replica), proc in getattr(sup.procs, "replaced", []):
                rc = proc.poll()
                how = "still running" if rc is None else f"rc {rc}"
                if rc is not None and rc < 0:
                    try:
                        how += f" ({signal.Signals(-rc).name})"
                    except ValueError:
                        pass
                said = []
                for name in (f"stall-{proc.pid}.txt", f"stderr-{proc.pid}.txt"):
                    path = os.path.join(g.watch.dir, name) \
                        if g.watch is not None else None
                    if path is None or not os.path.exists(path):
                        said.append(f"no {name}")
                        continue
                    with open(path, errors="replace") as f:
                        tail = [x.strip() for x in f.read().splitlines()
                                if x.strip()][-4:]
                    said.append(f"{name} ended: "
                                + (" / ".join(tail)[-600:] or "(empty)"))
                out.append(f"{sup.job_id(shard, replica)} pid {proc.pid} "
                           f"exited {how}; " + "; ".join(said))
    return out


class GeoRun(FleetRun):
    """Phase 22's two regions over phase 17's published rows: the home
    journal (``us``, the ``FleetRun`` journal), its follower (``eu``) fed
    by a ``JournalReplicator``, one elastic group a region, the proxies,
    and everything to stop at the end."""

    def __init__(self, work, base, dev):
        super().__init__(work, base, dev)
        from flink_ms_tpu_torch.serve import georepl, registry

        self.us_dir, self.eu_dir = self.path("journal"), self.path("eu")
        self.groups = {r: registry.qualify_region(GEO_GROUP, r)
                       for r in (GEO_HOME, GEO_FOLLOWER)}
        georepl.publish_region_topology(
            GEO_GROUP, GEO_HOME,
            {GEO_HOME: {"journal_dir": self.us_dir},
             GEO_FOLLOWER: {"journal_dir": self.eu_dir}}, topic=JOB_TOPIC)
        self.rep = georepl.JournalReplicator(
            self.us_dir, self.eu_dir, JOB_TOPIC, GEO_FOLLOWER, poll_s=0.01)
        self.region_ctl = None
        self.edge_procs = []
        self.region = {}
        self.items = [i for i in self.item_ids if i != "MEAN"]
        self.edge_eps, self.eu_eps = [], []
        self.sigstopped = None
        self.watch = None      # the phase's StallWatch, where it runs one

    def close(self):
        from flink_ms_tpu_torch.serve.edge import stop_edge_procs

        if self.region_ctl is not None:
            self.region_ctl.stop()
        self.rep.stop()
        stop_edge_procs(self.edge_procs)
        super().close()

    def start_regions(self):
        """Both regions' groups at once, and the proxies beside them (their
        imports and replays overlap; two in front of ``us``, one in
        ``eu``): ``us`` 2
        shards x 2 replicas, ``eu`` 2 x 1, every member with the
        co-located update plane -> seconds to ready."""
        import threading

        from flink_ms_tpu_torch.serve.edge import spawn_edge_procs
        from flink_ms_tpu_torch.serve.elastic import ScaleController

        errors = []

        def proxies():
            try:
                procs, ports = spawn_edge_procs(
                    GEO_GROUP, 2, self.path("edge-us"), region=GEO_HOME,
                    timeout_s=FLEET_WAIT_S)
                self.edge_procs.extend(procs)
                self.edge_eps = [("127.0.0.1", p) for p in ports]
                procs, ports = spawn_edge_procs(
                    GEO_GROUP, 1, self.path("edge-eu"), region=GEO_FOLLOWER,
                    timeout_s=FLEET_WAIT_S)
                self.edge_procs.extend(procs)
                self.eu_eps = [("127.0.0.1", p) for p in ports]
            except Exception as e:
                errors.append(f"proxies: {e!r}")

        def up(region, replicas):
            d = self.us_dir if region == GEO_HOME else self.eu_dir
            ctl = ScaleController(
                self.groups[region], d, JOB_TOPIC,
                port_dir=self.path(f"ports-{region}"),
                ready_timeout_s=FLEET_WAIT_S, device=self.dev_name,
                extra_args=["--updatePlane", "true",
                            "--pollInterval", GEO_POLL_S])
            self.ctls.append(ctl)
            self.region[region] = ctl
            try:
                ctl.scale_to(2, replicas=replicas)
            except Exception as e:
                errors.append(f"{region}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=up, args=a)
                   for a in ((GEO_HOME, 2), (GEO_FOLLOWER, 1))]
        threads.append(threading.Thread(target=proxies))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(not errors, f"a region did not start: {errors}")
        for ctl in self.ctls:
            for sup in ctl.supervisors.values():
                with sup._lock:
                    sup.procs = KeptProcs(sup.procs)
        return time.perf_counter() - t0

    def client(self, region, **kw):
        from flink_ms_tpu_torch.serve.elastic import ElasticClient

        kw.setdefault("timeout_s", 30)
        return ElasticClient(self.groups[region], retry=self.retry, **kw)

    def member(self, region, shard=0, replica=0):
        sup = self.region[region].active_supervisor
        return sup.procs[(shard, replica)], sup.ports[(shard, replica)]


def journal_files(d) -> dict:
    """A journal dir's segments and folds -> {name: sha256}."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(d)):
        if name == f"{JOB_TOPIC}.log" or name.startswith(
                (f"{JOB_TOPIC}.log.", f"{JOB_TOPIC}.clog.")):
            h = hashlib.sha256()
            with open(os.path.join(d, name), "rb") as f:
                for block in iter(lambda: f.read(1 << 24), b""):
                    h.update(block)
            out[name] = h.hexdigest()
    return out


def geo_byte_equal(g, label) -> str:
    """The follower journal equals home's: the same segment and fold files
    at the same global offsets, byte for byte (read again if home grew
    while the files were read)."""
    from flink_ms_tpu_torch.serve.journal import Journal

    t0 = time.perf_counter()
    while True:
        g.rep.run_until_caught_up(timeout_s=FLEET_WAIT_S)
        us, eu = Journal(g.us_dir, JOB_TOPIC), Journal(g.eu_dir, JOB_TOPIC)
        end = us.end_offset()
        offsets = ((us.start_offset(), end),
                   (eu.start_offset(), eu.end_offset()))
        a, b = journal_files(g.us_dir), journal_files(g.eu_dir)
        if (offsets[0] == offsets[1] and a == b) or \
                Journal(g.us_dir, JOB_TOPIC).end_offset() == end:
            break
        check(time.perf_counter() - t0 < FLEET_WAIT_S,
              f"{label}: the home journal never stood still")
    check(offsets[0] == offsets[1],
          f"{label}: follower offsets {offsets[1]} against home's "
          f"{offsets[0]}")
    check(a == b, f"{label}: follower files differ from home's: "
          f"{sorted(set(a.items()) ^ set(b.items()))[:4]}")
    return (f"{len(a)} segment/fold files, offsets {offsets[0][0]}.."
            f"{offsets[0][1]} ({offsets[0][1] - offsets[0][0]} bytes), "
            "byte for byte")


def geo_regions(g, card) -> dict:
    """(a) both regions up over a follower journal fed from home's: the
    files, and single TOPK replies of eu against us's."""
    g.rep.run_until_caught_up(timeout_s=FLEET_WAIT_S)
    t0 = time.perf_counter()
    ready_s = g.start_regions()
    g.rep.start()
    same = geo_byte_equal(g, "(a) at start")
    users = g.base["users"][:GEO_TOPK_USERS]
    replies = {}
    for region in (GEO_HOME, GEO_FOLLOWER):
        with g.client(region) as c:
            replies[region] = [c.topk(JOB_STATE, u, TOPK_K) for u in users]
    check(replies[GEO_FOLLOWER] == replies[GEO_HOME],
          "(a) eu's TOPK replies differ from us's")
    agree = fleet_topk_checks(replies[GEO_FOLLOWER], g, "(a) eu TOPK")
    log(f"geo (a) replication ({card}): both regions and the 3 proxies "
        f"ready {ready_s:.2f}s after their start (us 2 shards x 2 "
        f"replicas, eu 2 x 1, {g.dev_name}); the follower journal {same}; "
        f"{len(users)} single TOPK from eu equal us's; {agree}")
    return dict(geo_ready_s=ready_s, geo_regions_s=time.perf_counter() - t0)


def cpu_ticks(pid, tid=None) -> int:
    """A process's (or one of its threads') user and system CPU, in clock
    ticks; 0 once it is gone."""
    path = (f"/proc/{pid}/stat" if tid is None
            else f"/proc/{pid}/task/{tid}/stat")
    try:
        with open(path, "rb") as f:
            stat = f.read()
    except OSError:
        return 0
    fields = stat[stat.rindex(b")") + 2:].split()
    return int(fields[11]) + int(fields[12])


def all_cpu_ticks() -> dict:
    """{pid: CPU clock ticks} of every process this one can read."""
    return {int(n): cpu_ticks(n) for n in os.listdir("/proc") if n.isdigit()}


def descendants(pid) -> set:
    """``pid`` and every process below it."""
    parent = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat", "rb") as f:
                    stat = f.read()
                parent[int(name)] = int(stat[stat.rindex(b")") + 2:]
                                        .split()[1])
            except (OSError, ValueError, IndexError):
                continue
    return below(parent, {pid})


def mount_of(path) -> str:
    """'<fstype> at <mount point>' of the filesystem that holds ``path``."""
    path, best = os.path.realpath(path), ("?", "")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, point, fstype = line.split()[:3]
                if (path == point or path.startswith(point.rstrip("/") + "/")
                        ) and len(point) >= len(best[1]):
                    best = (fstype, point)
    except OSError:
        pass
    return f"{best[0]} at {best[1] or '?'}"


def ms_spread(xs) -> str:
    """Seconds -> 'p50/p99/max' in ms."""
    if not len(xs):
        return "none"
    a = np.asarray(xs) * 1e3
    return (f"{np.percentile(a, 50):.3f}/{np.percentile(a, 99):.3f}/"
            f"{a.max():.3f}")


class LagProbe:
    """(a)'s lag window taken apart, from ``start`` to ``stop``, on the
    replicator as it runs: its methods are timed in place and nothing they
    do changes.  Each step's read of home, its append's write and
    ``fsync``, its status record and the rest (Python, and waits for the
    GIL and a core), and whether it found home's end (a caught-up instant,
    when the lag drops to 0); the forwarder's ``fsync``s; the update
    planes' appends to home's topic, by the member that leases each
    partition; the CPU each process of the phase took; and this process's
    stalls."""

    FORWARDER = "geo-forwarder"    # the producer thread's name

    def __init__(self, g):
        self.g, self.rep = g, g.rep
        self.steps, self.fsyncs, self._cur = [], [], None

    def _applies(self):
        """{partition: apply records in home's apply topic}: each is one
        append of rows to home's topic by the plane that leases it."""
        from flink_ms_tpu_torch.serve import update_plane as UP
        from flink_ms_tpu_torch.serve.journal import Journal

        return {p: len(UP._read_all_lines(Journal(
            self.g.us_dir, UP.apply_topic(JOB_TOPIC, p))))
            for p in range(UP.default_partitions())}

    def _roles(self):
        """{role: pids} of the phase's processes."""
        roles = {}
        for region in (GEO_HOME, GEO_FOLLOWER):
            sup = self.g.region[region].active_supervisor
            roles[f"{region} members"] = {p.pid for p in sup.procs.values()}
        roles["proxies"] = {p.pid for p in self.g.edge_procs}
        watch = self.g.watch
        reh = [p for p, r in (watch.roles if watch else {}).items()
               if r == "(d) rehearsal"]
        if reh:
            roles["(d)"] = descendants(reh[0])
        return roles

    def _ticks(self):
        me = os.getpid()
        th = getattr(self.rep._thread, "native_id", None)
        every = all_cpu_ticks()
        out = {role: sum(every.get(p, 0) for p in pids)
               for role, pids in self._roles().items()}
        out["this process"] = every.get(me, 0)
        out["its replicator thread"] = cpu_ticks(me, th) if th else 0
        return out, every

    def start(self):
        rep, probe = self.rep, self
        real_read = rep.home.read_bytes_from
        real_append, real_publish = rep._append, rep._publish_lag
        real_step, real_fsync = rep.step, os.fsync

        def mine():
            cur = probe._cur
            return cur if cur is not None and \
                cur["tid"] == threading.get_ident() else None

        def timed(key, real):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    cur = mine()
                    if cur is not None:
                        cur[key] += time.perf_counter() - t
            return call

        def fsync(fd):
            t = time.perf_counter()
            try:
                return real_fsync(fd)
            finally:
                dt, cur = time.perf_counter() - t, mine()
                if cur is not None:
                    cur["fsync"] += dt
                elif threading.current_thread().name == probe.FORWARDER:
                    probe.fsyncs.append(dt)

        def publish(now):
            before = rep._status_written
            timed("status", real_publish)(now)
            cur = mine()
            if cur is not None and rep._status_written != before:
                cur["wrote"] += 1

        def step():
            cur = dict(t0=time.perf_counter(), tid=threading.get_ident(),
                       read=0.0, append=0.0, fsync=0.0, status=0.0, wrote=0,
                       n=0)
            probe._cur = cur
            try:
                cur["n"] = real_step()
                return cur["n"]
            finally:
                probe._cur = None
                cur["caught"] = cur["n"] == 0 and rep._caught_up
                cur["t1"] = time.perf_counter()
                probe.steps.append(cur)

        self.applies0 = self._applies()
        self.ticks0 = self._ticks()
        self.threads = sorted(t.name for t in threading.enumerate())
        self.t0, self.wall0 = time.perf_counter(), time.time()
        self._fsync = real_fsync
        rep.home.read_bytes_from = timed("read", real_read)
        rep._append = timed("append", real_append)
        rep._publish_lag = publish
        os.fsync = fsync
        rep.step = step
        return self

    def stop(self):
        """The instruments off, and the counts and CPU at the window's
        end."""
        rep = self.rep
        for name in ("step", "_append", "_publish_lag"):
            rep.__dict__.pop(name, None)
        rep.home.__dict__.pop("read_bytes_from", None)
        os.fsync = self._fsync
        self.t1, self.wall1 = time.perf_counter(), time.time()
        self.ticks1 = self._ticks()
        self.applies1 = self._applies()
        return self

    @staticmethod
    def runs(steps):
        """Each run from a caught-up instant to the next -> (ms, its
        steps, the step of the first instant): the steps after that one,
        up to the one of the next."""
        out, last, between = [], None, []
        for s in steps:
            if last is not None:
                between.append(s)
            if s.get("caught"):
                if last is not None:
                    out.append(((s["t1"] - last["t1"]) * 1e3, between, last))
                last, between = s, []
        return out

    def line(self, ticks, label="geo (a)") -> str:
        """The window's breakdown as one log line; ``ticks``, the
        sampler's instants."""
        import re

        from flink_ms_tpu_torch.serve import update_plane as UP

        win, st = self.t1 - self.t0, self.steps
        caught = [s for s in st if s.get("caught")]
        data = [s for s in st if s["n"]]

        def part(s, key):
            if key == "write":
                return s["append"] - s["fsync"]
            if key == "rest":
                return (s["t1"] - s["t0"] - s["read"] - s["append"]
                        - s["status"])
            return s[key]

        keys = ("read", "write", "fsync", "status", "rest")
        longest = max(self.runs(st), key=lambda r: r[0], default=None)
        if longest is not None:
            ms, steps, first = longest
            # the poll after the first instant, and the loop between steps
            gaps = sum((b["t0"] - a["t1"])
                       for a, b in zip([first] + steps, steps))
            run = (f"the longest run without one: {len(steps)} steps, "
                   f"{ms:.3f} ms (" + ", ".join(
                       f"{k} {sum(part(s, k) for s in steps) * 1e3:.3f}"
                       for k in keys)
                   + f", between steps {gaps * 1e3:.3f} ms, "
                   f"{sum(1 for s in steps if s['n'])} of them read data)")
        else:
            run = "no run between two caught-up instants"
        spread = "; ".join(f"{k} {ms_spread([part(s, k) for s in data])}"
                           for k in keys)
        wrote = sum(s["wrote"] for s in st)
        # appends to home's topic, by the member that leases each partition
        owners = {}
        for p in self.applies1:
            try:
                with open(os.path.join(UP.lease_dir(self.g.us_dir, JOB_TOPIC),
                                       f"p{p}.lock")) as f:
                    pid = int(f.read().split()[0].split("=")[1])
            except (OSError, ValueError, IndexError):
                pid = None
            owners.setdefault(pid, []).append(p)
        sup = self.g.region[GEO_HOME].active_supervisor
        who = {p.pid: sup.job_id(*k) for k, p in sup.procs.items()}
        applied = {p: self.applies1[p] - self.applies0.get(p, 0)
                   for p in self.applies1}
        planes = "; ".join(
            f"{who.get(pid, pid)} {sum(applied[p] for p in ps) / win:.1f}/s"
            f" ({len(ps)} partitions)"
            for pid, ps in sorted(owners.items(), key=lambda x: str(x[0])))
        appends = sum(applied.values()) / win
        rep_f = [s["fsync"] for s in data]
        late = np.diff(np.asarray(ticks)) - 0.005 if len(ticks) > 1 else []
        stalls = []
        if self.g.watch is not None:
            _, events = self.g.watch.read()
            stalls = [f"{kind} {sec:.3f} s: {frames}"
                      for t, sec, pid, kind, frames in events
                      if pid == os.getpid() and self.wall0 <= t <= self.wall1]
        (t0, e0), (t1, e1) = self.ticks0, self.ticks1
        hz = os.sysconf("SC_CLK_TCK")
        used = {k: (t1[k] - t0.get(k, 0)) / hz for k in t1}
        every = sum(e1[p] - e0[p] for p in e1 if p in e0) / hz
        roles = sum(v for k, v in used.items()
                    if k != "its replicator thread")
        step_ms = np.median([s["t1"] - s["t0"] for s in data]) if data \
            else 0.0

        names = {}
        for n in self.threads:
            n = re.sub(r"[0-9]+", "N", n)
            names[n] = names.get(n, 0) + 1

        return (
            f"{label} the lag's window taken apart: {len(st)} replicator "
            f"steps in {win:.3f} s ({len(data)} read data), {len(caught)} "
            f"caught-up instants; {run}; per step that read data, p50/p99/"
            f"max ms: {spread} (status record written {wrote} times); "
            f"appends to home's topic {appends:.1f}/s by the update planes "
            f"({planes}), {appends * step_ms:.2f} of them in a step's "
            f"median length; "
            f"fsyncs: the forwarder's {len(self.fsyncs)} "
            f"({len(self.fsyncs) / win:.1f}/s, one per ratings journal a "
            f"batch touches) {ms_spread(self.fsyncs)} ms, the replicator's "
            f"{len(rep_f)} {ms_spread(rep_f)} ms; the 5 ms sampler late by "
            f"{ms_spread(late)} ms; this process's stalls of {STALL_S} s in "
            f"the window: {stalls or 'none'}, its threads: " + ", ".join(
                f"{n} x{c}" if c > 1 else n for n, c in sorted(names.items()))
            + "; CPU s in the window: " + ", ".join(
                f"{k} {v:.2f}" for k, v in used.items())
            + f", every other process {max(every - roles, 0.0):.2f} "
            f"({os.cpu_count()} cores); journals on {mount_of(self.g.us_dir)}")


def geo_replication(g, card) -> dict:
    """(a) replication lag under forwarded SGD, and ``st=`` across a
    partition."""
    import threading

    from flink_ms_tpu_torch.serve import georepl
    from flink_ms_tpu_torch.serve.client import QueryClient

    t0 = time.perf_counter()
    # forwarded SGD: the home members' update planes apply it into the
    # home journal, which the replicator ships; its lag sampled each 5 ms
    fwd = georepl.GeoWriteForwarder(GEO_GROUP, JOB_TOPIC)
    check(fwd.home() == GEO_HOME, f"(a) the forwarder's home {fwd.home()}")
    u_ids = [int(u) for u in g.base["users"]]
    i_ids = [int(i) for i in g.items]
    rng = np.random.default_rng(29)
    stop, lag_ms, ticks, sent = threading.Event(), [], [], [0]

    def produce():
        while not stop.is_set():
            batch = [(u_ids[int(a)], i_ids[int(b)], float(r))
                     for a, b, r in zip(
                         rng.integers(0, len(u_ids), GEO_SGD_BATCH),
                         rng.integers(0, len(i_ids), GEO_SGD_BATCH),
                         rng.uniform(1.0, 5.0, GEO_SGD_BATCH))]
            fwd.submit_many(batch, flush=True)
            sent[0] += len(batch)
            time.sleep(GEO_SGD_EVERY_S)

    before = journal_files(g.us_dir)
    mirrored0 = g.rep.bytes_replicated
    probe = LagProbe(g).start()
    try:
        producer = threading.Thread(target=produce, daemon=True,
                                    name=LagProbe.FORWARDER)
        producer.start()
        t_end = time.perf_counter() + GEO_SGD_S
        while time.perf_counter() < t_end:
            lag_ms.append(g.rep.lag_seconds() * 1e3)
            ticks.append(time.perf_counter())
            time.sleep(0.005)
        mirrored1 = g.rep.bytes_replicated
    finally:
        probe.stop()
    stop.set()
    producer.join(timeout=30)
    wait_until(lambda: len(applied_geo(g)) > 0,
               "an applied SGD batch in the home journal")
    time.sleep(0.5)  # the update planes drain the last batches
    grew = journal_files(g.us_dir) != before
    same = geo_byte_equal(g, "(a) after the SGD load")
    lag = np.asarray(lag_ms)
    p50, p99 = float(np.percentile(lag, 50)), float(np.percentile(lag, 99))
    mirrored = g.rep.bytes_replicated
    load_bps = (mirrored1 - mirrored0) / GEO_SGD_S
    log(probe.line(ticks))
    log(f"geo (a) lag under forwarded SGD: {sent[0]} ratings in "
        f"{GEO_SGD_S:.1f}s ({sent[0] / GEO_SGD_S:.0f}/s of "
        f"{GEO_SGD_BATCH / GEO_SGD_EVERY_S:.0f}/s offered) through "
        f"GeoWriteForwarder into us's update planes; the home journal "
        f"grew: {grew}; {load_bps:.0f} bytes/s mirrored during the load; "
        f"replication lag p50 {p50:.3f} ms, p99 {p99:.3f} ms over "
        f"{len(lag)} samples (bound {GEO_LAG_P99_MS:.0f} ms); then the "
        f"follower journal {same}; {mirrored} bytes mirrored since the "
        f"replicator's start")
    check(grew, "(a) the forwarded SGD never reached the home journal")
    check(p99 < GEO_LAG_P99_MS, f"(a) replication lag p99 {p99:.3f} ms")

    # st= across a partition, read from an eu member directly
    _, port = g.member(GEO_FOLLOWER)
    seen = []
    with QueryClient("127.0.0.1", port, timeout_s=30, stale=True) as c:
        key = g.base["keys"][0]

        def read():
            c.query_state(JOB_STATE, key)
            return c.last_staleness_s

        wait_until(lambda: read() == 0.0, "st=0.000 while caught up")
        seen.append(read())
        g.rep.partitioned = True
        t_part = time.perf_counter()
        for _ in range(3):
            time.sleep(0.3)
            seen.append(read())
        g.rep.partitioned = False
        wait_until(lambda: read() == 0.0, "st=0.000 after the heal")
        heal_s = time.perf_counter() - t_part
        seen.append(read())
    grows = all(b > a for a, b in zip(seen[1:4], seen[2:4])) and seen[1] > 0
    log(f"geo (a) st= on an eu member across a partition: "
        + ", ".join(f"{s:.3f}" for s in seen) + f" (caught up, 3 reads "
        f"0.3 s apart partitioned, healed: back to 0.000 "
        f"{heal_s:.2f}s after the partition began)")
    check(seen[0] == 0.0 and seen[-1] == 0.0 and grows,
          f"(a) st= across a partition: {seen}")
    return dict(geo_lag_p50_ms=p50, geo_lag_p99_ms=p99,
                geo_mirrored_bytes=mirrored,
                geo_lag_s=time.perf_counter() - t0)


def applied_geo(g, region=GEO_HOME) -> list:
    """Every row a region's update planes applied (their apply records)."""
    from flink_ms_tpu_torch.serve import update_plane as UP
    from flink_ms_tpu_torch.serve.journal import Journal

    d = g.us_dir if region == GEO_HOME else g.eu_dir
    out = []
    for p in range(UP.default_partitions()):
        for line in UP._read_all_lines(Journal(
                d, UP.apply_topic(JOB_TOPIC, p))):
            fields = line.split("\t", 3)
            if len(fields) > 3 and fields[3]:
                out.extend(fields[3].split("|"))
    return out


def edge_counter(eps, name, **labels) -> float:
    """A counter summed over the proxies' METRICS (those that answer)."""
    from flink_ms_tpu_torch.serve.edge import EdgeClient

    total = 0.0
    for ep in eps:
        try:
            with EdgeClient(endpoints=[ep], timeout_s=10) as c:
                snap = c.metrics()
        except (ConnectionError, OSError):
            continue
        total += metric_sum(snap, "counters", name, **labels)
    return total


def proxy_surface(c, keys, users, vecs) -> dict:
    """GET, MGET, TOPK, TOPKV and COUNT through one client (TOPKV by each
    user's own vector, which a direct client answers as that user's
    TOPK)."""
    return {"get": [c.query_state(JOB_STATE, k) for k in keys],
            "mget": c.query_states(JOB_STATE, keys),
            "topk": [list(map(tuple, c.topk(JOB_STATE, u, TOPK_K)))
                     for u in users],
            "topkv": [list(map(tuple, c.topk_by_vector(JOB_STATE, v,
                                                        TOPK_K)))
                      for v in vecs],
            "count": c.count(JOB_STATE)}


class EdgeLoad:
    """Closed-loop GETs of sampled keys through the proxies from a few
    threads (tab and B2 in turn), every error kept."""

    def __init__(self, eps, keys, threads=4):
        import threading

        self.eps, self.keys = eps, keys
        self.ok, self.errors = [0] * threads, []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(threads)]

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def _run(self, idx):
        from flink_ms_tpu_torch.serve.client import RetryPolicy
        from flink_ms_tpu_torch.serve.edge import EdgeClient

        rng = np.random.default_rng(40 + idx)
        with EdgeClient(endpoints=self.eps, prefer=idx,
                        proto="b2" if idx % 2 else "tab", timeout_s=10,
                        retry=RetryPolicy(attempts=8, backoff_s=0.02,
                                          max_backoff_s=0.5)) as c:
            while not self._stop.is_set():
                key = self.keys[int(rng.integers(len(self.keys)))]
                try:
                    if c.query_state(JOB_STATE, key) is None:
                        self.errors.append((key, "missing"))
                    else:
                        self.ok[idx] += 1
                except Exception as e:
                    self.errors.append((key, repr(e)))

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        return sum(self.ok)


class PushSubscribers:
    """KEY subscriptions on hot item rows and one TOPK subscription, each
    on its own B2 ``su=1`` connection through the proxies; a dead proxy
    reconnects (to the next one) and RESUMEs at the last seq.  Every
    baseline and delta goes into one audit list (``audit_push_sequences``,
    as ``scripts/chaos_kill.py``'s push mode)."""

    def __init__(self, eps, hot, vec, n):
        import threading

        self.eps, self.hot, self.vec = eps, hot, vec
        self.events, self.lock = [], threading.Lock()
        self.state = [{"up": False, "pushes": 0, "resumes": 0,
                       "reconnects": 0} for _ in range(n + 1)]
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(n + 1)]

    def start(self):
        for t in self._threads:
            t.start()
        wait_until(lambda: all(s["up"] for s in self.state),
                   "the push subscriptions")
        return self

    def _audit(self, kind, sub_id, seq):
        with self.lock:
            self.events.append((kind, sub_id, seq))

    def _run(self, idx):
        from flink_ms_tpu_torch.serve.edge import EdgeClient

        st = self.state[idx]
        topk = idx == 0
        arg = self.vec if topk else self.hot[idx % len(self.hot)]
        kind = "TOPK" if topk else "KEY"
        sub, c, backoff = None, None, 0
        while not self._stop.is_set():
            try:
                if c is None:
                    c = EdgeClient(endpoints=self.eps, prefer=idx + backoff,
                                   proto="b2", push=True, timeout_s=10)
                    if sub is None:
                        sub = (c.subscribe_topk(JOB_STATE, arg, TOPK_K)
                               if topk else c.subscribe_key(JOB_STATE, arg))
                        self._audit("S", sub["sub_id"], sub["seq"])
                    else:
                        st["resumes"] += 1
                        r = c.resume_subscription(
                            JOB_STATE, kind, arg, TOPK_K if topk else 0,
                            sub["sub_id"], sub["seq"])
                        self._audit("S", r["sub_id"], r["seq"])
                        if r["mode"] == "replay":
                            sub["seq"] = r["seq"]
                        else:
                            sub = r
                    st["up"], backoff = True, 0
                msg = c.next_push(timeout_s=0.25)
                if msg is None:
                    continue
                sub_id, seq, _ = msg
                self._audit("P", sub_id, seq)
                sub["seq"] = seq
                st["pushes"] += 1
            except Exception:
                st["up"] = False
                try:
                    if c is not None:
                        c.close()
                except Exception:
                    pass
                c = None
                st["reconnects"] += 1
                backoff = min(backoff + 1, 8)
                time.sleep(0.05 * backoff)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)


def geo_edge_surface(g, card) -> dict:
    """(b) two proxies in front of ``us``: GET, MGET, TOPK, TOPKV and COUNT
    through them against a direct client, before any update (a
    co-located update plane puts foreign item rows into its member's
    index, which a direct client's merge and the proxy's treat apart)."""
    import threading

    from flink_ms_tpu_torch.serve.edge import EdgeClient

    t0 = time.perf_counter()
    eps = g.edge_eps
    keys = g.base["keys"][:GEO_KEYS]
    users = g.base["users"][:GEO_KEYS]
    vecs = [g.rows[f"{u}-U"] for u in users]
    got, raw = {}, {}

    def direct():
        with g.client(GEO_HOME) as c:
            got["direct"] = {
                "get": [c.query_state(JOB_STATE, k) for k in keys],
                "mget": c.query_states(JOB_STATE, keys),
                "topk": [list(map(tuple, c.topk(JOB_STATE, u, TOPK_K)))
                         for u in users],
                "count": c.total_count(JOB_STATE)}

    def through(wire):
        with EdgeClient(endpoints=eps, proto=wire, timeout_s=30,
                        retry=g.retry) as c:
            got[wire] = proxy_surface(c, keys, users, vecs)
            raw[wire] = c.pipeline(
                [f"GET\t{JOB_STATE}\t{k}" for k in keys]
                + [f"TOPK\t{JOB_STATE}\t{u}\t{TOPK_K}" for u in users[:32]]
                + [f"COUNT\t{JOB_STATE}"], window=1)

    # the three clients at once: a single query's scores do not depend on
    # what the member batches it with (exact frames score in 8-row blocks)
    threads = [threading.Thread(target=direct)] + [
        threading.Thread(target=through, args=(w,)) for w in ("tab", "b2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(len(got) == 3, f"(b) a client of the surface failed: {sorted(got)}")
    want = got["direct"]
    want["topkv"] = want["topk"]
    for wire in ("tab", "b2"):
        for verb in want:
            check(got[wire][verb] == want[verb],
                  f"(b) {verb} through the proxy on {wire} differs from "
                  "the direct client's")
    check(raw["tab"] == raw["b2"], "(b) tab and B2 replies differ")
    log(f"geo (b) edge ({card}): through us's 2 proxies, on tab and on "
        f"B2, {len(keys)} GET, an MGET "
        f"of {len(keys)} keys, {len(users)} TOPK, {len(vecs)} TOPKV and "
        f"COUNT ({want['count']}) equal the direct client's; the raw "
        "replies of the two wires are equal")
    return dict(geo_surface_s=time.perf_counter() - t0)


def geo_edge(g, card) -> dict:
    """(b) coalescing, hedging past a stopped replica, a proxy's SIGKILL
    under load and push subscriptions through the proxies, the ``st=``
    bound of a proxy in ``eu``, latency through the proxy against
    direct."""
    import signal
    import threading

    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.obs import metrics as obs_metrics
    from flink_ms_tpu_torch.serve import georepl
    from flink_ms_tpu_torch.serve.edge import EdgeClient
    from flink_ms_tpu_torch.serve.journal import Journal
    from flink_ms_tpu_torch.serve.push import audit_push_sequences

    t0 = time.perf_counter()
    eps = g.edge_eps
    keys = g.base["keys"][:GEO_KEYS]
    users = g.base["users"][:GEO_KEYS]
    procs = list(g.edge_procs)

    # coalescing: bursts of one hot key in one pipelined window
    hot = keys[0]
    c0 = edge_counter(eps, "tpums_edge_coalesce_hits_total")
    with EdgeClient(endpoints=eps, proto="b2", timeout_s=30) as c:
        for _ in range(8):
            replies = c.pipeline([f"GET\t{JOB_STATE}\t{hot}"] * 64,
                                 window=64)
            check(len(set(replies)) == 1, "(b) coalesced GETs differ")
    coalesce = edge_counter(eps, "tpums_edge_coalesce_hits_total") - c0

    # hedging: a us replica SIGSTOPped under load, inside its TTL
    h0 = {r: edge_counter(eps, "tpums_edge_hedges_total", result=r)
          for r in ("fired", "won")}
    load = EdgeLoad(eps, g.base["keys"]).start()
    time.sleep(GEO_LOAD_S)
    stopped, _ = g.member(GEO_HOME, 0, 0)
    g.sigstopped = g.region[GEO_HOME].active_supervisor.job_id(0, 0)
    stopped.send_signal(signal.SIGSTOP)
    time.sleep(GEO_STOP_S)
    stopped.send_signal(signal.SIGCONT)
    time.sleep(GEO_LOAD_S)
    n_hedge_load = load.stop()
    hedges = {r: edge_counter(eps, "tpums_edge_hedges_total", result=r)
              - h0[r] for r in h0}
    log(f"geo (b) coalescing: 8 bursts of 64 GETs of one key, "
        f"{coalesce:.0f} coalesce hits; a replica SIGSTOPped "
        f"{GEO_STOP_S}s under closed-loop GETs from 4 clients: "
        f"{n_hedge_load} GETs, hedges fired {hedges['fired']:.0f}, won "
        f"{hedges['won']:.0f}, {len(load.errors)} client errors")
    check(coalesce > 0, "(b) no coalesce hit")
    check(hedges["fired"] > 0 and hedges["won"] > 0,
          f"(b) hedges {hedges}")
    check(not load.errors, f"(b) errors past a stopped replica: "
          f"{load.errors[:3]}")

    # a proxy's SIGKILL under load, with push subscriptions through the
    # proxies and a storm of rewrites of their rows into the home journal
    item_ids = g.items[:max(GEO_PUSH_SUBS, 2)]
    hot_rows = [f"{i}-I" for i in item_ids]
    subs = PushSubscribers(eps, hot_rows, g.rows[f"{users[0]}-U"],
                           GEO_PUSH_SUBS).start()
    stop_storm = threading.Event()
    storm_rows = [0]

    def storm():
        rng = np.random.default_rng(30)
        j = Journal(g.us_dir, JOB_TOPIC)
        while not stop_storm.is_set():
            j.append([F.format_als_row(i, "I", rng.normal(0.0, 0.3, RANK))
                      for i in item_ids])
            storm_rows[0] += len(item_ids)
            time.sleep(0.05)

    r0 = metric_sum(obs_metrics.get_registry().snapshot(), "counters",
                    "tpums_client_proxy_reconnects_total")
    load = EdgeLoad(eps, g.base["keys"]).start()
    storm_t = threading.Thread(target=storm, daemon=True)
    storm_t.start()
    time.sleep(GEO_LOAD_S)
    procs[0].kill()
    procs[0].wait(timeout=30)
    time.sleep(GEO_LOAD_S)
    stop_storm.set()
    storm_t.join(timeout=30)
    n_kill_load = load.stop()
    time.sleep(1.0)  # the last deltas reach the subscribers
    subs.stop()
    reconnects = metric_sum(
        obs_metrics.get_registry().snapshot(), "counters",
        "tpums_client_proxy_reconnects_total") - r0
    audit = audit_push_sequences(subs.events)
    pushes = sum(s["pushes"] for s in subs.state)
    log(f"geo (b) proxy SIGKILL under closed-loop GETs from 4 clients: "
        f"{n_kill_load} GETs, {reconnects:.0f} proxy_reconnect, "
        f"{len(load.errors)} client errors; push through the proxies "
        f"across the kill: {len(subs.state)} subscriptions "
        f"({GEO_PUSH_SUBS} KEY, 1 TOPK), {storm_rows[0]} rows rewritten, "
        f"{pushes} deltas, {sum(s['resumes'] for s in subs.state)} "
        f"resumes, missed {audit['missed']}, duplicates "
        f"{audit['duplicates']}")
    check(reconnects > 0, "(b) no proxy_reconnect after a proxy's kill")
    check(not load.errors, f"(b) errors through a proxy's kill: "
          f"{load.errors[:3]}")
    check(pushes > 0 and audit["missed"] == 0 and audit["duplicates"] == 0,
          f"(b) push audit {audit['missed']} missed, "
          f"{audit['duplicates']} duplicates, {pushes} deltas")
    eps = eps[1:]

    # a proxy in eu with a staleness bound: local while caught up, home
    # once a partition drives the follower past the bound
    eu_ep = g.eu_eps
    key = g.base["keys"][1]
    kid, _, kind = key.rpartition("-")
    fresh = ";".join(f"{float(x) + 1.0!r}"
                     for x in g.rows[key].split(";"))
    with EdgeClient(endpoints=eu_ep, stale_bound_s=GEO_STALE_BOUND_S,
                    timeout_s=30) as bounded, \
            EdgeClient(endpoints=eu_ep, timeout_s=30) as plain:
        georepl._STALENESS_CACHE.clear()
        wait_until(lambda: georepl.staleness_of(g.eu_dir, JOB_TOPIC) == 0.0,
                   "the follower caught up")
        old = bounded.query_state(JOB_STATE, key)
        f0 = edge_counter(eu_ep, "tpums_edge_geo_failovers_total")
        n0 = edge_counter(eu_ep, "tpums_edge_requests_total")
        for k in keys[:64]:
            bounded.query_state(JOB_STATE, k)
        local_only = edge_counter(
            eu_ep, "tpums_edge_geo_failovers_total") == f0
        g.rep.partitioned = True
        Journal(g.us_dir, JOB_TOPIC).append([f"{kid},{kind},{fresh}"])
        with g.client(GEO_HOME) as direct:
            wait_until(lambda: direct.query_state(JOB_STATE, key) == fresh,
                       "the home region's fresh row")
        wait_until(lambda: (georepl.staleness_of(g.eu_dir, JOB_TOPIC)
                            or 0.0) > GEO_STALE_BOUND_S + 0.2,
                   "the follower past the bound")
        via_bound = bounded.query_state(JOB_STATE, key)
        via_plain = plain.query_state(JOB_STATE, key)
        stale_s = bounded.last_staleness_s
        f1 = edge_counter(eu_ep, "tpums_edge_geo_failovers_total")
        g.rep.partitioned = False
        g.rep.run_until_caught_up(timeout_s=FLEET_WAIT_S)
        wait_until(lambda: plain.query_state(JOB_STATE, key) == fresh,
                   "the follower's fresh row after the heal")
        n1 = edge_counter(eu_ep, "tpums_edge_requests_total")
    log(f"geo (b) eu proxy, st={GEO_STALE_BOUND_S:g} bound: 65 reads while "
        f"caught up all local: {local_only}; partitioned, a row rewritten "
        f"at home: the bounded read answers home's row: "
        f"{via_bound == fresh} (st={stale_s}), an unbounded one eu's old "
        f"row: {via_plain == old}; tpums_edge_geo_failovers_total "
        f"{f1 - f0:.0f} of {n1 - n0:.0f} tpums_edge_requests_total")
    check(local_only and f1 - f0 > 0 and n1 - n0 > f1 - f0,
          "(b) the eu proxy's routes")
    check(via_bound == fresh and via_plain == old,
          "(b) the bounded read did not go home, or the unbounded one did")

    # latency through the proxy beside the direct client's
    lat = {}
    with g.client(GEO_HOME) as direct, \
            EdgeClient(endpoints=eps, proto="b2", timeout_s=30) as c:
        for name, cl in (("direct", direct), ("proxy", c)):
            lat[name] = {
                "GET": latency_ms(lambda j: cl.query_state(
                    JOB_STATE, keys[j % len(keys)]), GEO_LATENCY_CALLS),
                "TOPK": latency_ms(lambda j: cl.topk(
                    JOB_STATE, users[j % len(users)], TOPK_K),
                    GEO_LATENCY_CALLS)}
    log(f"geo (b) latency, {GEO_LATENCY_CALLS} sequential each (p50/p99 "
        "ms): " + "; ".join(
        f"{verb} direct {lat['direct'][verb][0]:.3f}/"
        f"{lat['direct'][verb][1]:.3f}, proxy {lat['proxy'][verb][0]:.3f}/"
        f"{lat['proxy'][verb][1]:.3f}" for verb in ("GET", "TOPK")))
    return dict(edge_coalesce=coalesce, edge_hedges=hedges,
                edge_reconnects=reconnects, edge_latency=lat,
                geo_b_s=time.perf_counter() - t0)


def geo_failover(g, card) -> dict:
    """(c) the whole home region SIGKILLed, its supervisors first, under
    eu's region-local reads: the follower's ``RegionController`` promotes
    eu, reads hold, the forwarder's next write lands in eu and applies."""
    import signal

    from flink_ms_tpu_torch.serve import georepl

    t0 = time.perf_counter()
    g.region_ctl = georepl.RegionController(GEO_GROUP, JOB_TOPIC,
                                            GEO_FOLLOWER, replicator=g.rep)
    g.region_ctl.start()
    fwd = georepl.GeoWriteForwarder(GEO_GROUP, JOB_TOPIC)
    stream = OpenLoopStream(lambda: g.client(GEO_FOLLOWER, timeout_s=10),
                            g.base["keys"]).start()
    g.streams.append(stream)
    time.sleep(GEO_LOAD_S)
    ctl = g.region[GEO_HOME]
    victims = []
    for sup in list(ctl.supervisors.values()):
        sup._stop.set()
        if sup._thread is not None:
            sup._thread.join(timeout=10)
        victims += [p for p in sup.procs.values() if p.poll() is None]
    victims += [p for p in g.edge_procs[:2] if p.poll() is None]
    t_kill = time.perf_counter()
    for p in victims:
        p.send_signal(signal.SIGKILL)
    for p in victims:
        p.wait(timeout=30)
    wait_until(lambda: g.region_ctl.promoted is not None,
               "the follower's promotion", timeout_s=30)
    promote_s = time.perf_counter() - t_kill
    rec = g.region_ctl.promoted
    time.sleep(GEO_LOAD_S)
    stream.stop()
    g.streams.remove(stream)
    w = stream.window(t0, time.perf_counter())
    # the forwarder follows the new geo generation to eu
    fwd._refresh(force=True)
    user = g.base["users"][0]
    item = g.items[0]
    with g.client(GEO_FOLLOWER) as c:
        before = c.query_state(JOB_STATE, f"{user}-U")
        n_applied = len(applied_geo(g, GEO_FOLLOWER))
        fwd.submit_many([(int(user), int(item), 5.0)], flush=True)
        landed = any(n.startswith(f"{JOB_TOPIC}.upd")
                     for n in os.listdir(g.eu_dir))
        wait_until(lambda: len(applied_geo(g, GEO_FOLLOWER)) > n_applied,
                   "the forwarded rating applied in eu")
        wait_until(lambda: c.query_state(JOB_STATE, f"{user}-U") != before,
                   "the forwarded rating's row served in eu")
    geo = rec.get("geo") or {}
    log(f"geo (c) failover ({card}): {len(victims)} us processes "
        f"SIGKILLed (4 members, their supervisor stopped first, the "
        f"surviving proxy); eu promoted {promote_s:.3f}s later (generation "
        f"{rec.get('gen')}, home {geo.get('home')}, sealed at offset "
        f"{(geo.get('failover') or {}).get('sealed_offset')}); eu's "
        f"region-local reads: {fmt_window('open loop', w)}, "
        f"{len(stream.errors)} errors (availability "
        f"{1.0 - len(stream.errors) / max(w['n'], 1):.4f}); the "
        f"forwarder's home {fwd.home()} ({fwd.repoints} re-point): a "
        f"rating landed in eu's input log: {landed}, applied and served")
    check(promote_s < GEO_PROMOTE_S, f"(c) promotion took {promote_s:.3f}s")
    check(geo.get("home") == GEO_FOLLOWER, f"(c) the new home {geo}")
    check(w["n"] > 0 and not stream.errors,
          f"(c) eu reads {w['n']}, errors {stream.errors[:3]}")
    check(fwd.home() == GEO_FOLLOWER and landed,
          "(c) the forwarder did not re-point to eu")
    return dict(geo_promote_s=promote_s, geo_c_s=time.perf_counter() - t0)


# what a client says when it finds no live member for a shard: a live
# member taken for dead (its heartbeats lapsed past the TTL)
TAKEN_FOR_DEAD = ("no live replicas", "no endpoints")


def geo_supervision(g) -> tuple:
    """(a)-(c)'s supervisors: their respawns, and each member they took
    for dead -> ({supervisor: respawns}, ``member_exits``)."""
    respawns, expired = {}, []
    for ctl in g.ctls:
        for gen, sup in ctl.supervisors.items():
            respawns[f"{ctl.group} gen {gen}"] = sup.respawns
            expired += [f"{ctl.group} s{e['shard']}r{e['replica']}"
                        for e in sup.events
                        if e.get("action") == "heartbeat_expired"]
    log(f"geo (a)-(c) respawns by supervisor: {respawns}; heartbeats "
        f"taken as expired: {expired or 'none'} (no kill in (a)-(c) is "
        "respawned: (b) stops a replica inside its TTL, (c) stops the "
        "supervisors first)")
    exits = member_exits(g)
    if exits:
        log("geo (a)-(c) members that exited and were respawned: "
            + " | ".join(exits))
    return respawns, exits


def geo_phase(torch, base, dev, card) -> dict:
    """Phase 22: geo-replication and the edge proxy at the served model's
    width, two regions of ``--device`` members on this card: (a) the
    follower journal and region, (b) the edge tier, (c) failover, with
    (d) the rehearsal of phase 21 (c) with its edge arm in its process
    beside them: the process started before (a), its rehearsal from the
    end of (a)'s lag read, joined after (c).  Every process of the
    phase runs the stall watchdog (``StallWatch``); the phase prints each
    member's largest gap between heartbeats and every stall, and fails on
    a respawn but (d)'s kill's and on a client that found no live member
    of a shard."""
    import tempfile

    t_phase = time.perf_counter()
    prior = {k: os.environ.get(k)
             for k in list(GEO_ENV) + ["TPUMS_REGISTRY_DIR"]}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        os.environ.update(GEO_ENV)
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        os.makedirs(os.environ["TPUMS_REGISTRY_DIR"])
        watch = StallWatch(work)
        g = reh = None
        try:
            watch.start()
            # (d)'s process starts now and its rehearsal once (a) has
            # read the replication lag: the lag's bound is the region
            # drill's, which the reference runs alone (chaos_kill.py)
            reh = Rehearsal(torch, dev, card, users=GEO_REHEARSAL_USERS,
                            edge=GEO_REHEARSAL_EDGE,
                            duration_s=GEO_REHEARSAL_DURATION_S, hold=True)
            watch.roles[reh.run.proc.pid] = "(d) rehearsal"
            g = GeoRun(work, base, dev)
            g.watch = watch
            try:
                out.update(geo_regions(g, card))
                watch.roles.update({p.pid: "proxy" for p in g.edge_procs})
                out.update(geo_edge_surface(g, card))
                out.update(geo_replication(g, card))
                reh.release()
                out.update(geo_edge(g, card))
                if g.sigstopped is not None:
                    watch.notes[g.sigstopped] = (
                        f"SIGSTOPped {GEO_STOP_S} s in (b)")
                out.update(geo_failover(g, card))
            except Exception as e:
                dead = [m for m in TAKEN_FOR_DEAD if m in str(e)]
                check(not dead, f"a live member taken for dead: {e}")
                raise
            finally:
                respawns, exits = geo_supervision(g)
            check(not any(respawns.values()),
                  f"(a)-(c) respawned members: {respawns}"
                  + "".join(f"; {x}" for x in exits))
            g.close()
            g = None
            t_d = time.perf_counter()
            r, reh = reh, None
            out.update(r.finish())
            log(f"geo (d) joined {time.perf_counter() - t_d:.1f}s after "
                "(c) ended")
        finally:
            if g is not None:
                g.close()
            if reh is not None:
                reh.abandon()
            watch.stop()
            out.update(watch.report("geo", os.environ["TPUMS_REPLICA_TTL_S"]))
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(not out["crashes"], f"a process of the phase crashed: "
          f"{out['crashes']}")
    log(f"geo phase: {time.perf_counter() - t_phase:.1f}s")
    return out


def geo_only(torch, dev) -> int:
    """Phase 22 alone, for a look at geo-replication and the edge tier
    without the other phases: seeded random rows at the served model's
    shape (phase 17's 165,239 rows at rank 50) stand in for phase 17's
    topic."""
    from flink_ms_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    native_build.build()
    base = fleet_baseline(seeded_published(), dev, JOB_TOPK_USERS)
    geo_phase(torch, base, dev, card)
    stop_leftovers("phase 22", helpers=False)
    log(f"done in {time.perf_counter() - t0:.1f}s")
    print(card)
    return 0


# -- phase 23: the training configurations phases 4 and 7 leave out -----------


def rating_rows(torch, model, users, items, ratings, dev):
    """Each rating's (user row, item row) in the dense factor tables of
    `model` (an ``ALSModel``, or the ``BlockedProblem`` it is fitted on)
    and its value (float64), as tensors on `dev`."""
    return (torch.from_numpy(np.searchsorted(model.user_ids, users)).to(dev),
            torch.from_numpy(np.searchsorted(model.item_ids, items)).to(dev),
            torch.from_numpy(np.asarray(ratings, np.float64)).to(dev))


def train_rmse(torch, uf, itf, rows, chunk=1 << 22) -> float:
    """``TA.rmse`` of dense factors over the ratings ``rows`` holds, on
    their device: each prediction in the factors' dtype, its error in
    float64 (``rmse``'s host lookups take seconds at 20M ratings)."""
    u, i, r = rows
    total = 0.0
    for s in range(0, int(r.numel()), chunk):
        p = (uf[u[s:s + chunk]] * itf[i[s:s + chunk]]).sum(-1)
        total += float(((r[s:s + chunk] - p.double()) ** 2).sum())
    return math.sqrt(total / max(int(r.numel()), 1))


def implicit_objective(torch, uf, itf, rows, alpha=ALS_ALPHA, lam=LAMBDA,
                       chunk=1 << 22) -> float:
    """The Hu-Koren-Volinsky objective the implicit fit minimises, in
    float64: Σ over every (user, item) pair of (xᵀy)², plus Σ over the
    ratings of (1 + α r)(1 - xᵀy)² - (xᵀy)², plus λ (‖X‖² + ‖Y‖²).  The
    all-pairs sum is ⟨XᵀX, YᵀY⟩.  A rating counted twice weighs twice, as
    in the normal equations (A = YᵀY + Σ α r y yᵀ + λ I, b = Σ (1 + α r) y),
    whose block-wise exact solves never raise it."""
    u, i, r = rows
    X, Y = uf.double(), itf.double()
    total = float(((X.T @ X) * (Y.T @ Y)).sum())
    for s in range(0, int(r.numel()), chunk):
        p = (X[u[s:s + chunk]] * Y[i[s:s + chunk]]).sum(-1)
        c = 1.0 + alpha * r[s:s + chunk]
        total += float((c * (1.0 - p) ** 2 - p * p).sum())
    return total + lam * float((X * X).sum() + (Y * Y).sum())


class plain_kernels:
    """Within it the ALS fits run both kernels' plain versions (the same
    arithmetic in plain torch), the reference a kernel path is held to on
    the same inputs; no kernel launches."""

    def __init__(self, TA, GA, CH):
        self.TA, self.GA, self.CH = TA, GA, CH

    def __enter__(self):
        self.saved = (self.TA.fused_bucket_assembly,
                      self.TA.cholesky_solve_batched)
        self.TA.fused_bucket_assembly = self.GA.bucket_assembly_plain
        self.TA.cholesky_solve_batched = (
            lambda A, b, layout=None: self.CH.cholesky_solve_plain(A, b))
        return self

    def __exit__(self, *exc):
        (self.TA.fused_bucket_assembly,
         self.TA.cholesky_solve_batched) = self.saved


def seeded_problem(TA, n_users, n_items, nnz):
    """Phase 4's ratings (seed 0), blocked problem and init (rank
    ``RANK``, ``torch.Generator().manual_seed(42)``) at a size -> ((users,
    items, ratings), problem, init)."""
    import torch

    users, items, ratings = synth_ratings(n_users, n_items, nnz, seed=0)
    problem = TA.prepare_blocked(users, items, ratings, 1)
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, RANK, gen).numpy(),
            TA.init_factors(problem.n_items, RANK, gen).numpy())
    return (users, items, ratings), problem, init


def ml20m_problem(TA):
    """Phase 4's problem at the ML-20M shape."""
    return seeded_problem(TA, N_USERS, N_ITEMS, NNZ)


def anchor_problem(TA):
    """The anchor problem: phase 4's generators at the anchor's size."""
    return seeded_problem(TA, ANCHOR_USERS, ANCHOR_ITEMS, ANCHOR_NNZ)


def anchor_values(torch, TA, dev) -> dict:
    """The port's fits of the anchor problem, 3 iterations each, on `dev`
    (tier 1's CPU parity check): {"implicit_objective", "bf16_rmse"}."""
    (users, items, ratings), problem, init = anchor_problem(TA)
    out = {}
    for key, kw in (("implicit_objective", dict(implicit=True,
                                                alpha=ALS_ALPHA)),
                    ("bf16_rmse", dict(exchange_dtype="bfloat16"))):
        cfg = TA.ALSConfig(num_factors=RANK, iterations=3, lambda_=LAMBDA,
                           **kw)
        m = TA.als_fit(users, items, ratings, cfg, dev, problem=problem,
                       init=init)
        out[key] = (implicit_objective(
            torch, m.user_factors, m.item_factors,
            rating_rows(torch, m, users, items, ratings, dev))
            if key == "implicit_objective"
            else TA.rmse(m, users, items, ratings, dev))
    return out


def als_arm(torch, TA, CH, GA, problem, ratings_t, init, label, ref_sec,
            dev, **kw):
    """One ALS configuration at phase 4's shape, data and init: sec/iter
    (1 vs N iterations, median of 3), ``als_fit`` after 1, 2 and 3
    iterations, and both kernels' launches over that alone.  -> (sec/iter,
    the timed run's (uf, itf) in slot order, the three models, launches,
    the compiled fit's device arguments)."""
    users, items, ratings = ratings_t
    cfg = TA.ALSConfig(num_factors=RANK, iterations=1, lambda_=LAMBDA, **kw)
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    reset_als_launches(CH, GA)
    fit_fn, dev_args = TA.compile_fit(problem, cfg, dev, init=init)
    sec, ran, (uf, itf) = time_fit(torch, fit_fn, dev_args)
    models = []
    for it in (1, 2, 3):
        models.append(TA.als_fit(users, items, ratings,
                                 dataclasses.replace(cfg, iterations=it),
                                 dev, problem=problem, init=init))
        ran += it
    sync(torch)
    launches = als_launches(CH, GA)
    check(launches == {"cholesky": 2 * ran, "assembly": n_buckets * ran,
                       "cholesky_batch_major": 0},
          f"{label}: {launches} launches for {ran} iterations of "
          f"{n_buckets} buckets")
    # the exchange's dtype shows in the table each assembly reads
    bf16 = GA.BF16_LAUNCHES
    want = (launches["assembly"] if kw.get("exchange_dtype") == "bfloat16"
            else 0)
    check(bf16 == want, f"{label}: {bf16} of {launches['assembly']} "
          f"assembly launches on a bfloat16 table, not {want}")
    check(bool((uf[-1] == 0).all()) and bool((itf[-1] == 0).all()),
          f"{label}: a dummy slot's factor row is not zero")
    log(f"{label}: {sec:.6f} sec/iter (median of 3, 1 vs N iterations) "
        f"against phase 4's explicit f32 {ref_sec:.6f}; "
        f"launches over {ran} iterations: cholesky {launches['cholesky']} "
        f"(of them batch-major 0), assembly {launches['assembly']} (of "
        f"them on a bfloat16 table {bf16})")
    return sec, (uf, itf), models, launches, dev_args


def als_implicit_arm(torch, TA, CH, GA, problem, ratings_t, rows, init,
                     ref_sec, dev):
    """``als_implicit``: the implicit configuration at the ML-20M shape.
    Its objective must not rise over 1, 2 and 3 iterations, each side's
    half-sweep from the trained factors must agree with float64, and its
    objective after 3 must agree with the plain versions' fit and with
    the JAX package's fit of the same problem from the same init.
    ``rows``: ``rating_rows`` of the ratings.  -> launches."""
    t_arm = time.perf_counter()
    users, items, ratings = ratings_t
    kw = dict(implicit=True, alpha=ALS_ALPHA)
    sec, (uf, itf), models, launches, dev_args = als_arm(
        torch, TA, CH, GA, problem, ratings_t, init, "als_implicit",
        ref_sec, dev, **kw)
    objs = [implicit_objective(torch, torch.from_numpy(init[0]).to(dev),
                               torch.from_numpy(init[1]).to(dev), rows)]
    objs += [implicit_objective(torch, m.user_factors, m.item_factors, rows)
             for m in models]
    log(f"als_implicit: Hu-Koren-Volinsky objective at the init and after "
        f"1, 2, 3 iterations {objs}")
    check(all(np.isfinite(objs)) and all(
        b <= a + 1e-6 * abs(a) for a, b in zip(objs, objs[1:])),
        f"als_implicit: the objective rose (rtol 1e-6): {objs}")
    n_u = 2 * len(problem.u.widths) + 1
    f64_check(torch, TA, GA, dev_args[2:2 + n_u], itf, "user", implicit=True)
    f64_check(torch, TA, GA, dev_args[2 + n_u:], uf, "item", implicit=True)
    cfg = TA.ALSConfig(num_factors=RANK, iterations=3, lambda_=LAMBDA, **kw)
    with plain_kernels(TA, GA, CH):
        plain = TA.als_fit(users, items, ratings, cfg, dev, problem=problem,
                           init=init)
    obj_plain = implicit_objective(torch, plain.user_factors,
                                   plain.item_factors, rows)
    gap = abs(objs[3] - obj_plain) / abs(obj_plain)
    log(f"als_implicit: objective after 3 iterations {objs[3]!r}, the "
        f"plain versions' fit {obj_plain!r}: relative gap {gap:.3e} (limit "
        f"{IMPLICIT_PLAIN_RTOL})")
    check(gap <= IMPLICIT_PLAIN_RTOL,
          "als_implicit: off the plain versions' fit")
    gap = abs(objs[3] - ML20M_IMPLICIT_OBJECTIVE) / ML20M_IMPLICIT_OBJECTIVE
    log(f"als_implicit: objective after 3 iterations against the JAX "
        f"package's fit of this problem {ML20M_IMPLICIT_OBJECTIVE!r}: "
        f"relative gap {gap:.3e} (limit {IMPLICIT_JAX_RTOL})")
    check(gap <= IMPLICIT_JAX_RTOL, "als_implicit: off the JAX package's fit")
    log(f"als_implicit: the arm took {time.perf_counter() - t_arm:.1f}s")
    return launches


def als_bf16_arm(torch, TA, CH, GA, problem, ratings_t, rows, init, ref,
                 dev):
    """``als_bf16``: phase 4's explicit configuration with the opposite
    factors exchanged in bfloat16.  Its train RMSE after 3 iterations
    beside phase 4's f32 one; held to the plain versions' bf16 fit and to
    the JAX package's fit of the same problem.  -> launches."""
    t_arm = time.perf_counter()
    users, items, ratings = ratings_t
    kw = dict(exchange_dtype="bfloat16")
    sec, _, models, launches, _ = als_arm(
        torch, TA, CH, GA, problem, ratings_t, init, "als_bf16",
        ref["sec_per_iter"], dev, **kw)
    f32_rmse = ref["rmse"][2]
    rmses = [train_rmse(torch, m.user_factors, m.item_factors, rows)
             for m in models]
    delta = (rmses[2] - f32_rmse) / f32_rmse
    log(f"als_bf16: train RMSE after 1, 2, 3 iterations {rmses}; after 3 "
        f"against phase 4's f32 {f32_rmse!r}: relative delta {delta:+.3e} "
        f"(the JAX package's docstring claims +{BF16_TPU_CLAIM} on a TPU, "
        f"its figure and not this card's)")
    check(all(np.isfinite(rmses)) and rmses[0] > rmses[1] > rmses[2],
          f"als_bf16: train RMSE not finite and decreasing: {rmses}")
    cfg = TA.ALSConfig(num_factors=RANK, iterations=3, lambda_=LAMBDA, **kw)
    with plain_kernels(TA, GA, CH):
        plain = TA.als_fit(users, items, ratings, cfg, dev, problem=problem,
                           init=init)
    plain = train_rmse(torch, plain.user_factors, plain.item_factors, rows)
    gap = abs(rmses[2] - plain) / plain
    log(f"als_bf16: the plain versions' bf16 fit {plain!r}: relative gap "
        f"{gap:.3e} (limit {BF16_PLAIN_RTOL})")
    check(gap <= BF16_PLAIN_RTOL, "als_bf16: off the plain versions' fit")
    gap = abs(rmses[2] - ML20M_BF16_RMSE) / ML20M_BF16_RMSE
    log(f"als_bf16: train RMSE after 3 iterations {rmses[2]!r} against the "
        f"JAX package's fit of this problem {ML20M_BF16_RMSE!r}: relative "
        f"gap {gap:.3e} (limit {BF16_JAX_RTOL})")
    check(gap <= BF16_JAX_RTOL, "als_bf16: off the JAX package's fit")
    log(f"als_bf16: the arm took {time.perf_counter() - t_arm:.1f}s")
    return launches


def svm_avg_arm(torch, TS, SK, run, dev):
    """``svm_avg``: phase 7's RCV1 problem and device inputs in the avg
    mode (CoCoA-v1), the CLI's default: ms/round, the objective after 1
    and 10 rounds (it must fall, below w = 0's 1.0), the launches; then
    one round from w = 0 times K against one round of add with σ′ = 1
    from the same state and steps: equal bit for bit under the presorted
    Δw, whose sums repeat, and within rtol 2e-4 / atol 1e-6 with the
    default Δw, whose float atomics do not.  -> launches."""
    t_arm = time.perf_counter()
    data, problem, dev_args = run["data"], run["problem"], run["dev_args"]
    cfg = dataclasses.replace(svm_config(TS, problem), mode="avg")
    fit = TS._make_fit(problem, cfg, dev)[0]
    for key in SK.LAUNCHES:
        SK.LAUNCHES[key] = 0
    sec, ran = time_rounds(torch, fit, dev_args, SVM_ROUNDS)
    objs = []
    for rounds in (1, SVM_ROUNDS):
        model = TS.svm_fit(data, dataclasses.replace(cfg, iterations=rounds),
                           dev, problem=problem)
        objs.append(model.hinge_loss(data, SVM_LAMBDA))
        ran += rounds
    sync(torch)
    launches = dict(SK.LAUNCHES)
    log(f"svm_avg: {sec * 1e3:.3f} ms/round (median of 3, 1 vs "
        f"{SVM_ROUNDS} rounds) against add's {run['sec_per_round'] * 1e3:.3f}"
        f"; hinge+reg objective after 1 and {SVM_ROUNDS} rounds {objs} "
        f"(the JAX package's after {SVM_ROUNDS}, its own step indices: "
        f"{SVM_AVG_REF_OBJECTIVE}); launches over {ran} rounds: {launches}")
    check(all(np.isfinite(objs)) and objs[1] < objs[0] and objs[1] < 1.0,
          f"svm_avg: objective not finite, falling and below 1.0: {objs}")
    check(launches == {"margin_gather": ran, "scatter_add_dw": 0,
                       "scatter_add_dw[row_scale]": ran},
          f"svm_avg: {launches} launches for {ran} rounds")
    add1 = dataclasses.replace(cfg, mode="add", sigma_prime=1.0)
    K = float(problem.n_blocks)
    w_avg = fit(1, *dev_args)[0]
    w_add = TS._make_fit(problem, add1, dev)[0](1, *dev_args)[0]
    off = factors_off(w_avg * K, w_add, SVM_RTOL, SVM_ATOL)
    log(f"svm_avg: one round x K against add with sigma' 1, default dw: "
        f"{off:.4f} of rtol {SVM_RTOL} / atol {SVM_ATOL}, max |diff| "
        f"{(w_avg * K - w_add).abs().max().item():.3e}")
    check(off <= 1.0, "svm_avg: one round x K off add's with sigma' 1")
    args = list(dev_args) + list(TS.sorted_layout(
        dev_args[1], dev_args[2], problem.n_features))
    w_avg, w_add = with_env({"FLINK_MS_SVM_DW": "presorted"}, lambda: [
        TS._make_fit(problem, c, dev)[0](1, *args)[0] for c in (cfg, add1)])
    same = torch.equal(w_avg * K, w_add)
    log(f"svm_avg: one round x K equal to add's with sigma' 1 under the "
        f"presorted dw, bit for bit: {same} ({int((w_add != 0).sum())} "
        f"weights nonzero)")
    check(same and bool((w_add != 0).any()),
          "svm_avg: one round x K is not add's with sigma' 1 bit for bit")
    log(f"svm_avg: the arm took {time.perf_counter() - t_arm:.1f}s")
    return launches


def arms_phase(torch, TA, CH, GA, TS, SK, problem, ratings_t, init, runs,
               svm_run, dev) -> dict:
    """Phase 23: the training configurations the other phases do not run,
    on phase 4's problem, data and init and phase 7's SVM problem and
    device inputs.  -> {label: launches}."""
    ref = runs["default"]
    rows = rating_rows(torch, problem, *ratings_t, dev)
    return {
        "als_implicit": als_implicit_arm(torch, TA, CH, GA, problem,
                                         ratings_t, rows, init,
                                         ref["sec_per_iter"], dev),
        "als_bf16": als_bf16_arm(torch, TA, CH, GA, problem, ratings_t,
                                 rows, init, ref, dev),
        "svm_avg": svm_avg_arm(torch, TS, SK, svm_run, dev),
    }


# -- phase 24: the SVM's train -> publish -> serve -> predict loop -----------

# bench_sections.py:297-430 (run_svm_serving_section): the model served
# flat and range-partitioned (range 1,000, as ``svm_train --partition true
# --range 1000`` writes it), one job each; 1,000 queries of 70 features
# (default_rng(11)) timed four ways
SVMSERVE_RANGE = 1000
SVMSERVE_ROWS = 1000          # phase 7's training rows predicted (rng 11)
# of them predicted by the GET-per-key ways and the range MGET (about 1 MB
# a reply); the flat MGET predicts them all
SVMSERVE_SUBSET_ROWS = 100
SVMSERVE_QUERIES = 1000       # the section's latency queries (rng 11)
SVMSERVE_NNZ = 70             # features a latency query draws
SVMSERVE_LOOP_QUERIES = 200   # of them timed by the GET-per-key loops
SVMSERVE_CLI_QUERIES = 200    # each latency CLI's queries
SVMSERVE_CLI_FEATURES = 70    # their --maxNoOfFeatures
SVMSERVE_WAIT_S = 120.0       # the longest a job may take to hold its rows
# a served decision value against the host's float64 X·w of the same w:
# only the order of the float64 sums differs, so within this share of
# Σ |w_j x_j| (70 terms round to a few 1e-16 of it)
SVMSERVE_F64_RTOL = 1e-12
# the card's f32 margins (margin_gather) against the served float64
# values: about 10 times the reading on the card (NVIDIA H100 80GB HBM3,
# 700.00 W), 0.0277 of rtol 1e-5 / atol 1e-6
SVMSERVE_CARD_RTOL, SVMSERVE_CARD_ATOL = 3e-6, 3e-7
SVMSERVE_CSV_COLUMNS = ("qId", "nFeatures", "prediction", "ms")


def svm_serve_sample(svm_run) -> dict:
    """Phase 24's inputs, taken before phase 7's data is freed: the
    trained w (on the card) and ``SVMSERVE_ROWS`` of phase 7's training
    rows (``default_rng(11)``), their 0-based indices and values padded
    to one width with index 0 and value 0, their lengths and labels."""
    data = svm_run["data"]
    rows = np.sort(np.random.default_rng(11).choice(
        data.n_examples, SVMSERVE_ROWS, replace=False))
    lo, hi = data.indptr[rows], data.indptr[rows + 1]
    nnz = (hi - lo).astype(np.int64)
    idx = np.zeros((len(rows), int(nnz.max())), np.int64)
    val = np.zeros(idx.shape)
    for j, (a, b) in enumerate(zip(lo, hi)):
        idx[j, :b - a] = data.indices[a:b]
        val[j, :b - a] = data.values[a:b]
    return {"w": svm_run["w"], "rows": rows, "idx": idx, "val": val,
            "nnz": nnz, "labels": np.asarray(data.labels)[rows]}


def mapped_libraries(pid, names=("libcuda",)) -> list:
    """The files among process `pid`'s mappings whose names hold one of
    `names`."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if any(n in line.rsplit("/", 1)[-1] for n in names)})


class SvmJobProcess:
    """``python -m flink_ms_tpu_torch.serve.svm_consumer`` over one topic
    of ``<work>/bus`` as a subprocess, resolved through the job registry
    under its topic's name; ``stop`` ends it on every path."""

    def __init__(self, work, topic):
        self.job_id = topic
        self.log_path = os.path.join(work, f"job-{topic}.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "flink_ms_tpu_torch.serve.svm_consumer",
             "--journalDir", os.path.join(work, "bus"), "--topic", topic,
             "--host", "127.0.0.1", "--port", "0", "--jobId", topic],
            stdout=self._log, stderr=subprocess.STDOUT, env=child_env())
        self.port = None

    def tail(self, n=2000) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def wait_rows(self, n: int) -> float:
        """Seconds from the process start until the job is ready and its
        table holds `n` keys."""
        from flink_ms_tpu_torch.serve import registry
        from flink_ms_tpu_torch.serve.client import QueryClient
        from flink_ms_tpu_torch.serve.consumer import SVM_STATE

        deadline = time.perf_counter() + SVMSERVE_WAIT_S
        while time.perf_counter() < deadline:
            check(self.proc.poll() is None,
                  f"svm_serve: the job {self.job_id!r} exited "
                  f"{self.proc.returncode}: {self.tail()}")
            entry = registry.resolve(self.job_id)
            if entry is not None and entry.get("ready"):
                self.port = entry["port"]
                with QueryClient("127.0.0.1", self.port, timeout_s=60) as c:
                    if (c.health(SVM_STATE)["ready"]
                            and c.count(SVM_STATE) == n):
                        return time.perf_counter() - self.t0
            time.sleep(0.02)
        raise SmokeFailure(f"svm_serve: the job {self.job_id!r} did not "
                           f"hold {n} rows in {SVMSERVE_WAIT_S} s: "
                           f"{self.tail()}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


def svm_serve_files(work, w64) -> dict:
    """(a) The model files ``svm_train`` writes for ``--output`` (flat) and
    for ``--partition true --range SVMSERVE_RANGE``, parsed back.
    -> {"flat": path, "range": path, "buckets": count}."""
    from flink_ms_tpu_torch.core import formats as F

    paths = {kind: os.path.join(work, "model", kind)
             for kind in ("flat", "range")}
    os.makedirs(os.path.dirname(paths["flat"]))
    F.write_lines(paths["flat"], F.format_svm_flat_rows(w64))
    F.write_lines(paths["range"], F.format_svm_range_rows(w64,
                                                          SVMSERVE_RANGE))
    with open(paths["flat"]) as f:
        flat = [F.parse_svm_flat_row(line) for line in f if line.strip()]
    with open(paths["range"]) as f:
        ranged = [F.parse_svm_range_row(line) for line in f if line.strip()]
    d = len(w64)
    flat_ok = ([i for i, _ in flat] == list(range(1, d + 1))
               and np.array_equal(np.array([x for _, x in flat]), w64))
    pairs = [(b, i, x) for b, ps in ranged for i, x in ps]
    range_ok = ([i for _, i, _ in pairs] == list(range(1, d + 1))
                and all(b == i // SVMSERVE_RANGE for b, i, _ in pairs)
                and np.array_equal(np.array([x for _, _, x in pairs]), w64))
    log(f"svm_serve (a) model files: {len(flat)} flat rows "
        f"({os.path.getsize(paths['flat'])} bytes), {len(ranged)} range "
        f"rows at range {SVMSERVE_RANGE} "
        f"({os.path.getsize(paths['range'])} bytes); parsed back to w bit "
        f"for bit: flat {flat_ok}, range {range_ok}")
    check(flat_ok and range_ok,
          "svm_serve: a model file does not parse back to w bit for bit")
    return dict(paths, buckets=len(ranged))


def svm_serve_publish(work, paths, d, buckets, jobs) -> dict:
    """(b) Both files published by the producer's CLI, each topic served
    by a consumer CLI of its own, put into `jobs` ({"flat": job, "range":
    job}); checks that no job maps the CUDA driver.  -> seconds to
    ready."""
    pubs = [subprocess.Popen(
        [sys.executable, "-m", "flink_ms_tpu_torch.serve.svm_producer",
         "--input", paths[kind], "--journalDir", os.path.join(work, "bus"),
         "--topic", f"svm-{kind}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=child_env())
        for kind in ("flat", "range")]
    said = [p.communicate(timeout=SVMSERVE_WAIT_S)[0] for p in pubs]
    for p, text in zip(pubs, said):
        check(p.returncode == 0, f"svm_serve: the producer exited "
              f"{p.returncode}: {text[-2000:]}")
    for kind in ("flat", "range"):
        jobs[kind] = SvmJobProcess(work, f"svm-{kind}")
    ready = {"flat": jobs["flat"].wait_rows(d),
             "range": jobs["range"].wait_rows(buckets)}
    cuda = {kind: mapped_libraries(job.proc.pid)
            for kind, job in jobs.items()}
    torch_libs = {kind: len(mapped_libraries(job.proc.pid, ("libtorch",)))
                  for kind, job in jobs.items()}
    log("svm_serve (b) published: " + "; ".join(
        text.strip().splitlines()[-1] for text in said)
        + f"; ready with {d} features in {ready['flat']:.2f}s (flat) and "
        f"{buckets} buckets in {ready['range']:.2f}s (range) from spawn; "
        f"libcuda mapped by the jobs: {cuda}; libtorch files mapped: "
        f"{torch_libs}")
    check(not any(cuda.values()),
          f"svm_serve: an SVM job maps the CUDA driver: {cuda}")
    return ready


class _RecordingClient:
    """A ``QueryClient`` whose GET payloads are kept in order."""

    def __init__(self, client):
        self.client, self.payloads = client, []

    def query_state(self, name, key):
        p = self.client.query_state(name, key)
        self.payloads.append(p)
        return p


def svm_serve_predictions(jobs, sample, w64, dev, SK) -> dict:
    """(c) The sample's decision values served four ways (flat GET per
    feature through ``client.svm_predict.run``, range GET per bucket and
    range MGET per row for the first ``SVMSERVE_SUBSET_ROWS`` rows, flat
    MGET per row for all), each against the host's float64 X·w; the
    card's ``margin_gather`` margins against the flat MGET values; the
    sign predictions against the card's signs and the labels."""
    import io

    import torch

    from flink_ms_tpu_torch.client import svm_predict
    from flink_ms_tpu_torch.core.formats import RangePayloadCache
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.consumer import SVM_STATE

    idx, val, nnz = sample["idx"], sample["val"], sample["nnz"]
    entries = [list(zip((idx[j, :n] + 1).tolist(), val[j, :n].tolist()))
               for j, n in enumerate(nnz)]
    ref = np.array([sum(w64[i - 1] * v for i, v in e) for e in entries])
    scale = np.einsum("nl,nl->n", np.abs(w64[idx]), np.abs(val))
    served, few = {}, entries[:SVMSERVE_SUBSET_ROWS]
    with QueryClient("127.0.0.1", jobs["flat"].port, timeout_s=60) as c:
        rec, out = _RecordingClient(c), io.StringIO()
        svm_predict.run(rec, [" ".join(f"{i}:{v!r}" for i, v in e)
                              for e in few],
                        output_decision_function=True, out=out)
        printed = [line.split("=", 1)[1].strip() for line in
                   out.getvalue().splitlines()
                   if line.startswith("SVM Prediction")]
        check(len(rec.payloads) == sum(map(len, few)) and None not in
              rec.payloads, "svm_serve: a feature is missing from the flat "
              "plane")
        pos, get = 0, []
        for e in few:
            acc = 0.0
            for (_, v), p in zip(e, rec.payloads[pos:pos + len(e)]):
                acc += float(p) * v
            pos += len(e)
            get.append(acc)
        served["flat GET"] = np.array(get)
        check(printed == [f"{x:f}" for x in get],
              "svm_serve: svm_predict printed other values than it summed")
        served["flat MGET"] = np.array([
            sum(float(p) * v for p, (_, v) in zip(
                c.query_states(SVM_STATE, [str(i) for i, _ in e]), e))
            for e in entries])
    with QueryClient("127.0.0.1", jobs["range"].port, timeout_s=60) as c:
        for label, mget in (("range GET", False), ("range MGET", True)):
            cache, got = RangePayloadCache(), []
            for e in few:
                by = {}
                for i, v in e:
                    by.setdefault(i // SVMSERVE_RANGE, []).append((i, v))
                bs = sorted(by)
                payloads = (c.query_states(SVM_STATE, [str(b) for b in bs])
                            if mget else [c.query_state(SVM_STATE, str(b))
                                          for b in bs])
                acc = 0.0
                for b, p in zip(bs, payloads):
                    check(p is not None,
                          f"svm_serve: bucket {b} is missing")
                    ws, hit = cache.gather(p, [i for i, _ in by[b]])
                    check(bool(hit.all()),
                          f"svm_serve: a feature of bucket {b} is missing")
                    acc += float(np.dot(ws, [v for _, v in by[b]]))
                got.append(acc)
            served[label] = np.array(got)
    gaps = {k: float(np.max(np.abs(v - ref[:len(v)]) / scale[:len(v)]))
            for k, v in served.items()}
    for k, g in gaps.items():
        check(g <= SVMSERVE_F64_RTOL, f"svm_serve: the {k} values are off "
              f"the host's float64 X·w: {g:.3e} of Σ|w x|")
    for key in SK.LAUNCHES:
        SK.LAUNCHES[key] = 0
    margins = SK.margin_gather(
        sample["w"], torch.from_numpy(idx).to(dev, torch.int32),
        torch.from_numpy(val).to(dev, torch.float32))
    sync(torch)
    launches = SK.LAUNCHES["margin_gather"]
    margins = margins.double().cpu().numpy()
    value = served["flat MGET"]
    off = float(np.max(np.abs(margins - value) / (
        SVMSERVE_CARD_ATOL + SVMSERVE_CARD_RTOL * np.abs(value))))
    clear = np.abs(margins) > (SVMSERVE_CARD_ATOL
                               + SVMSERVE_CARD_RTOL * np.abs(margins))
    signs = np.array([svm_predict.decide(x, False, 0.0) for x in value])
    agree = int((signs[clear] == np.where(margins[clear] > 0, 1.0,
                                          -1.0)).sum())
    acc = float(np.mean(signs == sample["labels"]))
    log(f"svm_serve (c) {len(entries)} of phase 7's rows (rng 11, "
        f"{int(nnz.sum())} features): served decision values against the "
        f"host's float64 X·w, largest gap in Σ|w x|: "
        + ", ".join(f"{k} {g:.3e} ({len(served[k])} rows)"
                    for k, g in gaps.items())
        + f" (limit {SVMSERVE_F64_RTOL}); the card's margin_gather "
        f"({launches} launch, {idx.shape[1]} wide) against them: "
        f"{off:.4f} of rtol {SVMSERVE_CARD_RTOL} / atol "
        f"{SVMSERVE_CARD_ATOL}, max |diff| "
        f"{np.max(np.abs(margins - value)):.3e}; signs equal the card's on "
        f"{agree} of {int(clear.sum())} rows clear of the limit; training "
        f"accuracy of the served predictions {acc:.4f}")
    check(launches == 1, f"svm_serve: {launches} margin_gather launches")
    check(off <= 1.0, "svm_serve: the card's margins are off the served "
          "decision values")
    check(agree == int(clear.sum()),
          "svm_serve: a served sign differs from the card's")
    return {"launches": launches, "accuracy": acc}


def svm_serve_latency(jobs, w64) -> dict:
    """(d) The section's queries timed four ways, as
    ``bench_sections.py:360-430`` times them (GET loops over the first
    ``SVMSERVE_LOOP_QUERIES``), each query's sum checked against the
    host's."""
    from flink_ms_tpu_torch.core.formats import RangePayloadCache
    from flink_ms_tpu_torch.obs.metrics import bucketed_quantiles
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.consumer import SVM_STATE

    rng = np.random.default_rng(11)
    d = len(w64)
    queries = [np.unique(rng.integers(1, d + 1, SVMSERVE_NNZ))
               for _ in range(SVMSERVE_QUERIES)]
    want = [float(w64[q - 1].sum()) for q in queries]
    scale = [float(np.abs(w64[q - 1]).sum()) for q in queries]

    def timed(port, fn, qs):
        ms, sums = [], []
        with QueryClient("127.0.0.1", port, timeout_s=60) as c:
            for q in qs:
                t0 = time.perf_counter()
                sums.append(fn(c, q))
                ms.append((time.perf_counter() - t0) * 1e3)
        return ms, sums

    def flat_get(c, q):
        return sum(float(c.query_state(SVM_STATE, str(f))) for f in q)

    def flat_mget(c, q):
        return sum(float(p) for p in c.query_states(
            SVM_STATE, [str(int(f)) for f in q]))

    def ranged(mget):
        cache = RangePayloadCache()

        def fn(c, q):
            by = {}
            for f in q:
                by.setdefault(int(f) // SVMSERVE_RANGE, []).append(int(f))
            bs = sorted(by)
            payloads = (c.query_states(SVM_STATE, [str(b) for b in bs])
                        if mget else [c.query_state(SVM_STATE, str(b))
                                      for b in bs])
            return sum(float(cache.gather(p, by[b])[0].sum())
                       for b, p in zip(bs, payloads))
        return fn

    loop = queries[:SVMSERVE_LOOP_QUERIES]
    out, keys = {}, {}
    for key, port, fn, qs in (
            ("svmserve_flat", jobs["flat"].port, flat_get, loop),
            ("svmserve_flat_mget", jobs["flat"].port, flat_mget, queries),
            ("svmserve_range", jobs["range"].port, ranged(False), loop),
            ("svmserve_range_mget", jobs["range"].port, ranged(True),
             queries)):
        ms, sums = timed(port, fn, qs)
        off = max(abs(s - x) / m for s, x, m in zip(sums, want, scale))
        check(off <= SVMSERVE_F64_RTOL,
              f"svm_serve: {key}'s sums are off the host's: {off:.3e}")
        p50, p99 = bucketed_quantiles([m / 1e3 for m in ms], (50, 99))
        out[f"{key}_p50_ms"], out[f"{key}_p99_ms"] = p50 * 1e3, p99 * 1e3
        keys[key] = len(qs)
    log(f"svm_serve (d) {SVMSERVE_QUERIES} queries of {SVMSERVE_NNZ} "
        f"features (rng 11; the GET loops the first "
        f"{SVMSERVE_LOOP_QUERIES}), each sum equal to the host's: "
        + ", ".join(f"{k} {out[k]:.4f}" for k in out)
        + f" (queries {keys})")
    return out


def svm_serve_start_clis(work, clis) -> None:
    """(d) ``client.svm_predict_random`` on the flat job and
    ``client.range_partition_svm_predict`` on the range job, both started
    into `clis` ({module: (process, CSV path)}); they run beside (c),
    whose values their load cannot change, and no latency of theirs is
    read."""
    for mod, job in (("svm_predict_random", "svm-flat"),
                     ("range_partition_svm_predict", "svm-range")):
        path = os.path.join(work, f"{mod}.csv")
        clis[mod] = (subprocess.Popen(
            [sys.executable, "-m", f"flink_ms_tpu_torch.client.{mod}",
             "--jobId", job, "--numQueries", str(SVMSERVE_CLI_QUERIES),
             "--maxNoOfFeatures", str(SVMSERVE_CLI_FEATURES),
             "--range", str(SVMSERVE_RANGE), "--outputDecisionFunction",
             "true", "--outputFile", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=child_env()), path)


def svm_serve_cli_rows(clis) -> dict:
    """Waits for the CLIs of ``svm_serve_start_clis``: each exits 0 and
    its CSV holds the reference's four columns, one row a query.  ->
    {module: rows}."""
    rows = {}
    for mod, (p, path) in clis.items():
        text = p.communicate(timeout=SVMSERVE_WAIT_S)[0]
        check(p.returncode == 0 and "exist" not in text, f"svm_serve: "
              f"{mod} exited {p.returncode}: {text[-2000:]}")
        with open(path) as f:
            r = [line.rstrip("\n").split(",") for line in f]
        check(len(r) == SVMSERVE_CLI_QUERIES
              and all(len(x) == len(SVMSERVE_CSV_COLUMNS) for x in r)
              and [int(x[0]) for x in r] == list(range(len(r)))
              and all(x[1].isdigit() and x[3].isdigit() for x in r)
              and all(np.isfinite(float(x[2])) for x in r),
              f"svm_serve: {mod}'s CSV is not one "
              f"{','.join(SVMSERVE_CSV_COLUMNS)} row a query: {r[:3]}")
        rows[mod] = len(r)
    log("svm_serve (d) CLIs, run beside (c): " + ", ".join(
        f"{m} {n} rows" for m, n in rows.items())
        + f" of {','.join(SVMSERVE_CSV_COLUMNS)}")
    return rows


def svm_serve_phase(torch, sample, SK, dev) -> dict:
    """Phase 24: phase 7's trained model written as ``svm_train`` writes
    it (flat and range-partitioned), published by the producer's CLI,
    served by two consumer CLIs (no CUDA in either), its decision values
    queried four ways and held to the host's float64 X·w and to the
    card's ``margin_gather``, timed by the reference's method, and both
    latency CLIs run against it."""
    import tempfile

    t_phase = time.perf_counter()
    w64 = sample["w"].double().cpu().numpy()
    prior = os.environ.get("TPUMS_REGISTRY_DIR")
    jobs, clis = {}, {}
    with tempfile.TemporaryDirectory() as work:
        os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(work, "registry")
        try:
            paths = svm_serve_files(work, w64)
            ready = svm_serve_publish(work, paths, len(w64),
                                      paths["buckets"], jobs)
            svm_serve_start_clis(work, clis)
            out = svm_serve_predictions(jobs, sample, w64, dev, SK)
            out["cli_rows"] = svm_serve_cli_rows(clis)
            out.update(svm_serve_latency(jobs, w64))
            out["ready_s"] = ready
        finally:
            for p, _ in clis.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for job in jobs.values():
                job.stop()
            if prior is None:
                os.environ.pop("TPUMS_REGISTRY_DIR", None)
            else:
                os.environ["TPUMS_REGISTRY_DIR"] = prior
    alive = [p.pid for p in [j.proc for j in jobs.values()]
             + [p for p, _ in clis.values()] if p.poll() is None]
    log(f"svm_serve (e) both jobs stopped (exit codes "
        f"{[j.proc.returncode for j in jobs.values()]}); processes of the "
        f"phase alive: {alive}; phase {time.perf_counter() - t_phase:.1f}s")
    check(not alive, f"svm_serve: processes left alive: {alive}")
    return out


# -- --scale-only: the scale envelope, BASELINE.json's 10M x 1M ratings -------

# scripts/scale_envelope.py:40-85: its half scale first, then the full
# 10M x 1M with 100M ratings (numpy default_rng(0), uniform 1 to 5), rank
# 64, lambda 0.1, through the fused assembly-and-solve path
SCALE_ENV_SIZES = ((5_000_000, 500_000, 50_000_000),
                   (10_000_000, 1_000_000, 100_000_000))
SCALE_ENV_RANK = 64


def chunk_times(torch, CH, GA, y, idx, val, counts, k, lam):
    """The three ALS kernel entries on one fused-path chunk (``idx``,
    ``val``: its rows of one bucket), each beside its plain version, a
    library yardstick and its bound.  -> kernels-line entries without
    launches."""
    rows = int(idx.shape[0])
    nnz = int(counts.double().sum().item())

    def asm_library():
        g = torch.index_select(y, 0, idx.reshape(-1)).reshape(rows, -1, k)
        return (torch.einsum("rwk,rwl->rkl", g, g),
                torch.einsum("rwk,rw->rk", g, val))

    (A, b), (Ap, bp) = (GA.fused_bucket_assembly(y, idx, val),
                        GA.bucket_assembly_plain(y, idx, val))
    asm = {"name": "fused_bucket_assembly", "route": "cuda",
           "source": "flink_ms_tpu_torch/csrc/gather_assembly.cu",
           "replaces": "flink_ms_tpu/ops/gather_assembly.py:97",
           "max_abs_err": max((A - Ap).abs().max().item(),
                              (b - bp).abs().max().item()),
           "ms": event_ms(lambda: GA.fused_bucket_assembly(y, idx, val),
                          reps=5),
           "device_ms": event_ms(lambda: GA.fused_bucket_assembly(
               y, idx, val), reps=3, calls=10),
           "plain_ms": event_ms(lambda: GA.bucket_assembly_plain(
               y, idx, val), reps=3),
           "library_ms": event_ms(asm_library, reps=3)}
    asm["bound_ms"], asm["bound_by"] = bound(
        assembly_flops(nnz, k),
        assembly_bytes(rows, int(idx.numel()), y.numel(), k))
    check(rel_err(A, Ap) <= 1e-5 and rel_err(b, bp) <= 1e-5,
          "scale: the assembly off its plain version on a chunk")
    A.diagonal(dim1=-2, dim2=-1).add_(
        (lam * counts + torch.where(counts > 0, 0.0, 1.0))[:, None])
    out = [asm]
    for name, layout, replaces in (
            ("cholesky_solve_batched", None,
             "flink_ms_tpu/ops/cholesky_pallas.py:40"),
            ("cholesky_solve_batched[batch_major]", "batch_major",
             "flink_ms_tpu/ops/cholesky_pallas.py:97")):
        x_k = CH.cholesky_solve_batched(A, b, layout=layout)
        x_p = CH.cholesky_solve_plain(A, b)
        check(rel_err(x_k, x_p) <= 1e-4,
              f"scale: {name} off its plain version on a chunk")
        e = {"name": name, "route": "cuda",
             "source": "flink_ms_tpu_torch/csrc/cholesky_solve.cu",
             "replaces": replaces,
             "max_abs_err": (x_k - x_p).abs().max().item(),
             "ms": event_ms(lambda: CH.cholesky_solve_batched(
                 A, b, layout=layout), reps=10),
             "device_ms": event_ms(lambda: CH.cholesky_solve_batched(
                 A, b, layout=layout), reps=3, calls=10),
             "plain_ms": event_ms(lambda: CH.cholesky_solve_plain(A, b),
                                  reps=3),
             "library_ms": event_ms(lambda: torch.cholesky_solve(
                 b[..., None], torch.linalg.cholesky(A)), reps=3)}
        e["bound_ms"], e["bound_by"] = bound(solve_flops(rows, k),
                                             solve_bytes(rows, k))
        out.insert(len(out) - 1, e)
    for e in out:
        log(f"scale times {e['name']}, one chunk ({rows} rows, width "
            f"{idx.shape[1]}, nnz {nnz}, k {k}): kernel {e['ms']:.3f} ms, "
            f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']:.3f} "
            f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
    return out


def scale_envelope(torch, TA, CH, GA, n_users, n_items, nnz, dev,
                   times=False):
    """One size of the scale envelope through ``als_fit``'s fused path.
    -> (launches, kernels-line entries of one chunk's times, or [])."""
    import gc
    import resource

    k = SCALE_ENV_RANK
    label = f"scale {n_users} x {n_items}, {nnz} ratings, rank {k}"
    t0 = time.perf_counter()
    users, items, ratings = synth_ratings(n_users, n_items, nnz, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = TA.prepare_blocked(users, items, ratings, 1)
    prep_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, k, gen).numpy(),
            TA.init_factors(problem.n_items, k, gen).numpy())
    a_bytes = problem.n_users * k * k * 4
    log(f"{label}: generation {nnz / gen_s:,.0f} rows/s ({gen_s:.2f}s), "
        f"prepare_blocked {prep_s:.1f}s (host, untimed); buckets user "
        f"{len(problem.u.widths)}, item {len(problem.i.widths)}; the user "
        f"side's A would be {a_bytes / 1e9:.1f} GB")
    cfg = TA.ALSConfig(num_factors=k, iterations=1, lambda_=LAMBDA)
    saved = os.environ.get("FLINK_MS_ALS_FUSED")
    os.environ["FLINK_MS_ALS_FUSED"] = "1"
    try:
        # the chunk budget as the environment sets it, else its default
        log(f"{label}: FLINK_MS_ALS_FUSED=1, "
            f"FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES "
            f"{TA._assembly_chunk_bytes()}")
        if dev.type == "cuda":
            # the allocator exists once it has allocated on the card
            torch.empty(1, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reset_als_launches(CH, GA)
        fit_fn, dev_args = TA.compile_fit(problem, cfg, dev, init=init)

        def run(trip):
            t = time.perf_counter()
            out = fit_fn(trip, *dev_args)
            sync(torch)
            return time.perf_counter() - t, out

        run(1)  # warm-up
        samples = []
        for _ in range(3):
            t1, tn = run(1)[0], run(3)
            samples.append(max((tn[0] - t1) / 2, 1e-9))
        sec = float(np.median(samples))
        uf, itf = tn[1]
        ran = 1 + 3 * 4
        # scored on the card, each fit's ratings moved there after its peak
        # is read (the scoring's tensors are not the fit's)
        rows = rating_rows(torch, problem, users, items, ratings,
                           torch.device("cpu"))
        rmses, peak = [], 0
        for it in (1, 2):
            m = TA.als_fit(users, items, ratings,
                           dataclasses.replace(cfg, iterations=it), dev,
                           problem=problem, init=init)
            ran += it
            sync(torch)
            if dev.type == "cuda":
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
            rmses.append(train_rmse(torch, m.user_factors, m.item_factors,
                                    [t.to(dev) for t in rows]))
            del m
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        launches = als_launches(CH, GA)
        n_buckets = len(problem.u.widths) + len(problem.i.widths)
        log(f"{label}: {sec:.4f} sec/iter (median of 3, 1 vs 3 iterations); "
            f"train RMSE after 1, 2 iterations {rmses}; launches over {ran} "
            f"iterations: cholesky {launches['cholesky']} (of them "
            f"batch-major {launches['cholesky_batch_major']}), assembly "
            f"{launches['assembly']}; device memory at its peak "
            f"{peak / 1e9:.2f} GB (the {a_bytes / 1e9:.1f} GB of A never "
            f"exists); host peak RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f}"
            f" GB")
        check(all(np.isfinite(rmses)) and rmses[0] > rmses[1],
              f"{label}: train RMSE not finite and decreasing: {rmses}")
        check(bool((uf[-1] == 0).all()) and bool((itf[-1] == 0).all()),
              f"{label}: a dummy slot's factor row is not zero")
        check(launches["cholesky_batch_major"] > 0
              and launches["assembly"] > n_buckets * ran
              and launches["cholesky"] == launches["assembly"],
              f"{label}: {launches} for {ran} iterations of {n_buckets} "
              f"buckets: the fused path's chunks did not run")
        n_u = 2 * len(problem.u.widths) + 1
        f64_check(torch, TA, GA, dev_args[2:2 + n_u], itf, "user")
        f64_check(torch, TA, GA, dev_args[2 + n_u:], uf, "item")
        entries = []
        if times and dev.type == "cuda":
            # the first chunk of the user side's last bucket (widths
            # descend: its narrowest, cut into the most chunks)
            flat = dev_args[2:2 + n_u]
            j = len(flat) // 2 - 1
            rows = min(int(TA._assembly_chunk_bytes() // (3 * k * k * 4)),
                       int(flat[2 * j].shape[0]))
            off = sum(int(flat[2 * i].shape[0]) for i in range(j))
            entries = chunk_times(torch, CH, GA, itf, flat[2 * j][:rows],
                                  flat[2 * j + 1][:rows],
                                  flat[-1][off:off + rows], k, LAMBDA)
    finally:
        if saved is None:
            del os.environ["FLINK_MS_ALS_FUSED"]
        else:
            os.environ["FLINK_MS_ALS_FUSED"] = saved
    del dev_args, uf, itf, problem, users, items, ratings, init, rows
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, entries


def scale_only(torch, dev) -> int:
    """``--scale-only``: the kernels' build, then the scale envelope at each
    of ``SCALE_ENV_SIZES``, the last with each kernel's time on one
    chunk; a ``kernels`` line labels the last size's launches
    ``als_scale``."""
    from flink_ms_tpu_torch.ops import _build
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all(["cholesky_solve", "gather_assembly"])
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for j, (n_u, n_i, nnz) in enumerate(SCALE_ENV_SIZES):
        last = j == len(SCALE_ENV_SIZES) - 1
        launches, entries = scale_envelope(torch, TA, CH, GA, n_u, n_i, nnz,
                                           dev, times=last)
        log(f"clock: scale {n_u} x {n_i} done at "
            f"{time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for e, key in zip(entries, ("cholesky", "cholesky_batch_major",
                                "assembly")):
        e["launches"] = launches[key]
        e["launches_by_path"] = {"als_scale": launches[key]}
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{key: e[key] for key in keys}
                                  for e in entries]}))
    print(card)
    return 0


# -- the phases beside: 24, 11, 15 and 14 in processes of their own ---------

# From the end of phase 9 to the start of phase 17 three lanes run at once:
# this process (phases 23, 10, 12, 13 and 16, phase 16 (b)'s gloo ranks
# started with the lanes) and one spawned process for each lane here.
# What a lane takes from this process: phase 7's trained w and phase 24's
# sample of its rows, and phase 4's trained model; it makes the rest of
# its inputs itself (phase 15 draws phase 4's ratings again from their
# seed).  Their checks are exact or against fixed tolerances; the times
# they print are taken beside the other lanes (PERF.md, section 4)
BESIDE_LANES = (("24", "11"), ("15", "14"))
BESIDE_LABELS = {"24": "phase 24 (the SVM's serving loop)",
                 "11": "phase 11 (serve scale)",
                 "15": "phase 15 (retrain)",
                 "14": "phase 14 (generators)"}
BESIDE_WAIT_S = 900.0
MODEL_FIELDS = ("user_ids", "item_ids", "user_factors", "item_factors")


def beside_phase(torch, key, got, dev):
    """Phase ``key`` of a lane on its inputs ``got`` -> its launches (24:
    ``margin_gather``'s, 15: the ALS kernels'), else None."""
    if key == "24":
        from flink_ms_tpu_torch.ops import svm_kernels as SK

        sample = dict(got["sample"], w=got["sample"]["w"].to(dev))
        return svm_serve_phase(torch, sample, SK, dev)["launches"]
    if key == "11":
        return serve_scale_phase(torch, dev)
    if key == "15":
        from flink_ms_tpu_torch.ops import als as TA
        from flink_ms_tpu_torch.ops import cholesky as CH
        from flink_ms_tpu_torch.ops import gather_assembly as GA

        m = got["model"]
        model = TA.ALSModel(m["user_ids"], m["item_ids"],
                            m["user_factors"].to(dev),
                            m["item_factors"].to(dev))
        return retrain_phase(torch, CH, GA, model,
                             synth_ratings(N_USERS, N_ITEMS, NNZ, seed=0), dev)
    if key == "14":
        return gen_phase(torch, dev)
    raise ValueError(f"no phase {key!r} runs beside")


def beside_in_process(inputs_path, out_path, start_wall, dev_name,
                      lane) -> None:
    """The phases of ``lane`` in the process it is called in (``Beside``
    spawns one for each lane), each with its ``clock:`` line timed from
    the run's start (``start_wall``, on the wall clock): ``inputs_path``
    holds ``{"sample": svm_serve_sample(...), "model": phase 4's model's
    fields}``; writes ``{phase: its launches or None}``, or ``{"error":
    ...}``, to ``out_path`` as JSON."""
    import traceback

    import torch

    dev = torch.device(dev_name, 0) if dev_name == "cuda" else torch.device(
        dev_name)
    last = [time.time()]
    out = {}
    try:
        got = torch.load(inputs_path, weights_only=False)
        for key in lane:
            out[key] = beside_phase(torch, key, got, dev)
            now = time.time()
            log(f"clock: {BESIDE_LABELS[key]} done at "
                f"{now - start_wall:.1f}s (+{now - last[0]:.1f}s), in a "
                f"lane beside phases 23, 10, 12, 13, 16")
            last[0] = now
    except SmokeFailure as e:
        out = {"error": str(e)}
    except Exception:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f)


class Beside:
    """``beside_in_process`` for each lane of ``lanes``, each in a spawned
    process of its own, started by the constructor; ``join`` -> {phase:
    what it returned}, and a ``SmokeFailure`` if a phase failed or a lane
    outlasted ``BESIDE_WAIT_S``."""

    def __init__(self, torch, inputs, start_wall, dev, lanes=BESIDE_LANES):
        import multiprocessing
        import tempfile

        self.t0 = time.perf_counter()
        self.dir = tempfile.mkdtemp(prefix="tpums_beside_")
        path = os.path.join(self.dir, "inputs.pt")
        torch.save(inputs, path)
        ctx = multiprocessing.get_context("spawn")
        self.lanes = []
        for n, lane in enumerate(lanes):
            out = os.path.join(self.dir, f"lane-{n}.json")
            proc = ctx.Process(target=beside_in_process,
                               args=(path, out, start_wall, dev.type, lane))
            proc.start()
            self.lanes.append((lane, proc, out))

    def join(self) -> dict:
        got = {}
        try:
            for lane, proc, out in self.lanes:
                proc.join(max(BESIDE_WAIT_S - (time.perf_counter()
                                               - self.t0), 0.0))
                if proc.is_alive():
                    proc.kill()
                    proc.join()
                    raise SmokeFailure(f"the lane of phases {lane} outlasted "
                                       f"{BESIDE_WAIT_S:.0f}s")
                res = {}
                if os.path.exists(out):
                    with open(out) as f:
                        res = json.load(f)
                check("error" not in res, f"a phase beside, of the lane "
                      f"{lane}: {res.get('error')}")
                check(proc.exitcode == 0 and set(res) == set(lane),
                      f"the lane of phases {lane} exited {proc.exitcode}")
                got.update(res)
            return got
        finally:
            for _, proc, _ in self.lanes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            shutil.rmtree(self.dir, ignore_errors=True)


def main(argv=None) -> int:
    import torch

    argv = [] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("[smoke] CUDA is not available: nothing to drive",
              file=sys.stderr)
        return 2
    obs_users = argv[1:] if argv[:1] == ["--obs-only"] else None
    if argv not in ([], ["--multi-gpu"], ["--geo-only"],
                    ["--scale-only"]) and not (
            obs_users is not None and all(u.isdigit() for u in obs_users)):
        print(f"[smoke] unknown arguments {argv} (none, --multi-gpu, "
              "--obs-only [USERS ...], --geo-only or --scale-only)",
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
    if obs_users is not None:
        return obs_only(torch, dev, [int(u) for u in obs_users])
    if argv == ["--geo-only"]:
        return geo_only(torch, dev)
    if argv == ["--scale-only"]:
        return scale_only(torch, dev)
    if argv:
        return multi_gpu_only(torch, dev)
    t_start = time.perf_counter()
    laps, running_beside = [t_start], []

    def lap(label):
        now = time.perf_counter()
        log(f"clock: {label} done at {now - t_start:.1f}s "
            f"(+{now - laps[-1]:.1f}s)")
        laps.append(now)
        # a phase stops what it starts: name any process still alive here
        # (but, until they are joined, the processes spawned for the
        # phases beside and for phase 16 (b)'s ranks, which run on across
        # these laps)
        spawned = [p for p, c in own_processes(helpers=False).items()
                   if running_beside and "spawn_main" in c]
        alive = own_processes(helpers=False, exclude=spawned)
        if alive:
            log(f"processes alive after {label}: {len(alive)}: " + "; ".join(
                f"{pid} {c[:160]}" for pid, c in alive.items()))

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log("build: " + ", ".join(
        f"{name} {r['seconds']:.2f}s{' (cached)' if r['cached'] else ''}"
        for name, r in built.items())
        + f"; {time.perf_counter() - t0:.2f}s wall, in parallel")
    # the native store, lookup server and arena writer (phases 18-19),
    # built once here by g++ rather than by the first fleet member
    from flink_ms_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    cached = native_build.library_path().exists()
    lib = native_build.build()
    log(f"build: native library {lib.name} "
        f"{'(cached) ' if cached else ''}{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    (users, items, ratings), problem, init = ml20m_problem(TA)
    nnz_pad = {s: sum(r * w for r, w in zip(getattr(problem, s).rows,
                                            getattr(problem, s).widths))
               for s in "ui"}
    log(f"setup: {problem.n_users} users x {problem.n_items} items, "
        f"{problem.nnz} ratings; synth_ratings + prepare_blocked "
        f"{time.perf_counter() - t0:.1f}s (host, untimed); buckets "
        f"user {len(problem.u.widths)} (nnz_pad {nnz_pad['u']}), item "
        f"{len(problem.i.widths)} (nnz_pad {nnz_pad['i']})")

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

    lap("phases 1-9 (build, kernels, ALS and SVM)")
    # from here to phase 17 the lanes of phases beside this process and
    # phase 16 (b)'s two gloo ranks run on with it (``Beside``)
    gloo = multi_gloo_phase(torch, runs, svm_run["w"], dev)
    sample = svm_serve_sample(svm_run)
    model = {k: getattr(final["model"], k) for k in MODEL_FIELDS}
    beside = Beside(torch, {
        "sample": dict(sample, w=sample["w"].cpu()),
        "model": {k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in model.items()}},
        time.time() - (time.perf_counter() - t_start), dev)
    running_beside.append(beside)
    arms = arms_phase(torch, TA, CH, GA, TS, SK, problem,
                      (users, items, ratings), init, runs, svm_run, dev)
    for e, key in zip(entries[:3], ("cholesky", "cholesky_batch_major",
                                    "assembly")):
        for label in ("als_implicit", "als_bf16"):
            e["launches_by_path"][label] = arms[label][key]
    for e in entries[3:]:
        e["launches_by_path"]["svm_avg"] = arms["svm_avg"][e["name"]]
    del svm_run["data"], svm_run["problem"], svm_run["dev_args"]
    lap("phase 23 (implicit ALS, bf16 exchange, the SVM's avg mode)")
    serve = serve_phase(torch, final, (users, items, ratings),
                        final["rmse"][2], dev)
    lap("phase 10 (serve)")
    staged = staged_phase(torch, TA, CH, GA, problem, (users, items, ratings),
                          init, final["model"], final["sec_per_iter"], dev)
    lap("phase 12 (staged ALS)")
    modes = svm_modes_phase(torch, TS, SK, svm_run, dev)
    lap("phase 13 (SVM modes)")
    multi_world1_phase(torch, TA, CH, GA, TS, SK, problem,
                       (users, items, ratings), init, runs, svm_run["w"],
                       dev)
    multi = gloo()
    multi_shard_phase(torch, dev, [dev, dev], SCALE_EXACT_ROWS,
                      "(c) sharded exact, 2 slices on one card")
    if torch.cuda.device_count() >= 2:
        multi_nccl_phase(torch, dev)
    else:
        log("multi (d): NCCL over 2 and 4 ranks needs two or more cards; "
            f"this machine has {torch.cuda.device_count()} "
            "(run python3 chip_smoke.py --multi-gpu on one that has them)")
    lap("phase 16 (multi-rank; (b)'s ranks started after phase 9)")
    got = beside.join()
    running_beside.clear()
    retrain = got["15"]
    for e in entries[3:]:
        e["launches_by_path"]["svm_serve"] = (
            got["24"] if e["name"] == "margin_gather" else 0)
    lap("the lanes beside (phases 24, 11; 15, 14), joined")
    job = serving_job_phase(torch, final["model"], (users, items, ratings),
                            serve["p50_ms"], dev)
    lap("phase 17 (serving job)")
    fleet_phase(torch, job["fleet_base"], dev)
    lap("phase 18 (fleet)")
    arena_phase(torch, job["fleet_base"], dev)
    lap("phase 19 (arena)")
    loop = loop_phase(torch, job["fleet_base"], dev)
    lap("phase 20 (loop)")
    obs_phase(torch, job["fleet_base"], dev, card)
    lap("phase 21 (observability)")
    geo_phase(torch, job["fleet_base"], dev, card)
    lap("phase 22 (geo-replication and edge)")
    for e, key in zip(entries[:3], ("cholesky", "cholesky_batch_major",
                                    "assembly")):
        e["launches_by_path"]["als_staged"] = staged[key]
        e["launches_by_path"]["autopilot_retrain"] = retrain[key]
        e["launches_by_path"]["autopilot_tick"] = loop["launches"][key]
        for label in ("als_d2", "als_d2_fused", "als_routed"):
            e["launches_by_path"][label] = multi[label][key]
    for e in entries[3:]:
        for label, launches in modes.items():
            e["launches_by_path"][f"svm_{label}"] = launches[e["name"]]
        e["launches_by_path"]["svm_d2"] = multi["svm_d2"][e["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    stop_leftovers("phases 1-22", helpers=False)
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{key: e[key] for key in keys}
                                  for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    cache_bytecode()
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
    finally:
        # whatever way the run ends, nothing it started outlives it
        stop_leftovers("the run", say=lambda m: print(
            f"[smoke] {m}", file=sys.stderr, flush=True))
