#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone (the serving job in a process of
its own), on a model trained at phase 4's ML-20M shape and init-free
defaults (3 iterations, rank 50), for a quick look at the serving job on
one CUDA card without the other phases; with ``--fleet``, phase 18 (the
serving fleet) after it, and with ``--loop``, phase 20 (the closed loop:
rollout, the autopilot's tick, the canary, a drift rollback, the
autopilot's CLI), each on phase 17's published topic:

    python3 scripts/serving_job_probe.py [--fleet | --loop]

It builds the kernels (and, for ``--loop``, the native library), trains,
runs ``serving_job_phase`` (and ``fleet_phase`` or ``loop_phase``) and
prints their numbers and the card's name and power limit.  Without CUDA
it exits 2 before any output.
"""

import os
import sys
import time


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--fleet"], ["--loop"]):
        print(f"unknown arguments {argv} (none, --fleet or --loop)",
              file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to probe", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as S
    from flink_ms_tpu_torch.ops import _build
    from flink_ms_tpu_torch.ops import als as TA

    t0 = time.perf_counter()
    print(S.card_line(), flush=True)
    _build.build_all()
    if argv == ["--loop"]:
        from flink_ms_tpu_torch.native import _build as native_build

        native_build.build()
    users, items, ratings = S.synth_ratings(S.N_USERS, S.N_ITEMS, S.NNZ,
                                            seed=0)
    dev = torch.device("cuda", 0)
    model = TA.als_fit(users, items, ratings, TA.ALSConfig(
        num_factors=S.RANK, iterations=3, lambda_=S.LAMBDA), dev)
    S.log(f"probe: model in {time.perf_counter() - t0:.1f}s")
    try:
        job = S.serving_job_phase(torch, model, (users, items, ratings),
                                  0.8, dev)
        base = job.pop("fleet_base")
        print(job)
        if argv == ["--fleet"]:
            print(S.fleet_phase(torch, base, dev))
        elif argv == ["--loop"]:
            print(S.loop_phase(torch, base, dev))
    except S.SmokeFailure as e:
        S.log(f"FAIL: {e}")
        return 1
    S.log(f"probe done in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
