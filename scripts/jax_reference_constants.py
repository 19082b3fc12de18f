#!/usr/bin/env python3
"""The JAX package's values that ``chip_smoke.py`` holds the port to,
computed on the CPU.

Default: the anchor problem (``chip_smoke.anchor_problem``: ML-20M's users
and items / 10 and its ratings / 100, seed 0, rank 50, the init drawn as
phase 4 draws it), fitted by the JAX package's ``als_fit`` for 3
iterations from that init, on one CPU device; tier 1 holds the port's CPU
fits of it to these (``tests/test_torch_chip_smoke_arms.py``):

- ``ANCHOR_IMPLICIT_OBJECTIVE``: the implicit fit (alpha 40, lambda 0.1)
  scored by ``chip_smoke.implicit_objective``;
- ``ANCHOR_BF16_RMSE``: the explicit fit with ``exchange_dtype="bfloat16"``
  (lambda 0.1), its train RMSE.

``--ml20m``: phase 4's own problem (138,493 x 26,744, 20M ratings from
``chip_smoke.synth_ratings`` seed 0, rank 50, lambda 0.1) and init
(``torch.Generator().manual_seed(42)``), fitted by the JAX package's
``als_fit`` on one CPU device as phase 4 and phase 23 fit it on the card:

- ``ML20M_EXPLICIT_RMSE``: the explicit fit's train RMSE after 1, 2 and 3
  iterations (each a fit of its own from the init);
- ``ML20M_IMPLICIT_OBJECTIVE``: the implicit fit (alpha 40) after 3,
  scored by ``chip_smoke.implicit_objective``;
- ``ML20M_BF16_RMSE``: the bf16-exchange fit's train RMSE after 3.

It takes about 5 minutes and 10.5 GB of peak RSS on an 8-core CPU, and
takes no other argument.

``--svm-avg``: the JAX package's CoCoA fit in avg mode (the CLI's default
mode) of phase 7's RCV1 problem (700,000 x 47,236, K 8,192, lambda 1e-4,
one local pass a round): the hinge+reg objective after 1 and 10 rounds.
That is a full-size run: give it a machine with the memory for it.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_constants.py
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_constants.py --ml20m
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_constants.py --svm-avg

Prints each value with ``repr`` precision, then one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _fit_values(ratings_t, init, fits) -> dict:
    """The JAX package's ``als_fit`` of (users, items, ratings) from
    `init` on one CPU device, for each (name, iterations, ALSConfig
    keywords) of `fits`: the implicit objective when the fit is implicit,
    else the train RMSE."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flink_ms_tpu.ops import als as JA
    from flink_ms_tpu.parallel.mesh import make_mesh

    u, i, r = ratings_t
    mesh = make_mesh(1)
    out = {}
    for key, iterations, kw in fits:
        t0 = time.perf_counter()
        cfg = JA.ALSConfig(num_factors=init[0].shape[1],
                           iterations=iterations, lambda_=cs.LAMBDA, **kw)
        m = JA.als_fit(u, i, r, cfg, mesh, init=init)
        if kw.get("implicit"):
            dev = torch.device("cpu")
            out[key] = cs.implicit_objective(
                torch, torch.from_numpy(np.asarray(m.user_factors)),
                torch.from_numpy(np.asarray(m.item_factors)),
                cs.rating_rows(torch, m, u, i, r, dev))
        else:
            out[key] = float(JA.rmse(m, u, i, r))
        print(f"{key} after {iterations} = {out[key]!r}  "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


def als_values() -> dict:
    import chip_smoke as cs
    from flink_ms_tpu_torch.ops import als as TA

    ratings_t, _, init = cs.anchor_problem(TA)
    return _fit_values(ratings_t, init, (
        ("ANCHOR_IMPLICIT_OBJECTIVE", 3,
         dict(implicit=True, alpha=cs.ALS_ALPHA)),
        ("ANCHOR_BF16_RMSE", 3, dict(exchange_dtype="bfloat16"))))


def ml20m_values() -> dict:
    import chip_smoke as cs
    from flink_ms_tpu_torch.ops import als as TA

    t0 = time.perf_counter()
    ratings_t, _, init = cs.ml20m_problem(TA)
    print(f"phase 4's problem and init in {time.perf_counter() - t0:.1f}s",
          flush=True)
    got = _fit_values(ratings_t, init, (
        *((f"explicit_{it}", it, {}) for it in (1, 2, 3)),
        ("ML20M_IMPLICIT_OBJECTIVE", 3,
         dict(implicit=True, alpha=cs.ALS_ALPHA)),
        ("ML20M_BF16_RMSE", 3, dict(exchange_dtype="bfloat16"))))
    return {"ML20M_EXPLICIT_RMSE": [got.pop(f"explicit_{it}")
                                    for it in (1, 2, 3)], **got}


def svm_avg_values(rounds=10) -> dict:
    import dataclasses

    import chip_smoke as cs
    from flink_ms_tpu.core.formats import SparseData
    from flink_ms_tpu.ops import svm as JS
    from flink_ms_tpu.parallel.mesh import make_mesh

    data = cs.synth_rcv1(cs.SVM_N, cs.SVM_D, cs.SVM_NNZ, seed=0)
    data = SparseData(data.labels, data.indptr, data.indices, data.values,
                      data.n_features)
    mesh = make_mesh(1)
    problem = JS.prepare_svm_blocked(data, cs.SVM_K)
    cfg = JS.SVMConfig(iterations=1, local_iterations=problem.rows_per_block,
                       regularization=cs.SVM_LAMBDA, mode="avg")
    out = {}
    for it in (1, rounds):
        t0 = time.perf_counter()
        m = JS.svm_fit(data, dataclasses.replace(cfg, iterations=it), mesh,
                       problem=problem)
        out[f"svm_avg_objective_{it}"] = float(
            m.hinge_loss(data, cs.SVM_LAMBDA))
        print(f"svm avg objective after {it} rounds = "
              f"{out[f'svm_avg_objective_{it}']!r}  "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ml20m", action="store_true")
    mode.add_argument("--svm-avg", action="store_true")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = (ml20m_values() if a.ml20m else svm_avg_values() if a.svm_avg
           else als_values())
    print(f"{time.perf_counter() - t0:.1f}s in all", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
