#!/usr/bin/env python3
"""The JAX package's values that ``chip_smoke.py`` phase 23 holds the port
to on the card, computed on the CPU.

Default: the anchor problem of phase 23 (``chip_smoke.anchor_problem``:
ML-20M's users and items / 10 and its ratings / 100, seed 0, rank 50, the
init drawn as phase 4 draws it), fitted by the JAX package's ``als_fit``
for 3 iterations from that init, on one CPU device:

- ``ANCHOR_IMPLICIT_OBJECTIVE``: the implicit fit (alpha 40, lambda 0.1)
  scored by ``chip_smoke.implicit_objective``;
- ``ANCHOR_BF16_RMSE``: the explicit fit with ``exchange_dtype="bfloat16"``
  (lambda 0.1), its train RMSE.

``--svm-avg``: the JAX package's CoCoA fit in avg mode (the CLI's default
mode) of phase 7's RCV1 problem (700,000 x 47,236, K 8,192, lambda 1e-4,
one local pass a round): the hinge+reg objective after 1 and 10 rounds.
That is a full-size run: give it a machine with the memory for it.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_constants.py
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


def als_values() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from flink_ms_tpu.ops import als as JA
    from flink_ms_tpu.parallel.mesh import make_mesh
    from flink_ms_tpu_torch.ops import als as TA

    (u, i, r), _, init = cs.anchor_problem(TA)
    out = {}
    for key, kw in (("ANCHOR_IMPLICIT_OBJECTIVE",
                     dict(implicit=True, alpha=cs.ALS_ALPHA)),
                    ("ANCHOR_BF16_RMSE", dict(exchange_dtype="bfloat16"))):
        t0 = time.perf_counter()
        cfg = JA.ALSConfig(num_factors=init[0].shape[1], iterations=3,
                           lambda_=cs.LAMBDA, **kw)
        m = JA.als_fit(u, i, r, cfg, make_mesh(1), init=init)
        if key == "ANCHOR_IMPLICIT_OBJECTIVE":
            dev = torch.device("cpu")
            out[key] = cs.implicit_objective(
                torch, torch.from_numpy(np.asarray(m.user_factors)),
                torch.from_numpy(np.asarray(m.item_factors)),
                cs.rating_rows(torch, m, u, i, r, dev))
        else:
            out[key] = float(JA.rmse(m, u, i, r))
        print(f"{key} = {out[key]!r}  ({time.perf_counter() - t0:.1f}s)",
              flush=True)
    return out


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
    ap.add_argument("--svm-avg", action="store_true")
    a = ap.parse_args(argv)
    out = svm_avg_values() if a.svm_avg else als_values()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
