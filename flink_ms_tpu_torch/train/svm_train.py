"""SVM training CLI on CUDA cards, one process per card.

Counterpart of ``flink_ms_tpu/train/svm_train.py`` (itself the
counterpart of ``SVMImpl``, ``flink-svm/.../SVMImpl.scala``): the same
flags, the same ``[SVM] model-fitting: ...`` summary line and the same
output rows, byte for byte in format: 1-based ``featureIndex,weight``, or
range-partitioned ``bucket,idx:w;...`` with ``--partition true``.

    python -m flink_ms_tpu_torch.train.svm_train --device cuda \\
        --training train.libsvm --blocks 64 --iteration 10 --output model

Flags: ``--training`` (required), ``--blocks`` (10), ``--iteration``
(10; ``--iterations`` is an alias, SVMImpl.scala:26), ``--partition``,
``--range`` (1000), ``--output``, and FlinkML's CoCoA knobs
``--localIterations`` (default: one pass over a block per round),
``--regularization`` (1.0), ``--stepsize`` (1.0), ``--seed`` (0),
``--mode`` avg|add, ``--sigmaPrime``.  Beyond the reference:

  --device cuda|cpu    where to train (default cuda; no silent fallback)
  --profileDir DIR     write a torch.profiler trace of the fit

Ranks, as in ``train/als_train.py``: ``--devices N`` spawns N ranks of
this host (CPU processes over gloo on ``--device cpu``), and
``--coordinatorAddress/--numProcesses/--processId`` (``--backend``) join a
job started elsewhere; without them the job spans min(``--blocks``,
visible GPUs) ranks, as the reference's mesh.  The K = ``--blocks`` chains
are padded to a multiple of the ranks and split evenly; rank 0 alone
prints the summary and writes the model.
"""

from __future__ import annotations

import sys
import time

from ..core import formats as F
from ..core.params import Params
from ..ops.svm import SVMConfig, SVMModel, prepare_svm_blocked, svm_fit
from ..parallel import distributed as pdist
from ..parallel.mesh import (local_device, num_blocks, ranks_for_blocks,
                             resolve_device)
from ..utils import profiling
from .als_train import spawn_ranks


def _rank_run(params: Params):
    """One rank of a job that ``--devices N`` spawned -> the model (host
    numpy) on rank 0, else None."""
    model = run(params)
    return model if pdist.is_primary() else None


def run(params: Params) -> SVMModel:
    """The CLI's fit; a process group that the flags name is joined
    for the run and left at its end."""
    with pdist.joined_group(params):
        return _run(params)


def _run(params: Params) -> SVMModel:
    training_path = params.get_required("training")
    device = resolve_device(params.get("device", "cuda"))
    # blocks = K logical SDCA chains, ceil(K/D) of them on each rank
    blocks = params.get_int("blocks", 10)
    ranks = ranks_for_blocks(blocks, params.get_int("devices"), device)
    if ranks > 1 and not pdist.in_group():
        return spawn_ranks(_rank_run, params, ranks, device)
    device = local_device(device)
    data = F.read_libsvm(training_path)

    iterations = params.get_int("iteration", params.get_int("iterations", 10))
    seed = params.get_int("seed", 0)
    problem = prepare_svm_blocked(data, blocks, seed=seed)
    local_iters = params.get_int("localIterations", problem.rows_per_block)
    config = SVMConfig(
        iterations=iterations,
        local_iterations=local_iters,
        regularization=params.get_float("regularization", 1.0),
        stepsize=params.get_float("stepsize", 1.0),
        seed=seed,
        mode=params.get("mode", "avg"),
        # CoCoA+ smoothing: unset = provably safe gamma*K; values in
        # [1, gamma*K) are the aggressive sparse-data regime (ops/svm.py)
        sigma_prime=params.get_float("sigmaPrime"),
    )

    t0 = time.time()
    with profiling.trace(params.get("profileDir")):
        model = svm_fit(data, config, device, problem=problem)
    train_s = time.time() - t0
    if not pdist.is_primary():  # one rank reports and writes the output
        return model
    print(
        f"[SVM] model-fitting: {data.n_examples} examples x "
        f"{data.n_features} features, {iterations} rounds x {local_iters} "
        f"local steps, {num_blocks()} device(s), {train_s:.2f}s, "
        f"hinge+reg objective="
        f"{model.hinge_loss(data, config.regularization):.6f}"
    )

    if params.get_bool("partition"):
        rows = F.format_svm_range_rows(model.weights, params.get_int("range", 1000))
    else:
        rows = F.format_svm_flat_rows(model.weights)

    if params.has("output"):
        F.write_lines(params.get_required("output"), rows)
    else:
        print("Printing result to stdout. Use --output to specify output path.")
        for row in rows:
            print(row)
    return model


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
