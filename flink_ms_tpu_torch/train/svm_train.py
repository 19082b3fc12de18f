"""SVM training CLI on one CUDA card.

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

``--devices`` above 1 (multi-GPU) is not ported yet (ROADMAP.md) and is
refused with an error.
"""

from __future__ import annotations

import sys
import time

from ..core import formats as F
from ..core.params import Params
from ..ops.svm import SVMConfig, SVMModel, prepare_svm_blocked, svm_fit
from ..parallel.mesh import num_blocks, resolve_device
from ..utils import profiling


def run(params: Params) -> SVMModel:
    training_path = params.get_required("training")
    devices = params.get_int("devices")
    if devices is not None and devices != num_blocks():
        raise ValueError(
            f"--devices {devices}: the port trains on one card; multi-GPU "
            "is not ported yet: ROADMAP.md, Queue 1, item 'Multi-GPU'"
        )
    device = resolve_device(params.get("device", "cuda"))
    data = F.read_libsvm(training_path)

    # blocks = K logical SDCA chains, all of them on the one card
    blocks = params.get_int("blocks", 10)
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
