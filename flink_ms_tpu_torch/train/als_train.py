"""ALS training CLI on one CUDA card.

Counterpart of ``flink_ms_tpu/train/als_train.py`` (itself the
counterpart of ``ALSImpl``, ``flink-als/.../ALSImpl.scala``): the same
flags, the same ``[ALS] model-training: ...`` summary line and the same
``id,U|I,f1;f2;...`` factor files, byte for byte in format.

    python -m flink_ms_tpu_torch.train.als_train --device cuda \\
        --input ratings.csv --userFactors uf --itemFactors itf

Flags beyond the reference:
  --device cuda|cpu    where to train (default cuda; no silent fallback)
  --implicit true      confidence-weighted implicit-feedback ALS
  --alpha 40.0         implicit confidence scale
  --profileDir DIR     write a torch.profiler trace of the fit
                       (DIR/trace.json, Chrome/Perfetto format)

``--blocks`` is accepted and runs as one block: the solve is exact per row,
so the block count does not change the result.  Not in the port yet (see
ROADMAP.md): ``--temporaryPath`` staging and resume, and ``--devices``
above 1 (multi-GPU).  Both are refused with an error.
"""

from __future__ import annotations

import sys
import time

from ..core import formats as F
from ..core.params import Params, field_delimiter_from
from ..ops.als import ALSConfig, ALSModel, als_fit, rmse
from ..parallel.mesh import num_blocks, resolve_device
from ..utils import profiling


def run(params: Params) -> ALSModel | None:
    if not params.has("input"):
        print("Use --input to specify file input.")
        return None
    if params.has("temporaryPath"):
        raise ValueError(
            "--temporaryPath (staged training with resume) is not ported "
            "yet: ROADMAP.md, Queue 1, item 'Staging'"
        )
    devices = params.get_int("devices")
    if devices is not None and devices != num_blocks():
        raise ValueError(
            f"--devices {devices}: the port trains on one card; multi-GPU "
            "is not ported yet: ROADMAP.md, Queue 1, item 'Multi-GPU'"
        )
    device = resolve_device(params.get("device", "cuda"))

    delim = field_delimiter_from(params)
    users, items, ratings = F.read_ratings(
        params.get_required("input"),
        field_delimiter=delim,
        ignore_first_line=params.get_bool("ignoreFirstLine", True),
    )

    config = ALSConfig(
        num_factors=params.get_int("numFactors", 10),
        iterations=params.get_int("iterations", 10),
        lambda_=params.get_float("lambda", 0.9),
        seed=params.get_int("seed", 42),
        implicit=params.get_bool("implicit", False),
        alpha=params.get_float("alpha", 40.0),
    )

    t0 = time.time()
    with profiling.trace(params.get("profileDir")):
        model = als_fit(users, items, ratings, config, device=device)
        profiling.hard_sync(model.user_factors)
    train_s = time.time() - t0
    print(
        f"[ALS] model-training: {len(users)} ratings, "
        f"{len(model.user_ids)} users x {len(model.item_ids)} items, "
        f"k={config.num_factors}, {config.iterations} iters, "
        f"{num_blocks()} device(s), {train_s:.2f}s "
        f"({train_s / max(config.iterations, 1):.3f} s/iter), "
        f"train RMSE={rmse(model, users, items, ratings, device=device):.4f}"
    )

    user_factors = model.user_factors.cpu().numpy()
    item_factors = model.item_factors.cpu().numpy()
    if params.has("itemFactors") and params.has("userFactors"):
        F.write_als_model(
            params.get_required("itemFactors"), model.item_ids, F.ITEM, item_factors
        )
        F.write_als_model(
            params.get_required("userFactors"), model.user_ids, F.USER, user_factors
        )
    else:
        print(
            "Printing results to stdout. Use --itemFactors and --userFactors "
            "to specify output locations."
        )
        print("==== USER FACTORS ====")
        for id_, row in zip(model.user_ids, user_factors):
            print(F.format_als_row(id_, F.USER, row))
        print("==== ITEM FACTORS ====")
        for id_, row in zip(model.item_ids, item_factors):
            print(F.format_als_row(id_, F.ITEM, row))
    return model


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
