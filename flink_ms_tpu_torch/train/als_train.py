"""ALS training CLI on CUDA cards, one process per card.

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

``--temporaryPath DIR`` (the reference's setTemporaryPath,
ALSImpl.scala:42-44) runs the iterations one at a time, writes the
factors under DIR at every iteration boundary, resumes from the latest
matching snapshot on a rerun, prints the per-iteration ``StepTimer``
summary, and also writes a copy of the final factors under DIR.

Ranks (``parallel/distributed.py``), as the reference's mesh:

  --devices N          train on N ranks of this host, one per GPU (on
                       ``--device cpu``, N CPU processes over gloo): the
                       command spawns them and rank 0 writes the output
  --coordinatorAddress host:port --numProcesses N --processId I
                       join a job whose ranks were started elsewhere,
                       one command per rank (``--backend nccl|gloo``)

Without either, the job spans ``--blocks`` GPUs, at most every visible one
(default: all of them; the reference's ``mesh_for_blocks``).  The solve is
exact per row, so the block count does not change the result beyond the
order of float sums.  Rank 0 alone prints the summary and writes files.
"""

from __future__ import annotations

import sys
import time

import torch

from ..core import formats as F
from ..core.params import Params, field_delimiter_from
from ..ops.als import ALSConfig, ALSModel, als_fit, model_to_host, rmse
from ..parallel import distributed as pdist
from ..parallel.mesh import (local_device, num_blocks, ranks_for_blocks,
                             resolve_device)
from ..utils import profiling


def _rank_run(params: Params):
    """One rank of a job that ``--devices N`` spawned -> rank 0's model as
    host arrays (ids, then user and item factors), else None."""
    model = run(params)
    return model_to_host(model) if pdist.is_primary() else None


def spawn_ranks(rank_fn, params: Params, ranks: int, device):
    """Run ``rank_fn(params)`` on ``ranks`` ranks of this host -> rank 0's
    value.  The CUDA kernels are built here first, once, so the ranks load
    them instead of each running nvcc."""
    if device.type == "cuda":
        from ..ops import _build

        _build.build_all()
    return pdist.launch_local(rank_fn, ranks, (params,),
                              device=device.type,
                              backend=params.get("backend"))[0]


def run(params: Params) -> ALSModel | None:
    """The CLI's fit; a process group that the flags name is joined
    for the run and left at its end."""
    with pdist.joined_group(params):
        return _run(params)


def _run(params: Params) -> ALSModel | None:
    if not params.has("input"):
        print("Use --input to specify file input.")
        return None
    device = resolve_device(params.get("device", "cuda"))
    ranks = ranks_for_blocks(params.get_int("blocks"),
                             params.get_int("devices"), device)
    if ranks > 1 and not pdist.in_group():
        user_ids, item_ids, uf, itf = spawn_ranks(_rank_run, params, ranks,
                                                  device)
        return ALSModel(user_ids, item_ids, torch.from_numpy(uf),
                        torch.from_numpy(itf))
    device = local_device(device)

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

    # get_required raises on a present but valueless flag
    tmp = (
        params.get_required("temporaryPath").rstrip("/")
        if params.has("temporaryPath")
        else None
    )
    if tmp == "":  # "--temporaryPath /" (or all slashes) is not a usable dir
        raise ValueError("--temporaryPath must name a directory, got a bare '/'")
    t0 = time.time()
    step_timer = profiling.StepTimer("als-iteration") if tmp else None
    with profiling.trace(params.get("profileDir")):
        model = als_fit(users, items, ratings, config, device=device,
                        temporary_path=tmp, step_timer=step_timer)
        profiling.hard_sync(model.user_factors)
    train_s = time.time() - t0
    if not pdist.is_primary():  # one rank reports and writes the output
        return model
    if step_timer is not None and step_timer.durations_s:
        print(step_timer.summary())
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
    if tmp:
        F.write_als_model(f"{tmp}/userFactors", model.user_ids, F.USER,
                          user_factors)
        F.write_als_model(f"{tmp}/itemFactors", model.item_ids, F.ITEM,
                          item_factors)
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
