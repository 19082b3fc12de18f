"""Synthetic ALS model generator on one CUDA card.

Counterpart of ``flink_ms_tpu/gen/als_model_generator.py`` (itself the
counterpart of ``ALSModelGenerator``,
``model-generator/src/main/scala/de/tub/it4bi/ALSModelGenerator.scala``,
"Only for testing the latency and throughput. Not for quality."): rows
``id,U|I,f1;...`` for user ids 1..numUsers, then item ids 1..numItems,
each factor entry drawn from the ratio of uniforms
``nextDouble()/nextDouble() * latentFactors`` (heavy-tailed), or with
``--distribution bounded`` uniform in [0, sqrt(5/latent)).

    python -m flink_ms_tpu_torch.gen.als_model_generator --device cuda \\
        --numUsers 138493 --numItems 26744 --latentFactors 50 \\
        --parallelism 1 --output model

The single-process path (``--parallelism`` 1, or stdout) draws on
``--device`` from an explicit ``torch.Generator``, seeded with ``seed``
for the users and ``seed + 1`` for the items, in batches of 65,536 rows.
The reference draws threefry bits there, which torch cannot reproduce: the
rows have the reference's format and distribution, not its values.

``--parallelism p`` >= 2 writes a directory of part files "1".."p" (Flink's
parallel ``writeAsText``), each made by its own spawned worker process over
a contiguous id slice.  That path is the reference's numpy code, copied,
so its part files equal the reference's byte for byte.  If the pool fails,
the same files are written by one process, and the failure is printed to
stderr.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator

import numpy as np

from ..core import formats as F
from ..core.params import Params

_BATCH = 1 << 16


def _random_factor_batch(gen, n_rows: int, latent: int, distribution: str,
                         dev) -> np.ndarray:
    import torch

    num = torch.rand((n_rows, latent), generator=gen, device=dev)
    if distribution == "bounded":
        block = num * np.sqrt(5.0 / latent)
    else:
        den = torch.rand((n_rows, latent), generator=gen, device=dev)
        block = num / torch.clamp_min(den, 1e-12) * latent
    return block.cpu().numpy().astype(np.float64)


def generate_rows(
    n: int, category: str, latent: int, seed: int = 0,
    distribution: str = "ratio", device="cuda",
) -> Iterator[str]:
    """Rows ``id,U|I,f1;...`` for ids 1..n (the reference's ids are
    1-based, ALSModelGenerator.scala:47-53), drawn on `device`."""
    import torch

    from ..parallel.mesh import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rows():
        done = 0
        while done < n:
            m = min(_BATCH, n - done)
            block = _random_factor_batch(gen, m, latent, distribution, dev)
            for j in range(m):
                yield F.format_als_row(done + j + 1, category, block[j])
            done += m

    return rows()


def _write_parallel(path: str, rows: Iterator[str], parallelism: int) -> None:
    if parallelism <= 1:
        F.write_lines(path, rows)
        return
    os.makedirs(path, exist_ok=True)
    files = [open(os.path.join(path, str(i + 1)), "w") for i in range(parallelism)]
    try:
        for n, row in enumerate(rows):
            f = files[n % parallelism]
            f.write(row)
            f.write("\n")
    finally:
        for f in files:
            f.close()


def _part_worker(args) -> int:
    """One subtask: generate a contiguous id slice of each side into its
    part file (subtask i owns file i+1).  numpy only, one independent
    stream per (side, part), ``default_rng(seed + side * 1_000_003 +
    part)``: the reference's worker, so the file equals its."""
    (path, part, parallelism, num_users, num_items, latent, seed,
     distribution) = args
    n_written = 0
    with open(os.path.join(path, str(part + 1)), "w") as f:
        for total, category, base in (
            (num_users, F.USER, 0),
            (num_items, F.ITEM, 1),
        ):
            lo = part * total // parallelism
            hi = (part + 1) * total // parallelism
            rng = np.random.default_rng(seed + base * 1_000_003 + part)
            done = 0
            while done < hi - lo:
                m = min(_BATCH, hi - lo - done)
                num = rng.uniform(size=(m, latent))
                if distribution == "bounded":
                    block = num * np.sqrt(5.0 / latent)
                else:
                    den = np.maximum(rng.uniform(size=(m, latent)), 1e-12)
                    block = num / den * latent
                for j in range(m):
                    f.write(F.format_als_row(lo + done + j + 1, category,
                                             block[j]))
                    f.write("\n")
                    n_written += 1
                done += m
    return n_written


def run(params: Params) -> None:
    from ..parallel.mesh import resolve_device

    device = resolve_device(params.get("device", "cuda"))
    num_users = int(params.get_required("numUsers"))
    num_items = int(params.get_required("numItems"))
    latent = int(params.get_required("latentFactors"))
    p = params.get_int("parallelism", 2)
    seed = params.get_int("seed", 0)
    # "ratio" (the reference's, heavy-tailed) | "bounded" (predictions in
    # [0, 5), for harnesses that check a live MSE)
    distribution = params.get("distribution", "ratio")
    if distribution not in ("ratio", "bounded"):
        raise ValueError("distribution must be ratio|bounded")

    def all_rows():
        yield from generate_rows(num_users, F.USER, latent, seed,
                                 distribution, device)
        yield from generate_rows(num_items, F.ITEM, latent, seed + 1,
                                 distribution, device)

    if not params.has("output"):
        print("Printing results to stdout. Use --output to specify output location")
        for row in all_rows():
            print(row)
        return
    path = params.get_required("output")
    # the pool caps at the core count (every part is still written); below
    # two slots it buys nothing, and one process writes the p parts
    n_workers = max(min(p, os.cpu_count() or 1), 1)
    if p <= 1 or n_workers < 2:
        _write_parallel(path, all_rows(), p)
        return
    import multiprocessing as mp

    os.makedirs(path, exist_ok=True)
    jobs = [(path, part, p, num_users, num_items, latent, seed, distribution)
            for part in range(p)]
    try:
        # spawn, not fork: the parent may hold a live CUDA context
        with mp.get_context("spawn").Pool(n_workers) as pool:
            counts = pool.map(_part_worker, jobs)
        total = num_users + num_items
        if sum(counts) != total:
            raise RuntimeError(
                f"workers wrote {sum(counts)} rows, expected {total}")
    except Exception as e:
        # loud single-process fallback with the same output contract
        print(f"[gen] parallel generation failed ({e!r}); "
              "regenerating single-process", file=sys.stderr)
        _write_parallel(path, all_rows(), p)


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
