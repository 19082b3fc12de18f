"""Synthetic SVM model generator on one CUDA card.

Counterpart of ``flink_ms_tpu/gen/svm_model_generator.py`` (itself the
counterpart of ``SVMModelGenerator``,
``model-generator/src/main/scala/de/tub/it4bi/SVMModelGenerator.scala``):
range-partitioned rows ``bucket,idx:w;...`` for buckets 0..numFeatures/range
inclusive, bucket b covering keys ``b*range .. b*range + range-1``
(0-based, as the reference).  About half the weights are exactly 0 (printed
``0``), the rest uniform in (-10, 10) (printed as ``repr(float)``), drawn on
``--device`` from an explicit ``torch.Generator`` seeded with ``seed``.

    python -m flink_ms_tpu_torch.gen.svm_model_generator --device cuda \\
        --numFeatures 47236 --range 1000 --parallelism 1 --output svm
"""

from __future__ import annotations

import sys
from typing import Iterator

from ..core.params import Params


def generate_bucket_rows(num_features: int, range_: int, seed: int = 0,
                         device="cuda") -> Iterator[str]:
    import torch

    from ..parallel.mesh import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_buckets = num_features // range_ + 1

    def rows():
        for bucket in range(n_buckets):
            zero = (torch.rand(range_, generator=gen, device=dev) < 0.5
                    ).cpu().numpy()
            w = torch.empty(range_, device=dev).uniform_(
                -10.0, 10.0, generator=gen).cpu().numpy()
            start = bucket * range_
            yield f"{bucket}," + ";".join(
                f"{start + j}:{_fmt(0 if zero[j] else float(w[j]))}"
                for j in range(range_))

    return rows()


def _fmt(v) -> str:
    # the reference prints Scala Int 0 for a zeroed weight ("i:0")
    return "0" if v == 0 else repr(float(v))


def run(params: Params) -> None:
    from ..parallel.mesh import resolve_device

    device = resolve_device(params.get("device", "cuda"))
    num_features = int(params.get_required("numFeatures"))
    range_ = int(params.get_required("range"))
    p = params.get_int("parallelism", 2)
    seed = params.get_int("seed", 0)

    rows = generate_bucket_rows(num_features, range_, seed, device)
    if params.has("output"):
        from .als_model_generator import _write_parallel

        _write_parallel(params.get_required("output"), rows, p)
    else:
        print("Printing results to stdout. Use --output to specify output location")
        for row in rows:
            print(row)


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
