"""Mean factor-vector job: counterpart of ``ALSMeanVector``
(``ALSMeanVector.scala``); own copy of ``flink_ms_tpu/eval/mean_vector.py``.

Computes the elementwise mean of all factor vectors in a model file and emits
the cold-start row ``MEAN,U|I,f1;...`` consumed by the serving layer and the
online SGD updater (SGD.java:142-151 falls back to these rows for unseen
users/items).  It is numpy arithmetic on the host, as the reference's:

    python -m flink_ms_tpu_torch.eval.mean_vector --type user \\
        --input userFactors --output meanU
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import formats as F
from ..core.params import Params


def run(params: Params) -> str | None:
    type_flag = params.get_required("type")
    if type_flag == "item":
        factor_type = F.ITEM
    elif type_flag == "user":
        factor_type = F.USER
    else:
        raise ValueError("specify type as either 'item' or 'user'.")

    _ids, _types, factors = F.read_als_model(params.get_required("input"))
    if factors.size == 0:
        raise ValueError("empty model input")
    mean = np.mean(factors, axis=0)
    row = F.format_mean_row(factor_type, mean)

    if params.has("output"):
        F.write_lines(params.get_required("output"), [row])
    else:
        print("Printing results to stdout. Use --output to specify output location")
        print(row)
    return row


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
