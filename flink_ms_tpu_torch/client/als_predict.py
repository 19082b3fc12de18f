"""ALS console client: counterpart of ``ALSPredict`` (``ALSPredict.java``);
own copy of ``flink_ms_tpu/client/als_predict.py``.

REPL: ``user,item`` -> queries ``<u>-U`` and ``<i>-I`` from ``ALS_MODEL``
(:65-70) -> dot product (:74-83).  Positional args: jobID [host] [port].
"""

from __future__ import annotations

import sys
from typing import Iterable, Optional

from ..serve.client import QueryClient
from ..serve.consumer import ALS_STATE
from .common import parse_factors, read_lines, repl_client_from_argv

USAGE = "python -m flink_ms_tpu_torch.client.als_predict <jobID> [jobManagerHost] [jobManagerPort]"


def predict_pair(client: QueryClient, user: str, item: str) -> Optional[float]:
    user_payload = client.query_state(ALS_STATE, f"{user}-U")
    item_payload = client.query_state(ALS_STATE, f"{item}-I")
    if user_payload is None or item_payload is None:
        return None
    uf = parse_factors(user_payload)
    itf = parse_factors(item_payload)
    return sum(a * b for a, b in zip(uf, itf))


def run(client: QueryClient, lines: Iterable[str], out=sys.stdout) -> None:
    print("Enter <User,Item> to predict.", file=out)
    for line in lines:
        key = line.upper().strip()
        if not key:
            continue
        print(f"[info] Querying the model for <user,item> pair '{key}'", file=out)
        try:
            user, item = key.split(",")[:2]
            prediction = predict_pair(client, user, item)
            if prediction is None:
                print(
                    f"User or Item Factors do not exist in the model for the "
                    f"query: {key}",
                    file=out,
                )
            else:
                print(f"ALS Prediction =  {prediction:f}", file=out)
        except Exception as e:
            print(f"Query failed because of the following Exception:\n{e}", file=out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    with repl_client_from_argv(argv, USAGE) as client:
        run(client, read_lines())


if __name__ == "__main__":
    main()
