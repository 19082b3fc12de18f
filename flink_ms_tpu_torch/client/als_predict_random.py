"""ALS random-load latency harness: counterpart of ``ALSPredictRandom``
(``ALSPredictRandom.java``); own copy of
``flink_ms_tpu/client/als_predict_random.py``.

Sends N random ``(user, item)`` point queries within the given id bounds,
retrying queries that hit missing keys (:66-77), and writes the per-query
latency CSV ``uId,iId,prediction,ms`` (:93-97).

Quirk decision (SURVEY.md Appendix C #6): the reference decrements the loop
counter on every miss — an infinite loop on sparse models — and its
unbounded default id range overflows ``r.nextInt``.  Here misses still
retry, but total attempts are capped at 10x numQueries (warning on
exhaustion), and unset bounds defaults raise a clear error instead of
overflowing.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core import formats as F
from ..core.params import Params
from ..serve.client import QueryClient
from ..serve.registry import resolve_endpoint
from ..serve.consumer import ALS_STATE
from .common import parse_factors

INT_MAX = 2**31 - 1


def run(params: Params) -> int:
    host, port = resolve_endpoint(params)  # jobId routes via the registry
    timeout = params.get_int("queryTimeout", 5)
    num_queries = params.get_int("numQueries", 1000)
    lower_item = params.get_int("lowerItemId", 0)
    upper_item = params.get_int("upperItemId", INT_MAX)
    lower_user = params.get_int("lowerUserId", 0)
    upper_user = params.get_int("upperUserId", INT_MAX)
    out_file = params.get_required("outputFile")
    job_id = params.get_required("jobId")

    if upper_user - lower_user <= 0 or upper_item - lower_item <= 0:
        raise ValueError("id bounds must satisfy lower < upper")
    if upper_user == INT_MAX or upper_item == INT_MAX:
        raise ValueError(
            "set --upperUserId/--upperItemId to the model's id range "
            "(querying random 31-bit ids would never hit a real model)"
        )

    rng = np.random.default_rng()
    rows = []
    completed = 0
    attempts = 0
    max_attempts = num_queries * 10
    with QueryClient(host, port, timeout, job_id) as client:
        while completed < num_queries and attempts < max_attempts:
            attempts += 1
            u = int(rng.integers(lower_user, upper_user))
            i = int(rng.integers(lower_item, upper_item))
            try:
                t0 = time.perf_counter()
                user_payload = client.query_state(ALS_STATE, f"{u}-U")
                if user_payload is None:
                    print(f"User Factors do not exist in the model for the user: {u}")
                    continue
                item_payload = client.query_state(ALS_STATE, f"{i}-I")
                if item_payload is None:
                    print(f"Item Factors do not exist in the model for the item: {i}")
                    continue
                uf = parse_factors(user_payload)
                itf = parse_factors(item_payload)
                prediction = sum(a * b for a, b in zip(uf, itf))
                ms = (time.perf_counter() - t0) * 1000.0
                rows.append(F.format_als_latency_row(u, i, prediction, ms))
                completed += 1
            except Exception as e:
                print(f"Query failed because of the following Exception:\n{e}")
    if completed < num_queries:
        print(
            f"warning: only {completed}/{num_queries} queries completed after "
            f"{attempts} attempts (sparse model vs id bounds?)",
            file=sys.stderr,
        )
    F.write_lines(out_file, rows)
    print(
        "Output is written in the format:"
        "User ID, Item ID, ALS prediction, Query time in milliseconds"
    )
    return completed


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
