"""Top-k recommendation client: own copy of
``flink_ms_tpu/client/als_topk.py`` (the JAX package's extension of the
reference's clients: top-k recommendation serving from ALS factors).

Interactive: enter a user id per line, get the top-k items with scores from
the live served model (scored on-device server-side).  One-shot mode with
``--user``.  Flags: --jobId --jobManagerHost --jobManagerPort --k
[--user ID] [--outputFile latency.csv --numQueries N --lowerUserId/--upperUserId].
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
from .common import read_lines


def run(params: Params) -> None:
    host, port = resolve_endpoint(params)  # jobId routes via the registry
    timeout = params.get_int("queryTimeout", 5)
    k = params.get_int("k", 10)
    job_id = params.get("jobId", "local")

    with QueryClient(host, port, timeout, job_id) as client:
        if params.has("outputFile"):
            # load-harness mode: random users, latency CSV qId,k,topScore,ms
            num_queries = params.get_int("numQueries", 1000)
            lower = params.get_int("lowerUserId", 0)
            upper = int(params.get_required("upperUserId"))
            rng = np.random.default_rng()
            rows = []
            for qid in range(num_queries):
                u = int(rng.integers(lower, upper))
                t0 = time.perf_counter()
                result = client.topk(ALS_STATE, str(u), k)
                ms = (time.perf_counter() - t0) * 1000.0
                if result is None:
                    continue
                top_score = result[0][1] if result else 0.0
                rows.append(F.format_svm_latency_row(qid, k, top_score, ms))
            F.write_lines(params.get_required("outputFile"), rows)
            print(f"wrote {len(rows)} top-k latency rows")
            return
        if params.has("user"):
            _print_topk(client, params.get_required("user"), k)
            return
        print("Enter a user id to get top-k recommendations.")
        for line in read_lines():
            user = line.strip()
            if user:
                _print_topk(client, user, k)


def _print_topk(client: QueryClient, user: str, k: int) -> None:
    result = client.topk(ALS_STATE, user, k)
    if result is None:
        print(f"User Factors do not exist in the model for the user: {user}")
        return
    for rank, (item, score) in enumerate(result, 1):
        print(f"{rank:3d}. item {item}  score {score:.6f}")


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
