"""Shared client plumbing: own copy of ``flink_ms_tpu/client/common.py``
(the positional-arg parsing of the REPL clients, ``ALSPredict.java:26-35``)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..serve.client import QueryClient


def repl_client_from_argv(argv: Sequence[str], usage: str) -> QueryClient:
    # --proto tab|b2|auto rides along anywhere in argv (None defers to
    # TPUMS_PROTO, then "tab" — serve/proto.py); positional parsing below
    # stays byte-compatible with the Java clients' arg order
    argv = list(argv)
    proto: Optional[str] = None
    if "--proto" in argv:
        i = argv.index("--proto")
        try:
            proto = argv[i + 1]
        except IndexError:
            raise ValueError("--proto needs a value (tab|b2|auto)")
        del argv[i:i + 2]
    if len(argv) == 0:
        raise ValueError(
            "Missing required job ID argument. Usage: " + usage
        )
    job_id = argv[0]
    explicit_host = argv[1] if len(argv) > 1 else None
    if len(argv) > 2:
        host, port = explicit_host, int(argv[2])
    else:
        # no explicit port: resolve the jobId through the location
        # registry, like queryState resolves any job via the JobManager
        # (QueryClientHelper.java:82-92,121); shared precedence helper so
        # positional and flag-based clients can never diverge
        from ..serve.registry import merge_endpoint, resolve

        host, port = merge_endpoint(resolve(job_id), explicit_host)
    print(f"Using JobManager {host}:{port}")
    return QueryClient(host=host, port=port, timeout_s=5.0, job_id=job_id,
                       proto=proto)


def parse_factors(payload: str) -> List[float]:
    return [float(t) for t in payload.split(";") if t]


def read_lines(prompt: str = "$ "):
    """Console REPL line source (jline ConsoleReader stand-in)."""
    while True:
        try:
            yield input(prompt)
        except EOFError:
            return
