"""Counterpart of ``flink_ms_tpu.obs``: the metrics registry with its
Prometheus exposition and bench helpers (``metrics``), request tracing with
its rotated event files (``tracing``), the fleet scrape and its CLI
(``scrape``), the continuous sampling profiler and its PROFILE verb
(``profiler``, ``profdiff``), tail-latency forensics over span spills
(``forensics``), the watch store (``tsdb``), SLO reports (``slo``), alert
rules (``rules``), the fleet watch loop with its model-quality canary
(``watch``) and the rehearsal workload engine (``workload``), whose edge
arm puts the port's proxies (``serve/edge.py``) in front of the fleet.

Knobs: ``TPUMS_METRICS=0`` disables collection; ``TPUMS_TRACE=<path>``
mirrors events to a JSONL file that every process of a fleet appends to;
``TPUMS_PROF=0`` stops the profiler; ``TPUMS_WATCH_*`` sizes the watch
loop.
"""

from .metrics import (  # noqa: F401
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucketed_quantiles,
    diff_snapshots,
    get_registry,
    log_buckets,
    merge_snapshots,
    metrics_enabled,
    render_prometheus,
    set_enabled,
    snapshot_quantile,
    snapshot_to_json_line,
    synthesize_requests,
)
from .tracing import (  # noqa: F401
    call_with_trace,
    clear_events,
    current_trace,
    event,
    events_counter,
    load_events,
    new_trace_id,
    pop_tid,
    recent_events,
    set_trace,
    stamp,
    trace_span,
    unstamp_reply,
)
