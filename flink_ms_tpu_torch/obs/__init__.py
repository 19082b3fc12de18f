"""Counterpart of ``flink_ms_tpu.obs``: the metrics registry with its
Prometheus exposition and bench helpers (``metrics``), request tracing with
its rotated event files (``tracing``), the fleet scrape and its CLI
(``scrape``), the watch store (``tsdb``), SLO reports (``slo``), alert rules
(``rules``) and the live model-quality canary (``watch``).  The continuous
profiler, forensics, ``FleetWatcher`` and the workload engine are not
ported yet (ROADMAP.md, Queue 1, item 'Observability')."""
