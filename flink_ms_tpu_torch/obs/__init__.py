"""Counterpart of ``flink_ms_tpu.obs``: the metrics the serving path
records and the wire subset of request tracing."""
