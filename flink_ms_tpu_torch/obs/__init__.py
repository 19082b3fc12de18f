"""Counterpart of ``flink_ms_tpu.obs``: the metrics subset the serving path
records."""
