"""Counterpart of ``flink_ms_tpu.utils``."""
