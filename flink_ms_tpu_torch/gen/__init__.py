"""Synthetic model generators (latency and throughput models, not quality):
counterparts of ``flink_ms_tpu/gen``."""
