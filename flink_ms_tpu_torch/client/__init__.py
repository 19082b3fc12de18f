"""Counterpart of ``flink_ms_tpu.client``: the ALS console clients and the
random-load latency harness."""
