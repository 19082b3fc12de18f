"""Counterpart of ``flink_ms_tpu.eval``: offline MSE evaluation."""
