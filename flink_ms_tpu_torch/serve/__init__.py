"""Counterpart of ``flink_ms_tpu.serve``: the model table, the top-k index
with its IVF tier, the cross-request top-k batcher, the model journal's
writer and the autopilot's warm-started retrain."""
