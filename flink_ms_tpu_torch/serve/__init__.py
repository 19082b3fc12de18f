"""Counterpart of ``flink_ms_tpu.serve``: the model table, the top-k index
with its IVF tier, and the cross-request top-k batcher."""
