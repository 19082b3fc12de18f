"""Counterpart of ``flink_ms_tpu.online``: the online SGD updater."""
