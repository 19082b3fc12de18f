"""Counterpart of ``flink_ms_tpu.serve``: the model journal and table, the
standalone serving job (``consumer.py``) with its lookup server, wire
protocol, admission and registry, the query client, the model producer,
the top-k index with its IVF tier and cross-request batcher, the push
plane and snapshots, the fleet (sharded workers, HA replica sets, elastic
topology generations, the co-located update plane), the arena and native
store, blue/green model rollout, the autopilot (its controller around
the warm-started retrain on the card), geo-replication with region
failover (``georepl.py``) and the edge proxy (``edge.py``)."""
