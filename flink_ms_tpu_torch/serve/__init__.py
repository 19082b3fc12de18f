"""Counterpart of ``flink_ms_tpu.serve``: the model journal and table, the
standalone serving job (``consumer.py``) with its lookup server, wire
protocol, admission and registry, the query client, the model producer,
the top-k index with its IVF tier and cross-request batcher, the push
plane and snapshots, the fleet (sharded workers, HA replica sets, elastic
topology generations, the co-located update plane), the arena and native
store, blue/green model rollout, and the autopilot (its controller around
the warm-started retrain on the card).  Geo-replication and the edge proxy
are not ported yet."""


def not_ported(what: str, item: str) -> str:
    """The refusal text for a part of the JAX package's serving stack that
    the port does not have yet, naming its ROADMAP item."""
    return (f"{what} is not ported yet (ROADMAP.md, Queue 1, item "
            f"'{item}')")
