"""Blue/green model rollout: versioned model serving on topology generations.

Own copy of ``flink_ms_tpu/serve/rollout.py``, whole, over the port's
``ScaleController``: the same topology records with their ``model``
binding, events and CLI flags, so either package's controller rolls out,
rolls back and reports on a group the other package's controller
published.  Every generation's workers are the port's, on ``device``
(``--device``, default ``cuda``); the held-out MSE probe runs through the
port's ``eval/mse.compute_mse``.

The reference treats a trained model as a deployment artifact: stop the
old ``als-ms`` job, start a new one over the new model transport topic
(PAPER.md §0) — a window where queries fail.  This controller generalizes
the elastic plane's topology-generation machinery (serve/elastic.py) from
*reshaping* a serving group to *replacing the model it serves*:

1. a newly trained model (its own journal dir + topic) is bulk-loaded as
   generation g+1 of the SAME serving group — snapshot-first bootstrap
   (serve/snapshot.py) keeps the warm-up O(state);
2. the warming generation must pass a verification gate behind the ready
   barrier: row count, plus an optional held-out MSE probe (eval/mse.py)
   queried directly against the warming workers BEFORE they can win;
3. CAS publish (``registry.publish_topology`` with the generation's model
   binding attached), drain, GC — the ``ScaleController`` cutover
   protocol verbatim, so in-flight traffic sees zero failed queries;
4. the superseded generation's model binding follows it into the
   topology record's bounded history, and its journal + snapshots are
   retained — ``rollback()`` is one command that rolls *forward* to a new
   generation serving the PREVIOUS model (snapshot-fast, same zero-error
   cutover), rather than a fragile resurrection of stopped processes.

Tenancy: the group name is tenant-qualified (``registry.qualify_group``),
so ``acme``'s ALS rollout and ``globex``'s SVM rollout share one registry
with disjoint records, leases, snapshot scopes and GC.

CLI (one command per op)::

    python -m flink_ms_tpu_torch.serve.rollout --group als \\
        --journalDir /data/v2 --topic models --modelId v2 \\
        --verifyMinRows 1000 [--probeRatings heldout.csv --probeMaxMse 1.2] \\
        [--device cuda|cpu]
    python -m flink_ms_tpu_torch.serve.rollout --group als --rollback
    python -m flink_ms_tpu_torch.serve.rollout --group als --status

Workers spawned by the CLI outlive it (they serve and heartbeat on their
own); what ends with the controller process is respawn supervision and
ownership of older generations.  A resident controller (tests, the chaos
harness, an operator daemon) retains both.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence

from . import registry
from .client import RetryPolicy
from .elastic import ScaleController, ScaleError, generation_group
from .ha import HAShardedClient, ReplicaSupervisor


class RolloutError(RuntimeError):
    """A rollout/rollback could not proceed (no model binding, etc.)."""


class VerificationError(RolloutError):
    """The warming generation failed its pre-publish verification gate;
    the cutover was aborted and the active generation kept serving."""


def _parse_factors(payload: Optional[str]):
    """Serving payload ``"f1;f2;..."`` -> list of floats (None passes
    through: a missing key is the caller's skip signal)."""
    if payload is None:
        return None
    return [float(t) for t in payload.split(";") if t]


class RolloutController(ScaleController):
    """``ScaleController`` whose generations differ by WHAT they serve.

    Inherits the whole cutover protocol — lease, warming spawn, all-ready
    barrier, CAS publish, drain, generation GC — and specializes the two
    hooks: ``_verify_generation`` gates the warming MODEL (row count +
    optional MSE probe) and ``_publish_topology`` binds the model to the
    published generation so history knows what every generation served."""

    _EVENT_PREFIX = "rollout"

    def __init__(
        self,
        group: str,
        port_dir: Optional[str] = None,
        *,
        tenant: Optional[str] = None,
        state: str = "ALS_MODEL",
        journal_dir: Optional[str] = None,
        topic: Optional[str] = None,
        **kw,
    ):
        group = registry.qualify_group(group, tenant)
        # default journal binding: whatever model the group currently
        # serves (a fresh controller process attaching to a live group)
        topo = registry.resolve_topology(group)
        model = (topo or {}).get("model") or {}
        super().__init__(
            group,
            journal_dir if journal_dir is not None
            else model.get("journal_dir"),
            topic if topic is not None else model.get("topic"),
            port_dir=port_dir, **kw,
        )
        self.state = state
        self._pending_model: Optional[dict] = None

    # -- protocol hooks ----------------------------------------------------

    def _warming_client(self, gen: int,
                        sup: ReplicaSupervisor) -> HAShardedClient:
        return HAShardedClient(
            sup.num_workers, job_group=generation_group(self.group, gen),
            timeout_s=10.0,
            retry=RetryPolicy(attempts=4, backoff_s=0.05,
                              max_backoff_s=0.5))

    def _verify_generation(self, gen: int,
                           sup: ReplicaSupervisor) -> None:
        """The ready gate's second half: the warming generation answered
        ready (journal caught up), now prove it serves a sane MODEL.
        Queries go straight at the warming workers' shard groups — the
        published topology still points at the old generation, so probing
        is invisible to live traffic."""
        spec = self._pending_model
        if spec is None:
            return  # plain reshape through the inherited scale_to
        min_rows = int(spec.get("verify_min_rows") or 0)
        probe = spec.get("probe")
        if min_rows <= 0 and not probe:
            return
        client = self._warming_client(gen, sup)
        try:
            if min_rows > 0:
                rows = client.total_count(self.state)
                if rows < min_rows:
                    raise VerificationError(
                        f"warming generation {gen} of {self.group!r} "
                        f"holds {rows} rows < required {min_rows} — "
                        f"model {spec.get('model_id')!r} refused")
                self._event("verified", gen=gen, rows=rows)
            if probe:
                self._run_probe(client, gen, probe)
        finally:
            client.close()

    def _run_probe(self, client: HAShardedClient, gen: int,
                   probe: dict) -> None:
        """Held-out MSE gate: score ``probe``'s ratings against the
        warming model via eval/mse.py's reference skip semantics."""
        from ..eval.mse import compute_mse

        max_mse = float(probe["max_mse"])

        def lookup(key: str):
            return _parse_factors(client.query_state(self.state, key))

        def lookup_many(keys: Sequence[str]):
            return [_parse_factors(p)
                    for p in client.query_states(self.state, list(keys))]

        mse, n_scored, n_skipped = compute_mse(
            probe["users"], probe["items"], probe["ratings"],
            lookup, lookup_many=lookup_many)
        if mse is None or n_scored == 0:
            raise VerificationError(
                f"MSE probe scored 0 of {len(probe['ratings'])} held-out "
                f"ratings against warming generation {gen} — "
                "model refused")
        if mse > max_mse:
            raise VerificationError(
                f"warming generation {gen} MSE {mse:.4f} > gate "
                f"{max_mse:.4f} over {n_scored} held-out ratings "
                f"({n_skipped} skipped) — model refused")
        self._event("verified", gen=gen, mse=round(float(mse), 6),
                    scored=n_scored)

    def _publish_topology(self, shards: int, replicas: int, *,
                          expect_gen: int) -> dict:
        extra = None
        if self._pending_model is not None:
            extra = {"model": {
                k: self._pending_model[k]
                for k in ("journal_dir", "topic", "model_id",
                          "rolled_out_at")
                if k in self._pending_model
            }}
        return registry.publish_topology(
            self.group, shards, replicas, expect_gen=expect_gen,
            extra=extra)

    # -- the one-command surface -------------------------------------------

    def rollout(
        self,
        journal_dir: str,
        topic: str,
        *,
        model_id: Optional[str] = None,
        shards: Optional[int] = None,
        replicas: Optional[int] = None,
        verify_min_rows: int = 0,
        probe: Optional[dict] = None,
    ) -> dict:
        """Blue/green replace the group's model -> the published record.

        Spawns generation g+1 bound to ``(journal_dir, topic)``, waits
        for it to bulk-load (snapshot-first) and pass verification
        (``verify_min_rows`` row floor; ``probe`` = ``{"users", "items",
        "ratings", "max_mse"}`` held-out MSE gate), then CAS-cuts over
        and drains g.  Shape defaults to the active topology's (a model
        swap, not a reshape).  On ANY failure the active generation keeps
        serving and the warming one is torn down."""
        topo = self.current()
        if shards is None:
            shards = int(topo["shards"]) if topo else 1
        if replicas is None:
            replicas = (int(topo["replicas"]) if topo
                        else self.replication)
        journal_dir = os.path.abspath(journal_dir)
        self._pending_model = {
            "journal_dir": journal_dir, "topic": topic,
            "model_id": model_id or topic,
            "rolled_out_at": time.time(),
            "verify_min_rows": int(verify_min_rows),
            "probe": probe,
        }
        prev_binding = (self.journal_dir, self.topic)
        # the inherited _spawn_generation reads self.journal_dir/topic —
        # rebinding them IS how generation g+1 gets the new model
        self.journal_dir, self.topic = journal_dir, topic
        try:
            return self.scale_to(shards, replicas, force=True)
        except Exception:
            self.journal_dir, self.topic = prev_binding
            raise
        finally:
            self._pending_model = None

    def rollback(self, *, verify_min_rows: int = 0) -> dict:
        """One-command rollback: re-serve the PREVIOUS model.

        Reads the newest history entry whose model binding differs from
        the active one and rolls it out as a fresh generation — same
        zero-failed-queries cutover, snapshot-fast because the previous
        model's snapshot family was retained under its own journal dir."""
        topo = self.current()
        if topo is None:
            raise RolloutError(
                f"group {self.group!r} has no topology to roll back")
        cur = (topo.get("model") or {})
        cur_key = (cur.get("journal_dir"), cur.get("topic"))
        for h in reversed(list(topo.get("history", ()))):
            m = h.get("model")
            if m and (m.get("journal_dir"), m.get("topic")) != cur_key:
                self._event("rollback", from_gen=int(topo["gen"]),
                            to_model=m.get("model_id"))
                return self.rollout(
                    m["journal_dir"], m["topic"],
                    model_id=m.get("model_id"),
                    shards=int(h.get("shards", topo["shards"])),
                    replicas=int(h.get("replicas", topo["replicas"])),
                    verify_min_rows=verify_min_rows,
                )
        raise RolloutError(
            f"group {self.group!r}: no previous model in the topology "
            "history to roll back to")

    def status(self) -> dict:
        """The active record plus the rollback candidate, for operators."""
        topo = self.current() or {}
        cur = topo.get("model") or {}
        prev = None
        cur_key = (cur.get("journal_dir"), cur.get("topic"))
        for h in reversed(list(topo.get("history", ()))):
            m = h.get("model")
            if m and (m.get("journal_dir"), m.get("topic")) != cur_key:
                prev = m
                break
        return {"group": self.group, "topology": topo or None,
                "model": cur or None, "rollback_to": prev}


def main(argv=None) -> int:
    from ..core.formats import read_ratings
    from ..core.params import Params

    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    if not params.has("group"):
        print(__doc__)
        return 2
    ctl = RolloutController(
        params.get_required("group"),
        port_dir=params.get("portDir", None),
        tenant=params.get("tenant", None),
        state=params.get("state", "ALS_MODEL"),
        state_backend=params.get("stateBackend", "memory"),
        replication=params.get_int("replication", 1),
        ready_timeout_s=float(params.get("readyTimeoutS", "180")),
        snapshots=(params.get_bool("snapshots", True) or None),
        device=params.get("device", "cuda"),
    )
    if params.has("status"):
        print(json.dumps(ctl.status(), indent=1, default=str))
        return 0
    try:
        if params.has("rollback"):
            record = ctl.rollback(
                verify_min_rows=params.get_int("verifyMinRows", 0))
        else:
            probe = None
            if params.has("probeRatings"):
                users, items, ratings = read_ratings(
                    params.get_required("probeRatings"),
                    field_delimiter=params.get("fieldDelimiter", "\t"),
                    ignore_first_line=params.get_bool("ignoreFirstLine",
                                                      True))
                probe = {"users": users, "items": items,
                         "ratings": ratings,
                         "max_mse": float(
                             params.get("probeMaxMse", "1e9"))}
            record = ctl.rollout(
                params.get_required("journalDir"),
                params.get("topic", "models"),
                model_id=params.get("modelId", None),
                shards=(params.get_int("shards", 0) or None),
                replicas=(params.get_int("replication", 0) or None),
                verify_min_rows=params.get_int("verifyMinRows", 0),
                probe=probe,
            )
    except (RolloutError, ScaleError, registry.TopologyConflict) as e:
        print(f"rollout failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"group": ctl.group, "gen": record["gen"],
                      "shards": record["shards"],
                      "replicas": record["replicas"],
                      "model": record.get("model")}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
