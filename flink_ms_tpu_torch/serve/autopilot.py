"""Continuous-training autopilot: the unattended train->serve->update->
retrain flywheel, with its training step on one CUDA card.

Own copy of ``flink_ms_tpu/serve/autopilot.py``.  The controller
(``AutopilotController``: lease, windowing, evaluation, rollout, drift
watch, state record, metrics and events) and its CLI are the reference's;
its training step is ``retrain_candidate``, the port's warm-started ALS on
``device`` (default ``cuda``) through the card's kernels.  The state
record, window files, candidate journals and registry records are the
reference's, so either package resumes the other's loop.

The controller ties five subsystems (update-plane journals, warm-started
ALS, the held-out evaluator, blue/green rollout, the canary's drift
signal) into one closed loop::

    idle -> windowing -> training -> evaluating -> rolling-out -> watching
      ^        |            |            |              |            |
      +--------+------------+------------+--------------+------------+

Per tick (``TPUMS_AUTOPILOT_INTERVAL_S``):

1. **watching** — if the ``model_drift`` alert is firing (the registry's
   alert record), or the live canary MSE (``tpums_model_live_mse``) has
   regressed past the rollout-time probe by ``drift_factor``, drive
   ``RolloutController.rollback()``: one command, zero failed queries,
   previous answers restored.  Disarmed after a rollback until the next
   rollout, so one incident cannot ping-pong the fleet.
2. **windowing** — tail NEW ratings out of the update plane's
   per-partition input journals (``<topic>.upd<p>``; offsets persist
   across restarts, truncated offsets reset through the compacted prefix)
   into the accumulated last-write-wins training set; when at least
   ``min_window`` new ratings arrived, seal a VERSIONED window file.
3. **training** — ALS retrain warm-started from the current serving
   factors (``ops/als.py warm_start_factors``; novel ids fall back to the
   cold seed draw).
4. **evaluating** — candidate vs incumbent on the window's rolling
   held-out slice (``eval/mse.rolling_holdout_split``) through
   ``eval/mse.compute_mse``'s exact reference grouping: the SAME statistic
   the live canary publishes.
5. **rolling-out** — when the candidate wins by at least ``improvement``,
   ``RolloutController.rollout()`` with a row-count floor and a held-out
   MSE probe gate; the candidate's held-out MSE is persisted as the drift
   baseline for step 1.

Crash safety: a single JSON state record (``autopilot_state.json``,
atomic tmp+rename) holds the partition offsets, window/model versions and
the drift baseline; the controller runs under its OWN registry lease
scope (``<group>#autopilot``, distinct from the group lease ``rollout()``
itself takes), and a SIGKILLed holder's lease is stolen by the next
process, which resumes from the persisted record.  Serving never depends
on the autopilot being alive.

Metrics: ``tpums_autopilot_*`` counters/gauges through the process
registry, read fleet-wide by ``obs/scrape.fleet_signals``.

CLI::

    python -m flink_ms_tpu_torch.serve.autopilot --group als \\
        --ratingsDir /data/bus --workDir /data/autopilot \\
        [--topic models] [--bootstrap /data/v0 --shards 2] \\
        [--duration 60 | --once] [--interval 2] [--minWindow 200] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import formats as F
from ..obs.metrics import get_registry
from ..obs.tracing import event
from ..parallel.mesh import resolve_device
from . import registry
from .elastic import ControllerBusy, ScaleError
from .journal import Journal
from .rollout import RolloutController, RolloutError, VerificationError
from .update_plane import default_partitions, input_topic

__all__ = ["AutopilotController", "PHASES", "autopilot_scope", "main",
           "read_model_tables", "retrain_candidate"]

# the state machine, in gauge order (tpums_autopilot_phase publishes the
# index so a scrape can plot transitions)
PHASES = ("idle", "windowing", "training", "evaluating", "rolling-out",
          "watching", "standby")
_PHASE_LEVEL = {name: i for i, name in enumerate(PHASES)}

STATE_FILE = "autopilot_state.json"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def autopilot_scope(group: str) -> str:
    """The autopilot's OWN controller-lease scope.  Distinct from the
    group scope because ``ScaleController.scale_to`` (which ``rollout()``
    drives) takes the group lease itself: an autopilot leasing the group
    would deadlock against its own rollout."""
    return f"{group}#autopilot"


def read_model_tables(journal_dir: str, topic: str
                      ) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """A model journal's factors keyed by raw numeric id -> (users, items),
    as the reference's ``_incumbent_tables`` reads the serving model (rows
    that are not ``<int>,U|I,...``, a MEAN row say, are skipped)."""
    users: Dict[int, np.ndarray] = {}
    items: Dict[int, np.ndarray] = {}
    for line in Journal(journal_dir, topic).read_lines():
        try:
            id_, typ, vec = F.parse_als_row(line)
            id_n = int(id_)
        except ValueError:
            continue
        (users if typ == F.USER else items)[id_n] = vec
    return users, items


def retrain_candidate(
    work_dir: str,
    topic: str,
    model_seq: int,
    version: int,
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    incumbent=({}, {}),
    *,
    num_factors: int = 8,
    iterations: int = 4,
    lambda_: float = 0.1,
    holdout_fraction: float = 0.2,
    seed: int = 42,
    device="cuda",
) -> dict:
    """Warm-started retrain of window `version` -> the candidate
    ``{model_id, journal_dir, tables, rows, heldout, warm, train_s}``.

    - the window splits by ``rolling_holdout_split`` with seed
      ``seed + version``;
    - `incumbent` is the serving model's (users, items) factors keyed by
      raw numeric id; when both are non-empty, ``warm_start_factors``
      aligns them onto the train slice's ids (unseen ids get the cold
      draw from `seed`) and the fit starts there, else it starts cold;
    - the port's ``als_fit`` trains `iterations` on the train slice on
      `device`; ``train_s`` is its wall time, the copy of the factors to
      the host included;
    - `model_seq` is the last candidate number used: this candidate is
      ``auto-v{model_seq + 1:06d}``, its journal ``<work_dir>/models/<id>``
      with one topic `topic`;
    - ``tables`` maps ``"<id>-U"`` / ``"<id>-I"`` to the f32 factor rows,
      ``rows`` counts them, ``heldout`` is the held-out (users, items,
      ratings).

    The defaults are the reference controller's (``TPUMS_AUTOPILOT_*``
    unset)."""
    from ..eval.mse import rolling_holdout_split
    from ..ops.als import ALSConfig, als_fit, warm_start_factors
    from ..parallel.mesh import resolve_device

    dev = resolve_device(device)
    users, items, ratings = (np.asarray(users), np.asarray(items),
                             np.asarray(ratings))
    train_idx, hold_idx = rolling_holdout_split(
        users, items, ratings, fraction=holdout_fraction,
        seed=seed + version)
    tr_u, tr_i, tr_r = users[train_idx], items[train_idx], ratings[train_idx]
    prev_u, prev_i = incumbent
    k = num_factors
    kw = {}
    warm = bool(prev_u and prev_i)
    if warm:
        uf0, itf0 = warm_start_factors(np.unique(tr_u), np.unique(tr_i),
                                       prev_u, prev_i, k, seed=seed)
        kw = {"init_user_factors": uf0, "init_item_factors": itf0}
    t0 = time.perf_counter()
    config = ALSConfig(num_factors=k, iterations=iterations,
                       lambda_=lambda_, seed=seed)
    model = als_fit(tr_u, tr_i, tr_r, config, device=dev, **kw)
    user_factors = model.user_factors.cpu().numpy()
    item_factors = model.item_factors.cpu().numpy()
    train_s = time.perf_counter() - t0

    seq = int(model_seq) + 1
    model_id = f"auto-v{seq:06d}"
    models = os.path.join(os.path.abspath(work_dir), "models")
    os.makedirs(models, exist_ok=True)
    final = os.path.join(models, model_id)
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    j = Journal(tmp, topic)
    j.append(
        [F.format_als_row(int(uid), F.USER, vec) for uid, vec
         in zip(model.user_ids, user_factors)]
        + [F.format_als_row(int(iid), F.ITEM, vec) for iid, vec
           in zip(model.item_ids, item_factors)])
    j.sync()
    if os.path.isdir(final):
        shutil.rmtree(final)  # a crashed cycle's leftover
    os.rename(tmp, final)
    tables = {f"{int(u)}-U": vec for u, vec
              in zip(model.user_ids, user_factors)}
    tables.update({f"{int(i)}-I": vec for i, vec
                   in zip(model.item_ids, item_factors)})
    return {
        "model_id": model_id, "journal_dir": final, "tables": tables,
        "rows": len(model.user_ids) + len(model.item_ids),
        "heldout": (users[hold_idx], items[hold_idx], ratings[hold_idx]),
        "warm": warm, "train_s": train_s,
    }


class AutopilotController:
    """The unattended retrain loop for one serving group (see module
    docstring).  Use ``tick()`` synchronously (tests, ``--once``) or
    ``start()``/``stop()`` for the background loop."""

    def __init__(
        self,
        group: str,
        ratings_dir: str,
        work_dir: str,
        *,
        topic: str = "models",
        tenant: Optional[str] = None,
        rollout: Optional[RolloutController] = None,
        rollout_kw: Optional[dict] = None,
        interval_s: Optional[float] = None,
        min_window: Optional[int] = None,
        improvement: Optional[float] = None,
        holdout_fraction: Optional[float] = None,
        iterations: Optional[int] = None,
        num_factors: Optional[int] = None,
        lambda_: float = 0.1,
        drift_source: Optional[str] = None,
        drift_factor: Optional[float] = None,
        drift_rule: str = "model_drift",
        partitions: Optional[int] = None,
        max_probe: int = 256,
        seed: int = 42,
        lease_ttl_s: Optional[float] = None,
        live_mse=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.ratings_dir = ratings_dir
        self.topic = topic
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(os.path.join(self.work_dir, "windows"), exist_ok=True)
        os.makedirs(os.path.join(self.work_dir, "models"), exist_ok=True)
        if rollout is None:
            kw = {"device": self.device.type, **(rollout_kw or {})}
            rollout = RolloutController(group, tenant=tenant, **kw)
        self.rollout_ctl = rollout
        self.group = self.rollout_ctl.group  # tenant-qualified
        self.interval_s = (
            _env_float("TPUMS_AUTOPILOT_INTERVAL_S", 2.0)
            if interval_s is None else float(interval_s))
        self.min_window = (
            _env_int("TPUMS_AUTOPILOT_MIN_WINDOW", 100)
            if min_window is None else int(min_window))
        self.improvement = (
            _env_float("TPUMS_AUTOPILOT_IMPROVEMENT", 0.0)
            if improvement is None else float(improvement))
        self.holdout_fraction = (
            _env_float("TPUMS_AUTOPILOT_HOLDOUT", 0.2)
            if holdout_fraction is None else float(holdout_fraction))
        self.iterations = (
            _env_int("TPUMS_AUTOPILOT_ITERS", 4)
            if iterations is None else int(iterations))
        self.num_factors = (
            _env_int("TPUMS_AUTOPILOT_FACTORS", 8)
            if num_factors is None else int(num_factors))
        self.lambda_ = lambda_
        self.drift_source = (
            os.environ.get("TPUMS_AUTOPILOT_DRIFT_SOURCE", "both")
            if drift_source is None else drift_source)
        if self.drift_source not in ("alert", "gauge", "both", "off"):
            raise ValueError(
                f"drift_source must be alert|gauge|both|off, "
                f"got {self.drift_source!r}")
        self.drift_factor = (
            _env_float("TPUMS_AUTOPILOT_DRIFT_FACTOR", 1.5)
            if drift_factor is None else float(drift_factor))
        self.drift_rule = drift_rule
        self.partitions = partitions or default_partitions()
        self.max_probe = int(max_probe)
        self.seed = int(seed)
        self.lease_ttl_s = lease_ttl_s
        self._live_mse_fn = live_mse
        self._scope = autopilot_scope(self.group)
        self._token: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.last_error: Optional[str] = None
        # accumulated LWW training set: (user, item) -> rating
        self._acc: Dict[Tuple[int, int], float] = {}
        self.state = self._load_state()
        self._restore_window()

    # -- persisted state ---------------------------------------------------

    @property
    def state_path(self) -> str:
        return os.path.join(self.work_dir, STATE_FILE)

    def _load_state(self) -> dict:
        try:
            with open(self.state_path) as f:
                rec = json.load(f)
            if rec.get("kind") == "autopilot":
                return rec
        except (OSError, ValueError):
            pass
        return {
            "kind": "autopilot", "group": self.group, "phase": "idle",
            "offsets": {}, "window_version": 0, "window_rows": 0,
            "trained_version": 0, "model_seq": 0,
            "rollout_probe_mse": None, "incumbent_model_id": None,
            "drift_armed": False, "heldout_mse": None,
            "retrains": 0, "rollouts": 0, "rollbacks": 0,
            "wins": 0, "losses": 0, "updated_at": 0.0,
        }

    def _save_state(self) -> None:
        self.state["updated_at"] = time.time()
        tmp = f"{self.state_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
        os.replace(tmp, self.state_path)

    def _window_path(self, version: int) -> str:
        return os.path.join(self.work_dir, "windows",
                            f"window-v{version:06d}.tsv")

    def _restore_window(self) -> None:
        """Rebuild the in-memory LWW set from the last sealed window file
        (crash/restart path).  Offsets in the state record point at the
        first UNWINDOWED rating, so the tail picks up exactly after it."""
        v = int(self.state.get("window_version", 0))
        if v <= 0:
            return
        path = self._window_path(v)
        try:
            users, items, ratings = F.read_ratings(
                path, field_delimiter="\t", ignore_first_line=True)
        except OSError:
            return
        for u, i, r in zip(users, items, ratings):
            self._acc[(int(u), int(i))] = float(r)

    # -- lease -------------------------------------------------------------

    def _ensure_lease(self) -> bool:
        if self._token is not None:
            if registry.refresh_controller_lease(self._scope, self._token):
                return True
            self._token = None
        self._token = registry.acquire_controller_lease(
            self._scope, ttl_s=self.lease_ttl_s)
        if self._token is not None:
            event("autopilot_lease_acquired", group=self.group)
            return True
        return False

    def release_lease(self) -> None:
        if self._token is not None:
            registry.release_controller_lease(self._scope, self._token)
            self._token = None

    # -- metrics / phase ---------------------------------------------------

    def _set_phase(self, phase: str) -> None:
        self.state["phase"] = phase
        get_registry().gauge("tpums_autopilot_phase").set(
            _PHASE_LEVEL[phase])
        # the chaos harness targets its SIGKILLs by polling the persisted
        # phase, so every transition must reach disk, not just the gauge
        self._save_state()

    def _publish_gauges(self) -> None:
        reg = get_registry()
        reg.gauge("tpums_autopilot_window_rows").set(len(self._acc))
        if self.state.get("heldout_mse") is not None:
            reg.gauge("tpums_autopilot_heldout_mse").set(
                self.state["heldout_mse"])
        reg.gauge("tpums_autopilot_lease_held").set(
            1.0 if self._token else 0.0)

    def _count(self, name: str, key: str) -> None:
        self.state[key] = int(self.state.get(key, 0)) + 1
        get_registry().counter(f"tpums_autopilot_{name}_total").inc()

    # -- windowing ---------------------------------------------------------

    def _tail_ratings(self) -> int:
        """Drain every partition's input journal from the persisted
        offsets into the LWW set -> number of new rating rows."""
        offsets = self.state.setdefault("offsets", {})
        new_rows = 0
        for p in range(self.partitions):
            j = Journal(self.ratings_dir, input_topic(self.topic, p))
            off = int(offsets.get(str(p), j.start_offset()))
            while True:
                lines, off2 = j.read_from(off, on_truncated="reset")
                if not lines and off2 == off:
                    break
                for line in lines:
                    try:
                        _seq, u, i, r = line.split("\t")
                        self._acc[(int(u), int(i))] = float(r)
                        new_rows += 1
                    except ValueError:
                        continue  # torn/foreign line: not a rating
                off = off2
            offsets[str(p)] = off
        return new_rows

    def _seal_window(self) -> Tuple[int, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """Materialize the accumulated set as the next versioned training
        window (atomic file publish, then the state record advances)."""
        version = int(self.state["window_version"]) + 1
        keys = sorted(self._acc)
        users = np.asarray([k[0] for k in keys], dtype=np.int64)
        items = np.asarray([k[1] for k in keys], dtype=np.int64)
        ratings = np.asarray([self._acc[k] for k in keys],
                             dtype=np.float64)
        path = self._window_path(version)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write("user\titem\trating\n")
            for u, i, r in zip(users, items, ratings):
                f.write(f"{int(u)}\t{int(i)}\t{float(r)!r}\n")
        os.replace(tmp, path)
        prev = self._window_path(version - 1)
        if os.path.exists(prev):
            os.unlink(prev)  # the newest window subsumes it (LWW set)
        self.state["window_version"] = version
        self.state["window_rows"] = len(keys)
        self._save_state()
        self._count("windows", "windows")
        return version, users, items, ratings

    # -- training ----------------------------------------------------------

    def _incumbent_tables(self) -> Tuple[Dict[int, np.ndarray],
                                         Dict[int, np.ndarray]]:
        """The served model's factors keyed by raw numeric id (warm-start
        source + incumbent side of the evaluation)."""
        topo = self.rollout_ctl.current() or {}
        model = topo.get("model") or {}
        jd, tp = model.get("journal_dir"), model.get("topic")
        if not jd or not tp or not os.path.isdir(jd):
            return {}, {}
        try:
            return read_model_tables(jd, tp)
        except OSError:
            return {}, {}

    def _train(self, version: int, users: np.ndarray, items: np.ndarray,
               ratings: np.ndarray) -> dict:
        """Warm-started retrain on the window's train slice on the card
        (``retrain_candidate``) -> candidate ``{model_id, journal_dir,
        tables, rows, heldout, warm, train_s}``."""
        candidate = retrain_candidate(
            self.work_dir, self.topic, int(self.state["model_seq"]), version,
            users, items, ratings, self._incumbent_tables(),
            num_factors=self.num_factors, iterations=self.iterations,
            lambda_=self.lambda_, holdout_fraction=self.holdout_fraction,
            seed=self.seed, device=self.device)
        get_registry().gauge("tpums_autopilot_last_retrain_s").set(
            candidate["train_s"])
        self._count("retrains", "retrains")
        # trained_version is NOT advanced here: the window only counts as
        # trained once the rollout decision concluded (tick()), so a
        # SIGKILL mid-retrain OR mid-rollout makes the next lease holder
        # redo the whole unit from the sealed window (model_seq IS
        # durable: candidate dirs never collide across crashes)
        self.state["model_seq"] = int(self.state["model_seq"]) + 1
        self._save_state()
        event("autopilot_retrain", group=self.group,
              model_id=candidate["model_id"], window_version=version,
              rows=len(ratings) - len(candidate["heldout"][2]),
              warm_start=candidate["warm"],
              train_s=round(candidate["train_s"], 3))
        return candidate

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _table_mse(table: Dict[str, np.ndarray], users, items, ratings
                   ) -> Tuple[Optional[float], int]:
        from ..eval.mse import compute_mse

        def lookup(key):
            return table.get(key)

        def lookup_many(keys):
            return [table.get(k) for k in keys]

        mse, n_scored, _ = compute_mse(users, items, ratings, lookup,
                                       lookup_many=lookup_many)
        return mse, n_scored

    def _evaluate(self, candidate: dict) -> dict:
        """Candidate vs incumbent on the held-out slice — exact
        ``compute_mse`` grouping on both sides, same slice, so the
        comparison is one statistic, not two."""
        h_u, h_i, h_r = candidate["heldout"]
        cand_mse, cand_scored = self._table_mse(
            candidate["tables"], h_u, h_i, h_r)
        prev_u, prev_i = self._incumbent_tables()
        inc_table = {f"{u}-U": v for u, v in prev_u.items()}
        inc_table.update({f"{i}-I": v for i, v in prev_i.items()})
        inc_mse, inc_scored = (self._table_mse(inc_table, h_u, h_i, h_r)
                               if inc_table else (None, 0))
        cand_mse = None if cand_mse is None else float(cand_mse)
        inc_mse = None if inc_mse is None else float(inc_mse)
        win = bool(cand_mse is not None and (
            inc_mse is None
            or cand_mse <= inc_mse * (1.0 - self.improvement)))
        if cand_mse is not None:
            self.state["heldout_mse"] = float(cand_mse)
            get_registry().gauge("tpums_autopilot_heldout_mse").set(
                float(cand_mse))
        self._count("wins" if win else "losses",
                    "wins" if win else "losses")
        self._save_state()
        return {"candidate_mse": cand_mse, "incumbent_mse": inc_mse,
                "candidate_scored": cand_scored,
                "incumbent_scored": inc_scored, "win": win}

    # -- rollout / rollback ------------------------------------------------

    def _probe_slice(self, heldout) -> dict:
        h_u, h_i, h_r = heldout
        if len(h_r) > self.max_probe:
            idx = np.linspace(0, len(h_r) - 1, self.max_probe).astype(int)
            h_u, h_i, h_r = h_u[idx], h_i[idx], h_r[idx]
        return {"users": h_u, "items": h_i, "ratings": h_r}

    def _roll_out(self, candidate: dict, evaluation: dict) -> dict:
        probe = self._probe_slice(candidate["heldout"])
        cand_mse = evaluation["candidate_mse"]
        # gate: the warming generation must reproduce the offline score
        # (loose factor: the probe subsamples the slice, and a row-floor
        # failure should abort loudly, not a sampling wobble)
        probe["max_mse"] = max(cand_mse * 2.0, cand_mse + 0.5)
        record = self.rollout_ctl.rollout(
            candidate["journal_dir"], self.topic,
            model_id=candidate["model_id"],
            verify_min_rows=candidate["rows"], probe=probe)
        self._count("rollouts", "rollouts")
        self.state["rollout_probe_mse"] = float(cand_mse)
        self.state["incumbent_model_id"] = candidate["model_id"]
        self.state["drift_armed"] = True
        self._save_state()
        event("autopilot_rollout", group=self.group,
              model_id=candidate["model_id"], gen=record.get("gen"),
              heldout_mse=round(float(cand_mse), 6))
        return record

    def _live_mse(self) -> Optional[float]:
        if self._live_mse_fn is not None:
            try:
                v = self._live_mse_fn()
            except Exception:
                return None
            return None if v is None else float(v)
        v = get_registry().gauge("tpums_model_live_mse").value
        return v if v > 0.0 else None  # 0 = the canary never scored

    def _drift_fired(self) -> Optional[str]:
        if self.drift_source == "off" or not self.state.get("drift_armed"):
            return None
        if self.drift_source in ("alert", "both"):
            rec = registry.resolve_alerts()
            for alert in (rec or {}).get("alerts", ()):
                if alert.get("rule") == self.drift_rule:
                    return f"alert:{self.drift_rule}"
        if self.drift_source in ("gauge", "both"):
            baseline = self.state.get("rollout_probe_mse")
            live = self._live_mse()
            if baseline is not None and live is not None and \
                    live > baseline * self.drift_factor:
                return (f"live_mse {live:.4f} > "
                        f"{self.drift_factor:g}x probe {baseline:.4f}")
        return None

    def _roll_back(self, reason: str) -> Optional[dict]:
        try:
            record = self.rollout_ctl.rollback()
        except (RolloutError, VerificationError) as e:
            self.last_error = f"rollback: {e}"
            return None
        self._count("rollbacks", "rollbacks")
        # disarm until the next rollout: the alert needs a few canary
        # rounds to resolve, and re-rolling back during them would
        # ping-pong between the only two models in history
        self.state["drift_armed"] = False
        self.state["rollout_probe_mse"] = None
        self.state["incumbent_model_id"] = (
            record.get("model") or {}).get("model_id")
        self._save_state()
        event("autopilot_rollback", group=self.group, reason=reason,
              restored=self.state["incumbent_model_id"],
              gen=record.get("gen"))
        return record

    # -- one tick ----------------------------------------------------------

    def tick(self) -> dict:
        """One pass of the state machine -> what happened this tick."""
        out: dict = {"ts": time.time(), "group": self.group}
        self.ticks += 1
        if not self._ensure_lease():
            out["state"] = "standby"
            get_registry().gauge("tpums_autopilot_phase").set(
                _PHASE_LEVEL["standby"])
            self._publish_gauges()
            return out
        try:
            self._set_phase("watching")
            reason = self._drift_fired()
            if reason is not None:
                out["drift"] = reason
                rec = self._roll_back(reason)
                out["rollback"] = rec.get("gen") if rec else None
                self._set_phase("idle")
                return out
            self._set_phase("windowing")
            new_rows = self._tail_ratings()
            out["new_ratings"] = new_rows
            pending = int(self.state["window_version"]) > \
                int(self.state["trained_version"])
            if new_rows < self.min_window and not pending:
                # not enough new signal: persist the offsets we advanced
                # past non-rating lines, but don't seal a window
                self._set_phase("idle")
                return out
            if pending:
                # a previous holder sealed this window then died before
                # training: resume it instead of sealing another
                version = int(self.state["window_version"])
                users, items, ratings = F.read_ratings(
                    self._window_path(version), field_delimiter="\t",
                    ignore_first_line=True)
                out["resumed_window"] = version
            else:
                version, users, items, ratings = self._seal_window()
            out["window_version"] = version
            out["window_rows"] = len(ratings)
            self._set_phase("training")
            candidate = self._train(version, users, items, ratings)
            out["model_id"] = candidate["model_id"]
            out["warm_start"] = candidate["warm"]
            out["train_s"] = round(candidate["train_s"], 3)
            self._set_phase("evaluating")
            evaluation = self._evaluate(candidate)
            out.update({k: evaluation[k] for k in
                        ("candidate_mse", "incumbent_mse", "win")})
            if evaluation["win"]:
                self._set_phase("rolling-out")
                try:
                    record = self._roll_out(candidate, evaluation)
                    out["rollout_gen"] = record.get("gen")
                except (RolloutError, VerificationError, ControllerBusy,
                        ScaleError, registry.TopologyConflict) as e:
                    # refused candidates never reach traffic; the active
                    # generation kept serving (scale_to's abort contract)
                    self.last_error = f"rollout: {e}"
                    out["rollout_error"] = str(e)
            # the train->evaluate->rollout unit concluded (rolled out,
            # lost, or cleanly refused): the window is consumed
            self.state["trained_version"] = version
            self._set_phase("watching")
            return out
        finally:
            self._publish_gauges()

    # -- lifecycle ---------------------------------------------------------

    def run(self, duration_s: Optional[float] = None) -> dict:
        """Tick on the cadence until ``duration_s`` (or stop()) — the CLI
        foreground loop."""
        t_end = None if duration_s is None else time.time() + duration_s
        while not self._stop.is_set():
            t0 = time.time()
            if t_end is not None and t0 >= t_end:
                break
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self.last_error = f"{type(e).__name__}: {e}"
                event("autopilot_tick_error", group=self.group,
                      error=self.last_error)
            self._stop.wait(max(self.interval_s - (time.time() - t0),
                                0.01))
        return self.summary()

    def start(self) -> "AutopilotController":
        if self._thread is not None:
            raise RuntimeError("autopilot already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="tpums-autopilot")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(30.0, 3 * self.interval_s))
            self._thread = None
        self.release_lease()

    def __enter__(self) -> "AutopilotController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> dict:
        """The artifact section bench/chaos runs record."""
        return {
            "group": self.group, "ticks": self.ticks,
            "phase": self.state.get("phase"),
            "window_version": self.state.get("window_version"),
            "window_rows": len(self._acc),
            "retrains": self.state.get("retrains", 0),
            "rollouts": self.state.get("rollouts", 0),
            "rollbacks": self.state.get("rollbacks", 0),
            "wins": self.state.get("wins", 0),
            "losses": self.state.get("losses", 0),
            "heldout_mse": self.state.get("heldout_mse"),
            "rollout_probe_mse": self.state.get("rollout_probe_mse"),
            "incumbent_model_id": self.state.get("incumbent_model_id"),
            "last_error": self.last_error,
        }


def main(argv=None) -> int:
    from ..core.params import Params

    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    if not params.has("group") or not params.has("ratingsDir") \
            or not params.has("workDir"):
        print(__doc__)
        return 2
    pilot = AutopilotController(
        params.get_required("group"),
        params.get_required("ratingsDir"),
        params.get_required("workDir"),
        topic=params.get("topic", "models"),
        tenant=params.get("tenant", None),
        interval_s=(float(params.get("interval"))
                    if params.has("interval") else None),
        min_window=(params.get_int("minWindow", 0) or None),
        iterations=(params.get_int("iterations", 0) or None),
        num_factors=(params.get_int("numFactors", 0) or None),
        device=params.get("device", "cuda"),
        rollout_kw={
            "port_dir": params.get("portDir", None),
            "replication": params.get_int("replication", 1),
            "ready_timeout_s": float(params.get("readyTimeoutS", "180")),
        },
    )
    # bootstrap: a fresh group with no topology gets generation 1 from
    # the seed model so the flywheel has an incumbent to improve on.
    # Bare --bootstrap (no journal dir) is also legal: the first tick
    # cold-trains gen 1 from the accumulated window itself — there is no
    # incumbent, so the candidate wins by definition and rolls out.
    if params.has("bootstrap") and pilot.rollout_ctl.current() is None:
        seed_dir = params.get("bootstrap", None)
        if seed_dir:
            record = pilot.rollout_ctl.rollout(
                seed_dir,
                params.get("topic", "models"),
                model_id=params.get("bootstrapModelId", "seed"),
                shards=params.get_int("shards", 1))
            print(json.dumps({"bootstrap_gen": record["gen"]}), flush=True)
    try:
        if params.has("once"):
            result = pilot.tick()
            print(json.dumps(result, indent=1, default=str))
        else:
            duration = (float(params.get("duration"))
                        if params.has("duration") else None)
            pilot.run(duration_s=duration)
            print(json.dumps(pilot.summary(), indent=1, default=str))
    except KeyboardInterrupt:
        pass
    finally:
        pilot.release_lease()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
