"""The autopilot's warm-started retrain on one CUDA card.

Counterpart of ``AutopilotController._train`` in
``flink_ms_tpu/serve/autopilot.py``: the training step of the reference's
unattended train -> serve -> retrain loop.  ``retrain_candidate`` takes a
sealed ratings window and the incumbent (serving) model's factors, splits
off the rolling held-out slice, warm-starts ALS from the incumbent on the
train slice, writes the candidate as ``id,U|I,f1;...`` rows into a model
journal ``<work_dir>/models/auto-v%06d`` (written under a ``.tmp-<pid>``
name, synced, then renamed), and returns the reference's candidate dict.

The controller around it (windowing, lease, evaluation, rollout, drift
watch, registry and metrics events) is host code of the reference and is
not ported.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Tuple

import numpy as np

from ..core import formats as F
from .journal import Journal


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
