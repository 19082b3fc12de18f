"""MSE evaluator: the mean squared error of a ratings set against an ALS
model.

Counterpart of ``flink_ms_tpu/eval/mse.py`` (itself the counterpart of
``MSE.java``).  The ``--model path[,path...]`` mode reads model row files
and computes every prediction in one batched device pass through
``ops.als.predict``:

    python -m flink_ms_tpu_torch.eval.mse --device cuda \\
        --input ratings.tsv --model uf,itf

Flags beyond the reference: ``--device cuda|cpu`` (default cuda; no silent
fallback).  The live mode, which asks a running serving job for each row
(``--jobId ...``), needs the serving job, which is not ported yet
(ROADMAP.md, Queue 1, item 'Serving job'); without ``--model`` the CLI
refuses.

Skip semantics are the reference's: a missing user drops that user's whole
group (MSE.java:137-139), a missing item just that rating (:156-158).  The
input always skips its first line (MSE.java:43).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import formats as F
from ..core.params import Params, field_delimiter_from


def _load_model_tables(paths: str) -> Dict[str, np.ndarray]:
    """Read ALS rows from comma-separated paths into a {key: factors} map
    keyed like the serving state: ``"<id>-U"`` / ``"<id>-I"``."""
    table: Dict[str, np.ndarray] = {}
    for path in paths.split(","):
        for line in F.iter_lines(path):
            id_, typ, vec = F.parse_als_row(line)
            table[f"{id_}-{typ}"] = vec
    return table


def rolling_holdout_split(
    users,
    items,
    ratings,
    *,
    fraction: float = 0.2,
    seed: int = 0,
    min_train_per_user: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded, user-stratified held-out split -> (train_idx, holdout_idx).

    Per user with enough ratings, ``fraction`` of them (at least one, and
    never so many that fewer than ``min_train_per_user`` stay behind) go to
    the held-out side; users with too few ratings keep everything in
    train, so every held-out user has train-side ratings.  Deterministic in
    (inputs, seed); rolling windows pass ``seed=base + version``.  Returns
    positional indices, both sorted, disjoint and covering every row."""
    users = np.asarray(users)
    n = len(users)
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"fraction must be in (0, 1), got {fraction}")
    if len(np.asarray(items)) != n or len(np.asarray(ratings)) != n:
        raise ValueError("users/items/ratings length mismatch")
    rng = np.random.default_rng(seed)
    holdout: list = []
    order = np.argsort(users, kind="stable")
    sorted_users = users[order]
    # per-user index runs of the stable sort, visited in ascending user
    # order so the rng consumption does not depend on the input order
    starts = np.flatnonzero(
        np.r_[True, sorted_users[1:] != sorted_users[:-1]])
    ends = np.r_[starts[1:], n]
    for s, e in zip(starts, ends):
        grp = order[s:e]
        n_grp = len(grp)
        n_hold = min(max(int(round(fraction * n_grp)), 1),
                     n_grp - min_train_per_user)
        if n_hold <= 0:
            continue
        holdout.extend(rng.choice(grp, size=n_hold, replace=False).tolist())
    holdout_idx = np.sort(np.asarray(holdout, dtype=np.int64))
    mask = np.ones(n, dtype=bool)
    mask[holdout_idx] = False
    return np.flatnonzero(mask), holdout_idx


def compute_mse(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    lookup,
    lookup_many=None,
) -> Tuple[Optional[float], int, int]:
    """The reference's group and skip semantics over any key -> factors
    lookup.  ``lookup_many`` (optional) takes a list of keys and returns a
    payload or None per key: one round trip per user group.

    Returns (mse | None if nothing scored, n_scored, n_skipped)."""
    sq_sum = 0.0
    n_scored = 0
    n_skipped = 0
    for u in np.unique(users):
        sel = users == u
        group_items = items[sel]
        group_ratings = ratings[sel]
        if lookup_many is not None:
            keys = [f"{u}-U"] + [f"{it}-I" for it in group_items]
            payloads = lookup_many(keys)
            uf = payloads[0]
            item_payloads = payloads[1:]
        else:
            uf = lookup(f"{u}-U")
            item_payloads = None
        if uf is None:
            print(f"No record found for the user ID: {u}-U", file=sys.stderr)
            n_skipped += int(sel.sum())
            continue
        for j, (it, r) in enumerate(zip(group_items, group_ratings)):
            itf = item_payloads[j] if item_payloads is not None else lookup(f"{it}-I")
            if itf is None:
                print(
                    f"No record found for the itemID query: {it}-I", file=sys.stderr
                )
                n_skipped += 1
                continue
            pred = float(np.dot(uf, itf))
            sq_sum += (r - pred) ** 2
            n_scored += 1
    return (sq_sum / n_scored if n_scored else None), n_scored, n_skipped


def _compute_mse_offline_batched(
    users, items, ratings, table: Dict[str, np.ndarray], device="cuda"
) -> Tuple[Optional[float], int, int]:
    """compute_mse's semantics with every prediction in one device pass.
    The factors are float32 on the device, as the reference's device op
    holds them."""
    from ..ops.als import model_from_arrays, predict

    def numeric_ids(suffix: str):
        out = set()
        for key in table:
            if key.endswith(suffix):
                id_part = key[: -len(suffix)]
                # model dumps legitimately contain the MEAN cold-start row
                # (ALSMeanVector.scala:35); only numeric ids are scoreable
                if id_part.lstrip("-").isdigit():
                    out.add(int(id_part))
        return sorted(out)

    u_ids = numeric_ids("-U")
    i_ids = numeric_ids("-I")
    if not u_ids or not i_ids:
        return None, 0, len(ratings)
    model = model_from_arrays(
        np.asarray(u_ids), np.asarray(i_ids),
        np.stack([table[f"{u}-U"] for u in u_ids]).astype(np.float32),
        np.stack([table[f"{i}-I"] for i in i_ids]).astype(np.float32),
        device=device,
    )
    known_u = np.isin(users, model.user_ids)
    known_i = np.isin(items, model.item_ids)
    ok = known_u & known_i
    preds = predict(model, users[ok], items[ok], device=device)
    err = ratings[ok] - preds
    n_scored = int(ok.sum())
    return (
        (float(np.mean(err * err)) if n_scored else None),
        n_scored,
        int((~ok).sum()),
    )


def run(params: Params, lookup=None) -> Optional[float]:
    """The MSE of ``--input`` against ``--model`` on ``--device``, or
    against an injected ``lookup(key) -> factors | None``."""
    if not params.has("model") and lookup is None:
        raise ValueError(
            "the live mode (no --model) asks a running serving job, which "
            "is not ported yet: ROADMAP.md, Queue 1, item 'Serving job'; "
            "pass --model to evaluate model files"
        )
    delim = field_delimiter_from(params, default="tab")
    users, items, ratings = F.read_ratings(
        params.get_required("input"), field_delimiter=delim, ignore_first_line=True
    )

    if params.has("model"):
        table = _load_model_tables(params.get_required("model"))
        mse, n_scored, n_skipped = _compute_mse_offline_batched(
            users, items, ratings, table, device=params.get("device", "cuda")
        )
    else:
        mse, n_scored, n_skipped = compute_mse(users, items, ratings, lookup)

    if n_skipped:
        print(f"skipped {n_skipped} ratings with missing keys", file=sys.stderr)
    if mse is None:
        print("No predictions could be made (empty model?)", file=sys.stderr)
        return None
    if params.has("output"):
        F.write_lines(params.get_required("output"), [repr(float(mse))])
    else:
        print("Printing result to stdout. Use --output to specify output path.")
        print(mse)
    return mse


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
