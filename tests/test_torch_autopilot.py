"""The autopilot's warm-started retrain in the port
(``flink_ms_tpu_torch/serve/autopilot.py`` ``retrain_candidate``) and the
journal writer it uses (``serve/journal.py``) against the JAX package's
``AutopilotController._train`` and ``Journal`` on the CPU.  With the
reference's threefry draws for unseen ids injected, the two candidates'
factors agree at the parity contract's rtol 1e-3 / atol 1e-5."""

import os

import jax
import numpy as np
import pytest
import torch

from flink_ms_tpu.eval.mse import compute_mse
from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.serve import journal as JJ
from flink_ms_tpu.serve.autopilot import AutopilotController, \
    _read_journal_lines
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.serve import autopilot as AP
from flink_ms_tpu_torch.serve.journal import Journal


class _StubRollout:
    group = "stub"

    def current(self):
        return None


def _window(rng, n_users=50, n_items=30, k_true=3, frac=0.6, noise=0.1):
    uf = rng.normal(size=(n_users, k_true))
    itf = rng.normal(size=(n_items, k_true))
    mask = rng.uniform(size=(n_users, n_items)) < frac
    u, i = np.nonzero(mask)
    r = (uf @ itf.T)[u, i] + noise * rng.normal(size=u.shape)
    return u.astype(np.int64) + 1, i.astype(np.int64) + 100, r


def _incumbent(u, i, r, k, drop_users=(), drop_items=()):
    """A fit on the window's ratings, with some ids left out so the warm
    start draws for them."""
    model = TA.als_fit(u, i, r, TA.ALSConfig(num_factors=k, iterations=6,
                                             lambda_=0.1), device="cpu")
    prev_u = {int(x): v for x, v in zip(model.user_ids,
                                        model.user_factors.numpy())
              if int(x) not in drop_users}
    prev_i = {int(x): v for x, v in zip(model.item_ids,
                                        model.item_factors.numpy())
              if int(x) not in drop_items}
    return prev_u, prev_i


def _reference_draws(monkeypatch, seed):
    """Make the port's ``warm_start_factors`` draw the reference's threefry
    init for unseen ids (``flink_ms_tpu/ops/als.py`` warm_start_factors:
    the split of PRNGKey(seed), users first)."""
    keys = list(jax.random.split(jax.random.PRNGKey(seed)))

    def draw(n, k, generator, dtype=torch.float32):
        return torch.from_numpy(np.array(
            JA.init_factors(n, k, keys.pop(0), np.float32)))

    monkeypatch.setattr(TA, "init_factors", draw)


def _reference_train(tmp_path, monkeypatch, incumbent, window, version,
                     **kw):
    ctl = AutopilotController("stub", str(tmp_path / "bus"),
                              str(tmp_path / "ref"), rollout=_StubRollout(),
                              partitions=1, **kw)
    monkeypatch.setattr(ctl, "_incumbent_tables", lambda: incumbent)
    return ctl._train(version, *window)


KW = dict(num_factors=4, iterations=3, lambda_=0.1, holdout_fraction=0.25,
          seed=42)


@pytest.mark.parametrize("version", [1, 3])
def test_candidate_matches_reference_train(tmp_path, monkeypatch, rng,
                                           version):
    window = _window(rng)
    incumbent = _incumbent(*window, 4, drop_users={3, 17}, drop_items={101})
    want = _reference_train(tmp_path, monkeypatch, incumbent, window, version,
                            **KW)
    _reference_draws(monkeypatch, KW["seed"])
    got = AP.retrain_candidate(str(tmp_path / "port"), "models", 0, version,
                               *window, incumbent, device="cpu", **KW)
    assert sorted(got) == sorted(want)
    assert got["model_id"] == want["model_id"] == "auto-v000001"
    assert got["rows"] == want["rows"] == len(got["tables"])
    assert got["warm"] is want["warm"] is True
    for a, b in zip(got["heldout"], want["heldout"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(got["tables"]) == sorted(want["tables"])
    for key, vec in want["tables"].items():
        np.testing.assert_allclose(got["tables"][key], vec, rtol=1e-3,
                                   atol=1e-5, err_msg=key)
    assert got["journal_dir"] == os.path.join(str(tmp_path / "port"),
                                              "models", "auto-v000001")
    assert got["train_s"] > 0


def test_reference_reader_reads_the_port_journal(tmp_path, rng):
    window = _window(rng, n_users=20, n_items=12)
    got = AP.retrain_candidate(str(tmp_path), "models", 6, 1, *window,
                               device="cpu", **KW)
    jd = got["journal_dir"]
    assert got["model_id"] == "auto-v000007" and got["warm"] is False
    assert sorted(os.listdir(os.path.dirname(jd))) == ["auto-v000007"]
    assert os.listdir(jd) == ["models.log"]
    lines = _read_journal_lines(jd, "models")
    assert lines == Journal(jd, "models").read_lines()
    assert len(lines) == got["rows"]
    # the candidate's rows as written, and parsed back to its tables
    users, items = AP.read_model_tables(jd, "models")
    assert len(users) + len(items) == got["rows"]
    for key, vec in got["tables"].items():
        id_, typ = key.split("-")
        table = users if typ == "U" else items
        assert np.array_equal(table[int(id_)], vec.astype(np.float64))
        assert vec.dtype == np.float32
    # users, then items, each in id order
    assert lines == [TF.format_als_row(*key.split("-"), vec)
                     for key, vec in got["tables"].items()]


def test_leftovers_of_a_crashed_cycle_are_replaced(tmp_path, rng):
    window = _window(rng, n_users=15, n_items=10)
    final = tmp_path / "models" / "auto-v000001"
    tmp = tmp_path / "models" / f"auto-v000001.tmp-{os.getpid()}"
    for d in (final, tmp):
        d.mkdir(parents=True)
        (d / "models.log").write_text("stale\n")
    got = AP.retrain_candidate(str(tmp_path), "models", 0, 1, *window,
                               device="cpu", **KW)
    assert sorted(os.listdir(tmp_path / "models")) == ["auto-v000001"]
    assert "stale" not in _read_journal_lines(got["journal_dir"], "models")


def test_warm_retrain_beats_cold_on_heldout(tmp_path, rng):
    """One warm iteration from the incumbent beats one cold iteration on
    the window's held-out slice (``tests/test_als.py:755``'s claim at the
    autopilot's level), both scored by the reference's MSE grouping."""
    u, i, r = _window(rng, n_users=60, n_items=40, noise=0.05)
    n_seed = int(0.8 * len(r))
    opt = TA.als_fit(u[:n_seed], i[:n_seed], r[:n_seed],
                     TA.ALSConfig(num_factors=3, iterations=12, lambda_=0.1),
                     device="cpu")
    incumbent = ({int(x): v for x, v in zip(opt.user_ids,
                                            opt.user_factors.numpy())},
                 {int(x): v for x, v in zip(opt.item_ids,
                                            opt.item_factors.numpy())})
    kw = dict(KW, num_factors=3, iterations=1, holdout_fraction=0.2)
    out = {}
    for label, inc in (("warm", incumbent), ("cold", ({}, {}))):
        cand = AP.retrain_candidate(str(tmp_path / label), "models", 0, 1,
                                    u, i, r, inc, device="cpu", **kw)
        assert cand["warm"] is (label == "warm")
        table = cand["tables"]
        mse, n, _ = compute_mse(*cand["heldout"], table.get,
                                lookup_many=lambda ks: [table.get(k)
                                                        for k in ks])
        assert n == len(cand["heldout"][2])
        out[label] = mse
    assert out["warm"] < out["cold"], out


def test_journal_append_matches_reference_offsets(tmp_path):
    lines = ["1,U,1.0;2.0", "2,I,0.5;-0.25", "MEAN,U,0.0;0.0"]
    port, ref = Journal(str(tmp_path / "p"), "t"), JJ.Journal(
        str(tmp_path / "r"), "t")
    assert port.append(lines[:2]) == ref.append(lines[:2])
    assert port.append(lines[2:], flush=False) == ref.append(lines[2:],
                                                             flush=False)
    port.sync()
    with open(port.path, "rb") as a, open(ref.path, "rb") as b:
        assert a.read() == b.read()
    assert _read_journal_lines(port.dir, "t") == lines
    assert port.read_lines() == lines
    with pytest.raises(ValueError, match="single lines"):
        port.append(["a\nb"])
    with pytest.raises(ValueError, match="invalid topic"):
        Journal(str(tmp_path), "../x")


def test_journal_appends_to_the_reference_active_segment(tmp_path):
    """A journal the reference wrote: the port appends to its segment, and
    the reference reads every line in order, up to its own end offset."""
    d = str(tmp_path / "j")
    ref = JJ.Journal(d, "t")
    for n in range(5):
        ref.append([f"{n},U,{n}.0;1.0"])
    port = Journal(d, "t")
    end = port.append(["9,I,2.0;3.0"])
    assert os.listdir(d) == ["t.log"]  # no new segment
    want = [f"{n},U,{n}.0;1.0" for n in range(5)] + ["9,I,2.0;3.0"]
    assert _read_journal_lines(d, "t") == want == port.read_lines()
    assert end == JJ.Journal(d, "t").end_offset()
