"""Rehearsals of ``chip_smoke.py``'s phase 20 (the closed loop) on the
CPU at a small size: every member and the autopilot's CLI a ``--device
cpu`` process, the tick's fit counting its launches through fakes of the
kernel wrappers that run the plain versions; and the cases where the phase
must fail.  (Phase 20 has a file of its own so that the suite's
file-by-file scheduling can run it beside the rehearsals of phases 10 to
19.)"""

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def fleet_base(monkeypatch):
    """Phase 17's published topic at a small size: random rank-8 rows
    (1,200 users, 1,100 items, the MEAN rows) and the one job's replies
    from ``fleet_baseline``; the fleet's sizes shrunk."""
    from flink_ms_tpu_torch.core import formats as F

    # arenas start small and grow with their rows, so their files stay
    # dense (deleting a sparse file can cost one discard per extent)
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    for name, value in (("FLEET_WINDOW_S", 0.5), ("FLEET_RATE_QPS", 100.0),
                        ("FLEET_WAIT_S", 90.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(0)
    uf, itf = rng.normal(size=(1200, 8)), rng.normal(size=(1100, 8))
    published = [F.format_als_row(u, "U", uf[u]) for u in range(1200)]
    published += [F.format_als_row(i, "I", itf[i]) for i in range(1100)]
    published += [F.format_als_row("MEAN", side, m.mean(axis=0))
                  for side, m in (("U", uf), ("I", itf))]
    return chip_smoke.fleet_baseline(published, torch.device("cpu"), 16)


@pytest.fixture
def counted(monkeypatch):
    """The fits' kernel wrappers replaced by fakes that count as each
    wrapper does where it launches its kernel, then run the plain
    versions (no kernel launches on the CPU)."""
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    chip_smoke.count_plain_versions(TA, CH, GA, TS, SK, monkeypatch.setattr)
    monkeypatch.setattr(chip_smoke, "RANK", 8)


@pytest.fixture
def small_loop(monkeypatch, fleet_base, counted):
    """Phase 20's sizes shrunk around ``fleet_base``'s rank-8 topic; the
    tick's fit counts its launches through ``counted``'s fakes."""
    for name, value in (("LOOP_USERS", 300), ("LOOP_ITEMS", 200),
                        ("LOOP_RATINGS", 20_000),
                        ("LOOP_MORE_RATINGS", 3_000),
                        ("LOOP_STREAM_KEYS", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    return fleet_base


def test_loop_phase_rehearsal(small_loop, capsys):
    """Phase 20 on the CPU: every member a ``--device cpu`` process, the
    autopilot's CLI a ``--device cpu`` process."""
    out = chip_smoke.loop_phase(torch, small_loop, torch.device("cpu"))
    logs = capsys.readouterr().out
    assert "verified [{'gen': 1, 'rows': 2302}, {'gen': 1, 'mse':" in logs
    assert "window 20000 new ratings" in logs and "win True" in logs
    assert "generation 2 cut over in" in logs
    assert "0 failed queries" in logs
    assert "coverage 1.0" in logs
    assert "alert 'alert:model_drift' -> rollback to generation 3 (seed)" \
        in logs
    assert "16 of 16 TOPK replies (k 10) equal generation 1's" in logs
    assert "alerts_firing 1, alerts_max_severity 'warn'" in logs
    assert "3000 new ratings windowed" in logs
    assert ("loop (g) admission (generation 4, 1 member(s), "
            "TPUMS_ADMIT_TENANT_QPS 'abuse=50', burst 50)") in logs
    assert "serving_rollout_abuse_other_errors 0" in logs
    assert "1 member(s) the CLI spawned stopped" in logs
    assert out["inquota_availability"] >= chip_smoke.LOOP_AVAILABILITY
    abuse = out["abuse"]
    assert abuse["TOPK"]["shed"] > 0 and abuse["GET"]["shed"] > 0
    assert all(abuse[v]["served"] + abuse[v]["shed"] == abuse[v]["offered"]
               for v in abuse)
    assert out["shed_per_s"] > 0 and 0 < out["admission_pressure"] <= 1
    assert out["launches"]["cholesky"] == 8
    assert out["launches"]["assembly"] >= 8
    assert out["candidate_mse"] < out["incumbent_mse"]
    assert abs(out["live_mse"] - out["offline_mse"]) <= \
        1e-5 * out["offline_mse"]
    assert out["cli_s"] > 0 and out["rollback_s"] > 0


def test_loop_phase_fails_when_the_rollback_serves_other_bytes(
        small_loop, monkeypatch):
    """A seed journal that gained a rewritten user row before the rollback:
    generation 3 answers that user's TOPK otherwise, and the phase fails."""
    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.serve import rollout as PRO
    from flink_ms_tpu_torch.serve.journal import Journal

    real = PRO.RolloutController.rollback

    def tampered(self, **kw):
        seed = next(h["model"] for h in self.current()["history"]
                    if (h.get("model") or {}).get("model_id") == "seed")
        Journal(seed["journal_dir"], seed["topic"]).append(
            [F.format_als_row(small_loop["users"][0], "U", np.ones(8))])
        return real(self, **kw)

    monkeypatch.setattr(PRO.RolloutController, "rollback", tampered)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="generation 3 answers [1-9][0-9]* TOPK"):
        chip_smoke.loop_phase(torch, small_loop, torch.device("cpu"))


def test_loop_phase_fails_when_an_over_quota_topk_reaches_the_index(
        small_loop, monkeypatch, tmp_path):
    """Every process the phase starts runs an admission whose over-quota
    TOPKV is counted as shed and scored all the same: (g) finds more
    TOPKs served than its members' index scored past their sheds."""
    import os

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.dirname(chip_smoke.__file__)!r})\n"
        "from flink_ms_tpu_torch.serve import admission as A\n"
        "real = A.AdmissionController.admit\n"
        "def admit(self, tenant, verb, cost=1.0, now=None):\n"
        "    return (real(self, tenant, verb, cost, now)\n"
        "            or verb in A.LOW_PRIORITY_VERBS)\n"
        "A.AdmissionController.admit = admit\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=r"\(g\): a shed TOPK reached the index"):
        chip_smoke.loop_phase(torch, small_loop, torch.device("cpu"))
