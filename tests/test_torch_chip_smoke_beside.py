"""``chip_smoke.py``'s lanes of phases beside the main process (24 and 11;
15 and 14; each lane a spawned process of its own) and its bytecode
cache, on the CPU: a lane's plumbing with the phases replaced by
recording fakes, a phase's failure carried back to the main process
through real spawns, and ``cache_bytecode``'s settings."""

import json
import os
import sys

import pytest
import torch

import chip_smoke


def _inputs(tmp_path):
    w = torch.arange(4, dtype=torch.float32)
    inputs = {"sample": {"w": w, "rows": [1, 2]},
              "model": {"user_ids": [7, 8], "item_ids": [9],
                        "user_factors": torch.ones(2, 3),
                        "item_factors": torch.zeros(1, 3)}}
    path = str(tmp_path / "inputs.pt")
    torch.save(inputs, path)
    return path


def _record_phases(monkeypatch, fail=None):
    calls = []

    def phase(name, result):
        def run(torch_, *args):
            calls.append((name, args))
            if name == fail:
                raise chip_smoke.SmokeFailure(f"{name} failed")
            return result
        return run

    for name, result in (("svm_serve_phase", {"launches": 3}),
                         ("serve_scale_phase", None),
                         ("retrain_phase", {"cholesky": 16}),
                         ("gen_phase", None)):
        monkeypatch.setattr(chip_smoke, name, phase(name, result))
    monkeypatch.setattr(chip_smoke, "synth_ratings",
                        lambda *a, **k: ("ratings", a, k))
    return calls


def test_the_lanes_hold_the_phases_beside_and_nothing_else():
    lanes = [k for lane in chip_smoke.BESIDE_LANES for k in lane]
    assert sorted(lanes) == ["11", "14", "15", "24"]
    assert set(chip_smoke.BESIDE_LABELS) == set(lanes)


def test_a_lane_runs_its_phases_in_order_and_writes_their_launches(
        tmp_path, monkeypatch, capsys):
    """Each lane's phases in order, each with its clock line: phase 24 on
    the sample, phase 15 on phase 4's model and its ratings drawn again
    from their seed; the launches of 24 and 15 come back."""
    calls = _record_phases(monkeypatch)
    inputs = _inputs(tmp_path)
    for n, lane in enumerate(chip_smoke.BESIDE_LANES):
        chip_smoke.beside_in_process(inputs, str(tmp_path / f"{n}.json"),
                                     0.0, "cpu", lane)
    got = [json.loads((tmp_path / f"{n}.json").read_text()) for n in (0, 1)]
    assert got == [{"24": 3, "11": None}, {"15": {"cholesky": 16},
                                           "14": None}]
    assert [c[0] for c in calls] == ["svm_serve_phase", "serve_scale_phase",
                                     "retrain_phase", "gen_phase"]
    sample = calls[0][1][0]
    assert sample["rows"] == [1, 2] and torch.equal(
        sample["w"], torch.arange(4, dtype=torch.float32))
    _, _, model, ratings, _ = calls[2][1]
    assert model.user_ids == [7, 8] and model.item_ids == [9]
    assert torch.equal(model.user_factors, torch.ones(2, 3))
    assert ratings == ("ratings", (chip_smoke.N_USERS, chip_smoke.N_ITEMS,
                                   chip_smoke.NNZ), {"seed": 0})
    logs = capsys.readouterr().out
    for label in chip_smoke.BESIDE_LABELS.values():
        assert f"clock: {label} done at " in logs
    assert "in a lane beside phases 23, 10, 12, 13, 16" in logs


@pytest.mark.parametrize("lane,fail", [(("24", "11"), "svm_serve_phase"),
                                       (("15", "14"), "retrain_phase"),
                                       (("15", "14"), "gen_phase")])
def test_a_lane_stops_at_a_failed_phase_and_writes_its_error(
        tmp_path, monkeypatch, lane, fail):
    calls = _record_phases(monkeypatch, fail=fail)
    out = tmp_path / "lane.json"
    chip_smoke.beside_in_process(_inputs(tmp_path), str(out), 0.0, "cpu",
                                 lane)
    assert json.loads(out.read_text()) == {"error": f"{fail} failed"}
    assert calls[-1][0] == fail


def test_a_failed_lane_fails_the_main_process():
    """Real spawns, one lane whose phase fails (here at its inputs: phase
    24's sample is missing) and one that names no phase beside: ``join``
    raises with the first lane's error, and every lane's process is
    gone."""
    beside = chip_smoke.Beside(torch, {"model": {}}, 0.0,
                               torch.device("cpu"), lanes=(("24",), ("9",)))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="(?s)a phase beside, of the lane \\('24',\\): "
                             ".*KeyError: 'sample'"):
        beside.join()
    assert not any(p.is_alive() for _, p, _ in beside.lanes)
    assert not os.path.exists(beside.dir)


def test_cache_bytecode_writes_under_the_checkout(monkeypatch):
    """Beside the port: bytecode written and read under ``build/pycache``
    in this process and the processes it starts, whatever
    PYTHONDONTWRITEBYTECODE said."""
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.delenv("PYTHONPYCACHEPREFIX", raising=False)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "pycache_prefix", None)
    chip_smoke.cache_bytecode()
    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    want = os.path.join(root, "build", "pycache")
    assert chip_smoke.PYCACHE == want
    assert "PYTHONDONTWRITEBYTECODE" not in os.environ
    assert os.environ["PYTHONPYCACHEPREFIX"] == want
    assert sys.dont_write_bytecode is False and sys.pycache_prefix == want


def test_cache_bytecode_leaves_a_script_alone_as_it_is(tmp_path, monkeypatch):
    """The script in a directory without the port changes nothing."""
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.delenv("PYTHONPYCACHEPREFIX", raising=False)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(chip_smoke, "__file__", str(tmp_path / "chip_smoke.py"))
    chip_smoke.cache_bytecode()
    assert os.environ["PYTHONDONTWRITEBYTECODE"] == "1"
    assert "PYTHONPYCACHEPREFIX" not in os.environ
    assert sys.dont_write_bytecode is True and sys.pycache_prefix is None
