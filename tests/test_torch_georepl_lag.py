"""What sets a replicator's lag, held to the reference on a clock of the
test's own.

``JournalReplicator.lag_seconds`` is the time since the replicator last
found home's end (a step that read nothing), not the age of the oldest
byte it has not shipped.  So under appends that come faster than a step
takes, no step finds the end and the lag grows with the load's length,
whatever the byte rate; under the reference's region drill (one writer,
200 rows each 20 ms, ``scripts/chaos_kill.py``), every append is followed
by a caught-up instant.  Phase 22 (a)'s load reaches home's topic through
the home members' update planes: on a quiet card host, 4 planes appended
371-403 times a second, about one append in a step's median length
(PERF.md, section 5).

Each case drives both packages' replicators through ``step`` alone (no
thread, no sleep), each module's ``time`` and ``os`` replaced: the clock
is the test's, an ``fsync`` costs ``FSYNC_S`` of it and a step's Python
``STEP_S``, and advancing it runs what falls due meanwhile at its own
instant: the writers' appends to home, and a sampler that reads
``lag_seconds()`` every 5 ms, as phase 22 (a) and the drill do.  Both
packages must give the same lag samples and the same follower bytes."""

import heapq
import itertools
import os

import numpy as np
import pytest

from flink_ms_tpu.serve import georepl as RG
from flink_ms_tpu.serve.journal import Journal as RefJournal
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve import georepl as PG
from flink_ms_tpu_torch.serve.journal import Journal

FSYNC_S = 0.0015       # an fsync of the follower's segment
STEP_S = 0.001         # the rest of a step: the read, write, status record
POLL_S = 0.01          # the replicator's poll when it found home's end
SAMPLE_S = 0.005       # the lag sampler's period
WINDOW_S = 1.0         # the load's length
# (writers, each one's period, rows an append); one writer is the drill's
DRILL = (1, 0.020, 200)
PHASE_22A = (4, 0.010, 20)


class _Clock:
    """A module's ``time``: ``time()`` reads the test's clock, and
    ``advance`` runs every event that falls due, at its own instant."""

    def __init__(self):
        self.t = 1_000_000.0
        self._events, self._seq = [], itertools.count()

    def time(self):
        return self.t

    monotonic = perf_counter = time

    def sleep(self, s):
        self.advance(s)

    def at(self, t, fn):
        heapq.heappush(self._events, (t, next(self._seq), fn))

    def advance(self, dt):
        end = self.t + dt
        while self._events and self._events[0][0] <= end:
            t, _, fn = heapq.heappop(self._events)
            self.t = max(self.t, t)
            fn()
        self.t = end


class _Os:
    """A module's ``os``: an ``fsync`` also costs ``cost`` of the clock."""

    def __init__(self, clock, cost):
        self._clock, self._cost = clock, cost

    def __getattr__(self, name):
        return getattr(os, name)

    def fsync(self, fd):
        os.fsync(fd)
        self._clock.advance(self._cost)


def _drive(monkeypatch, mod, journal_cls, root, load, fsync_s, step_s):
    """One package's replicator under ``load`` -> (lag samples in ms, the
    steps' caught-up instants, appends made, the follower's bytes)."""
    writers, period, rows = load
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setattr(mod, "os", _Os(clock, fsync_s))
    home, follower = os.path.join(root, "us"), os.path.join(root, "eu")
    # the published model the replicator ships first, then the load
    journal_cls(home, "m").append([F.format_als_row(i, "U", [0.5] * 8)
                                   for i in range(50)])
    rep = mod.JournalReplicator(home, follower, "m", "eu", poll_s=POLL_S,
                                lease=False)
    rep.run_until_caught_up()
    start = clock.t
    end = start + WINDOW_S
    samples, appends = [], [0]
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(writers, 1000, 8))

    def sample():
        samples.append(rep.lag_seconds() * 1e3)
        if clock.t + SAMPLE_S < end:
            clock.at(clock.t + SAMPLE_S, sample)

    def writer(w, j, k=0):
        def append():
            j.append([F.format_als_row(w * 1000 + r, "I", vecs[w, k % 1000])
                      for r in range(rows)], flush=False)
            appends[0] += 1
            if clock.t + period < end:
                clock.at(clock.t + period, writer(w, j, k + 1))
        return append

    for w in range(writers):
        # the writers' appends spread evenly over a period
        clock.at(start + period * w / writers,
                 writer(w, journal_cls(home, "m")))
    clock.at(start, sample)
    caught = []
    while clock.t < end:
        n = rep.step()
        clock.advance(step_s)
        if n == 0:
            caught.append(clock.t - start)
            clock.advance(POLL_S)
    seg = os.path.join(follower, "m.log")
    with open(seg, "rb") as f:
        return samples, caught, appends[0], f.read()


def _both(monkeypatch, tmp_path, load, fsync_s=FSYNC_S, step_s=STEP_S):
    out = {}
    for name, mod, cls in (("reference", RG, RefJournal),
                           ("port", PG, Journal)):
        root = tmp_path / name
        root.mkdir()
        with monkeypatch.context() as m:
            out[name] = _drive(m, mod, cls, str(root), load, fsync_s, step_s)
    ref, port = out["reference"], out["port"]
    assert port[0] == ref[0], "the two packages' lag samples differ"
    assert port[1] == ref[1] and port[2] == ref[2]
    assert port[3] == ref[3], "the follower bytes differ"
    return port


def test_the_drill_catches_up_after_every_append(monkeypatch, tmp_path):
    """One writer each 20 ms: a caught-up instant between any two appends,
    so the lag never exceeds a poll and two steps (the one that ships an
    append and the one that finds the end)."""
    samples, caught, appends, _ = _both(monkeypatch, tmp_path, DRILL)
    assert appends == WINDOW_S / DRILL[1]
    assert len(caught) >= appends
    for k in range(appends - 1):
        a, b = k * DRILL[1], (k + 1) * DRILL[1]
        assert any(a < c <= b for c in caught), (k, caught[:8])
    assert max(samples) <= (POLL_S + 2 * (FSYNC_S + STEP_S)) * 1e3 + 1e-6


@pytest.mark.parametrize("fsync_s,step_s,grows", [
    (FSYNC_S, STEP_S, True),          # a step of 2.5 ms: one append a step
    (0.0003, 0.0002, False),          # a step of 0.5 ms: five steps an append
])
def test_phase_22a_cadence_sets_the_lag(monkeypatch, tmp_path, fsync_s,
                                        step_s, grows):
    """Four writers, an append each 2.5 ms over them: where a step takes
    as long, no step finds home's end after the first append until the
    load stops, and the lag grows with the window (at a byte rate far
    below the drill's); where a step takes a fifth of it, the replicator
    finds the end after every poll, and the lag stays under a poll and
    two steps, as the drill's does."""
    samples, caught, appends, _ = _both(monkeypatch, tmp_path, PHASE_22A,
                                        fsync_s, step_s)
    assert appends == WINDOW_S / PHASE_22A[1] * PHASE_22A[0]
    step = fsync_s + step_s
    if grows:
        late = [c for c in caught if PHASE_22A[1] < c < WINDOW_S - 0.01]
        assert not late, late[:8]
        assert float(np.percentile(samples, 99)) > 0.9 * WINDOW_S * 1e3
    else:
        gaps = np.diff(caught)
        assert gaps.max() <= POLL_S + 3 * step + 1e-9, gaps.max()
        assert max(samples) <= (POLL_S + 2 * step) * 1e3 + 1e-6
