"""The metric-name lint of ``tests/test_metric_hygiene.py`` on the port's
serving smoke: journal -> the port's ``ServingJob`` (``device="cpu"``) ->
queries, traced and not -> profiler flush -> fleet scrape.  Every live
series must match the reference's ``NAME_PATTERN``, take label keys from
its ``LABEL_VOCABULARY`` and, for counters, end in ``_total``.

The smoke runs in a subprocess that imports only the port: the metrics
registry is process-wide, so an in-process walk would lint whatever
series earlier tests in the worker minted."""

import json
import os
import re
import subprocess
import sys

from flink_ms_tpu.obs import metrics as RM
from flink_ms_tpu_torch.obs import metrics as PM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SMOKE = r"""
import json, os, sys, tempfile, time
import numpy as np

tmp = tempfile.mkdtemp(prefix="tpums_hygiene_")
os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(tmp, "registry")
os.environ["TPUMS_PROF"] = "1"
os.environ["TPUMS_PROF_HZ"] = "200"

from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.obs import profiler as P
from flink_ms_tpu_torch.obs import tracing as T
from flink_ms_tpu_torch.obs.metrics import get_registry
from flink_ms_tpu_torch.obs.scrape import (fleet_signals, scrape_fleet,
                                           scrape_fleet_profiles)
from flink_ms_tpu_torch.serve.client import QueryClient
from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                               make_backend,
                                               parse_als_record)
from flink_ms_tpu_torch.serve.journal import Journal

assert "flink_ms_tpu" not in sys.modules and "jax" not in sys.modules
rng = np.random.default_rng(0)
journal = Journal(os.path.join(tmp, "bus"), "models")
journal.append([F.format_als_row(u, "U", rng.normal(size=4))
                for u in range(50)]
               + [F.format_als_row(i, "I", rng.normal(size=4))
                  for i in range(20)])
job = ServingJob(journal, ALS_STATE, parse_als_record,
                 make_backend("memory", None), host="127.0.0.1", port=0,
                 poll_interval_s=0.01, device="cpu").start()
try:
    assert job.wait_ready(120)
    with QueryClient("127.0.0.1", job.port, timeout_s=30) as c:
        tid = T.new_trace_id()
        with T.trace_span(tid):
            for u in range(30):
                c.query_state(ALS_STATE, f"{u}-U")
        c.query_state(ALS_STATE, "no-such-key-U")
        c.query_states(ALS_STATE, ["1-U", "2-U"])
        c.topk(ALS_STATE, "3", 5)
    prof = P.get_profiler()
    assert prof is not None
    # the sampler is a thread of its own and samples only threads that
    # burned CPU since its last tick: on a loaded host it may not have
    # ticked during the queries above, and a flush of no sample mints no
    # samples counter; query until it has sampled
    deadline = time.time() + 60
    while prof.samples == 0 and time.time() < deadline:
        with QueryClient("127.0.0.1", job.port, timeout_s=30) as c:
            c.topk(ALS_STATE, "3", 5)
    prof.flush()
    s0 = scrape_fleet()
    time.sleep(0.05)
    fleet_signals(s0, scrape_fleet())
    assert scrape_fleet_profiles()["scraped"] == 1
    print(json.dumps(get_registry().snapshot()))
finally:
    job.stop()
sys.stdout.flush()
os._exit(0)
"""


def test_port_registry_passes_the_reference_hygiene_lint(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _SMOKE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    snap = json.loads(out.stdout.strip().splitlines()[-1])

    entries = (snap.get("counters", []) + snap.get("gauges", [])
               + snap.get("histograms", []))
    names = {e["name"] for e in entries}
    assert len(snap.get("counters", [])) > 0
    assert len(snap.get("histograms", [])) > 0
    # the profiler's flush published its two counters
    assert {"tpums_prof_samples_total",
            "tpums_process_cpu_seconds_total"} <= names

    name_re = re.compile(RM.NAME_PATTERN)
    bad_names = sorted(n for n in names if not name_re.match(n))
    assert bad_names == [], f"non-conforming series names: {bad_names}"
    bad_labels = sorted({(e["name"], k) for e in entries
                         for k in e.get("labels", {})
                         if k not in RM.LABEL_VOCABULARY})
    assert bad_labels == [], f"label keys outside vocabulary: {bad_labels}"
    bad_counters = sorted({c["name"] for c in snap.get("counters", [])
                           if not c["name"].endswith("_total")})
    assert bad_counters == [], \
        f"counters without _total suffix: {bad_counters}"


def test_port_vocabulary_is_the_reference_contract():
    assert PM.NAME_PATTERN == RM.NAME_PATTERN
    assert PM.LABEL_VOCABULARY == RM.LABEL_VOCABULARY
    assert isinstance(PM.LABEL_VOCABULARY, frozenset)
