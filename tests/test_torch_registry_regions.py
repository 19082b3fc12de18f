"""The port's region and edge namespaces (``flink_ms_tpu_torch/serve/
registry.py``) against the JAX package's on the CPU.

A table of names goes through both packages' ``qualify_region``,
``split_region``, ``region_of`` and ``edge_group``, with and without an
ambient ``TPUMS_GEO_REGION`` and tenant: the results (or the refusals)
must be equal.  ``list_regions``, ``list_region_jobs`` and
``gc_region_entries`` of either package read one registry that both
packages wrote, and agree.
"""

import time

import pytest

from flink_ms_tpu.serve import registry as RReg
from flink_ms_tpu_torch.serve import registry as PReg

NAMES = ["als", "acme::als", "eu@@als", "eu@@acme::als@g3/shard-0",
         "g@g2/shard-1", "@@x", "a::b", ""]
REGIONS = [None, "", "eu", " ap ", "bad@@r", "bad::r", "bad/r", "bad\tr"]


def _call(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("ambient", [None, "us"])
@pytest.mark.parametrize("tenant", [None, "acme"])
def test_region_functions_equal_on_a_table_of_names(monkeypatch, ambient,
                                                    tenant):
    for var, value in (("TPUMS_GEO_REGION", ambient),
                       ("TPUMS_TENANT", tenant)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert PReg.REGION_SEP == RReg.REGION_SEP == "@@"
    assert PReg.EDGE_PREFIX == RReg.EDGE_PREFIX == "edge/"
    assert PReg.default_region() == RReg.default_region()
    for name in NAMES:
        for fn in ("split_region", "region_of"):
            assert _call(getattr(PReg, fn), name) == \
                _call(getattr(RReg, fn), name), (fn, name)
        for region in REGIONS:
            for fn in ("qualify_region", "edge_group"):
                assert _call(getattr(PReg, fn), name, region) == \
                    _call(getattr(RReg, fn), name, region), \
                    (fn, name, region)
        assert PReg._entry_region({"job_id": name}) == \
            RReg._entry_region({"job_id": name})
        assert PReg._entry_region({"replica_of": name, "job_id": "x"}) == \
            RReg._entry_region({"replica_of": name, "job_id": "x"})


def test_region_listing_and_gc_agree_across_packages():
    # live entries of two regions and the unscoped namespace, written by
    # both packages, and a topology record of a third region
    PReg.register("eu@@g:s0r0", "127.0.0.1", 1, "ALS_MODEL",
                  replica_of="eu@@g/shard-0", ttl_s=300.0)
    RReg.register("us@@g:s0r0", "127.0.0.1", 2, "ALS_MODEL",
                  replica_of="us@@g/shard-0", ttl_s=300.0)
    PReg.register("plain", "127.0.0.1", 3, "ALS_MODEL", ttl_s=300.0)
    RReg.publish_topology("ap@@g", 2)
    assert PReg.list_regions() == RReg.list_regions() == ["ap", "eu", "us"]
    for region in ("eu", "us", "ap", None):
        assert [e["port"] for e in PReg.list_region_jobs(region)] == \
            [e["port"] for e in RReg.list_region_jobs(region)]
    # dead entries: each package reaps only the region it was asked for
    for mod, region, port in ((RReg, "eu", 4), (PReg, "us", 5)):
        mod.register(f"{region}@@dead:s0r0", "127.0.0.1", port, "ALS_MODEL",
                     replica_of=f"{region}@@dead/shard-0", ttl_s=0.01)
    time.sleep(0.05)
    assert PReg.gc_region_entries("eu") == 1
    assert RReg.gc_region_entries("us") == 1
    assert PReg.gc_region_entries("eu") == RReg.gc_region_entries("eu") == 0
    assert sorted(e["port"] for e in PReg.list_jobs(gc=False)) == [1, 2, 3]
    for mod in (PReg, RReg):
        with pytest.raises(ValueError):
            mod.gc_region_entries("")
