"""PyTorch port vs the JAX reference: the shard-fault-tolerance layer —
``dist/health.py`` (``HealthRegistry``, ``CoverageReport``),
``dist/sharding.py`` (``ReplicaMap``, ``datastore_specs``) and
``dist/search.py`` (``FaultTolerantSearch``, ``reference_over_covered``).

The state machines and the placement arithmetic are driven through the
same calls in both packages and must agree after every step. The
fault-tolerant searches run on the same numpy corpus with the same seeded
``FaultInjector`` schedule (each package's own injector, the same seed) and
a clock that never advances, so no deadline depends on how fast either
machine is: their answers, coverage reports, counters and ``stats()`` must
be equal, and each answer equal to both packages' ``reference_over_covered``
(the port on the CPU, ``repro``'s Pallas kernels in interpret mode).
Integers are compared exactly.
"""
import itertools

import numpy as np
import pytest

from repro.dist import health as jhealth
from repro.dist import search as jsearch
from repro.dist import sharding as jsharding
from repro.runtime import faults as jfaults
from repro_torch.dist import health as thealth
from repro_torch.dist import search as tsearch
from repro_torch.dist import sharding as tsharding
from repro_torch.runtime import faults as tfaults

UNITS = ("u0", "u1", "u2", "u3")


# ---------------------------------------------------------------------------
# health registry and coverage reports
# ---------------------------------------------------------------------------

def _registries(**kw):
    return (jhealth.HealthRegistry(UNITS, **kw),
            thealth.HealthRegistry(UNITS, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_registry_walk_matches_reference(seed):
    """A seeded random walk of observe / kill / revive / mark_recovered
    (latencies across the deadline included): the same state after every
    call and the same snapshot at the end."""
    rng = np.random.default_rng(seed)
    jr, tr = _registries(deadline_s=0.05, suspect_after=1, dead_after=3,
                         recover_probes=2)
    for _ in range(300):
        unit = UNITS[rng.integers(len(UNITS))]
        op = rng.choice(["observe", "observe", "observe", "kill", "revive",
                         "mark_recovered"])
        if op == "observe":
            ok, lat = bool(rng.random() < 0.6), float(rng.random() * 0.1)
            assert tr.observe(unit, ok, lat) == jr.observe(unit, ok, lat)
        else:
            getattr(jr, op)(unit)
            getattr(tr, op)(unit)
        assert tr.state(unit) == jr.state(unit)
        assert (tr.serving(), tr.dead(), tr.not_serving()) == (
            jr.serving(), jr.dead(), jr.not_serving())
    assert tr.snapshot() == jr.snapshot()
    assert tr.transitions == jr.transitions


def test_health_deadline_misses_and_bad_inputs_match_reference():
    for mod in (jhealth, thealth):
        reg = mod.HealthRegistry(["a"], deadline_s=0.01, suspect_after=1,
                                 dead_after=2)
        assert reg.observe("a", True, latency_s=0.5) == mod.SUSPECT
        assert reg.observe("a", True, latency_s=0.5) == mod.DEAD
        snap = reg.snapshot()
        assert snap["counters"]["a"]["deadline_misses"] == 2
        assert ("a", mod.SUSPECT, mod.DEAD) in snap["transitions"]
        with pytest.raises(KeyError):
            reg.observe("nope", True)
        with pytest.raises(ValueError):
            mod.HealthRegistry(["a"], suspect_after=2, dead_after=1)
    assert thealth.STATES == jhealth.STATES


@pytest.mark.parametrize("covered,total,dead", [
    (750, 1000, ("unit2",)), (5, 5, ()), (0, 0, ()), (0, 0, ("u",)),
    (0, 1024, ("a", "b"))])
def test_coverage_report_matches_reference(covered, total, dead):
    j = jhealth.CoverageReport(covered, total, dead)
    t = thealth.CoverageReport(covered, total, dead)
    assert (t.coverage_frac, t.complete, t.as_dict()) == (
        j.coverage_frac, j.complete, j.as_dict())


# ---------------------------------------------------------------------------
# replica placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 3])
def test_replica_map_matches_reference_on_every_alive_set(factor):
    """Every alive subset, nominal and with a revived-empty unit: owners,
    assignment, uncovered ranges, covered rows and the rebuild work list."""
    counts = (10, 20, 30, 40)
    jm = jsharding.ReplicaMap(counts, UNITS, factor=factor)
    tm = tsharding.ReplicaMap(counts, UNITS, factor=factor)
    assert (tm.total_rows, tm.n_units) == (jm.total_rows, jm.n_units)
    for i in range(4):
        assert tm.holders(i) == jm.holders(i)
        assert tm.range_bounds(i) == jm.range_bounds(i)
        assert tm.held_by(UNITS[i]) == jm.held_by(UNITS[i])
    empty = {u: set(jm.held_by(u)) for u in UNITS}
    empty["u1"] = set()
    for r in range(5):
        for alive in itertools.combinations(UNITS, r):
            for held in (None, empty):
                assert tm.assignment(alive, held) == jm.assignment(alive,
                                                                   held)
                assert tm.uncovered(alive, held) == jm.uncovered(alive, held)
                assert tm.covered_rows(alive, held) == jm.covered_rows(
                    alive, held)
                assert tm.rebuild_targets(alive, held) == \
                    jm.rebuild_targets(alive, held)
                for i in range(4):
                    assert tm.owner(i, alive, held) == jm.owner(i, alive,
                                                                held)


def test_replica_map_refuses_what_reference_refuses():
    for mod in (jsharding, tsharding):
        with pytest.raises(ValueError):
            mod.ReplicaMap((1, 1), ("a", "b"), factor=3)
        with pytest.raises(ValueError):
            mod.ReplicaMap((1,), ("a", "b"))
        with pytest.raises(ValueError):
            mod.ReplicaMap((1, -1), ("a", "b"))


def test_datastore_specs_follow_the_store_structure():
    from torch.distributed.tensor import Replicate

    from repro_torch.core import quantize, retrieval

    specs = tsharding.datastore_specs()
    assert specs.codes == Replicate() and specs.layout is None
    assert specs.itq == quantize.ITQParams(Replicate(), Replicate(),
                                           Replicate())
    assert retrieval.DataStore._fields == type(
        jsharding.datastore_specs())._fields


# ---------------------------------------------------------------------------
# the fault-tolerant search
# ---------------------------------------------------------------------------

COUNTS = [300, 512, 11, 201]
N = sum(COUNTS)
_rng = np.random.default_rng(0)
CODES = _rng.integers(0, 2 ** 32, (N, 2), dtype=np.uint32)
QUERIES = _rng.integers(0, 2 ** 32, (5, 2), dtype=np.uint32)
BOUNDS = np.cumsum([0] + COUNTS)


def _clock():
    return 0.0


def _pair(factor=1, injector=None, **kw):
    """repro's and the port's searches over the same corpus, each with its
    own injector of the same schedule (``injector``: site -> p)."""
    jinj = tinj = None
    if injector is not None:
        seed, p = injector
        jinj = jfaults.FaultInjector(seed=seed, p=p)
        tinj = tfaults.FaultInjector(seed=seed, p=p)
    j = jsearch.FaultTolerantSearch(CODES, 64, counts=COUNTS, factor=factor,
                                    injector=jinj, clock=_clock, **kw)
    t = tsearch.FaultTolerantSearch(CODES, 64, counts=COUNTS, factor=factor,
                                    injector=tinj, clock=_clock,
                                    device="cpu", **kw)
    return j, t


def _rows(ranges):
    ranges = list(ranges)
    if not ranges:
        return np.empty(0, np.int64)
    return np.concatenate([np.arange(BOUNDS[i], BOUNDS[i + 1])
                           for i in ranges])


def _search_both(j, t, k, covered=None):
    """Both searches agree (answer, report, counters, stats); the answer is
    both packages' reference over the covered rows."""
    jd, ji, jrep = j.search(QUERIES, k)
    td, ti, trep = t.search(QUERIES, k)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)
    assert td.dtype == ti.dtype == np.int32
    assert trep == thealth.CoverageReport(**{
        f: getattr(jrep, f) for f in ("covered_rows", "total_rows",
                                      "dead_shards")})
    assert t.counters == j.counters
    assert t.stats() == j.stats()
    assert t.covered_ranges() == j.covered_ranges()
    m = t.covered_row_ids()
    np.testing.assert_array_equal(m, j.covered_row_ids())
    if covered is not None:
        np.testing.assert_array_equal(m, _rows(covered))
    rd, ri = tsearch.reference_over_covered(CODES, QUERIES, k, 64, m,
                                            device="cpu")
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_array_equal(ti, ri)
    jd2, ji2 = jsearch.reference_over_covered(CODES, QUERIES, k, 64, m)
    np.testing.assert_array_equal(rd, jd2)
    np.testing.assert_array_equal(ri, ji2)
    return trep


def test_fts_healthy_matches_reference():
    j, t = _pair()
    rep = _search_both(j, t, 16, covered=range(4))
    assert rep.complete and t.fanout == j.fanout


@pytest.mark.parametrize("dead", [0, 1, 2, 3])
def test_fts_single_dead_matches_reference(dead):
    """Degraded but exact, k = 16 and k = 1200 (more than any survivor
    total); the report names the dead unit."""
    j, t = _pair()
    for srch in (j, t):
        srch.kill(f"unit{dead}")
    for k in (16, 1200):
        rep = _search_both(j, t, k, covered=[i for i in range(4)
                                             if i != dead])
        assert rep.dead_shards == (f"unit{dead}",)


def test_fts_replicas_rereplication_and_revives_match_reference():
    """R = 2: a replica keeps full coverage; both holders of a range dead
    degrade it; a warm revive + maintain() restores 1.0; a cold revive
    refills from the replicas."""
    j, t = _pair(factor=2)
    for srch in (j, t):
        srch.kill("unit1")
    _search_both(j, t, 16, covered=range(4))
    for srch in (j, t):
        srch.kill("unit2")
    _search_both(j, t, 16, covered=[0, 2, 3])
    for srch in (j, t):
        srch.revive("unit1", with_data=True)
    assert t.maintain() == j.maintain()
    _search_both(j, t, 16, covered=range(4))
    for srch in (j, t):
        srch.revive("unit2", with_data=False)
    for _ in range(3):
        assert t.maintain(budget=1) == j.maintain(budget=1)
    assert t.coverage().coverage_frac == 1.0
    _search_both(j, t, 16, covered=range(4))


@pytest.mark.parametrize("schedule", [
    (1, {"shard_hist@unit0": 1.0, "shard_emit@unit0": 1.0}),
    (2, {"merge_psum": 0.5}),
    (5, {"shard_hist": 0.3, "shard_emit": 0.3, "merge_psum": 0.3}),
], ids=["unit0-down", "merge-retries", "every-site"])
def test_fts_injected_fault_schedules_match_reference(schedule):
    """The same seeded schedule of shard_hist / shard_emit / merge_psum
    faults drives both registries through the same failovers, and both
    answer exactly over what they still cover."""
    j, t = _pair(factor=2, injector=schedule)
    for _ in range(3):
        try:
            jres = j.search(QUERIES, 16)
        except jfaults.TRANSIENT as e:
            with pytest.raises(tfaults.InjectedFault, match=e.site):
                t.search(QUERIES, 16)
            continue
        tres = t.search(QUERIES, 16)
        for a, b in zip(tres[:2], jres[:2]):
            np.testing.assert_array_equal(a, b)
        assert tres[2].as_dict() == jres[2].as_dict()
        assert t.stats() == j.stats()
        assert t.injector.fired == j.injector.fired
        assert t.injector.calls == j.injector.calls
    assert t.registry.transitions == j.registry.transitions


def test_fts_all_dead_and_zero_k_match_reference():
    j, t = _pair()
    for u in j.map.units:
        j.kill(u)
        t.kill(u)
    rep = _search_both(j, t, 7, covered=[])
    assert rep.covered_rows == 0 and len(rep.dead_shards) == 4
    j, t = _pair()
    _search_both(j, t, 0, covered=range(4))


def test_fts_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the search would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.FaultTolerantSearch(CODES, 64, counts=COUNTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.reference_over_covered(CODES, QUERIES, 4, 64, np.arange(N))
