"""PyTorch port vs the JAX reference: the multi-tenant packed arena
(``repro_torch.core.tenant``).

The mixed-tenant batch runs one K1 and one K2 launch over every tenant's
packed epoch; each tenant's answer must equal its own
``MutableStore.search`` and ``repro``'s arena on the same operations, bit
for bit — with ties, empty tenants, k beyond a tenant's live rows and
queries at the pad rows' distance. K2 runs split over runs of tiles (the
main path's form, bases from the pad-corrected run histograms) and as one
run; the two forms are held equal. Namespaces recover and quarantine as
the reference's do."""
import os

import numpy as np
import pytest

from repro.core import tenant as jten
from repro_torch.checkpoint import wal as twal
from repro_torch.core import tenant as tten
from repro_torch.kernels import topk_select as tsel
from repro_torch.runtime import faults as tfaults

D = 64
W = 2


def _codes(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, W), dtype=np.uint32)


def _pair(rng, sizes, bn=64, roots=(None, None), **kw):
    ja = jten.TenantArena(D, bn=bn, root=roots[0], min_slack=4, **kw)
    ta = tten.TenantArena(D, bn=bn, root=roots[1], min_slack=4,
                          device="cpu", **kw)
    for tid, n in sizes.items():
        c = _codes(rng, n) if n else None
        if n > 12:
            c[4:12] = c[0]                 # equal codes: ties
        v = np.arange(n, dtype=np.int32) if n else None
        ja.create_tenant(tid, c, values=v)
        ta.create_tenant(tid, c, values=v)
    return ja, ta


def _queries(rng, ar, n_max=30):
    q = {}
    for tid in ar.healthy_tids():
        q[tid] = _codes(rng, int(rng.integers(1, n_max)))
        st = ar.tenant(tid).store
        if st.epoch.n:
            q[tid][0] = st.epoch.layout.codes[0].cpu().numpy().view(
                np.uint32)                 # a query at distance 0
    first = ar.healthy_tids()[0]
    q[first][-1] = 0xFFFFFFFF              # at the pad rows' distance 0
    return q


def _check(ja, ta, q, k):
    jr = ja.search(q, k)
    tr = ta.search(q, k)
    ts = ta.search(q, k, emit="single")
    for tid in q:
        for res in (tr, ts):
            assert np.array_equal(res[tid][0], np.asarray(jr[tid][0])), tid
            assert np.array_equal(res[tid][1], np.asarray(jr[tid][1])), tid
        own = ta.tenant(tid).store.search(q[tid], k)
        assert np.array_equal(own[0], tr[tid][0]), tid
        assert np.array_equal(own[1], tr[tid][1]), tid


@pytest.mark.parametrize("k", [1, 9, 70])
def test_mixed_batch_equals_each_tenant_and_reference(k):
    rng = np.random.default_rng(k)
    sizes = {"a": 300, "b": 0, "c": 77, "d": 5, "e": 128, "f": 129}
    ja, ta = _pair(rng, sizes)
    _check(ja, ta, _queries(rng, ta), k)
    p = ta.pack()
    assert p.regions == ja.pack().regions
    assert np.array_equal(p.codes.numpy().view(np.uint32),
                          np.asarray(ja.pack().codes))


def test_one_k1_and_one_k2_launch_and_split_emit(monkeypatch):
    """The batch launches K1 once (with per-run histograms) and K2 once
    over several runs; the pad correction lands in each tenant's last
    run, so the split bases equal the single-run ones."""
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, {"a": 700, "b": 200, "c": 64, "d": 1})
    seen = []
    real_h, real_e = tsel.hamming_hist_kernel, tsel.hamming_emit_kernel

    def hist(*a, **kw):
        seen.append(("K1", kw.get("runs")))
        return real_h(*a, **kw)

    def emit(*a, **kw):
        rb = kw.get("run_bases")
        seen.append(("K2", None if rb is None else rb[0].shape[1]))
        return real_e(*a, **kw)

    monkeypatch.setattr(tsel, "hamming_hist_kernel", hist)
    monkeypatch.setattr(tsel, "hamming_emit_kernel", emit)
    q = _queries(rng, ta)
    ta.search(q, 12)
    assert [s[0] for s in seen] == ["K1", "K2"]
    assert seen[0][1] == seen[1][1] and seen[0][1] > 1
    seen.clear()
    ta.search(q, 12, emit="single")
    assert seen == [("K1", None), ("K2", None)]
    _check(ja, ta, q, 12)
    with pytest.raises(ValueError, match="emit"):
        ta.search(q, 3, emit="tree")


def test_identity_survives_churn_maintenance_and_repack():
    rng = np.random.default_rng(3)
    ja, ta = _pair(rng, {"a": 150, "b": 60, "c": 0})
    for r in range(3):
        for tid, n in (("a", 30), ("b", 12), ("c", 7)):
            c = _codes(rng, n)
            ja.append(tid, c)
            ta.append(tid, c)
            live = ta.tenant(tid).store._next_id
            victims = rng.choice(live, min(live, 5), replace=False)
            ja.delete(tid, victims)
            ta.delete(tid, victims)
        rj, rt = ja.maintain(), ta.maintain()
        assert rt == rj
        assert ta.pack().seq == ja.pack().seq == r + 1
        _check(ja, ta, _queries(rng, ta), 10)
    assert ta.stats() == ja.stats()


def test_recover_quarantine_and_scoped_faults(tmp_path):
    rng = np.random.default_rng(4)
    roots = (str(tmp_path / "j"), str(tmp_path / "t"))
    ja, ta = _pair(rng, {"t0": 40, "t1": 40, "t2": 10}, roots=roots)
    for tid in ("t0", "t1", "t1"):
        c = _codes(rng, 6)
        ja.append(tid, c)
        ta.append(tid, c)
    ja.close()
    ta.close()
    # interior corruption of t1's log quarantines t1 alone, in both
    for root in roots:
        wal = os.path.join(twal.namespace_root(root, "t1"), "wal.log")
        with open(wal, "r+b") as f:
            f.seek(twal._HEADER.size + 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0x10]))
    recs = [(jten.TenantArena.recover(D, roots[0]),
             tten.TenantArena.recover(D, roots[1], device="cpu")),
            (jten.TenantArena.recover(D, roots[1]),
             tten.TenantArena.recover(D, roots[0], device="cpu"))]
    for jr, tr in recs:
        assert tr.healthy_tids() == jr.healthy_tids() == ["t0", "t2"]
        assert tr.tenant("t1").status == tten.QUARANTINED
        assert "corruption" in tr.tenant("t1").error
        q = _queries(rng, tr)
        _check(jr, tr, q, 6)
        with pytest.raises(tten.TenantQuarantined):
            tr.search({"t1": _codes(rng, 2)}, 5)
        assert tr.admission_check("t1") == "quarantined"
        jr.close()
        tr.close()
    inj = tfaults.FaultInjector(seed=6, p={"wal_append@b": 1.0})
    ar = tten.TenantArena(D, root=str(tmp_path / "s"), fault_injector=inj,
                          device="cpu")
    ar.create_tenant("a", _codes(rng, 8))
    ar.create_tenant("b", _codes(rng, 8))
    ar.append("a", _codes(rng, 2))
    with pytest.raises(tfaults.InjectedFault):
        ar.append("b", _codes(rng, 2))
    assert inj.fired.get("wal_append@a", 0) == 0
    quota = tten.TenantQuota(max_rows=10)
    ar.create_tenant("c", _codes(rng, 9), quota=quota)
    assert ar.admission_check("c", 1) is None
    assert ar.admission_check("c", 2) == "quota_exceeded"
    ar.close()
