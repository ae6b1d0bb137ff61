"""PyTorch port vs the JAX reference: the crash-safe mutable store
(``repro_torch.core.mutable``) and the arena under it
(``repro_torch.core.layout.Arena``).

Both packages take the same numpy-seeded operations. The port's store
must match ``repro``'s arena, epoch checksum, search results and
``stats()`` after churn, equal a from-scratch rebuild of the same logical
contents, recover after a crash (torn WAL tail included) to the same
epoch, and recover a store root written by ``repro`` to ``repro``'s
epoch checksum (and the other way round)."""
import os

import numpy as np
import pytest
import torch

from repro.core import layout as jlay
from repro.core import mutable as jmut
from repro_torch.core import engine as teng
from repro_torch.core import layout as tlay
from repro_torch.core import mutable as tmut
from repro_torch.runtime import faults as tfaults

D = 64
W = 2


def _codes(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, W), dtype=np.uint32)


def _pair(rng, n=400, root=None, **kw):
    codes = _codes(rng, n)
    vals = np.arange(n, dtype=np.int32)
    j = jmut.MutableStore.create(codes, D, values=vals, n_buckets=8,
                                 root=None if root is None
                                 else os.path.join(root, "j"), **kw)
    t = tmut.MutableStore.create(codes, D, values=vals, n_buckets=8,
                                 root=None if root is None
                                 else os.path.join(root, "t"),
                                 device="cpu", **kw)
    return j, t


def _churn(stores, rng, rounds=4, app=40, dele=25):
    """The same appends and deletes on every store, flushed."""
    for r in range(rounds):
        c = _codes(rng, app)
        v = rng.integers(0, 1 << 20, app).astype(np.int32)
        c[:3] = c[3]                       # equal codes: ties across rows
        nxt = stores[0]._next_id
        victims = rng.choice(nxt, dele, replace=False)
        for st in stores:
            st.append(c, values=v)
            st.delete(victims)
            if r % 2:
                st.flush()
    for st in stores:
        st.flush()


def _same_store(j, t):
    ej, et = j.epoch, t.epoch
    assert et.checksum == ej.checksum
    assert np.array_equal(et.store_ids, ej.store_ids)
    assert np.array_equal(et.layout.codes.numpy().view(np.uint32),
                          np.asarray(ej.layout.codes))
    assert np.array_equal(et.layout.starts.numpy(),
                          np.asarray(ej.layout.starts))
    for f in ("codes", "ids", "values", "cap_starts", "n_used", "positions"):
        assert np.array_equal(getattr(t.arena, f), getattr(j.arena, f)), f
    assert t.stats() == j.stats()


def test_arena_and_key_match_reference():
    rng = np.random.default_rng(0)
    codes = _codes(rng, 500)
    ids = np.arange(0, 1000, 2, dtype=np.int64)
    for nb in (None, 4, 16):
        ja = jlay.build_arena(codes, D, ids=ids, n_buckets=nb,
                              slack_frac=0.3, min_slack=5)
        ta = tlay.build_arena(codes, D, ids=ids, n_buckets=nb,
                              slack_frac=0.3, min_slack=5)
        for f in ("codes", "ids", "values", "cap_starts", "n_used",
                  "positions"):
            assert np.array_equal(getattr(ta, f), getattr(ja, f)), (nb, f)
        assert ta.n_live == ja.n_live and ta.capacity == ja.capacity
        assert np.array_equal(tlay.hamming_key_host(codes, ta.positions),
                              jlay.hamming_key_host(codes, ja.positions))
    assert np.array_equal(tlay.bucket_capacities([0, 3, 40], 0.25, 8),
                          jlay.bucket_capacities([0, 3, 40], 0.25, 8))
    empty = tlay.build_arena(np.zeros((0, W), np.uint32), D,
                             ids=np.zeros(0, np.int64), n_buckets=4)
    jempty = jlay.build_arena(np.zeros((0, W), np.uint32), D,
                              ids=np.zeros(0, np.int64), n_buckets=4)
    assert np.array_equal(empty.positions, jempty.positions)
    assert empty.capacity == jempty.capacity == 32
    with pytest.raises(ValueError, match="id-ascending"):
        tlay.build_arena(codes[:2], D, ids=np.array([3, 1]))


def test_churn_flush_search_equals_reference_and_rebuild():
    rng = np.random.default_rng(1)
    j, t = _pair(rng, slack_frac=0.1, min_slack=2)
    _churn([j, t], rng)
    _same_store(j, t)
    assert t.stats()["compactions"] > 0 and t.stats()["overflow"] == 0
    q = _codes(rng, 9)
    q[0] = t.arena.codes[t._id_map[int(t.epoch.store_ids[5])]]
    for k in (1, 8, 2000):
        td, ti = t.search(q, k)
        jd, ji = j.search(q, k)
        assert np.array_equal(td, np.asarray(jd)), k
        assert np.array_equal(ti, ji), k
    # == a from-scratch rebuild of the same logical contents
    ep = t.epoch
    order = np.argsort(ep.store_ids)
    fresh = tmut.MutableStore(tlay.build_arena(
        ep.layout.codes.numpy().view(np.uint32)[order], D,
        ids=ep.store_ids[order], values=ep.values.numpy()[order],
        positions=t.arena.positions), device="cpu")
    assert fresh.epoch.checksum == ep.checksum
    assert np.array_equal(fresh.epoch.store_ids, ep.store_ids)
    assert torch.equal(fresh.epoch.layout.codes, ep.layout.codes)
    assert torch.equal(fresh.epoch.layout.starts, ep.layout.starts)
    eng = teng.KNNEngine.from_epoch(ep, D)
    assert eng.layout is ep.layout and eng.codes is ep.layout.codes
    fd, fi = fresh.search(q, 8)
    td, ti = t.search(q, 8)
    assert np.array_equal(fd, td) and np.array_equal(fi, ti)
    view = t.datastore_view(itq=object())
    assert view.codes is ep.layout.codes and view.layout is ep.layout
    assert np.array_equal(view.key_positions.numpy(), t.arena.positions)
    assert t.audit()["ok"]


def test_epoch_pinning_and_visibility():
    rng = np.random.default_rng(2)
    _, t = _pair(rng, n=100)
    ep = t.epoch
    q = _codes(rng, 3)
    before = t.search(q, 5)
    new = _codes(rng, 4)
    t.append(new)
    assert t.epoch is ep and t.pending_mutations == 4
    assert np.array_equal(t.search(q, 5)[1], before[1])
    t.flush()
    assert t.epoch is not ep and t.epoch.n == 104
    assert ep.n == 100                 # the pinned epoch never changed
    with pytest.raises(ValueError, match="exceed every prior id"):
        t.append(new, ids=[3, 4, 5, 6])
    empty = tmut.MutableStore.create(np.zeros((0, W), np.uint32), D,
                                     n_buckets=4, device="cpu")
    dd, ii = empty.search(q, 4)
    assert (dd == D + 1).all() and (ii == -1).all()


def test_crash_recover_and_cross_package_roots(tmp_path):
    """Churn with a WAL; crash without close (and tear the log's last
    record); recover in both packages from BOTH roots: every recovery
    lands on the same epoch checksum, audits clean and searches alike."""
    rng = np.random.default_rng(3)
    root = str(tmp_path)
    j, t = _pair(rng, root=root, slack_frac=0.2)
    _churn([j, t], rng, rounds=3)
    j.snapshot(), t.snapshot()
    _churn([j, t], rng, rounds=2)
    extra = _codes(rng, 5)
    for st in (j, t):
        st.append(extra)               # recovery replays it from the WAL
    _same_store(j, t)
    want = None
    for st in (j, t):
        st.flush()
        want = st.epoch.checksum if want is None else want
        assert st.epoch.checksum == want
    q = _codes(rng, 6)
    ref = t.search(q, 7)
    for sub, Rec in (("t", tmut.MutableStore), ("j", tmut.MutableStore),
                     ("t", jmut.MutableStore), ("j", jmut.MutableStore)):
        kw = {"device": "cpu"} if Rec is tmut.MutableStore else {}
        rec = Rec.recover(os.path.join(root, sub), **kw)
        assert rec.epoch.checksum == want, (sub, Rec)
        assert rec.audit()["ok"]
        got = rec.search(q, 7)
        assert np.array_equal(np.asarray(got[0]), ref[0])
        assert np.array_equal(got[1], ref[1])
        rec.close()
    # torn tail: the last whole record survives, the torn one is dropped
    wal = os.path.join(root, "t", "wal.log")
    t.delete([int(t.epoch.store_ids[0])])
    t._wal.close()
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 3)
    rec = tmut.MutableStore.recover(os.path.join(root, "t"), device="cpu")
    assert rec.epoch.checksum == want and rec.audit()["ok"]


def test_fault_sites_never_lose_acked_mutations(tmp_path):
    rng = np.random.default_rng(4)
    inj = tfaults.FaultInjector(seed=0, p={})
    t = tmut.MutableStore.create(_codes(rng, 64), D, n_buckets=4,
                                 root=str(tmp_path), fault_injector=inj,
                                 device="cpu")
    inj.p["wal_append"] = 1.0
    with pytest.raises(tfaults.InjectedFault):
        t.append(_codes(rng, 2))
    assert t._next_id == 64            # never acked, never applied
    inj.p["wal_append"] = 0.0
    ids = t.append(_codes(rng, 3))
    inj.p["epoch_install"] = 1.0
    with pytest.raises(tfaults.InjectedFault):
        t.flush()
    inj.p["epoch_install"] = 0.0
    inj.p["compact_build"] = 1.0
    with pytest.raises(tfaults.InjectedFault):
        t.compact()
    t._wal.close()
    rec = tmut.MutableStore.recover(str(tmp_path), device="cpu")
    assert set(ids.tolist()) <= set(rec.epoch.store_ids.tolist())
    assert rec.n_live == 67 and rec.audit()["ok"]


def test_audit_detects_corruption_like_the_reference():
    rng = np.random.default_rng(5)
    j, t = _pair(rng, n=120)
    for st in (j, t):
        slot = st._id_map[5]
        st.arena.ids[slot + 1] = 5          # a duplicate live id
    tr, jr = t.audit(strict=False), j.audit(strict=False)
    assert not tr["ok"] and tr["problems"] == jr["problems"]
    with pytest.raises(tmut.AuditError):
        t.audit()
    _, t2 = _pair(rng, n=50)
    t2._epoch = t2.epoch._replace(checksum=t2.epoch.checksum ^ 1)
    assert "epoch checksum mismatch" in t2.audit(strict=False)["problems"]
