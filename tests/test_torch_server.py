"""PyTorch port vs the JAX reference: the continuous-batching server with
kNN-LM retrieval in every decode step (``runtime/server.py``), its step
builders (``dist/steps.py``) and the serving launcher.

Both servers run the same carried f32 weights (``scaled_down`` gemma-2b)
and the same carried datastore, built by the reference from the model's
own hidden states, on the same requests: the reference on a 1x1 mesh, the
port on the CPU. Their output tokens must be identical and their
``stats()`` counters equal (latencies aside); with a seeded
``FaultInjector`` on ``store_search`` both count the same retries,
failures and failover ticks; with a ``FaultTolerantSearch`` attached
(``shard_search``) both walk the same shard-loss rung under the same kill
schedule. With ``mesh`` and ``shard_axes`` (a 4-rank gloo world) the port's
server logs the reference's sharded plan and serves the same tokens."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import compat
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.core import layout as jlay
from repro.core import mutable as jmut
from repro.core import tenant as jten
from repro.core import retrieval as jret
from repro.dist import search as jsearch
from repro.dist import steps as jsteps
from repro.models import frontends as jfrontends
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime import server as jserver
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.core import mutable as tmut
from repro_torch.core import retrieval as tret
from repro_torch.core import tenant as tten
from repro_torch.dist import search as tsearch
from repro_torch.dist import steps
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import server as tserver

TIMING = {"p50_token_s", "p99_token_s", "mean_tick_s"}


@pytest.fixture(scope="module")
def env():
    jc = jscaled_down(jget_config("gemma-2b"), dtype="float32")
    tc = scaled_down(get_config("gemma-2b"), dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    model = carry.lm_params(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    corpus = np.random.default_rng(1).integers(
        0, jc.vocab_size, (8, 64)).astype(np.int32)
    _, _, hidden = jlm.forward(params, jc, jnp.asarray(corpus),
                               return_hidden=True)
    h = hidden[:, :-1].reshape(-1, jc.d_model)
    store = jret.build_datastore(h, jnp.asarray(corpus[:, 1:].reshape(-1)),
                                 jc.retrieval.code_bits, itq_iters=6)
    tstore = carry.datastore(jax.tree_util.tree_map(np.asarray, store),
                             device="cpu")
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    return jc, tc, params, model, store, tstore, corpus, mesh


def _requests(mod, corpus, n=5):
    return [mod.Request(uid=i, prompt=corpus[i, :3 + i % 3].copy(),
                        max_new_tokens=5) for i in range(n)]


def _serve_both(env, max_batch=2, max_len=24, **kw):
    jc, tc, params, model, store, tstore, corpus, mesh = env
    jkw = {k: (v() if callable(v) else v) for k, v in kw.items()}
    tkw = {k: (v(torch=True) if callable(v) else v) for k, v in kw.items()}
    js = jserver.Server(jc, mesh, params, max_batch=max_batch,
                        max_len=max_len, store=store, **jkw)
    ts = tserver.Server(tc, model, max_batch=max_batch, max_len=max_len,
                        store=tstore, device="cpu", **tkw)
    admitted = []
    for srv, mod in ((js, jserver), (ts, tserver)):
        admitted.append([srv.submit(req) for req in _requests(mod, corpus)])
        srv.run(max_ticks=200)
    assert admitted[0] == admitted[1]
    return js, ts


def _assert_same(js, ts):
    assert [r.uid for r in ts.done] == [r.uid for r in js.done]
    for a, b in zip(ts.done, js.done):
        assert a.out_tokens == b.out_tokens, a.uid
        assert (a.status, a.finish_reason, a.admit_tick, a.finish_tick) == (
            b.status, b.finish_reason, b.admit_tick, b.finish_tick)
    sj, st = js.stats(), ts.stats()
    assert set(st) == set(sj)
    assert {k: v for k, v in st.items() if k not in TIMING} == {
        k: v for k, v in sj.items() if k not in TIMING}
    assert st["lost"] == 0


def test_server_matches_reference(env):
    js, ts = _serve_both(env)
    _assert_same(js, ts)
    assert ts.stats()["done"] == 5 and ts.rung == 0
    assert ts.retrieval_plan.compact() == js.retrieval_plan.compact()


def test_fault_injection_counts_match_reference(env):
    def injector(torch=False):
        mod = tfaults if torch else jfaults
        return mod.FaultInjector(seed=3, p={"store_search": 0.5})

    js, ts = _serve_both(env, fault_injector=injector, search_retries=1)
    _assert_same(js, ts)
    s = ts.stats()
    assert s["search_retries"] > 0 and s["failover_ticks"] > 0
    assert s["rung"] == "retrieval_off" and s["transitions"] == 1
    assert ts.transitions == js.transitions


def test_deadlines_and_queue_shedding_match_reference(env):
    js, ts = _serve_both(env, max_batch=1, max_queue=2,
                         default_deadline_ticks=9)
    _assert_same(js, ts)
    s = ts.stats()
    assert s["shed"] == 3 and s["timed_out"] >= 1, s


def test_serve_step_is_memoized_and_degraded_variants_raise(env):
    """The degraded variants are memoized: the probe variant on its probe
    positions, the approx variant on its recall target; both steps' logits
    agree with repro's on a carried hamming-prefix store."""
    jc, tc, params, model, store, _, corpus, mesh = env
    fn = steps.make_serve_step(tc, 16)
    assert steps.make_serve_step(tc, 16) is fn
    assert steps.make_serve_step(tc, 16, with_retrieval=False) is not fn
    afn = steps.make_serve_step(tc, 16, select="approx", recall_target=0.9)
    assert afn is not fn and steps.make_serve_step(
        tc, 16, select="approx", recall_target=0.9) is afn
    assert steps.make_serve_step(tc, 16, select="approx",
                                 recall_target=0.8) is not afn
    jstore = store._replace(layout=jlay.build_layout(
        store.codes, jc.retrieval.code_bits, n_buckets=8))
    tstore = carry.datastore(jax.tree_util.tree_map(np.asarray, jstore),
                             device="cpu")
    jpos = jret.probe_key_positions(jstore, jc.retrieval)
    tpos = tret.probe_key_positions(tstore, tc.retrieval)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    tfn = steps.make_serve_step(tc, 16, nprobe=2, probe_positions=tpos)
    assert tfn is not fn
    assert steps.make_serve_step(tc, 16, nprobe=2, probe_positions=tpos) is tfn
    jfn, _, _ = jsteps.make_serve_step(jc, mesh, 16, nprobe=2,
                                       probe_positions=jpos)
    token = corpus[:2, :1]
    jl, _ = jfn(params, jnp.asarray(token), jlm.init_decode_state(jc, 2, 16),
                jnp.ones((2,), bool), jstore)
    tl, _ = tfn(model, torch.from_numpy(token),
                tlm.init_decode_state(tc, 2, 16, device="cpu"),
                torch.ones(2, dtype=torch.bool), tstore)
    assert tl.shape == (2, 1, tc.vocab_size)
    # f32: only the order of sums differs (tests/test_torch_models.py)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-5)
    jafn, _, _ = jsteps.make_serve_step(jc, mesh, 16, select="approx",
                                        recall_target=0.8)
    tafn = steps.make_serve_step(tc, 16, select="approx", recall_target=0.8)
    jl, _ = jafn(params, jnp.asarray(token),
                 jlm.init_decode_state(jc, 2, 16), jnp.ones((2,), bool),
                 jstore)
    tl, _ = tafn(model, torch.from_numpy(token),
                 tlm.init_decode_state(tc, 2, 16, device="cpu"),
                 torch.ones(2, dtype=torch.bool), tstore)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-5)


def test_prefill_step_matches_reference_prefill(env):
    jc, tc, params, model, _, _, corpus, _ = env
    fn = steps.make_prefill_step(tc, seq_len=20, attn_impl="flash",
                                 device="cpu")
    logits, state = fn(model, {"tokens": corpus[:2, :20]})
    ref, rstate = jlm.prefill(params, jc, jnp.asarray(corpus[:2, :20]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)
    assert state["pos"].tolist() == [20, 20]
    assert logits.is_inference()


class _FakeMesh:
    """What ``repro``'s ``log_store_plan`` reads of a mesh: axis sizes."""

    def __init__(self, **sizes):
        self.shape = sizes


def _local_k(cfg, local_k):
    return dataclasses.replace(cfg, retrieval=dataclasses.replace(
        cfg.retrieval, local_k=local_k))


@pytest.fixture(scope="module")
def sharded_serving(env):
    """Servers with ``mesh`` and ``shard_axes=("data",)`` on every rank
    of a 4-rank gloo world, at local_k 4 (the concat_sort merge) and 16
    (hist_merge); the same requests as the other tests."""
    import _torch_shard_tasks as tasks
    from _torch_world import World

    tc, model, tstore, corpus = env[1], env[3], env[5], env[6]
    prompts = [r.prompt for r in _requests(tserver, corpus)]
    out = {}
    with World(4) as world:
        for local_k in (4, 16):
            out[local_k] = world.run(tasks.serve, (4,), ("data",),
                                     _local_k(tc, local_k), model, tstore,
                                     prompts, 5)
    return out


@pytest.mark.parametrize("local_k", [4, 16])
def test_shard_axes_logs_the_reference_sharded_plan(env, sharded_serving,
                                                    local_k):
    """``repro``'s server logs ``log_store_plan(store, ..., mesh=mesh,
    axes=shard_axes)`` over its whole store; the port's logs the same
    plan, merge geometry and lines on every rank."""
    import logging

    jc, store = env[0], env[4]
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("reference_plan")
    logger.addHandler(Keep(logging.INFO))
    logger.setLevel(logging.INFO)
    ref = jret.log_store_plan(store, _local_k(jc, local_k).retrieval, q=2,
                              logger=logger, mesh=_FakeMesh(data=4),
                              axes=("data",))
    assert ref.merge.kind == "sharded" and ref.n_shards == 4
    assert ref.merge.strategy == ("hist_merge" if local_k == 16
                                  else "concat_sort")
    for compact, merge, logged, _ in sharded_serving[local_k]:
        assert compact == ref.compact()
        assert merge == ref.geometry()["merge"]
        assert logged[:2] == lines
        assert f"{store.codes.shape[0]} entries" in logged[0]


@pytest.mark.parametrize("local_k", [4, 16])
def test_shard_axes_serves_the_same_tokens(env, sharded_serving, local_k):
    """The decode step stays local over the server's store: with
    ``shard_axes`` every rank serves what a server without them serves."""
    tc, model, tstore, corpus = env[1], env[3], env[5], env[6]
    ts = tserver.Server(_local_k(tc, local_k), model, max_batch=2,
                        max_len=24, store=tstore, device="cpu")
    for req in _requests(tserver, corpus):
        ts.submit(req)
    ts.run(max_ticks=200)
    want = {r.uid: list(r.out_tokens) for r in ts.done}
    assert len(want) == 5
    for *_, tokens in sharded_serving[local_k]:
        assert tokens == want
    assert ts.retrieval_plan.merge.kind == "none"


def test_shard_axes_need_a_mesh(env):
    tc, model, tstore = env[1], env[3], env[5]
    with pytest.raises(ValueError, match="mesh"):
        tserver.Server(tc, model, max_batch=1, max_len=8, store=tstore,
                       device="cpu", shard_axes=("data",))


def test_shard_loss_rung_matches_reference(env):
    """Both servers shadow the store with a FaultTolerantSearch of its codes
    (4 units, factor 1). unit2 killed after 3 ticks: each serves the
    degraded view of the covered rows (shard_losses 1); revived with its
    data 3 ticks later, maintain() brings the full store back
    (shard_recoveries 1). Tokens and stats() — stats()["shards"] included
    — are equal, and nothing is lost."""
    jc, tc, params, model, store, tstore, corpus, mesh = env
    codes = np.asarray(store.codes)
    jf = jsearch.FaultTolerantSearch(codes, jc.retrieval.code_bits)
    tf = tsearch.FaultTolerantSearch(codes, tc.retrieval.code_bits,
                                     device="cpu")
    js = jserver.Server(jc, mesh, params, max_batch=2, max_len=24,
                        store=store, shard_search=jf)
    ts = tserver.Server(tc, model, max_batch=2, max_len=24, store=tstore,
                        device="cpu", shard_search=tf)
    for srv, mod, fts in ((js, jserver, jf), (ts, tserver, tf)):
        for req in _requests(mod, corpus):
            srv.submit(req)
        for _ in range(3):
            srv.tick()
        fts.kill("unit2")
        for _ in range(3):
            srv.tick()
        assert srv.store is not srv._full_store
        assert srv.store.codes.shape[0] == fts.coverage().covered_rows
        fts.revive("unit2", with_data=True)
        srv.run(max_ticks=200)
        assert srv.store is srv._full_store
    _assert_same(js, ts)
    st = ts.stats()
    assert (st["shard_losses"], st["shard_recoveries"]) == (1, 1)
    assert st["shard_degraded_ticks"] == 3 and st["coverage_frac"] == 1.0
    assert st["shards"]["registry"]["states"]["unit2"] == "healthy"
    with pytest.raises(ValueError, match="covers"):
        tserver.Server(tc, model, max_batch=2, max_len=24,
                       store=tstore._replace(codes=tstore.codes[:8]),
                       device="cpu", shard_search=tf)


def test_mutable_store_raises(env, tmp_path):
    """A MutableStore attaches (ported since): both servers serve its
    epoch, take the same online appends and deletes between ticks,
    compact, flush, audit and snapshot alike; tokens and stats() agree.
    A store on another device than the server's still raises."""
    jc, tc, params, model, store, tstore, corpus, mesh = env
    d = jc.retrieval.code_bits
    codes = np.asarray(store.codes)
    values = np.asarray(store.values)
    jm = jmut.MutableStore.create(codes[:300], d, values=values[:300],
                                  n_buckets=8, itq=store.itq,
                                  root=str(tmp_path / "j"), slack_frac=0.1)
    tm = tmut.MutableStore.create(codes[:300], d, values=values[:300],
                                  n_buckets=8, itq=tstore.itq,
                                  root=str(tmp_path / "t"), slack_frac=0.1,
                                  device="cpu")
    servers = [jserver.Server(jc, mesh, params, max_batch=2, max_len=24,
                              store=jm, audit_every=3, snapshot_every=5,
                              snapshot_dir=str(tmp_path / "unused")),
               tserver.Server(tc, model, max_batch=2, max_len=24, store=tm,
                              device="cpu", audit_every=3, snapshot_every=5,
                              snapshot_dir=str(tmp_path / "unused"))]
    for srv, mod in zip(servers, (jserver, tserver)):
        for req in _requests(mod, corpus):
            srv.submit(req)
        rng = np.random.default_rng(5)
        row = 300
        while srv.has_work and srv.ticks < 200:
            if srv.ticks % 2 == 0 and row < codes.shape[0] - 20:
                assert srv.submit_append(codes[row:row + 20],
                                         values=values[row:row + 20])
                assert srv.submit_delete(rng.choice(row, 7, replace=False))
                row += 20
            srv.tick()
    _assert_same(*servers)
    st = servers[1].stats()
    assert st["mutations_applied"] > 0 and st["audits"] > 0
    assert st["audit_failures"] == 0 and st["store_epoch"] > 1
    assert jm.epoch.checksum == tm.epoch.checksum
    other = tmut.MutableStore.create(codes[:50], d, itq=tstore.itq,
                                     device="meta")
    with pytest.raises(ValueError, match="the store is on"):
        tserver.Server(tc, model, max_batch=1, max_len=8, store=other,
                       device="cpu")


def test_degradation_policy_matches_reference():
    """The pure controller walks the same rungs on the same pressure."""
    jp, tp = jserver.DegradationPolicy(queue_high=3, cooldown_ticks=2), \
        tserver.DegradationPolicy(queue_high=3, cooldown_ticks=2)
    rj = rt = 0
    for q, dt in [(0, .01), (3, .02), (4, .01), (1, .01), (0, .03),
                  (0, .01), (1, .01), (5, .2), (0, .01)]:
        rj = jp.update(rj, 5, q, dt)
        rt = tp.update(rt, 5, q, dt)
        assert rt == rj and tp.ewma_s == pytest.approx(jp.ewma_s)


def test_launcher_scaled_on_cpu(capsys):
    srv = tserve.main(["--arch", "gemma-2b", "--scaled", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--max-batch", "2", "--max-len", "16"])
    assert srv.stats()["done"] == 3 and srv.stats()["lost"] == 0
    assert "served 3/3 requests" in capsys.readouterr().out
    assert dataclasses.replace(srv.cfg) == scaled_down(get_config("gemma-2b"))


def _layout_env(env, n_buckets=16):
    jc, tc, params, model, store, _, corpus, mesh = env
    jstore = store._replace(layout=jlay.build_layout(
        store.codes, jc.retrieval.code_bits, n_buckets=n_buckets))
    tstore = carry.datastore(jax.tree_util.tree_map(np.asarray, jstore),
                             device="cpu")
    return jc, tc, params, model, jstore, tstore, corpus, mesh


def _transitions(srv):
    return [t[:3] for t in srv.transitions]


def test_degradation_ladder_walk_matches_reference(env):
    """Under the same DegradationPolicy both servers build the same ladder
    (exact, probe rungs, approx_rt95/90/80, retrieval_off), a burst walks
    it all the way down, calm ticks walk it back up, and every served
    token and counter agrees."""
    lenv = _layout_env(env)
    jc, tc, params, model, jstore, tstore, corpus, mesh = lenv

    def policy(torch=False):
        mod = tserver if torch else jserver
        return mod.DegradationPolicy(queue_high=2, queue_low=0,
                                     cooldown_ticks=2)

    servers = []
    for mod, make in ((jserver, lambda p: jserver.Server(
            jc, mesh, params, max_batch=1, max_len=24, store=jstore,
            degradation=p)),
                      (tserver, lambda p: tserver.Server(
            tc, model, max_batch=1, max_len=24, store=tstore, device="cpu",
            degradation=p))):
        srv = make(policy(torch=mod is tserver))
        for i in range(12):
            srv.submit(mod.Request(uid=i, prompt=corpus[i % 8, :2].copy(),
                                   max_new_tokens=2))
        srv.run(max_ticks=300)
        uid = 100                       # calm ticks walk the ladder back
        while srv.rung != 0 and srv.ticks < 400:
            if not srv.has_work:
                srv.submit(mod.Request(uid=uid, prompt=corpus[0, :1].copy(),
                                       max_new_tokens=1))
                uid += 1
            srv.tick()
        servers.append(srv)
    js, ts = servers
    names = [r.name for r in ts.rungs]
    assert names == [r.name for r in js.rungs]
    assert names[0] == "exact" and names[-1] == "retrieval_off"
    assert names[-4:-1] == ["approx_rt95", "approx_rt90", "approx_rt80"]
    assert any(n.startswith("probe") for n in names)
    visited = {t[2] for t in ts.transitions} | {"exact"}
    assert visited == set(names), ts.transitions
    assert ts.rung == 0
    assert _transitions(ts) == _transitions(js)
    for r in ts.rungs:
        assert ts._rung_plan_str(r) == js._rung_plan_str(r)
    _assert_same(js, ts)


def test_snapshot_restore_fallback_matches_reference(env, tmp_path):
    """One injected search fault with no retries restores the store from
    the last-good snapshot, written by each package at startup; the step
    completes at the same rung, and periodic snapshots are saved."""
    class OneShot:
        """Raises once, on the first check of the search site."""

        def __init__(self, mod):
            self.mod = mod
            self.inner = mod.FaultInjector(seed=0, p={})

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def check(self, site, tenant=None):
            self.inner.check(site, tenant)
            if site == "store_search" and self.inner.calls[site] == 1:
                raise self.mod.InjectedFault(site)

    js, ts = _serve_both(
        env, max_batch=1, search_retries=0, snapshot_every=3,
        fault_injector=lambda torch=False: OneShot(
            tfaults if torch else jfaults),
        snapshot_dir=lambda torch=False: str(
            tmp_path / ("t" if torch else "j")))
    _assert_same(js, ts)
    s = ts.stats()
    assert s["snapshot_restores"] == 1 and s["failover_ticks"] == 0
    assert s["snapshot_saves"] > 1 and ts.transitions == []


def test_tenant_arena_serving_matches_reference(env, tmp_path):
    """A TenantArena attached to both servers: the per-tenant admission
    ladder (quota, rate limit), maintenance, snapshots and tenant_search
    agree with repro, and a mixed batch equals each tenant's own store."""
    jc, tc, params, model, store, tstore, corpus, mesh = env
    d = jc.retrieval.code_bits
    codes = np.asarray(store.codes)
    quota = {"a": dict(max_rows=140), "b": dict(max_mutations_per_tick=10)}
    out = []
    for mod, tmod in ((jserver, jten), (tserver, tten)):
        kw = {} if mod is jserver else {"device": "cpu"}
        arena = tmod.TenantArena(d, root=str(tmp_path / mod.__name__),
                                 bn=64, slack_frac=0.1, **kw)
        for tid, (lo, hi) in (("a", (0, 120)), ("b", (120, 200)),
                              ("c", (200, 203))):
            arena.create_tenant(tid, codes[lo:hi],
                                quota=tmod.TenantQuota(**quota.get(tid, {})))
        if mod is jserver:
            srv = mod.Server(jc, mesh, params, max_batch=1, max_len=16,
                             store=store, tenants=arena, snapshot_every=4)
        else:
            srv = mod.Server(tc, model, max_batch=1, max_len=16,
                             store=tstore, tenants=arena, snapshot_every=4,
                             device="cpu")
        acks = []
        for t in range(10):
            acks.append(srv.submit_append(codes[200 + 8 * t:208 + 8 * t],
                                          tenant="a"))
            acks.append(srv.submit_append(codes[280 + 12 * t:292 + 12 * t],
                                          tenant="b"))
            acks.append(srv.submit_delete([t], tenant="c"))
            srv.tick()
        q = {"a": codes[400:405], "b": codes[405:413], "c": codes[413:415]}
        out.append((acks, srv.tenant_search(q, 9), srv.stats(), arena, q))
    (jacks, jres, jst, _, _), (tacks, tres, tst, tarena, q) = out
    assert tacks == jacks and not all(tacks) and any(tacks)
    for tid in q:
        assert np.array_equal(tres[tid][0], jres[tid][0])
        assert np.array_equal(tres[tid][1], jres[tid][1])
        own = tarena.tenant(tid).store.search(q[tid], 9)
        assert np.array_equal(own[0], tres[tid][0])
        assert np.array_equal(own[1], tres[tid][1])
    for key in ("mutations_applied", "mutations_shed", "compactions",
                "snapshot_saves", "n_tenants", "packed_rows"):
        assert tst[key] == jst[key], key
    assert tst["tenants"].keys() == jst["tenants"].keys()
    for tid in q:
        assert tst["tenants"][tid] == jst["tenants"][tid], tid


# ---------------------------------------------------------------------------
# the recurrent families: zamba2-2.7b (Mamba2 hybrid) and rwkv6-1.6b
# ---------------------------------------------------------------------------

RECURRENT = ["zamba2-2.7b", "rwkv6-1.6b"]


@pytest.fixture(scope="module", params=RECURRENT)
def rec_env(request):
    """The gemma ``env`` for one recurrent arch: scaled f32 weights and a
    datastore built by the reference from the model's hidden states."""
    arch = request.param
    jc = jscaled_down(jget_config(arch), dtype="float32")
    tc = scaled_down(get_config(arch), dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    model = carry.lm_params(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    corpus = np.random.default_rng(2).integers(
        0, jc.vocab_size, (8, 48)).astype(np.int32)
    _, _, hidden = jax.jit(lambda p, t: jlm.forward(
        p, jc, t, return_hidden=True))(params, jnp.asarray(corpus))
    store = jret.build_datastore(
        hidden[:, :-1].reshape(-1, jc.d_model),
        jnp.asarray(corpus[:, 1:].reshape(-1)), jc.retrieval.code_bits,
        itq_iters=6)
    tstore = carry.datastore(jax.tree_util.tree_map(np.asarray, store),
                             device="cpu")
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    return jc, tc, params, model, store, tstore, corpus, mesh


def _serve(mod, srv, corpus, uids):
    reqs = [mod.Request(uid=i, prompt=corpus[i, :3 + i % 3].copy(),
                        max_new_tokens=4) for i in uids]
    for r in reqs:
        assert srv.submit(r)
    srv.run(max_ticks=200)
    return {r.uid: r.out_tokens for r in reqs}


def _servers(env, max_batch):
    jc, tc, params, model, store, tstore, corpus, mesh = env
    return (jserver.Server(jc, mesh, params, max_batch=max_batch,
                           max_len=24, store=store),
            tserver.Server(tc, model, max_batch=max_batch, max_len=24,
                           store=tstore, device="cpu"))


def test_recurrent_server_matches_reference_on_fresh_slots(rec_env):
    """Two requests on two fresh slots: the same tokens, ticks and
    ``stats()`` counters as the reference, with retrieval in every step."""
    js, ts = _servers(rec_env, 2)
    corpus = rec_env[6]
    assert _serve(jserver, js, corpus, [0, 1]) == _serve(tserver, ts, corpus,
                                                         [0, 1])
    _assert_same(js, ts)
    assert ts.retrieval_plan.compact() == js.retrieval_plan.compact()


def test_reused_slot_starts_from_a_zero_recurrent_state(rec_env):
    """One slot serves requests 0, 1, 2 in turn. The port zeroes the
    slot's Mamba2 / RWKV6 state rows on admission, so requests 1 and 2
    get the tokens a fresh reference server gives each alone; the
    reference keeps the last request's state there and its tokens differ
    for at least one of them (ROADMAP queue 3, pinned divergence; the
    retrieval mixture can hide the difference in a short answer). Request 0, on a fresh slot, is
    served alike by both."""
    corpus = rec_env[6]
    js, ts = _servers(rec_env, 1)
    reused_j = _serve(jserver, js, corpus, [0, 1, 2])
    reused_t = _serve(tserver, ts, corpus, [0, 1, 2])
    fresh = {}
    for uid in (1, 2):
        js1, ts1 = _servers(rec_env, 1)
        fresh[uid] = _serve(jserver, js1, corpus, [uid])[uid]
        assert _serve(tserver, ts1, corpus, [uid])[uid] == fresh[uid]
    assert reused_t[0] == reused_j[0]
    assert all(reused_t[uid] == fresh[uid] for uid in (1, 2))
    assert any(reused_j[uid] != fresh[uid] for uid in (1, 2)), (reused_j,
                                                                 fresh)
    assert ts.stats()["lost"] == 0 and ts.stats()["done"] == 3


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_recurrent_archs_on_cpu(capsys, arch):
    srv = tserve.main(["--arch", arch, "--scaled", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--max-batch", "2", "--max-len", "16"])
    assert srv.stats()["done"] == 3 and srv.stats()["lost"] == 0
    assert "served 3/3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the MoE and frontend families: kimi-k2 and llava-next-mistral-7b
# ---------------------------------------------------------------------------

NEW_SERVED = ["kimi-k2-1t-a32b", "llava-next-mistral-7b"]


@pytest.fixture(scope="module", params=NEW_SERVED)
def new_env(request):
    """The gemma ``env`` for an MoE or a frontend arch: scaled f32 weights
    and a datastore built by the reference from the model's hidden states
    over the corpus (after a synthetic prefix for the frontend config,
    whose positions the store leaves out). The servers take tokens
    alone, in both packages."""
    arch = request.param
    jc = jscaled_down(jget_config(arch), dtype="float32")
    tc = scaled_down(get_config(arch), dtype="float32")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    model = carry.lm_params(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    corpus = np.random.default_rng(3).integers(
        0, jc.vocab_size, (8, 48)).astype(np.int32)
    pre = jfrontends.synthetic_prefix(jc, 8)
    _, _, hidden = jax.jit(lambda p, t, e: jlm.forward(
        p, jc, t, e, return_hidden=True))(params, jnp.asarray(corpus), pre)
    P = jc.frontend_positions
    store = jret.build_datastore(
        hidden[:, P:-1].reshape(-1, jc.d_model),
        jnp.asarray(corpus[:, 1:].reshape(-1)), jc.retrieval.code_bits,
        itq_iters=6)
    tstore = carry.datastore(jax.tree_util.tree_map(np.asarray, store),
                             device="cpu")
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    return jc, tc, params, model, store, tstore, corpus, mesh


def test_moe_and_frontend_servers_match_reference(new_env):
    """Three requests on two slots (one reused): the same tokens, ticks
    and ``stats()`` counters as the reference, with retrieval in every
    decode step."""
    js, ts = _servers(new_env, 2)
    corpus = new_env[6]
    assert _serve(jserver, js, corpus, [0, 1, 2]) == _serve(
        tserver, ts, corpus, [0, 1, 2])
    _assert_same(js, ts)
    assert ts.stats()["done"] == 3


@pytest.mark.parametrize("arch", ["granite-20b", "internlm2-20b",
                                  "deepseek-67b", "llava-next-mistral-7b",
                                  "musicgen-medium", "arctic-480b",
                                  "kimi-k2-1t-a32b"])
def test_launcher_new_archs_on_cpu(capsys, arch):
    srv = tserve.main(["--arch", arch, "--scaled", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--max-batch", "2", "--max-len", "16"])
    assert srv.stats()["done"] == 3 and srv.stats()["lost"] == 0
    assert "served 3/3 requests" in capsys.readouterr().out
