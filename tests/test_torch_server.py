"""PyTorch port vs the JAX reference: the continuous-batching server with
kNN-LM retrieval in every decode step (``runtime/server.py``), its step
builders (``dist/steps.py``) and the serving launcher.

Both servers run the same carried f32 weights (``scaled_down`` gemma-2b)
and the same carried datastore, built by the reference from the model's
own hidden states, on the same requests: the reference on a 1x1 mesh, the
port on the CPU. Their output tokens must be identical and their
``stats()`` counters equal (latencies aside); with a seeded
``FaultInjector`` on ``store_search`` both count the same retries,
failures and failover ticks."""
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
from repro.core import retrieval as jret
from repro.dist import steps as jsteps
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime import server as jserver
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.core import retrieval as tret
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
    """The approx variant still raises; the degraded probe variant, ported
    since, is memoized on its probe positions and its step's logits agree
    with repro's on a carried hamming-prefix store."""
    jc, tc, params, model, store, _, corpus, mesh = env
    fn = steps.make_serve_step(tc, 16)
    assert steps.make_serve_step(tc, 16) is fn
    assert steps.make_serve_step(tc, 16, with_retrieval=False) is not fn
    with pytest.raises(NotImplementedError, match="item 9"):
        steps.make_serve_step(tc, 16, select="approx", recall_target=0.9)
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


@pytest.mark.parametrize("option,value,queue", [
    ("degradation", tserver.DegradationPolicy(), "item 9"),
    ("snapshot_dir", "/nonexistent", "item 10"),
    ("snapshot_every", 4, "item 10"),
    ("audit_every", 4, "item 10"),
    ("tenants", object(), "item 10"),
    ("shard_search", object(), "item 8"),
    ("shard_axes", ("data",), "item 8"),
])
def test_unported_server_options_raise(env, option, value, queue):
    tc, model, tstore = env[1], env[3], env[5]
    with pytest.raises(NotImplementedError, match=queue):
        tserver.Server(tc, model, max_batch=1, max_len=8, store=tstore,
                       device="cpu", **{option: value})


def test_mutable_store_raises(env):
    tc, model, tstore = env[1], env[3], env[5]

    class Mutable:
        def datastore_view(self):
            return tstore

    with pytest.raises(NotImplementedError, match="item 10"):
        tserver.Server(tc, model, max_batch=1, max_len=8, store=Mutable(),
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
