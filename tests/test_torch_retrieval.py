"""PyTorch port vs the JAX reference: ITQ (``core/quantize.py``) and
kNN-LM retrieval (``core/retrieval.py``).

Float-trained state crosses with ``carry.itq``/``carry.datastore``, and
everything downstream of it is compared exactly: codes (away from
projections within 1e-5 of zero, where f32 rounding may flip a sign) and
the (dists, ids) of every select path. Log-probabilities are compared
with atol 1e-6 (the neighbor weights are summed in another order). A
port-trained ITQ cannot match the reference bit for bit (SVD signs, the
JAX PRNG), so it is held to invariants: the same PCA subspace, an
orthogonal rotation and an objective within 2 % of the reference's."""
import dataclasses
import logging
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.core import binary as jbin
from repro.core import plan as jplan
from repro.core import quantize as jq
from repro.core import retrieval as jret
from repro_torch import carry
from repro_torch.configs import get_config, scaled_down
from repro_torch.core import binary as tbin
from repro_torch.core import plan as tplan
from repro_torch.core import quantize as tq
from repro_torch.core import retrieval as tret


def _data(n=1500, dim=64, seed=0):
    """Gaussian rows with a decaying spectrum (a clear gap at every PCA
    rank), so the subspaces the two packages find are well defined."""
    rng = np.random.default_rng(seed)
    scale = np.exp(-np.arange(dim) / 12.0).astype(np.float32)
    return (rng.standard_normal((n, dim)).astype(np.float32) * scale
            + rng.standard_normal(dim).astype(np.float32))


def _cfgs(**rkw):
    jc = jscaled_down(jget_config("gemma-2b"), dtype="float32")
    tc = scaled_down(get_config("gemma-2b"), dtype="float32")
    if rkw:
        jc = dataclasses.replace(jc, retrieval=dataclasses.replace(
            jc.retrieval, **rkw))
        tc = dataclasses.replace(tc, retrieval=dataclasses.replace(
            tc.retrieval, **rkw))
    return jc, tc


def test_itq_encode_with_carried_params_is_exact():
    x = _data()
    p = jq.itq_train(jnp.asarray(x), 32, iters=10)
    tp = carry.itq(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    ref = np.asarray(jq.itq_encode(jnp.asarray(x), p))
    out = tq.itq_encode(torch.from_numpy(x), tp).numpy()
    proj = np.asarray(jq.itq_project(jnp.asarray(x), p))
    np.testing.assert_allclose(
        tq.itq_project(torch.from_numpy(x), tp).numpy(), proj, atol=1e-5)
    clear = np.abs(proj) >= 1e-5
    assert clear.mean() > 0.999
    assert np.array_equal(out[clear], ref[clear])
    np.testing.assert_allclose(float(tq.itq_objective(torch.from_numpy(x),
                                                      tp)),
                               float(jq.itq_objective(jnp.asarray(x), p)),
                               rtol=1e-5)
    # packed, the codes keep repro's uint32 bit pattern
    assert np.array_equal(tbin.pack_bits(torch.from_numpy(ref.copy())).numpy()
                          .view(np.uint32), np.asarray(jbin.pack_bits(ref)))


@pytest.mark.parametrize("bits", [16, 32])
def test_itq_train_invariants(bits):
    x = _data(seed=1)
    ref = jq.itq_train(jnp.asarray(x), bits, iters=20)
    out = tq.itq_train(torch.from_numpy(x), bits, iters=20,
                       generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean),
                               atol=1e-5)
    pr, pt = np.asarray(ref.proj), out.proj.numpy()
    # the same PCA subspace: equal orthogonal projectors
    np.testing.assert_allclose(pt @ pt.T, pr @ pr.T, atol=1e-3)
    rot = out.rot.numpy()
    np.testing.assert_allclose(rot.T @ rot, np.eye(bits), atol=1e-5)
    jo = float(jq.itq_objective(jnp.asarray(x), ref))
    to = float(tq.itq_objective(torch.from_numpy(x), out))
    assert abs(to - jo) <= 0.02 * jo
    # training lowers the objective from the PCA start
    start = out._replace(rot=torch.eye(bits))
    assert to < float(tq.itq_objective(torch.from_numpy(x), start))


def test_lsh_encode_with_carried_planes():
    x = _data(n=200, seed=2)
    p = jq.lsh_train(64, 32)
    tp = tq.LSHParams(proj=carry.tensor(np.asarray(p.proj), "cpu"))
    assert np.array_equal(tq.lsh_encode(torch.from_numpy(x), tp).numpy(),
                          np.asarray(jq.lsh_encode(jnp.asarray(x), p)))
    assert tq.lsh_train(64, 32, device="cpu").proj.shape == (64, 32)


@pytest.fixture(scope="module")
def stores():
    """A reference datastore built from hidden-like rows, with and without
    a hamming-prefix layout, carried to the port."""
    rng = np.random.default_rng(3)
    h = _data(n=3000, dim=128, seed=3)
    nxt = rng.integers(0, 512, 3000).astype(np.int32)
    out = {}
    for lay in ("none", "hamming_prefix"):
        js = jret.build_datastore(jnp.asarray(h), jnp.asarray(nxt), 64,
                                  itq_iters=6, layout=lay)
        out[lay] = (js, carry.datastore(
            jax.tree_util.tree_map(np.asarray, js), device="cpu"))
    return out


@pytest.mark.parametrize("layout", ["none", "hamming_prefix"])
@pytest.mark.parametrize("select", [None, "fused", "counting", "composite"])
def test_knn_logits_matches_reference(stores, layout, select):
    jc, tc = _cfgs(layout=layout, code_bits=64, k=16)
    js, ts = stores[layout]
    hid = _data(n=12, dim=128, seed=4)
    proj = np.asarray(jq.itq_project(jnp.asarray(hid), js.itq))
    assert np.abs(proj).min() >= 1e-5          # no sign a rounding can flip
    jp = jret.plan_for_store(js, jc.retrieval, 12, select=select)
    tp = tret.plan_for_store(ts, tc.retrieval, 12, select=select)
    assert tp.compact() == jp.compact()
    q_j = jbin.pack_bits(jq.itq_encode(jnp.asarray(hid), js.itq))
    q_t = tbin.pack_bits(tq.itq_encode(torch.from_numpy(hid), ts.itq))
    jd, ji = jplan.execute(jp, q_j, codes=js.codes, layout=js.layout)
    td, ti = tplan.execute(tp, q_t, codes=ts.codes, layout=ts.layout)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    ref = jret.knn_logits(js, jnp.asarray(hid), jc.retrieval, 512,
                          select=select)
    out = tret.knn_logits(ts, torch.from_numpy(hid), tc.retrieval, 512,
                          select=select)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_build_datastore_codes_from_carried_itq(stores):
    """The port's build with the reference's ITQ gives the reference's
    codes; its own build gives a store of the same shape and values."""
    js, ts = stores["none"]
    h = _data(n=3000, dim=128, seed=3)
    codes = tbin.pack_bits(tq.itq_encode(torch.from_numpy(h), ts.itq))
    proj = np.asarray(jq.itq_project(jnp.asarray(h), js.itq))
    rows = (np.abs(proj) >= 1e-5).all(axis=1)
    assert rows.mean() > 0.99
    assert np.array_equal(codes.numpy()[rows],
                          np.asarray(js.codes).view(np.int32)[rows])
    own = tret.build_datastore(torch.from_numpy(h), ts.values, 64,
                               itq_iters=6, layout="hamming_prefix")
    assert own.codes.shape == ts.codes.shape and own.codes.dtype == torch.int32
    assert torch.equal(own.values, ts.values)
    assert own.layout.codes.shape == own.codes.shape


def test_interpolate_matches_reference():
    rng = np.random.default_rng(5)
    lm_logits = rng.standard_normal((4, 512)).astype(np.float32) * 3
    knn = np.log(np.maximum(rng.dirichlet(np.ones(512) * 0.05, 4), 1e-9))
    knn = knn.astype(np.float32)
    ref = jret.interpolate(jnp.asarray(lm_logits), jnp.asarray(knn), 0.25)
    out = tret.interpolate(torch.from_numpy(lm_logits),
                           torch.from_numpy(knn), 0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)


def test_synthetic_datastore_and_logged_plan(caplog):
    jc, tc = _cfgs()
    st = tret.synthetic_datastore(tc, device="cpu")
    ref = jret.synthetic_datastore(jc)
    assert st.codes.shape == ref.codes.shape and st.codes.dtype == torch.int32
    assert int(st.values.max()) < tc.vocab_size
    assert torch.equal(st.itq.rot, torch.eye(64))
    log = logging.getLogger("test_torch_retrieval")
    with caplog.at_level(logging.INFO):
        p = tret.log_store_plan(st, tc.retrieval, 4, log)
    jp = jret.plan_for_store(ref, jc.retrieval, 4)
    assert p.compact() == jp.compact()
    assert p.reason.startswith("auto->composite")
    assert "active plan" in caplog.text


def test_unported_retrieval_paths_raise(stores):
    """Sharded plans, the degraded probe calls and the approx tier, ported
    since, run and agree with repro (the sharded search itself in
    test_torch_sharded.py): a sharded store's plan is repro's for the same
    shard count, the store's codes being one rank's slice."""
    jc, tc = _cfgs(code_bits=64)
    js, ts = stores["hamming_prefix"]
    hid = torch.zeros((2, 128))
    n_loc = ts.codes.shape[0] // 4
    sharded = ts._replace(codes=ts.codes[:n_loc])
    jmesh = types.SimpleNamespace(shape={"data": 4})
    tmesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                  size=lambda dim: 4)
    for rcfg_kw in ({}, {"local_k": 16}):
        jr = dataclasses.replace(jc.retrieval, **rcfg_kw)
        tr = dataclasses.replace(tc.retrieval, **rcfg_kw)
        jp = jret.plan_for_store(js._replace(codes=js.codes[:n_loc * 4]),
                                 jr, 2, mesh=jmesh, axes=("data",))
        tp = tret.plan_for_store(sharded, tr, 2, mesh=tmesh, axes=("data",))
        assert (tp.compact(), tp.n_shards, tp.n) == (jp.compact(), 4, jp.n)
        assert tp.merge == tplan.MergeStage(**dataclasses.asdict(jp.merge))
    hid_np = np.random.default_rng(4).standard_normal((3, 128)).astype(
        np.float32)
    for rt in (0.8, 1.0):
        out = tret.knn_logits(ts, torch.from_numpy(hid_np), tc.retrieval,
                              512, select="approx", recall_target=rt)
        ref = jret.knn_logits(js, jnp.asarray(hid_np), jc.retrieval, 512,
                              select="approx", recall_target=rt)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        assert (tret.plan_for_store(ts, tc.retrieval, 3, select="approx",
                                    recall_target=rt).compact()
                == jret.plan_for_store(js, jc.retrieval, 3, select="approx",
                                       recall_target=rt).compact())
    pos = tret.probe_key_positions(ts, tc.retrieval)
    assert np.array_equal(pos.numpy(), np.asarray(
        jret.probe_key_positions(js, jc.retrieval)))
    assert (tret.degraded_plan_for_store(ts, tc.retrieval, 2, 4).compact()
            == jret.degraded_plan_for_store(js, jc.retrieval, 2, 4).compact())
    out = tret.knn_logits(ts, hid, tc.retrieval, 512, nprobe=4,
                          probe_positions=pos)
    assert out.shape == (2, 512) and bool(torch.isfinite(out).all())


def test_probe_key_positions_match_reference(stores):
    """The key bits of a hamming-prefix store, recomputed from its codes;
    none without a layout or with a bucket count off a power of two."""
    jc, tc = _cfgs(code_bits=64)
    js, ts = stores["hamming_prefix"]
    pos = tret.probe_key_positions(ts, tc.retrieval)
    assert pos.dtype == torch.int32
    assert 1 << pos.shape[0] == ts.layout.n_buckets
    assert np.array_equal(pos.numpy(), np.asarray(
        jret.probe_key_positions(js, jc.retrieval)))
    assert tret.probe_key_positions(stores["none"][1], tc.retrieval) is None
    odd = ts._replace(layout=ts.layout._replace(starts=ts.layout.starts[:-1]))
    assert tret.probe_key_positions(odd, tc.retrieval) is None
    frozen = ts._replace(key_positions=torch.arange(3, dtype=torch.int32))
    assert (tret.probe_key_positions(frozen, tc.retrieval)
            is frozen.key_positions)


@pytest.mark.parametrize("nprobe", [1, 4, 64])
def test_degraded_knn_logits_matches_reference(stores, nprobe):
    """knn_logits(nprobe>0, probe_positions) on a carried hamming-prefix
    store: the masked plan, its (dists, ids) and the log-probabilities."""
    jc, tc = _cfgs(layout="hamming_prefix", code_bits=64, k=16)
    js, ts = stores["hamming_prefix"]
    hid = _data(n=12, dim=128, seed=6)
    jpos = jret.probe_key_positions(js, jc.retrieval)
    tpos = tret.probe_key_positions(ts, tc.retrieval)
    jp = jret.degraded_plan_for_store(js, jc.retrieval, 12, nprobe)
    tp = tret.degraded_plan_for_store(ts, tc.retrieval, 12, nprobe)
    assert tp.compact() == jp.compact() == (
        f"probe:hamming_prefix@{nprobe}|cand:block_mask+prebuilt|"
        "select:fused|merge:none")
    assert tp.reason == jp.reason
    q_j = jbin.pack_bits(jq.itq_encode(jnp.asarray(hid), js.itq))
    q_t = tbin.pack_bits(tq.itq_encode(torch.from_numpy(hid), ts.itq))
    jprobe = jret._bucket_probe(q_j, jpos, js.layout.n_buckets, nprobe, 64)
    tprobe = tret._bucket_probe(q_t, tpos, ts.layout.n_buckets, nprobe, 64)
    assert np.array_equal(tprobe.numpy(), np.asarray(jprobe))
    jd, ji = jplan.execute(jp, q_j, layout=js.layout, probe=jprobe)
    td, ti = tplan.execute(tp, q_t, layout=ts.layout, probe=tprobe)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    ref = jret.knn_logits(js, jnp.asarray(hid), jc.retrieval, 512,
                          nprobe=nprobe, probe_positions=jpos)
    out = tret.knn_logits(ts, torch.from_numpy(hid), tc.retrieval, 512,
                          nprobe=nprobe, probe_positions=tpos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
