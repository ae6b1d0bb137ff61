"""PyTorch port vs the JAX reference: the sharded exact kNN on
``torch.distributed`` (``ops.hamming_topk_sharded``, ``ops._tree_psum``,
``approx_select.approx_topk_sharded``, ``plan._execute_sharded``,
``engine.search_sharded`` / ``shard_datastore`` and
``retrieval.knn_logits(mesh=...)``).

The port's side runs in a world of gloo ranks on the CPU
(``_torch_world.World``: one world at a time, 4, 6 or 8 ranks, started
once each for this module; rank tasks in ``_torch_shard_tasks.py``). Every
rank must return the same answer, and that answer must be bit-identical
(dists and ids) to ``repro.kernels.ops.hamming_topk`` — Pallas in
interpret mode — over the concatenated valid rows, or the surviving rows
where shards are dead: the contract ``repro`` itself tests in
tests/test_sharded_merge.py and tests/test_shard_faults.py. Some cases are
also held against ``repro``'s own ``search_sharded`` and
``approx_topk_sharded`` under ``shard_map``, run once on the same numpy
inputs in a subprocess with 4 host devices (``conftest.run_multidevice``).
Integers are compared exactly everywhere; ``knn_logits`` within 1e-6.
"""
import dataclasses
import functools
import warnings

import numpy as np
import jax.numpy as jnp
import pytest

import _torch_shard_tasks as tasks
from _torch_world import World
from repro.core import plan as jplan
from repro.core import retrieval as jret
from repro.configs import get_config as jget_config
from repro.configs import scaled_down as jscaled_down
from repro.kernels import ops as jops
from repro_torch.configs import get_config, scaled_down

D, Q, K = 64, 8, 16
BINS = D + 1
_rng = np.random.default_rng(11)
CODES = _rng.integers(0, 1 << 32, (2400, 2), dtype=np.uint32)
QUERIES = _rng.integers(0, 1 << 32, (Q, 2), dtype=np.uint32)
# uneven: 4 shards padded to 256 rows; shard 2 holds 11 valid rows
N_LOC = 256
NV = np.array([150, 256, 11, 101], np.int32)
PADDED = CODES[:4 * N_LOC]
VALID = [PADDED[s * N_LOC:s * N_LOC + NV[s]] for s in range(4)]

MESHES = {4: ((4,), ("data",)), 6: ((6,), ("data",)),
          8: ((8,), ("data",)), "2x4": ((2, 4), ("host", "data")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
WORLD_OF = {4: 4, 6: 6, 8: 8, "2x4": 8, "2x2x2": 8}


class _Worlds:
    """At most one world at a time: a test asks for n ranks and gets the
    open world, or a new one after the old one closed."""

    def __init__(self):
        self.world = None

    def get(self, n):
        if self.world is None or self.world.n != n:
            self.close()
            self.world = World(n)
        return self.world

    def close(self):
        if self.world is not None:
            self.world.close()
            self.world = None


@pytest.fixture(scope="module")
def worlds():
    pool = _Worlds()
    yield pool
    pool.close()


def _run(worlds, key, fn, *args):
    """Run a task on the world of mesh ``key``; every rank's answer must
    be the same, and that answer is returned."""
    shape, names = MESHES[key]
    outs = worlds.get(WORLD_OF[key]).run(fn, shape, names, *args)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
    return outs[0]


@functools.lru_cache(maxsize=None)
def _ref(rows_key, k):
    """repro's single-device fused select over a named set of rows."""
    rows = _ROWS[rows_key]()
    d, i = jops.hamming_topk(jnp.asarray(QUERIES), jnp.asarray(rows), k, BINS)
    return np.asarray(d), np.asarray(i)


_ROWS = {
    "all": lambda: CODES,
    "valid": lambda: np.concatenate(VALID),
    **{f"valid-{s}": (lambda s=s: np.concatenate(
        [VALID[t] for t in range(4) if t != s])) for s in range(4)},
    **{f"even4-{s}": (lambda s=s: np.concatenate(
        [CODES[t * 600:(t + 1) * 600] for t in range(4) if t != s]))
       for s in range(4)},
}


def _same(got, want, what=""):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"dists {what}")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"ids {what}")


def _true_dists(rows, ids):
    """Each id's real Hamming distance to its query (numpy)."""
    x = rows[np.minimum(ids, len(rows) - 1)]                  # (Q, k, W)
    xor = np.bitwise_xor(QUERIES[:, None, :], x)
    return np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1)


# ---------------------------------------------------------------------------
# repro's own sharded search under shard_map, once, on the same inputs
# ---------------------------------------------------------------------------

_REPRO_SCRIPT = """
import warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import engine
from repro.kernels import approx_select
warnings.simplefilter("ignore")
inp = np.load({inp!r})
codes, q, nv = inp["codes"], inp["q"], jnp.asarray(inp["nv"])
part = jnp.asarray([1, 1, 0, 1], jnp.int32)
d = {d}
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
def search(k, **kw):
    return jax.jit(lambda c, qq: engine.search_sharded(
        c, qq, k, d, mesh, ("data",), **kw))(codes, q)
def approx(rt, **kw):
    def local(x, qq):
        extra = dict(kw)
        if "n_valid" in extra:
            extra["n_valid"] = extra["n_valid"][jax.lax.axis_index("data")]
        return approx_select.approx_topk_sharded(
            qq, x, {k}, d + 1, ("data",), n_shards=4, recall_target=rt,
            bn=64, **extra)
    f = shard_map(local, mesh=mesh, in_specs=(P("data", None), P(None, None)),
                  out_specs=(P(None, None), P(None, None)))
    return jax.jit(f)(jnp.asarray(codes), jnp.asarray(q))
out = {{}}
with mesh:
    out["hist_merge"] = search({k})
    out["reorder_local"] = search({k}, reorder_local=True)
    out["concat_k4"] = search({k}, k_local=4)
    out["uneven_dead_tree"] = search(64, merge="hist_tree", fanout=2,
                                     shard_n_valid=nv, shard_participate=part)
    out["uneven_reorder"] = search(64, reorder_local=True, shard_n_valid=nv)
    out["uneven_concat_k4"] = search({k}, k_local=4, shard_n_valid=nv)
    out["approx_0.7"] = approx(0.7)
    out["approx_0.9_uneven_dead"] = approx(0.9, n_valid=nv, participate=part)
np.savez({out_path!r}, **{{f"{{key}}_{{j}}": np.asarray(v[j])
                          for key, v in out.items() for j in (0, 1)}})
print("OK")
"""


@pytest.fixture(scope="module")
def repro_sharded(multidevice, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repro_sharded")
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, codes=PADDED, q=QUERIES, nv=NV)
    multidevice(_REPRO_SCRIPT.format(inp=inp, out_path=out, d=D, k=K),
                n_devices=4)
    res = np.load(out)
    return {key[:-2]: (res[key[:-2] + "_0"], res[key[:-2] + "_1"])
            for key in res.files if key.endswith("_0")}


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hist_merge", "reorder_local", "concat_k4",
                                  "uneven_dead_tree", "uneven_reorder",
                                  "uneven_concat_k4"])
def test_matches_repro_search_sharded(worlds, repro_sharded, case):
    """The same numpy inputs through repro's search_sharded under
    shard_map (4 host devices) and the port's on 4 gloo ranks."""
    kw = {"hist_merge": {}, "reorder_local": {"reorder_local": True},
          "concat_k4": {"k_local": 4},
          "uneven_dead_tree": {"merge": "hist_tree", "fanout": 2,
                               "shard_n_valid": NV,
                               "shard_participate": [1, 1, 0, 1]},
          "uneven_reorder": {"reorder_local": True, "shard_n_valid": NV},
          "uneven_concat_k4": {"k_local": 4, "shard_n_valid": NV}}
    k = 64 if case in ("uneven_dead_tree", "uneven_reorder") else K
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _run(worlds, 4, tasks.search, PADDED, QUERIES, k, D, kw[case])
    _same(got, repro_sharded[case], case)


@pytest.mark.parametrize("rt,case", [(0.7, "approx_0.7"),
                                     (0.9, "approx_0.9_uneven_dead")])
def test_approx_sharded_matches_reference_geometry(worlds, repro_sharded, rt,
                                                   case):
    """Below recall_target 1 the pool depends on the geometry: at repro's
    bn both packages keep the same pool and merge it the same way."""
    kw = {"recall_target": rt, "bn": 64}
    if "uneven" in case:
        kw.update(n_valid_all=NV, participate=np.array([1, 1, 0, 1]))
    got = _run(worlds, 4, tasks.approx, PADDED, QUERIES, K, BINS, kw)
    _same(got, repro_sharded[case], case)


@pytest.mark.parametrize("kw,rows", [
    ({}, "all"),
    ({"n_valid_all": NV}, "valid"),
    ({"n_valid_all": NV, "participate": np.array([1, 0, 1, 1])}, "valid-1"),
])
def test_approx_sharded_at_recall_one_equals_fused(worlds, kw, rows):
    codes = CODES[:2400] if rows == "all" else PADDED
    got = _run(worlds, 4, tasks.approx, codes, QUERIES, K, BINS,
               dict(kw, recall_target=1.0))
    _same(got, _ref(rows, K), rows)


@pytest.mark.parametrize("k", [64, 1200])
@pytest.mark.parametrize("merge", ["hist_merge", "hist_tree", "concat_sort"])
def test_uneven_shards_match_reference(worlds, merge, k):
    """Per-shard n_valid, k larger than one shard's valid rows (64 > 11)
    and larger than every valid row (1200 > 518): bit-identical to the
    fused select over the concatenated valid rows, sentinels included."""
    kw = {"shard_n_valid": NV, "merge": merge, "fanout": 2}
    if merge == "concat_sort":
        kw["select"] = "fused"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _run(worlds, 4, tasks.search, PADDED, QUERIES, k, D, kw)
    _same(got, _ref("valid", k), merge)


@pytest.mark.parametrize("k", [64, 1200])
@pytest.mark.parametrize("dead", [0, 1, 2, 3])
def test_participation_matches_surviving_rows(worlds, dead, k):
    """Every single-dead pattern over uneven shards, flat and tree merge:
    ids renumber exactly as a store rebuilt from the surviving rows."""
    part = np.ones(4, np.int32)
    part[dead] = 0
    want = _ref(f"valid-{dead}", k)
    for merge in ("hist_merge", "hist_tree"):
        got = _run(worlds, 4, tasks.search, PADDED, QUERIES, k, D,
                   {"shard_n_valid": NV, "shard_participate": part,
                    "merge": merge, "fanout": 2})
        _same(got, want, (merge, dead))


def test_participation_on_even_shards_and_all_dead(worlds):
    """Even shards without n_valid: id bases from the masked counts on the
    host; all shards dead: pure (bins, 0) sentinels."""
    part = np.array([1, 0, 1, 1], np.int32)
    got = _run(worlds, 4, tasks.search, CODES, QUERIES, K, D,
               {"shard_participate": part})
    _same(got, _ref("even4-1", K), "even, shard 1 dead")
    dd, ii = _run(worlds, 4, tasks.search, PADDED, QUERIES, K, D,
                  {"shard_n_valid": NV,
                   "shard_participate": np.zeros(4, np.int32)})
    assert (dd == BINS).all() and (ii == 0).all()


def test_participation_refused_by_the_concat_merge(worlds):
    with pytest.raises(AssertionError, match="hist-family"):
        _run(worlds, 4, tasks.search, CODES, QUERIES, K, D,
             {"merge": "concat_sort", "shard_participate": [1, 1, 1, 1]})


def test_uneven_shards_refused_by_a_materializing_select(worlds):
    """Only the two-pass kernels (and the approx tier) mask per-shard
    padding: a forced counting select is refused with guidance, as repro
    refuses it."""
    with pytest.raises(AssertionError, match="needs the fused or approx"):
        _run(worlds, 4, tasks.search, PADDED, QUERIES, K, D,
             {"select": "counting", "shard_n_valid": NV})


def test_reorder_local_keeps_the_distances(worlds):
    """Per-shard local_sort: the distance vector equals the reference and
    every id carries its real distance (tie picks follow layout order)."""
    zero_pads = PADDED.copy()
    for s in range(4):
        zero_pads[s * N_LOC + NV[s]:(s + 1) * N_LOC] = 0
    for codes, kw, rows, k in ((CODES, {}, "all", K),
                               (PADDED, {"shard_n_valid": NV}, "valid", 64),
                               # all-zero pads would sort first if the sort
                               # did not pin them last
                               (zero_pads, {"shard_n_valid": NV}, "valid",
                                64)):
        dd, ii = _run(worlds, 4, tasks.search, codes, QUERIES, k, D,
                      dict(kw, reorder_local=True))
        want_d, _ = _ref(rows, k)
        np.testing.assert_array_equal(dd, want_d)
        live = dd <= D
        np.testing.assert_array_equal(
            _true_dists(_ROWS[rows](), ii)[live], dd[live])


def _masks(seed, n_shards, n_loc, bq=8, bn=64):
    m = np.random.default_rng(seed).random((n_shards, Q // bq,
                                            n_loc // bn)) < 0.5
    m[:, :, 0] = True
    return m.astype(np.int32)


@pytest.mark.parametrize("emit,k,one_tile", [("split", K, False),
                                             ("single", K, False),
                                             ("split", 300, True)])
def test_block_mask_matches_reference(worlds, emit, k, one_tile):
    """Each rank's (Q_pad/bq, n_loc/bn) enable mask; the shards' masks
    side by side are the single-device mask over the concatenation. With
    one enabled tile and k = 300 > its 64 rows, the surplus slots get the
    single-device sentinels."""
    masks = _masks(5, 4, 600 // 64 * 64)
    if one_tile:
        masks[:] = 0
        masks[1, 0, 3] = 1
    codes = np.concatenate([CODES[s * 600:s * 600 + 576] for s in range(4)])
    got = _run(worlds, 4, tasks.topk_sharded, codes, QUERIES, k, BINS,
               {"block_masks": masks, "bq": 8, "bn": 64, "sub": 8,
                "emit": emit})
    glob = np.concatenate(list(masks), axis=1)
    d, i = jops.hamming_topk(jnp.asarray(QUERIES), jnp.asarray(codes), k,
                             BINS, block_mask=jnp.asarray(glob), bq=8, bn=64,
                             sub=8)
    _same(got, (np.asarray(d), np.asarray(i)), emit)


@pytest.mark.parametrize("kw", [
    {},
    {"n_valid_all": NV},
    {"n_valid_all": NV, "participate": np.array([1, 1, 0, 1])},
    {"tree_fanout": 2, "n_valid_all": NV},
], ids=["even", "uneven", "uneven-dead", "tree"])
def test_split_emit_matches_single_run(worlds, kw):
    """Each shard's K2 split over runs of N tiles (bases from K1's per-run
    histograms plus the shard's) fills exactly the slots of the single-run
    emit; bn = 32 gives each shard 8 runs."""
    outs = [_run(worlds, 4, tasks.topk_sharded, PADDED, QUERIES, 40, BINS,
                 dict(kw, bq=8, bn=32, sub=8, emit=emit))
            for emit in ("split", "single")]
    _same(outs[0], outs[1], "split vs single")


def test_kernel_failure_propagates_without_fallback(worlds):
    """On CPU tensors the ranks take the plain K1/K2 and count no launch;
    a failing K2 wrapper raises out of search_sharded on every rank —
    nothing gives way to another path."""
    counts, raised = _run(worlds, 4, tasks.no_fallback, CODES, QUERIES, K, D)
    assert counts == (0, 0)
    assert "topk_emit_launch" in raised


def test_knn_logits_sharded_matches_reference(worlds):
    """knn_logits(mesh=...) with each rank holding its slice of the codes
    equals repro's knn_logits on the whole store (exact selects agree bit
    for bit, so the neighbour distributions match to 1e-6)."""
    jc = jscaled_down(jget_config("gemma-2b"), dtype="float32")
    tc = scaled_down(get_config("gemma-2b"), dtype="float32")
    # exact sharded serving: k' = k, so the plan is hist_merge
    jc = dataclasses.replace(jc, retrieval=dataclasses.replace(
        jc.retrieval, local_k=jc.retrieval.k))
    tc = dataclasses.replace(tc, retrieval=dataclasses.replace(
        tc.retrieval, local_k=tc.retrieval.k))
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((64 * 4, jc.d_model)).astype(np.float32)
    nxt = rng.integers(0, jc.vocab_size, 64 * 4).astype(np.int32)
    store = jret.build_datastore(jnp.asarray(hidden), jnp.asarray(nxt),
                                 jc.retrieval.code_bits, itq_iters=3)
    h = rng.standard_normal((3, jc.d_model)).astype(np.float32)
    want = np.asarray(jret.knn_logits(store, jnp.asarray(h), jc.retrieval,
                                      jc.vocab_size))
    store_np = (np.asarray(store.codes), np.asarray(store.values),
                np.asarray(store.itq.mean), np.asarray(store.itq.proj),
                np.asarray(store.itq.rot))
    got, compact = _run(worlds, 4, tasks.knn_logits, store_np, h,
                        tc.retrieval, tc.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-6)
    jp = jplan.plan_sharded(
        jplan.stats_for(256, jc.retrieval.code_bits, store.codes.shape[1],
                        3, k=jc.retrieval.k, n_shards=4),
        jc.retrieval.k, axes=("data",), k_local=jc.retrieval.local_k)
    assert compact == jp.compact()


def test_plan_sharded_on_the_ranks_matches_reference(worlds):
    for kw in ({}, {"merge": "hist_tree"}, {"k_local": 4},
               {"select": "approx", "recall_target": 0.9}):
        got = _run(worlds, 4, tasks.plan_of, 1 << 16, 2, Q, K, D, kw)
        jp = jplan.plan_sharded(jplan.stats_for(1 << 16, D, 2, Q,
                                                n_shards=4),
                                K, axes=("data",), **kw)
        # the one wording that differs (the port's composite path is
        # torch.topk): the pinned "XLA top_k" divergence
        assert tuple(got) == (jp.compact(),
                              jp.reason.replace("XLA top_k", "top_k")), kw


# ---------------------------------------------------------------------------
# 4, 6 and 8 ranks, and a 2 x 4 mesh: every strategy on even shards, and
# the tree reduction against the flat one
# ---------------------------------------------------------------------------

_EVEN = [(4, "hist_merge", 0), (4, "hist_tree", 2), (4, "hist_tree", 3),
         (4, "concat_sort", 0),
         (6, "hist_merge", 0), (6, "hist_tree", 2), (6, "hist_tree", 3),
         (6, "hist_tree", 4), (6, "concat_sort", 0),
         (8, "hist_merge", 0), (8, "hist_tree", 2), (8, "hist_tree", 4),
         (8, "concat_sort", 0),
         ("2x4", "hist_merge", 0), ("2x4", "hist_tree", 2),
         ("2x4", "concat_sort", 0),
         ("2x2x2", "hist_merge", 0), ("2x2x2", "hist_tree", 2),
         ("2x2x2", "concat_sort", 0)]


@pytest.mark.parametrize("key,merge,fanout", _EVEN, ids=[
    f"{w}-{m}{f or ''}" for w, m, f in _EVEN])
def test_even_shards_match_reference(worlds, key, merge, fanout):
    """2400 rows over 4, 6 or 8 ranks (600, 400, 300 each), flat, 2-D or
    3-D mesh: every merge bit-identical to the fused select over all rows; the
    tree's rounds (divisible and remainder) sum exactly as the flat
    all-reduce does, and the all-gather through all_reduce is in flat-shard
    order."""
    got = _run(worlds, key, tasks.search, CODES, QUERIES, K, D,
               {"merge": merge, "fanout": fanout})
    _same(got, _ref("all", K), (key, merge, fanout))
    if merge == "hist_tree":
        shape, names = MESHES[key]
        outs = worlds.get(WORLD_OF[key]).run(tasks.tree_psum, shape, names,
                                             fanout)
        for tree, flat_sum, gathered, flat in outs:
            np.testing.assert_array_equal(tree, flat_sum)
            assert gathered[flat].tolist() == (
                np.arange(6).reshape(2, 3) * (flat + 1) + flat).tolist()
        n = len(outs)
        want = sum(np.arange(6).reshape(2, 3) * (f + 1) + f
                   for f in range(n))
        np.testing.assert_array_equal(outs[0][0], want)
        assert sorted(o[3] for o in outs) == list(range(n))


def test_statistical_reduction_on_a_3d_mesh(worlds):
    """k' = 4 over the 8 shards of a (pod, data, model) mesh: each shard's
    local top-4 (the fused select over its 300 rows), gathered in flat-shard
    order and cut by one stable sort — the reduction repro runs — and its
    recall against the exact top-16."""
    dd, ii = _run(worlds, "2x2x2", tasks.search, CODES, QUERIES, K, D,
                  {"k_local": 4, "select": "fused"})
    local = [jops.hamming_topk(jnp.asarray(QUERIES),
                               jnp.asarray(CODES[s * 300:(s + 1) * 300]), 4,
                               BINS) for s in range(8)]
    ld = np.concatenate([np.asarray(d) for d, _ in local], axis=1)
    li = np.concatenate([np.asarray(i) + s * 300
                         for s, (_, i) in enumerate(local)], axis=1)
    order = np.argsort(ld, axis=1, kind="stable")
    _same((dd, ii), (np.take_along_axis(ld, order, 1)[:, :K],
                     np.take_along_axis(li, order, 1)[:, :K]))
    exact = _ref("all", K)[1]
    recall = np.mean([np.isin(exact[r], ii[r]).mean() for r in range(Q)])
    assert recall > 0.5, recall
