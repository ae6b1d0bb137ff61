"""PyTorch port vs the JAX reference: the local planner
(repro_torch.core.plan). For the same StoreStats, select requests,
layout policies and forced-plan overrides, both packages must choose the
same stages, and write the same reason and compact strings; the cost hints
``explain()`` reports must agree; what the port has not ported raises.
Index plans (``plan_index``) and their forced overrides too, and sharded
plans (``plan_sharded``): merge strategies, merge keys of ``parse_force``
and the ``merge`` part of ``explain()``."""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro_torch.core import plan as tplan

FLAT = dict(n=1 << 17, d=128, w=4, q=256, backend="cpu")
LAY = dict(FLAT, has_layout=True, mean_bucket_rows=256, n_buckets=512)

SELECTS = [None, "auto", "composite", "counting", "bisect", "fused",
           "fused_scan", "approx"]
FORCES = [None, "layout=off", "select=fused_scan,chunk=4096",
          "layout=local_sort", "select=counting,layout=prebuilt", "k_local=4",
          "merge=hist_merge", "fanout=4", "reorder_local=1",
          "candidates=gather", "candidates=full", "recall_target=0.9",
          "select=approx,recall_target=0.9", "method=mxu",
          {"select": "bisect", "chunk": "1000"}]


def _norm(reason: str) -> str:
    # the reference names XLA's top_k; the port's composite path is
    # torch.topk — the only wording that differs
    return reason.replace("XLA top_k", "top_k")


def _ref_explain(je: dict) -> dict:
    """The reference's ``explain()`` without the geometry keys the port has
    no counterpart of: the TPU sub-step, its one-hot footprint and the
    autotune cache's hint source."""
    je["geometry"] = {k: v for k, v in je["geometry"].items()
                      if k not in ("sub", "onehot_bytes", "hint_source")}
    return je


def _plans(stats_kw, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the local_sort fallback warns
        return (jplan.plan_local(jplan.StoreStats(**stats_kw), 16, **kw),
                tplan.plan_local(tplan.StoreStats(**stats_kw), 16, **kw))


def _same(jp, tp):
    assert dataclasses.asdict(tp.select) == dataclasses.asdict(jp.select)
    assert dataclasses.asdict(tp.candidates) == dataclasses.asdict(
        jp.candidates)
    assert dataclasses.asdict(tp.probe) == dataclasses.asdict(jp.probe)
    assert tp.merge.kind == jp.merge.kind == "none"
    assert tp.reason == _norm(jp.reason)
    assert tp.compact() == jp.compact()


@pytest.mark.parametrize("stats", ["flat", "layout"])
@pytest.mark.parametrize("policy", ["auto", "require", "off"])
@pytest.mark.parametrize("select", SELECTS)
def test_plan_local_matches_reference(stats, policy, select):
    jp, tp = _plans(FLAT if stats == "flat" else LAY, select=select,
                    layout_policy=policy)
    _same(jp, tp)


@pytest.mark.parametrize("force", FORCES, ids=str)
@pytest.mark.parametrize("stats", ["flat", "layout"])
def test_forced_plan_overrides_match_reference(stats, force):
    jp, tp = _plans(FLAT if stats == "flat" else LAY, force=force)
    _same(jp, tp)


@pytest.mark.parametrize("select", ["auto", "composite", "counting", "fused",
                                    "fused_scan"])
@pytest.mark.parametrize("stats", ["flat", "layout"])
def test_explain_matches_reference(stats, select):
    """Everything but the kernel names (the port names its own kernels)."""
    jp, tp = _plans(FLAT if stats == "flat" else LAY, select=select)
    je, te = _ref_explain(jp.explain()), tp.explain()
    for key in ("shape", "stages", "geometry", "predicted_pruning",
                "compact"):
        assert te[key] == je[key], key
    assert te["reason"] == _norm(je["reason"])
    assert te["kernels"] and "QueryPlan[" in tp.explain_str()


def test_bad_requests_raise_like_reference():
    stats = tplan.StoreStats(**FLAT)
    with pytest.raises(ValueError):
        tplan.plan_local(stats, 16, select="nope")
    for bad in ("select=auto", "select=nope", "layout=sideways",
                "candidates=nope", "merge=nope", "recall_target=2",
                "bogus=1", "novalue"):
        with pytest.raises(ValueError):
            jplan.plan_local(jplan.StoreStats(**FLAT), 16, force=bad)
        with pytest.raises(ValueError):
            tplan.plan_local(stats, 16, force=bad)
    assert tplan.parse_force("a=1, b = 2,,") == jplan.parse_force(
        "a=1, b = 2,,")


def test_unported_paths_raise_not_implemented():
    """The approximate tier, K3 (method='pallas'), gather candidates and
    sharded plans, ported since, run and agree with the reference (sharded
    ones in test_torch_sharded.py); a sharded plan without its mesh
    raises rather than running another path."""
    stats = tplan.StoreStats(**FLAT)
    rng = np.random.default_rng(0)
    qn = rng.integers(0, 1 << 32, (2, 4), dtype=np.uint32)
    cn = rng.integers(0, 1 << 32, (64, 4), dtype=np.uint32)
    q = torch.from_numpy(qn.view(np.int32))
    codes = torch.from_numpy(cn.view(np.int32))
    jstats = jplan.StoreStats(**FLAT)
    for rt in (1.0, 0.5):
        approx = tplan.plan_local(stats, 4, select="approx",
                                  recall_target=rt)
        ref = jplan.execute(jplan.plan_local(jstats, 4, select="approx",
                                             recall_target=rt),
                            jnp.asarray(qn), codes=jnp.asarray(cn))
        out = tplan.execute(approx, q, codes=codes)
        assert np.array_equal(out[0].numpy(), np.asarray(ref[0]))
        assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
        assert approx.explain()["geometry"]["kind"] == "approx"
    masked_approx = tplan.plan_index(tplan.StoreStats(**LAY), 4,
                                     kind="kmeans", select="approx")
    with pytest.raises(ValueError, match="pruning stats"):
        tplan.execute(masked_approx, q, layout=object(), return_stats=True)
    sharded = tplan.plan_sharded(tplan.StoreStats(**FLAT, n_shards=4), 4,
                                 axes=("data",))
    with pytest.raises(ValueError, match="needs the mesh"):
        tplan.execute(sharded, q, codes=codes)
    jstats = jplan.StoreStats(**FLAT)
    pallas = tplan.plan_local(stats, 4, select="counting", method="pallas")
    ref = jplan.execute(jplan.plan_local(jstats, 4, select="counting",
                                         method="pallas"),
                        jnp.asarray(qn), codes=jnp.asarray(cn))
    out = tplan.execute(pallas, q, codes=codes)
    assert np.array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
    cand = np.array([[3, 9, -1, 60], [-1, -1, -1, -1]], np.int32)
    gather = dataclasses.replace(
        tplan.plan_local(stats, 4),
        candidates=tplan.CandidateStage(kind="gather"))
    ref = jplan.execute(dataclasses.replace(
        jplan.plan_local(jstats, 4),
        candidates=jplan.CandidateStage(kind="gather")),
        jnp.asarray(qn), codes=jnp.asarray(cn), cand=jnp.asarray(cand))
    out = tplan.execute(gather, q, codes=codes, cand=torch.from_numpy(cand))
    assert np.array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
    with pytest.raises(ValueError, match="needs the codes and cand"):
        tplan.execute(gather, q, codes=codes)


# the DESIGN.md section 3 index rows, and the serving ladder's probe rung
INDEX_ROWS = [
    ("kmeans", LAY, dict(nprobe=2)),
    ("kmeans", FLAT, dict(nprobe=2, use_layout=False)),
    ("kmeans", LAY, dict(nprobe=2, use_layout=False)),
    ("kmeans", LAY, dict(nprobe=2, select="approx", recall_target=0.95)),
    ("lsh", LAY, dict(n_tables=4)),
    ("lsh", FLAT, dict(n_tables=4)),
    ("kdtree", FLAT, dict()),
    ("kdtree", LAY, dict(n_tables=4)),
    ("hamming_prefix", LAY, dict(nprobe=8)),
]


def _index_plans(kind, stats_kw, kw, force=None):
    return (jplan.plan_index(jplan.StoreStats(**stats_kw, index=kind), 16,
                             kind=kind, force=force, **kw),
            tplan.plan_index(tplan.StoreStats(**stats_kw, index=kind), 16,
                             kind=kind, force=force, **kw))


@pytest.mark.parametrize("kind,stats_kw,kw", INDEX_ROWS, ids=str)
def test_plan_index_matches_reference(kind, stats_kw, kw):
    jp, tp = _index_plans(kind, stats_kw, kw)
    assert tp.compact() == jp.compact() and tp.reason == jp.reason
    for stage in ("probe", "candidates", "select", "merge"):
        assert dataclasses.asdict(getattr(tp, stage)) == dataclasses.asdict(
            getattr(jp, stage)), stage
    je, te = _ref_explain(jp.explain()), tp.explain()
    for key in ("geometry", "predicted_pruning", "stages", "compact"):
        assert te[key] == je[key], key


@pytest.mark.parametrize("force", [
    "select=counting", "select=fused", "select=approx", "layout=off",
    "layout=local_sort", "candidates=gather", "candidates=full",
    "candidates=block_mask", "select=bisect,candidates=gather",
    "method=pallas,chunk=512", "k_local=2"], ids=str)
@pytest.mark.parametrize("row", [0, 1, 4, 8])
def test_forced_overrides_on_index_plans_match_reference(row, force):
    """Masked plans ignore a forced non-fused select and a forced layout;
    candidates=gather is the one transition they honour."""
    kind, stats_kw, kw = INDEX_ROWS[row]
    jp, tp = _index_plans(kind, stats_kw, kw, force=force)
    assert tp.compact() == jp.compact() and tp.reason == jp.reason
    assert dataclasses.asdict(tp.select) == dataclasses.asdict(jp.select)
    assert dataclasses.asdict(tp.candidates) == dataclasses.asdict(
        jp.candidates)


def test_stats_and_auto_chunk_match_reference():
    codes = np.zeros((1000, 8), np.uint32)
    q = np.zeros((7, 8), np.uint32)
    js = jplan.stats_of(codes, q, 256)
    ts = tplan.stats_of(torch.from_numpy(codes.view(np.int32)),
                        torch.from_numpy(q.view(np.int32)), 256)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for d in (8, 64, 128, 256, 1024):
        for chunk in (1000, 1 << 16, 1 << 20):
            assert tplan._auto_chunk(chunk, d) == jplan._auto_chunk(chunk, d)


# sharded plans: the planner's merge rules (DESIGN.md's sharded rows and
# tests/test_shard_faults.py's hist_tree selection)
SHARDED_ROWS = [
    (8, {}), (8, dict(select="approx", recall_target=0.95)),
    (8, dict(merge="concat_sort")), (64, {}),
    (8, dict(merge="hist_tree", fanout=4)), (8, dict(reorder_local=True)),
    (8, dict(k_local=4, select="fused", reorder_local=True)),
    (8, dict(select="counting", reorder_local=True)), (4, {}),
    (4, dict(merge="hist_tree")), (4, dict(uneven=True, k_local=4)),
    (4, dict(merge="hist_merge", k_local=4)), (4, dict(fanout=3)),
    (8, dict(layout_policy="require")),
    (8, dict(select="approx", merge="hist_tree")),
]
SHARDED_FORCES = [None, "merge=concat_sort", "merge=hist_tree",
                  "merge=hist_tree,fanout=4", "fanout=4", "k_local=4",
                  "reorder_local=1", "reorder_local=0", "select=counting",
                  "select=approx,recall_target=0.9", "merge=hist_merge",
                  "select=fused_scan,layout=local_sort", "recall_target=0.5"]


def _sharded(n_shards, kw, force=None):
    stats = dict(FLAT, n_shards=n_shards)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (jplan.plan_sharded(jplan.StoreStats(**stats), 16,
                                   axes=("data",), force=force, **kw),
                tplan.plan_sharded(tplan.StoreStats(**stats), 16,
                                   axes=("data",), force=force, **kw))


def _same_sharded(jp, tp):
    for stage in ("probe", "candidates", "select", "merge"):
        assert dataclasses.asdict(getattr(tp, stage)) == dataclasses.asdict(
            getattr(jp, stage)), stage
    assert tp.reason == _norm(jp.reason)
    assert tp.compact() == jp.compact()
    assert tp.n_shards == jp.n_shards


@pytest.mark.parametrize("n_shards,kw", SHARDED_ROWS, ids=str)
def test_plan_sharded_matches_reference(n_shards, kw):
    """Stages, reason, compact form and explain() — the merge sub-dict of
    the geometry (tuning.shard_hints) and the explain_str merge lines
    included; only the kernel names are the port's own."""
    jp, tp = _sharded(n_shards, kw)
    _same_sharded(jp, tp)
    je, te = _ref_explain(jp.explain()), tp.explain()
    for key in ("shape", "stages", "geometry", "predicted_pruning",
                "compact"):
        assert te[key] == je[key], key
    tlines = tp.explain_str().splitlines()
    jlines = jp.explain_str().splitlines()
    assert [ln for ln in tlines if "merge" in ln.split(":")[0]] == [
        ln for ln in jlines if "merge" in ln.split(":")[0]]
    if tp.merge.strategy in tplan.HIST_STRATEGIES:
        assert any("hamming_topk_sharded" in k or "approx_topk_sharded" in k
                   for k in te["kernels"])


@pytest.mark.parametrize("force", SHARDED_FORCES, ids=str)
@pytest.mark.parametrize("row", [0, 1, 2, 3, 6])
def test_sharded_forced_overrides_match_reference(row, force):
    """parse_force's merge keys (merge, fanout, k_local, reorder_local) and
    the demotions they trigger, as repro applies them."""
    n_shards, kw = SHARDED_ROWS[row]
    jp, tp = _sharded(n_shards, kw, force=force)
    _same_sharded(jp, tp)


def test_bad_sharded_requests_raise_like_reference():
    stats = dict(FLAT, n_shards=4)
    for kw in (dict(merge="nope"), dict(force="merge=hist_tree,fanout=1"),
               dict(force="merge=sideways")):
        with pytest.raises(ValueError):
            jplan.plan_sharded(jplan.StoreStats(**stats), 16,
                               axes=("data",), **kw)
        with pytest.raises(ValueError):
            tplan.plan_sharded(tplan.StoreStats(**stats), 16,
                               axes=("data",), **kw)
    assert tplan.HIST_STRATEGIES == jplan.HIST_STRATEGIES
