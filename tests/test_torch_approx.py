"""PyTorch port vs the JAX reference: the approximate tier
(``kernels/approx_select.py``), its planner plans and its seeded
geometry.

Same numpy-seeded codes through both packages. At ``recall_target=1.0``
the port's approx select must equal its fused select bit for bit; below 1
its pool depends on the block geometry, so the reference's ``bn`` and
``l`` are passed and the port must equal ``repro``'s ``approx_topk`` bit
for bit. The asymmetric path is f32 in both packages off a TPU; its
scores agree to 1e-5 absolute and its ids where no two scores tie."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.core import layout as jlay
from repro.core import plan as jplan
from repro.kernels import approx_select as jax_
from repro.kernels import tuning as jtuning
from repro_torch.core import binary as tbin
from repro_torch.core import layout as tlay
from repro_torch.core import plan as tplan
from repro_torch.core import topk as ttopk
from repro_torch.kernels import approx_select as tax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tuning as ttuning


@pytest.fixture(autouse=True)
def _empty_caches(monkeypatch):
    monkeypatch.setattr(jtuning, "_CACHE", jtuning.AutotuneCache(""))
    monkeypatch.setattr(ttuning, "_CACHE", ttuning.AutotuneCache(""))


def _codes(seed, n, q, d):
    """(numpy uint32 x, q) and the port's int32 tensors of the same bits."""
    rng = np.random.default_rng(seed)
    xp = np.asarray(jbin.pack_bits(jnp.asarray(
        rng.integers(0, 2, (n, d)), jnp.uint8)))
    qp = np.asarray(jbin.pack_bits(jnp.asarray(
        rng.integers(0, 2, (q, d)), jnp.uint8)))
    t = lambda a: torch.from_numpy(a.view(np.int32).copy())
    return xp, qp, t(xp), t(qp)


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the bound and the scores
# ---------------------------------------------------------------------------

def test_recall_bound_math_equals_reference():
    for k in (1, 5, 16, 40):
        for nb in (1, 2, 7, 32, 128):
            for l in (0, 1, 2, 5, 16):
                assert (tax.expected_recall(k, nb, l)
                        == jax_.expected_recall(k, nb, l)), (k, nb, l)
            for rt in (0.5, 0.8, 0.9, 0.95, 0.99, 1.0):
                for rows in (1, 8, 64):
                    assert (tax.l_for_recall(k, nb, rows, rt)
                            == jax_.l_for_recall(k, nb, rows, rt))


@pytest.mark.parametrize("q", [1, 8, 16, 17, 40])
def test_plane_scores_exact_and_padded_product_shape(q, monkeypatch):
    """The ±1 int8 product equals popcount Hamming, and the first operand
    of ``torch._int_mm`` always has more than 16 rows and K, N multiples
    of 8 — what CUDA's ``_int_mm`` takes — whatever Q is."""
    d = 96
    xp, qp, tx, tq = _codes(q, 300, q, d)
    shapes = []
    real = torch._int_mm

    def spy(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    got = tax.hamming_scores_planes(tax.bit_planes(tq, d),
                                    tax.bit_planes(tx, d), d)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, 300)
    assert _eq(got, tbin.hamming_xor(tq, tx))
    assert _eq(tax.bit_planes(tq, d), jax_.bit_planes(jnp.asarray(qp), d))
    (m, k), (k2, n) = shapes[0]
    assert m > 16 and m % 8 == 0 and m == tax._mm_rows(q)
    assert k == k2 and k % 8 == 0 and n % 8 == 0


def test_asymmetric_scores_and_topk_within_tolerance():
    n, q, d, k = 400, 6, 64, 7
    xp, _, tx, _ = _codes(5, n, q, d)
    v = np.random.default_rng(5).normal(size=(q, d)).astype(np.float32)
    sc = tax.asymmetric_scores(torch.from_numpy(v), tax.bit_planes(tx, d))
    ref = jax_.asymmetric_scores(jnp.asarray(v),
                                 jax_.bit_planes(jnp.asarray(xp), d))
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref), atol=1e-5)
    for rt, bn in ((1.0, 128), (0.8, 64)):
        tv, ti = tax.asymmetric_topk(torch.from_numpy(v), tx, k, d,
                                     recall_target=rt, bn=bn)
        jv, ji = jax_.asymmetric_topk(jnp.asarray(v), jnp.asarray(xp), k, d,
                                      recall_target=rt, bn=bn)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        untied = np.abs(np.diff(np.asarray(jv), axis=1)) > 1e-4
        same = ti.numpy() == np.asarray(ji)
        assert same[:, :1].all() and same[:, 1:][untied].all()
    # k > N: -inf scores and id N past the rows
    tv, ti = tax.asymmetric_topk(torch.from_numpy(v), tx[:3], 5, d)
    assert torch.isinf(tv[:, 3:]).all() and (ti[:, 3:] == 3).all()


# ---------------------------------------------------------------------------
# the partial-reduce select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn", [64, 96, 512, 1024])
def test_full_recall_bit_identical_to_fused(bn):
    n, q, d, k = 700, 7, 64, 11
    _, _, tx, tq = _codes(1, n, q, d)
    fd, fi = tops.hamming_topk(tq, tx, k, d + 1)
    dd, ii = tax.approx_topk(tq, tx, k, d + 1, recall_target=1.0, bn=bn)
    assert _eq(dd, fd) and _eq(ii, fi)


def test_full_recall_edges_equal_fused():
    """n_valid (k > n_valid included), k > N, a masked select against the
    composite select over the enabled rows, and every block masked."""
    n, q, d, k = 256, 5, 64, 12
    _, _, tx, tq = _codes(2, n, q, d)
    for nv in (3, 17, n):
        rd, ri = tops.hamming_topk(tq, tx, k, d + 1, n_valid=nv)
        dd, ii = tax.approx_topk(tq, tx, k, d + 1, bn=64, n_valid=nv)
        assert _eq(dd, rd) and _eq(ii, ri), nv
    dd, ii = tax.approx_topk(tq, tx[:4], 9, d + 1)
    assert (dd[:, 4:] == d + 1).all() and (ii[:, 4:] == 4).all()
    bn, nb = 64, 4
    bm = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2, (q, nb)).astype(np.int32))
    dd, ii = tax.approx_topk(tq, tx, k, d + 1, bn=bn, block_mask=bm)
    rowmask = bm.repeat_interleave(bn, dim=1)[:, :n] > 0
    dist = torch.where(rowmask, tbin.hamming_xor(tq, tx), d + 1)
    rd, ri = ttopk.composite_topk(dist, k, d + 1)
    assert _eq(dd, rd) and _eq(ii, torch.where(rd <= d, ri, n))
    dd, ii = tax.approx_topk(tq, tx, k, d + 1, bn=bn,
                             block_mask=torch.zeros((q, nb), dtype=torch.int32))
    assert (dd == d + 1).all() and (ii == n).all()


@pytest.mark.parametrize("rt,bn,l", [(0.5, 64, None), (0.8, 128, None),
                                     (0.9, 64, None), (0.9, 100, 3),
                                     (0.99, 256, None)])
def test_partial_reduce_equals_reference_at_its_geometry(rt, bn, l):
    n, q, d, k = 900, 9, 64, 10
    xp, qp, tx, tq = _codes(3, n, q, d)
    rng = np.random.default_rng(3)
    xp = xp.copy()
    xp[100:120] = xp[7]                   # ties across blocks
    tx = torch.from_numpy(xp.view(np.int32).copy())
    bm = rng.integers(0, 2, (q, -(-n // bn))).astype(np.int32)
    for nv, mask in ((None, None), (613, None), (None, bm)):
        jd, ji = jax_.approx_topk(
            jnp.asarray(qp), jnp.asarray(xp), k, d + 1, recall_target=rt,
            bn=bn, l=l, n_valid=nv,
            block_mask=None if mask is None else jnp.asarray(mask))
        td, ti = tax.approx_topk(
            tq, tx, k, d + 1, recall_target=rt, bn=bn, l=l, n_valid=nv,
            block_mask=None if mask is None else torch.from_numpy(mask))
        assert _eq(td, jd) and _eq(ti, ji), (nv, mask is not None)
    ll = l or jax_.l_for_recall(k, -(-n // bn), bn, rt)
    jp = jax_._pool(jnp.asarray(qp), jnp.asarray(xp), d + 1, bn, ll, None,
                    None)
    tp = tax._pool(tq, tx, d + 1, bn, ll)
    assert _eq(tp[0], jp[0]) and _eq(tp[1], jp[1])


def test_chunked_merge_equals_one_pass(monkeypatch):
    """A tiny chunk budget splits the queries and the blocks into many
    chunks; the running merge gives the one-pass answer."""
    n, q, d, k = 640, 11, 64, 9
    _, _, tx, tq = _codes(8, n, q, d)
    one = [tax.approx_topk(tq, tx, k, d + 1, recall_target=rt, bn=64)
           for rt in (1.0, 0.8)]
    monkeypatch.setitem(tax._CHUNK_ELEMS, "cpu", 100)
    for rt, (od, oi) in zip((1.0, 0.8), one):
        dd, ii = tax.approx_topk(tq, tx, k, d + 1, recall_target=rt, bn=64)
        assert _eq(dd, od) and _eq(ii, oi), rt


def test_masked_approx_matches_reference_and_full_recall():
    n, q, d, k, bn = 512, 5, 64, 9, 64
    xp, qp, tx, tq = _codes(4, n, q, d)
    jl = jlay.build_layout(jnp.asarray(xp), d, n_buckets=8)
    tl = tlay.build_layout(tx, d, n_buckets=8)
    assert _eq(tl.perm, jl.perm)
    probe = np.random.default_rng(11).integers(0, 8, (q, 2)).astype(np.int32)
    for rt in (1.0, 0.7):
        jd, ji = jax_.masked_approx_topk(jl, jnp.asarray(qp), k, d,
                                         probe=jnp.asarray(probe),
                                         recall_target=rt, bn=bn)
        td, ti = tax.masked_approx_topk(tl, tq, k, d,
                                        probe=torch.from_numpy(probe),
                                        recall_target=rt, bn=bn)
        assert _eq(td, jd) and _eq(ti, ji), rt
    # at rt=1.0: a composite select over exactly the enabled rows
    mask = tlay.probe_block_mask(tl, torch.from_numpy(probe), 1, bn, q,
                                 -(-n // bn))
    rows = mask.repeat_interleave(bn, dim=1)[:, :n] > 0
    dist = torch.where(rows, tbin.hamming_xor(tq, tl.codes), d + 1)
    rd, rp = ttopk.composite_topk(dist, k, d + 1)
    rids = tlay.original_ids(tl, rd, torch.where(rd <= d, rp, n), d)
    td, ti = tax.masked_approx_topk(tl, tq, k, d,
                                    probe=torch.from_numpy(probe), bn=bn)
    assert _eq(td, rd) and _eq(ti, rids)


def test_recall_meets_target_on_seeded_data():
    n, q, d, k, bn = 2048, 16, 64, 10, 128
    for target in (0.9, 0.99):
        recalls = []
        for seed in range(3):
            _, _, tx, tq = _codes(seed, n, q, d)
            rd, _ = tops.hamming_topk(tq, tx, k, d + 1)
            dd, _ = tax.approx_topk(tq, tx, k, d + 1, recall_target=target,
                                    bn=bn)
            recalls.append(float((dd <= rd[:, k - 1:k]).float().mean()))
        assert float(np.mean(recalls)) >= target, (target, recalls)


# ---------------------------------------------------------------------------
# the planner and the tuning row
# ---------------------------------------------------------------------------

def test_plans_execute_and_explain_like_the_reference():
    n, q, d, k = 900, 6, 64, 8
    xp, qp, tx, tq = _codes(6, n, q, d)
    for rt in (1.0, 0.9):
        tp = tplan.plan_local(tplan.stats_of(tx, tq, d), k, select="approx",
                              recall_target=rt)
        jp = jplan.plan_local(jplan.stats_of(jnp.asarray(xp),
                                             jnp.asarray(qp), d), k,
                              select="approx", recall_target=rt)
        assert tp.compact() == jp.compact() and tp.reason == jp.reason
        te, je = tp.explain(), jp.explain()
        for key in ("geometry", "predicted_pruning", "stages"):
            assert te[key] == je[key], key
        td, ti = tplan.execute(tp, tq, codes=tx)
        jd, ji = jplan.execute(jp, jnp.asarray(qp), codes=jnp.asarray(xp))
        assert _eq(td, jd) and _eq(ti, ji), rt
    assert tp.compact() == "probe:none|cand:full|select:approx@r0.9|merge:none"
    for force in ("select=approx,recall_target=0.85", "recall_target=0.5",
                  "select=approx,layout=on"):
        st = dict(n=1 << 14, d=64, w=2, q=32, backend="cpu")
        for sel in ("auto", "fused", "approx"):
            tpl = tplan.plan_local(tplan.StoreStats(**st), 8, select=sel,
                                   force=force)
            jpl = jplan.plan_local(jplan.StoreStats(**st), 8, select=sel,
                                   force=force)
            assert tpl.compact() == jpl.compact()
            # the one recorded wording divergence (ROADMAP queue 3)
            assert tpl.reason == jpl.reason.replace("XLA top_k", "top_k")


def test_approx_blocks_rows():
    """cpu and tpu rows are the reference's; the gpu row caps bn at 2^15,
    so the main shape (N = 2^20) runs 32 blocks of 32768 rows."""
    for be in ("cpu", "tpu"):
        for N in (1, 100, 5000, 1 << 16, 1 << 20, 1 << 24):
            assert (ttuning.approx_blocks(8, N, 8, backend=be)
                    == jtuning.approx_blocks(8, N, 8, backend=be))
    assert ttuning.approx_blocks(4096, 1 << 20, 8, backend="gpu") == 1 << 15
    assert ttuning.approx_blocks(8, 5000, 8, backend="gpu") == 256
    g = tplan.plan_local(
        tplan.StoreStats(n=1 << 20, d=256, w=8, q=4096, backend="gpu"), 16,
        select="approx", recall_target=0.9).geometry()
    assert g["bn"] == 1 << 15 and g["n_blocks"] == 32
    assert g["predicted_recall"] >= 0.9
