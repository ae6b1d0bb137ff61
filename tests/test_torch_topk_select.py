"""PyTorch port vs the JAX reference: the two-pass counting select.

K1 (pass-1 histogram + block-min summary) and K2 (pass-2 emit) of
repro_torch.kernels.topk_select run their plain PyTorch versions on CPU
tensors; the reference runs its Pallas kernels in interpret mode, as
tests/test_fused_topk.py does. Both get the SAME padded inputs and the
reference's (bq, bn, sub) geometry, and every integer output — hist,
block_min, emitted (dists, ids) slots, the finished (dists, ids) and the
pruning stats — must match exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.kernels import ops as jops
from repro.kernels.topk_select import hamming_emit_pallas, hamming_hist_pallas
from repro_torch import carry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_select as tsel

# as in tests/test_fused_topk.py: aligned and ragged N, W from 1 to 8
# words, Q below one sublane tile; last, d = 128 (kNN-SIFT's width) at a
# ragged N
SHAPES = [(8, 1024, 64), (5, 999, 96), (16, 300, 32), (1, 4097, 256),
          (33, 130, 160), (32, 1031, 128)]


def _codes(seed, n, q, d):
    """Seeded bits packed by the reference -> (jax x, jax q, torch x, torch q)."""
    rng = np.random.default_rng(seed)
    xj = jbin.pack_bits(jnp.asarray(rng.integers(0, 2, (n, d)), jnp.uint8))
    qj = jbin.pack_bits(jnp.asarray(rng.integers(0, 2, (q, d)), jnp.uint8))
    return xj, qj, _t(xj), _t(qj)


def _t(a) -> torch.Tensor:
    return carry.codes(np.asarray(a), device="cpu")


def _eq(j, t) -> bool:
    return np.array_equal(np.asarray(j), t.numpy())


def _topk_both(xj, qj, xt, qt, k, bins, **kw):
    """hamming_topk through both packages at the reference's geometry."""
    Q, W = qj.shape
    N = xj.shape[0]
    bq, bn, sub, _, _ = jops.topk_geometry(Q, N, W, max(bins, min(k, N)),
                                           kw.pop("bq", None),
                                           kw.pop("bn", None))
    tmask = kw.pop("tmask", None)
    j = jops.hamming_topk(qj, xj, k, bins, bq=bq, bn=bn, sub=sub,
                          return_stats=True, **kw)
    if tmask is not None:
        kw["block_mask"] = tmask
    t = tops.hamming_topk(qt, xt, k, bins, bq=bq, bn=bn, sub=sub,
                          return_stats=True, **kw)
    return j, t


def _same_topk(j, t):
    (jd, ji, js), (td, ti, ts) = j, t
    assert td.dtype == torch.int32 and ti.dtype == torch.int32
    assert _eq(jd, td) and _eq(ji, ti)
    assert _eq(js["block_min"], ts["block_min"])
    assert js["blocks_total"] == ts["blocks_total"]
    assert int(js["blocks_skipped"]) == int(ts["blocks_skipped"])
    assert int(js["p1_blocks_skipped"]) == int(ts["p1_blocks_skipped"])


@pytest.mark.parametrize("q,n,d", SHAPES)
def test_pass1_hist_and_block_min_match_reference(q, n, d):
    """Raw K1 on the padded tiles: histogram and block-min summary."""
    xj, qj, _, _ = _codes(4, n, q, d)
    bins = d + 1
    qp, xp, bq, bn, sub = jops._topk_blocked(qj, xj, bins, None, None, None)
    nv = n - n // 3                      # n_valid < N: tail rows excluded
    jh, jb = hamming_hist_pallas(qp, xp, bins, jnp.int32(nv), bq=bq, bn=bn,
                                 sub=sub, interpret=True)
    th, tb = tsel.hamming_hist_kernel(_t(qp), _t(xp), bins, nv, bq=bq, bn=bn,
                                      sub=sub)
    assert _eq(jh, th) and _eq(jb, tb)
    assert tsel.hamming_hist_kernel.launches == 0      # plain path on CPU


def test_pass2_emit_with_slot_and_id_base_matches_reference():
    """Raw K2 on the second half of a store, with the slot bases and id base
    the distributed select hands that shard (hamming_topk_sharded): the
    slot-ordered output, untouched slots 0, must match exactly."""
    xj, qj, _, _ = _codes(21, 2048, 16, 64)
    bins, k = 65, 24
    qp, xp, bq, bn, sub = jops._topk_blocked(qj, xj, bins, None, 256, None)
    lo = xp.shape[0] // 2
    h, bm = hamming_hist_pallas(qp, xp, bins, bq=bq, bn=bn, sub=sub,
                                interpret=True)
    h0, _ = hamming_hist_pallas(qp, xp[:lo], bins, bq=bq, bn=bn, sub=sub,
                                interpret=True)
    _, r, n_lt, _ = jops._radius_from_cum(jnp.cumsum(h, axis=-1), k)
    c0 = jnp.cumsum(h0, axis=-1)
    at = lambda c, i: jnp.take_along_axis(c, i[:, None], axis=-1)[:, 0]
    lt0 = jnp.where(r > 0, at(c0, jnp.maximum(r - 1, 0)), 0)
    sb, tb = lt0, n_lt + at(h0, r)
    assert int(jnp.max(sb)) > 0                      # nonzero slot bases
    j0 = lo // bn
    jd, ji = hamming_emit_pallas(qp, xp[lo:], r, tb, bins, k,
                                 block_min=bm[:, j0:], slot_base=sb,
                                 id_base=jnp.int32(lo), bq=bq, bn=bn,
                                 sub=sub, interpret=True)
    td, ti = tsel.hamming_emit_kernel(
        _t(qp), _t(xp[lo:]), _t(r), _t(tb), bins, k,
        block_min=_t(bm[:, j0:]), slot_base=_t(sb), id_base=lo,
        bq=bq, bn=bn, sub=sub)
    assert _eq(jd, td) and _eq(ji, ti)
    assert int((ti >= lo).sum()) > 0 and int((ti == 0).sum()) > 0
    assert tsel.hamming_emit_kernel.launches == 0


def test_heavy_ties_at_r_star():
    """d=8 over 4096 rows: hundreds of ties at every radius."""
    xj, qj, xt, qt = _codes(1, 4096, 4, 8)
    for k in (3, 50, 512):
        _same_topk(*_topk_both(xj, qj, xt, qt, k, 9))


def test_k_exceeds_rows():
    xj, qj, xt, qt = _codes(2, 37, 3, 64)
    j, t = _topk_both(xj, qj, xt, qt, 50, 65)
    _same_topk(j, t)
    assert (t[0][:, 37:] == 65).all() and (t[1][:, 37:] == 37).all()


@pytest.mark.parametrize("nv,k", [(300, 16), (20, 32)])
def test_n_valid_masks_tail_rows(nv, k):
    """Rows >= n_valid are invisible; k > n_valid pads with sentinels."""
    xj, qj, xt, qt = _codes(3, 512, 4, 64)
    _same_topk(*_topk_both(xj, qj, xt, qt, k, 65, n_valid=nv))


def test_block_mask_restricts_candidate_set():
    xj, qj, xt, qt = _codes(13, 1024, 8, 64)
    mask = np.asarray([[0, 1, 0, 1]], np.int32)
    j, t = _topk_both(xj, qj, xt, qt, 10, 65, bn=256,
                      block_mask=jnp.asarray(mask),
                      tmask=torch.from_numpy(mask))
    _same_topk(j, t)
    assert int(t[2]["p1_blocks_skipped"]) == 2


def test_block_mask_below_k_candidates_sentinels():
    xj, qj, xt, qt = _codes(14, 1024, 4, 64)
    mask = np.zeros((1, 4), np.int32)
    mask[:, 2] = 1
    j, t = _topk_both(xj, qj, xt, qt, 300, 65, bn=256,
                      block_mask=jnp.asarray(mask),
                      tmask=torch.from_numpy(mask))
    _same_topk(j, t)
    assert (t[0][:, 256:] == 65).all() and (t[1][:, 256:] == 1024).all()


def test_clustered_store_prunes_identically():
    """One near cluster owns the top-k: most pass-2 tiles skip, and both
    packages skip exactly the same ones."""
    rng = np.random.default_rng(8)
    d, n = 128, 4096
    near = (rng.random((64, d)) < 0.05).astype(np.uint8)
    far = (rng.random((n - 64, d)) < 0.9).astype(np.uint8)
    xj = jbin.pack_bits(jnp.asarray(np.concatenate([near, far])))
    qj = jbin.pack_bits(jnp.zeros((4, d), jnp.uint8))
    j, t = _topk_both(xj, qj, _t(xj), _t(qj), 10, d + 1)
    _same_topk(j, t)
    assert int(t[2]["blocks_skipped"]) >= t[2]["blocks_total"] // 2


@pytest.mark.parametrize("q,n,d", SHAPES[:3])
def test_hamming_hist_pad_path(q, n, d):
    """Block-alignment padding rows contribute nothing to the histogram."""
    xj, qj, xt, qt = _codes(4, n, q, d)
    bq, bn, sub, _, _ = jops.topk_geometry(q, n, qj.shape[1], d + 1)
    jh = jops.hamming_hist(qj, xj, d + 1, bq=bq, bn=bn, sub=sub)
    th = tops.hamming_hist(qt, xt, d + 1, bq=bq, bn=bn, sub=sub)
    assert _eq(jh, th) and int(th.sum()) == q * n


def test_hamming_hist_clamp_bin():
    """Distances >= bins clamp into the top bin."""
    th = tops.hamming_hist(torch.zeros((2, 2), dtype=torch.int32),
                           torch.full((70, 2), -1, dtype=torch.int32), 5)
    jh = jops.hamming_hist(jnp.zeros((2, 2), jnp.int32),
                           jnp.full((70, 2), -1, jnp.int32), 5)
    assert _eq(jh, th) and (th[:, 4] == 70).all()


def test_empty_store_returns_sentinels():
    qt = torch.zeros((3, 2), dtype=torch.int32)
    td, ti, ts = tops.hamming_topk(qt, torch.zeros((0, 2), dtype=torch.int32),
                                   5, 65, return_stats=True)
    jd, ji = jops.hamming_topk(jnp.zeros((3, 2), jnp.int32),
                               jnp.zeros((0, 2), jnp.int32), 5, 65)
    assert _eq(jd, td) and _eq(ji, ti) and ts["blocks_total"] == 0


def test_radius_from_cum_matches_reference():
    rng = np.random.default_rng(6)
    hist = rng.integers(0, 4, (50, 17)).astype(np.int32)
    hist[:5] = 0                                   # no candidates at all
    cum = np.cumsum(hist, axis=-1).astype(np.int32)
    for k in (1, 5, 40, 1000):
        for j, t in zip(jops._radius_from_cum(jnp.asarray(cum), k),
                        tops._radius_from_cum(torch.from_numpy(cum), k)):
            assert np.array_equal(np.asarray(j), t.numpy().astype(np.int32))


def test_geometry_must_tile():
    q = torch.zeros((10, 2), dtype=torch.int32)
    x = torch.zeros((100, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not tile"):
        tsel.hamming_hist_kernel(q, x, 65, bq=8, bn=32, sub=8)
