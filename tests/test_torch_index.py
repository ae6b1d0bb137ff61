"""PyTorch port vs the JAX reference: the probe masks and the masked fused
select (``repro_torch.core.layout``), the gather scan and the spatial
indexes (``repro_torch.core.index``: IVF, LSH, kd-trees, hamming-prefix
probes).

``repro`` draws k-means' initial centroids and LSH's bit ids with
``jax.random``, which no torch generator reproduces, so its indexes are
carried across (``carry.kmeans_index`` / ``carry.lsh_index``) and both
packages search the same index; the port's own builders are held to
invariants. kd-trees are host numpy in both and build the same forest
from the same seed. The port runs K1/K2's plain versions on the CPU, the
reference its Pallas kernels in interpret mode; every (dists, ids) and
every mask is compared exactly."""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.core import index as jidx
from repro.core import layout as jlay
from repro.core import plan as jplan
from repro_torch import carry
from repro_torch.core import binary as tbin
from repro_torch.core import index as tidx
from repro_torch.core import layout as tlay
from repro_torch.core import plan as tplan

D = 64


@pytest.fixture(scope="module")
def data():
    """16 well-separated Gaussian clusters in 32 dims (so the nearest
    centroids are far from any f32 tie), their sign codes through a fixed
    random projection, and 20 queries from the same mixture."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 4
    own = rng.integers(0, 16, 2048 + 20)
    pts = centers[own] + rng.standard_normal((2048 + 20, 32)).astype(
        np.float32) * 0.5
    proj = rng.standard_normal((32, D)).astype(np.float32)
    bits = (pts @ proj > 0).astype(np.uint8)
    codes = np.asarray(jbin.pack_bits(jnp.asarray(bits)))
    return pts[:2048], codes[:2048], pts[2048:], codes[2048:]


def _lay_arrays(lay):
    return tuple(np.asarray(a) for a in (lay.codes, lay.perm, lay.inv,
                                         lay.starts))


def _same(ref, out):
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.int32
    assert np.array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))


@pytest.fixture(scope="module")
def kmeans(data):
    x, codes, _, _ = data
    ji = jidx.kmeans_build(jnp.asarray(x), jnp.asarray(codes), D, 16,
                           iters=5)
    ti = carry.kmeans_index(np.asarray(ji.centroids), np.asarray(ji.buckets),
                            codes, _lay_arrays(ji.layout), D, device="cpu")
    return ji, ti


@pytest.fixture(scope="module")
def lsh(data):
    _, codes, _, _ = data
    ji = jidx.lsh_build(jnp.asarray(codes), D, n_tables=3, bits_per_table=6)
    ti = carry.lsh_index(np.asarray(ji.bit_ids), np.asarray(ji.buckets),
                         codes, _lay_arrays(ji.layout), D, device="cpu")
    return ji, ti


# ---------------------------------------------------------------------------
# masks and the masked select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bq,bn", [(8, 256), (16, 512), (8, 128)])
def test_probe_and_position_masks_match_reference(kmeans, bq, bn):
    ji, ti = kmeans
    rng = np.random.default_rng(bq + bn)
    probe = rng.integers(0, 16, (20, 3)).astype(np.int32)
    cand = rng.integers(-1, 2048, (20, 40)).astype(np.int32)
    nq, nn = -(-20 // bq), -(-2048 // bn)
    ref = jlay.probe_block_mask(ji.layout, jnp.asarray(probe), bq, bn, nq, nn)
    out = tlay.probe_block_mask(ti.layout, torch.from_numpy(probe), bq, bn,
                                nq, nn)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(ref))
    ref = jlay.position_block_mask(ji.layout, jnp.asarray(cand), bq, bn, nq,
                                   nn)
    out = tlay.position_block_mask(ti.layout, torch.from_numpy(cand), bq, bn,
                                   nq, nn)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    inv = tlay.invert_permutation(ti.layout.perm)
    assert torch.equal(tlay.position_block_mask_from_inv(
        inv, torch.from_numpy(cand), bq, bn, nq, nn), out)


def test_empty_buckets_enable_nothing():
    """A layout whose last buckets are empty (starts end at N, N a
    multiple of bn): their probes add nothing, as the reference's dropped
    scatter does."""
    codes = np.arange(512, dtype=np.uint32).reshape(256, 2)
    assign = np.repeat(np.arange(4), 64)
    jl = jlay.build_layout(jnp.asarray(codes), 64, n_buckets=8,
                           assign=jnp.asarray(assign))
    tl = tlay.build_layout(carry.codes(codes, "cpu"), 64, n_buckets=8,
                           assign=torch.from_numpy(assign))
    probe = np.array([[7, 6], [0, 7], [3, 5]], np.int32)
    ref = jlay.probe_block_mask(jl, jnp.asarray(probe), 8, 64, 1, 4)
    out = tlay.probe_block_mask(tl, torch.from_numpy(probe), 8, 64, 1, 4)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert out.tolist() == [[1, 0, 0, 1]]


@pytest.mark.parametrize("geometry", [(8, 256, 64), (8, 128, 32)])
def test_masked_topk_matches_reference(kmeans, data, geometry):
    """Both candidate operands, the reference's geometry passed explicitly;
    the result is a brute force over the enabled positions."""
    ji, ti = kmeans
    _, _, _, qc = data
    bq, bn, sub = geometry
    rng = np.random.default_rng(7)
    probe = rng.integers(0, 16, (20, 2)).astype(np.int32)
    cand = rng.integers(-1, 2048, (20, 30)).astype(np.int32)
    ref = jlay.masked_topk(ji.layout, jnp.asarray(qc), 10, D,
                           probe=jnp.asarray(probe),
                           cand_ids=jnp.asarray(cand), bq=bq, bn=bn, sub=sub,
                           return_stats=True)
    qt = carry.codes(qc, "cpu")
    out = tlay.masked_topk(ti.layout, qt, 10, D, probe=torch.from_numpy(probe),
                           cand_ids=torch.from_numpy(cand), bq=bq, bn=bn,
                           sub=sub, return_stats=True)
    _same(ref, out)
    for key in ("blocks_total", "blocks_skipped", "p1_blocks_skipped"):
        assert int(out[2][key]) == int(ref[2][key]), key
    mask, *_ = tlay._enable_mask(ti.layout, 20, qt.shape[1], 10, D,
                                 torch.from_numpy(probe),
                                 torch.from_numpy(cand), bq, bn, sub)
    for qi in (0, 13):
        pos = tlay.enabled_positions(ti.layout, mask[qi // bq], bn)
        dist = tbin.hamming_xor(qt[qi:qi + 1], ti.layout.codes[pos])[0]
        order = torch.argsort(dist, stable=True)[:10]
        assert torch.equal(out[0][qi], dist[order])
        assert torch.equal(out[1][qi], ti.layout.perm[pos][order])


# ---------------------------------------------------------------------------
# the indexes on carried state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 3])
def test_kmeans_search_matches_reference(kmeans, data, nprobe):
    ji, ti = kmeans
    _, _, qx, qc = data
    _, jprobe = jax.lax.top_k(
        -(jnp.sum(jnp.asarray(qx) ** 2, 1)[:, None]
          - 2 * jnp.asarray(qx) @ ji.centroids.T
          + jnp.sum(ji.centroids ** 2, 1)[None]), nprobe)
    assert np.array_equal(tidx._kmeans_probe(ti, torch.from_numpy(qx),
                                             nprobe).numpy(),
                          np.asarray(jprobe))
    qt = carry.codes(qc, "cpu")
    ref = jidx.kmeans_search(ji, jnp.asarray(qx), jnp.asarray(qc), 8,
                             nprobe=nprobe, return_stats=True)
    out = tidx.kmeans_search(ti, torch.from_numpy(qx), qt, 8, nprobe=nprobe,
                             return_stats=True)
    _same(ref, out)
    for key in ("blocks_total", "blocks_skipped", "p1_blocks_skipped"):
        assert int(out[2][key]) == int(ref[2][key]), key
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        gref = jidx.kmeans_search(ji, jnp.asarray(qx), jnp.asarray(qc), 8,
                                  nprobe=nprobe, use_layout=False)
        gout = tidx.kmeans_search(ti, torch.from_numpy(qx), qt, 8,
                                  nprobe=nprobe, use_layout=False)
    _same(gref, gout)
    # masked scans whole buckets (a superset of the capped gather lists)
    assert bool((out[0][:, -1] <= gout[0][:, -1]).all())
    assert (tidx.kmeans_plan(ti, 20, 8, nprobe).compact()
            == jidx.kmeans_plan(ji, 20, 8, nprobe).compact())


def test_lsh_search_matches_reference(lsh, data):
    ji, ti = lsh
    _, _, _, qc = data
    qt = carry.codes(qc, "cpu")
    ref = jidx.lsh_search(ji, jnp.asarray(qc), 8, return_stats=True)
    out = tidx.lsh_search(ti, qt, 8, return_stats=True)
    _same(ref, out)
    assert int(out[2]["p1_blocks_skipped"]) == int(ref[2]["p1_blocks_skipped"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _same(jidx.lsh_search(ji, jnp.asarray(qc), 8, use_layout=False),
              tidx.lsh_search(ti, qt, 8, use_layout=False))
    assert (tidx.lsh_plan(ti, 20, 8).reason == jidx.lsh_plan(ji, 20, 8).reason)


def test_lsh_tables_from_carried_bit_ids_match_reference(lsh, data):
    ji, _ = lsh
    _, codes, _, _ = data
    ti = tidx._lsh_from_bit_ids(carry.codes(codes, "cpu"), D,
                                torch.from_numpy(np.array(ji.bit_ids)))
    assert np.array_equal(ti.buckets.numpy(), np.asarray(ji.buckets))
    for name in ("perm", "inv", "starts"):
        assert np.array_equal(getattr(ti.layout, name).numpy(),
                              np.asarray(getattr(ji.layout, name))), name
    keys = tidx._hash_codes(tbin.unpack_bits(ti.codes, D), ti.bit_ids)
    jkeys = jidx._hash_codes(jbin.unpack_bits(jnp.asarray(codes), D),
                             ji.bit_ids)
    assert np.array_equal(keys.numpy(), np.asarray(jkeys))


def test_kdtree_matches_reference(data):
    x, codes, qx, qc = data
    jt = jidx.KDTreeIndex(x, jnp.asarray(codes), D, n_trees=3, leaf_size=64,
                          seed=4)
    tt = tidx.KDTreeIndex(x, carry.codes(codes, "cpu"), D, n_trees=3,
                          leaf_size=64, seed=4)
    cand = tt._candidates(qx)
    for qi, q in enumerate(qx):
        ids = np.unique(np.concatenate([jt._traverse(t, q)
                                        for t in jt.trees]))
        assert np.array_equal(cand[qi, :len(ids)], ids)
        assert (cand[qi, len(ids):] == -1).all()
    _same(jt.search(qx, jnp.asarray(qc), 8),
          tt.search(qx, carry.codes(qc, "cpu"), 8))


# ---------------------------------------------------------------------------
# helpers, and the port's own builders
# ---------------------------------------------------------------------------

def test_pad_buckets_matches_reference():
    rng = np.random.default_rng(1)
    assign = rng.integers(0, 9, 500)
    for cap in (1, 30, 80, 200):
        assert np.array_equal(tidx._pad_buckets(assign, 12, cap),
                              jidx._pad_buckets(assign, 12, cap))


def test_dedup_candidates_matches_reference():
    rng = np.random.default_rng(2)
    cand = rng.integers(-1, 25, (7, 40)).astype(np.int32)
    out = tidx._dedup_candidates(torch.from_numpy(cand))
    ref = jidx._dedup_candidates(jnp.asarray(cand))
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits,nprobe", [(4, 5), (6, 64), (3, 20)])
def test_hamming_prefix_probe_matches_reference(data, bits, nprobe):
    _, codes, _, qc = data
    _, pos = jlay.hamming_prefix_assign(jnp.asarray(codes), D, bits)
    ref = jidx.hamming_prefix_probe(jnp.asarray(qc), pos, 1 << bits, nprobe,
                                    D)
    out = tidx.hamming_prefix_probe(carry.codes(qc, "cpu"),
                                    torch.from_numpy(np.asarray(pos)),
                                    1 << bits, nprobe, D)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_gather_scan_matches_reference(data):
    _, codes, _, qc = data
    rng = np.random.default_rng(3)
    cand = rng.integers(-1, 2048, (20, 50)).astype(np.int32)
    cand[0] = -1                                   # an empty candidate list
    _same(jplan.gather_scan(jnp.asarray(codes), jnp.asarray(qc),
                            jnp.asarray(cand), 12, D),
          tplan.gather_scan(carry.codes(codes, "cpu"), carry.codes(qc, "cpu"),
                            torch.from_numpy(cand), 12, D))


def test_kmeans_build_invariants(data):
    x, codes, qx, qc = data
    ct = carry.codes(codes, "cpu")
    ti = tidx.kmeans_build(torch.from_numpy(x), ct, D, 16, iters=5,
                           generator=torch.Generator().manual_seed(3))
    assert ti.centroids.shape == (16, 32) and ti.buckets.shape == (16, 256)
    assign = torch.argmin(tidx._sq_dists(torch.from_numpy(x), ti.centroids),
                          dim=1)
    counts = torch.bincount(assign, minlength=16)
    for b in range(16):
        members = ti.buckets[b][ti.buckets[b] >= 0]
        assert bool((assign[members.long()] == b).all())
        assert len(members) == min(int(counts[b]), 256)
    lay = ti.layout
    assert torch.equal(torch.sort(lay.perm).values,
                       torch.arange(2048, dtype=torch.int32))
    assert torch.equal(lay.starts[1:] - lay.starts[:-1], counts.int())
    assert torch.equal(lay.codes, ct[lay.perm.long()])
    dd, ii = tidx.kmeans_search(ti, torch.from_numpy(qx),
                                carry.codes(qc, "cpu"), 8, nprobe=2)
    assert dd.shape == (20, 8) and bool((ii >= 0).all())


def test_lsh_build_invariants(data):
    _, codes, _, qc = data
    ct = carry.codes(codes, "cpu")
    ti = tidx.lsh_build(ct, D, n_tables=3, bits_per_table=6,
                        generator=torch.Generator().manual_seed(2))
    assert ti.bit_ids.shape == (3, 6) and ti.buckets.shape == (3, 64, 128)
    for t in range(3):
        assert len(set(ti.bit_ids[t].tolist())) == 6
    assert int(ti.bit_ids.min()) >= 0 and int(ti.bit_ids.max()) < D
    keys = tidx._hash_codes(tbin.unpack_bits(ct, D), ti.bit_ids)
    for t in range(3):
        for b in range(64):
            members = ti.buckets[t, b][ti.buckets[t, b] >= 0].long()
            assert bool((keys[t][members] == b).all())
    assert torch.equal(torch.sort(ti.layout.perm).values,
                       torch.arange(2048, dtype=torch.int32))
    assert torch.equal(keys[0][ti.layout.perm.long()],
                       torch.sort(keys[0], stable=True).values)
    dd, _ = tidx.lsh_search(ti, carry.codes(qc, "cpu"), 8)
    assert dd.shape == (20, 8)
    with pytest.raises(ValueError, match="bits_per_table"):
        tidx.lsh_build(ct, 8, bits_per_table=9)
