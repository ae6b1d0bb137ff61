"""PyTorch port vs the JAX reference: the bounded-domain selects of
repro_torch.core.topk on the same seeded integer distance matrices.

Contract under test: ascending distances, ties by index order, rows beyond
min(k, N) padded with (d_max+1, N) — identical (dists, ids) in both
packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import topk as jtopk
from repro_torch.core import topk as ttopk

# (Q, N, d_max, k): few ties, heavy ties (d_max=8), k > N, k == N
CASES = [(4, 300, 64, 10), (3, 500, 8, 50), (5, 37, 64, 50), (2, 64, 32, 64),
         (6, 1000, 256, 16)]


def _dist(seed, q, n, d_max):
    return np.random.default_rng(seed).integers(0, d_max + 1, (q, n),
                                                dtype=np.int32)


def _same(jpair, tpair):
    jd, ji = (np.asarray(a) for a in jpair)
    td, ti = (t.numpy() for t in tpair)
    assert td.dtype == np.int32 and ti.dtype == np.int32
    assert np.array_equal(jd, td) and np.array_equal(ji, ti)


@pytest.mark.parametrize("q,n,d_max,k", CASES)
@pytest.mark.parametrize("fn", ["counting_topk", "counting_topk_bisect",
                                "composite_topk"])
def test_selects_match_reference(fn, q, n, d_max, k):
    dist = _dist(q * n + d_max, q, n, d_max)
    _same(getattr(jtopk, fn)(jnp.asarray(dist), k, d_max),
          getattr(ttopk, fn)(torch.from_numpy(dist), k, d_max))


@pytest.mark.parametrize("q,n,d_max,k", CASES[:4])
def test_topk_ref_matches_reference(q, n, d_max, k):
    dist = _dist(q + n, q, n, d_max)
    _same(jtopk.topk_ref(jnp.asarray(dist), min(k, n)),
          ttopk.topk_ref(torch.from_numpy(dist), min(k, n)))


def test_composite_guard_falls_back_to_bisect():
    """(d_max+1)*N >= 2^24: the f32 composite key is not exact, so both
    packages take the bisection select — same answer either way."""
    dist = _dist(9, 2, 70000, 255)
    assert 256 * 70000 >= 1 << 24
    _same(jtopk.composite_topk(jnp.asarray(dist), 12, 255),
          ttopk.composite_topk(torch.from_numpy(dist), 12, 255))


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(5)
    d1 = np.sort(rng.integers(0, 20, (4, 8), dtype=np.int32), axis=1)
    d2 = np.sort(rng.integers(0, 20, (4, 6), dtype=np.int32), axis=1)
    i1 = rng.integers(0, 100, (4, 8), dtype=np.int32)
    i2 = rng.integers(100, 200, (4, 6), dtype=np.int32)
    _same(jtopk.merge_topk(*(jnp.asarray(a) for a in (d1, i1, d2, i2)), 10),
          ttopk.merge_topk(*(torch.from_numpy(a) for a in (d1, i1, d2, i2)),
                           10))


@pytest.mark.parametrize("n_bins", [16, 256])
def test_bucketed_topk_matches_reference(n_bins):
    vals = np.random.default_rng(n_bins).standard_normal(
        (5, 300)).astype(np.float32)
    jv, ji = jtopk.bucketed_topk(jnp.asarray(vals), 7, n_bins)
    tv, ti = ttopk.bucketed_topk(torch.from_numpy(vals), 7, n_bins)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())   # gathered, not computed
