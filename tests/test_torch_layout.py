"""PyTorch port vs the JAX reference: bucket-clustered layouts
(repro_torch.core.layout). The same codes must give the same bucket
assignment, permutation, inverse and bucket starts — including stores
whose row count is not a power of two, where the bit means that pick the
key positions have to be computed exactly as ``jnp.mean`` does."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin, layout as jlay
from repro_torch import carry
from repro_torch.core import layout as tlay


def _store(seed, n, d, p=None):
    rng = np.random.default_rng(seed)
    probs = rng.random(d) if p is None else np.full(d, p)
    bits = (rng.random((n, d)) < probs).astype(np.uint8)
    xj = jbin.pack_bits(jnp.asarray(bits))
    return xj, carry.codes(np.asarray(xj), device="cpu")


def _same_layout(jl, tl):
    for name in ("codes", "perm", "inv", "starts"):
        j, t = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
        assert t.dtype == np.int32, name
        assert np.array_equal(j.view(np.int32) if j.dtype == np.uint32 else j,
                              t), name
    assert (tl.n, tl.n_buckets, tl.mean_bucket_rows) == (
        jl.n, jl.n_buckets, jl.mean_bucket_rows)


@pytest.mark.parametrize("n,d", [(1000, 64), (4097, 256), (3000, 96),
                                 (777, 32), (2048, 128)])
@pytest.mark.parametrize("n_buckets", [None, 16, 1])
def test_prefix_layout_matches_reference(n, d, n_buckets):
    xj, xt = _store(n + d, n, d)
    _same_layout(jlay.build_layout(xj, d, n_buckets=n_buckets),
                 tlay.build_layout(xt, d, n_buckets=n_buckets))


def test_balanced_bit_ties_order_identically():
    """Every bit has the same expected mean: many exact ties and near-ties
    in |mean - 1/2|, which a different rounding of the means would order
    differently."""
    xj, xt = _store(5, 1000, 256, p=0.5)
    ja, jpos = jlay.hamming_prefix_assign(xj, 256, 10)
    ta, tpos = tlay.hamming_prefix_assign(xt, 256, 10)
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    # given positions are reused as they are
    ja2, _ = jlay.hamming_prefix_assign(xj, 256, 10, positions=jpos[::-1])
    ta2, _ = tlay.hamming_prefix_assign(xt, 256, 10, positions=tpos.flip(0))
    assert np.array_equal(np.asarray(ja2), ta2.numpy())


def test_assignment_layout_matches_reference():
    xj, xt = _store(9, 600, 64)
    assign = np.random.default_rng(9).integers(0, 13, 600).astype(np.int32)
    _same_layout(jlay.build_layout(xj, 64, assign=jnp.asarray(assign)),
                 tlay.build_layout(xt, 64, assign=torch.from_numpy(assign)))
    _same_layout(
        jlay.build_layout(xj, 64, n_buckets=20, assign=jnp.asarray(assign)),
        tlay.build_layout(xt, 64, n_buckets=20,
                          assign=torch.from_numpy(assign)))
    with pytest.raises(ValueError):
        tlay.build_layout(xt, 64, n_buckets=5, assign=torch.from_numpy(assign))
    with pytest.raises(ValueError):
        tlay.build_layout(xt, 64, assign=torch.from_numpy(assign) - 1)


@pytest.mark.parametrize("n_valid", [None, 700])
def test_local_sort_matches_reference(n_valid):
    xj, xt = _store(11, 1000, 128)
    jc, jp = jlay.local_sort(xj, 128, n_valid=n_valid)
    tc, tp = tlay.local_sort(xt, 128, n_valid=n_valid)
    assert np.array_equal(np.asarray(jc).view(np.int32), tc.numpy())
    assert np.array_equal(np.asarray(jp), tp.numpy())


def test_permutation_helpers_match_reference():
    rng = np.random.default_rng(12)
    perm = rng.permutation(500).astype(np.int32)
    assert np.array_equal(np.asarray(jlay.invert_permutation(jnp.asarray(perm))),
                          tlay.invert_permutation(torch.from_numpy(perm)).numpy())
    ids = rng.integers(0, 520, (7, 9)).astype(np.int32)     # >= 500: sentinels
    dists = rng.integers(0, 70, (7, 9)).astype(np.int32)
    assert np.array_equal(
        np.asarray(jlay.to_original_ids(jnp.asarray(perm), jnp.asarray(ids))),
        tlay.to_original_ids(torch.from_numpy(perm),
                             torch.from_numpy(ids)).numpy())
    xj, xt = _store(13, 500, 64)
    jl, tl = jlay.build_layout(xj, 64), tlay.build_layout(xt, 64)
    assert np.array_equal(
        np.asarray(jlay.original_ids(jl, jnp.asarray(dists), jnp.asarray(ids),
                                     64)),
        tlay.original_ids(tl, torch.from_numpy(dists), torch.from_numpy(ids),
                          64).numpy())
    for n in (0, 1, 255, 256, 4096, 1 << 20, 1 << 24):
        assert tlay.default_bits(n) == jlay.default_bits(n)
