"""PyTorch port vs the JAX reference: bucket-clustered layouts
(repro_torch.core.layout). The same codes must give the same bucket
assignment, permutation, inverse and bucket starts — including stores
whose row count is not a power of two, where the bit means that pick the
key positions have to be computed exactly as ``jnp.mean`` does."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


# chunks of 28 rows at d=1024 (921 at d=32) for the bit counts and of 256
# key rows at 12 bits: the chunk loops of the key run several times
SMALL_CHUNK = 12 * 12 * 256
LAYOUT_STORES = [(1000, 64), (4097, 256), (3000, 96), (777, 32), (2048, 128),
                 (3000, 1024)]


def _same_prefix_layout(n, d, n_buckets):
    xj, xt = _store(n + d, n, d)
    _same_layout(jlay.build_layout(xj, d, n_buckets=n_buckets),
                 tlay.build_layout(xt, d, n_buckets=n_buckets))
    bits = ((n_buckets - 1).bit_length() if n_buckets
            else tlay.default_bits(n))
    ja, jpos = jlay.hamming_prefix_assign(xj, d, bits)
    ta, tpos = tlay.hamming_prefix_assign(xt, d, bits)
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())


@pytest.mark.parametrize("n,d", LAYOUT_STORES)
@pytest.mark.parametrize("n_buckets", [None, 16, 1])
def test_prefix_layout_matches_reference(n, d, n_buckets, monkeypatch):
    """With the chunk patched down, so that every chunk loop of the bit
    counts and of the key runs several times."""
    monkeypatch.setattr(tlay, "_CHUNK_BYTES", SMALL_CHUNK)
    _same_prefix_layout(n, d, n_buckets)


@pytest.mark.parametrize("n,d", LAYOUT_STORES)
@pytest.mark.parametrize("n_buckets", [None, 16, 1])
def test_prefix_layout_in_one_chunk_matches_reference(n, d, n_buckets):
    """At the module's own chunk, which takes each of these stores whole."""
    _same_prefix_layout(n, d, n_buckets)


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


@pytest.mark.parametrize("d", [256, 1024])
def test_balanced_bit_ties_order_identically_in_chunks(d, monkeypatch):
    """The same ties, and positions given by the caller, with the bit
    counts taken in chunks of 28 (d=1024) or 115 rows and the 10-bit key
    in chunks of 307."""
    monkeypatch.setattr(tlay, "_CHUNK_BYTES", SMALL_CHUNK)
    xj, xt = _store(5, 1000, d, p=0.5)
    ja, jpos = jlay.hamming_prefix_assign(xj, d, 10)
    ta, tpos = tlay.hamming_prefix_assign(xt, d, 10)
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    ja2, _ = jlay.hamming_prefix_assign(xj, d, 10, positions=jpos[::-1])
    ta2, pos2 = tlay.hamming_prefix_assign(xt, d, 10, positions=tpos.flip(0))
    assert np.array_equal(np.asarray(ja2), ta2.numpy())
    assert torch.equal(pos2, tpos.flip(0))


class _Largest(TorchDispatchMode):
    """Records the bytes of the largest tensor any operator returns."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


def test_prefix_key_works_a_chunk_of_rows_at_a_time(monkeypatch):
    """The bit counts and the key take the store in chunks of at most
    _CHUNK_BYTES // (40 W) and _CHUNK_BYTES // (12 bits) rows, nothing is
    unpacked, and no operator of the assignment or of local_sort returns
    a tensor larger than the chunk or the packed codes: nothing of (N, d)
    or (N, W, 32) is made. The result is the whole-store one."""
    n, d = 5000, 1024
    xj, xt = _store(41, n, d)
    whole_a, whole_pos = tlay.hamming_prefix_assign(xt, d, 12)
    whole_sort = tlay.local_sort(xt, d, n_valid=4000)
    chunk = 40 * 32 * 700
    monkeypatch.setattr(tlay, "_CHUNK_BYTES", chunk)
    rows, unpacked = [], []
    real_chunks = tlay._row_chunks

    def chunks(codes, row_bytes):
        for c in real_chunks(codes, row_bytes):
            rows.append((c.shape[0], row_bytes))
            yield c

    monkeypatch.setattr(tlay, "_row_chunks", chunks)
    monkeypatch.setattr(tlay.binary, "unpack_bits",
                        lambda *a: unpacked.append(a))
    with _Largest() as largest:
        a, pos = tlay.hamming_prefix_assign(xt, d, 12)
    # the counts: 7 chunks of 700 rows and one of 100; the key's 12 bits:
    # one chunk, of up to 896,000 // 144 = 6222 rows
    assert rows == ([(700, 40 * 32)] * 7 + [(100, 40 * 32)]
                    + [(5000, 12 * 12)])
    assert unpacked == [] and largest.bytes <= chunk
    assert torch.equal(a, whole_a) and torch.equal(pos, whole_pos)
    rows.clear()
    with _Largest() as largest:
        got = tlay.local_sort(xt, d, n_valid=4000)
    assert rows == [(5000, 12 * 4)] and unpacked == []    # 4 key bits
    assert largest.bytes <= max(chunk, xt.numel() * 4)
    assert all(torch.equal(g, w) for g, w in zip(got, whole_sort))


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


def _same_local_sort(d, n_valid):
    xj, xt = _store(11, 1000, d)
    jc, jp = jlay.local_sort(xj, d, n_valid=n_valid)
    tc, tp = tlay.local_sort(xt, d, n_valid=n_valid)
    assert np.array_equal(np.asarray(jc).view(np.int32), tc.numpy())
    assert np.array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("n_valid", [None, 700])
def test_local_sort_matches_reference(n_valid, monkeypatch):
    # key chunks of 100 rows at 10 bits
    monkeypatch.setattr(tlay, "_CHUNK_BYTES", 12 * 10 * 100)
    _same_local_sort(128, n_valid)


@pytest.mark.parametrize("n_valid", [None, 700])
def test_local_sort_of_1024_bit_codes_matches_reference(n_valid,
                                                         monkeypatch):
    monkeypatch.setattr(tlay, "_CHUNK_BYTES", 12 * 10 * 100)
    _same_local_sort(1024, n_valid)


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
