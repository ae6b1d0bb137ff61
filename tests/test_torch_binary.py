"""PyTorch port vs the JAX reference: bit packing, popcount and the Hamming
distance oracles (repro_torch.core.binary, repro_torch.kernels.ref).

Inputs are made with numpy from a seed and go through both packages;
integer outputs must match exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.kernels import ref as jref
from repro_torch.core import binary as tbin
from repro_torch.kernels import ref as tref

DIMS = [1, 8, 31, 32, 33, 64, 96, 160, 256, 384]


def _bits(seed, n, d, p=0.5):
    return (np.random.default_rng(seed).random((n, d)) < p).astype(np.uint8)


def _as_i32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("d", DIMS)
def test_pack_bits_matches_reference(d):
    bits = _bits(d, 50, d)
    bits[0] = 1                       # all ones: bit 31 of every word set
    bits[1] = 0
    jp = jbin.pack_bits(jnp.asarray(bits))
    tp = tbin.pack_bits(torch.from_numpy(bits))
    assert tp.dtype == torch.int32
    assert tp.shape == (50, jbin.padded_words(d))
    assert np.array_equal(_as_i32(jp), tp.numpy())


@pytest.mark.parametrize("d", DIMS)
def test_unpack_bits_matches_reference(d):
    bits = _bits(100 + d, 20, d)
    jp = jbin.pack_bits(jnp.asarray(bits))
    tp = tbin.pack_bits(torch.from_numpy(bits))
    ju = np.asarray(jbin.unpack_bits(jp, d))
    tu = tbin.unpack_bits(tp, d)
    assert tu.dtype == torch.uint8
    assert np.array_equal(ju, tu.numpy())
    assert np.array_equal(tu.numpy(), bits)           # round trip


def test_pack_bits_leading_batch_dims():
    bits = _bits(7, 24, 70).reshape(2, 3, 4, 70)
    jp = jbin.pack_bits(jnp.asarray(bits))
    tp = tbin.pack_bits(torch.from_numpy(bits))
    assert np.array_equal(_as_i32(jp), tp.numpy())


def test_popcount32_every_bit_pattern_class():
    rng = np.random.default_rng(3)
    words = np.concatenate([
        rng.integers(0, 1 << 32, 5000, dtype=np.uint32),
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                  0xAAAAAAAA], dtype=np.uint32)])
    expect = np.array([bin(int(w)).count("1") for w in words], np.int32)
    got = tbin.popcount32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("q,n,d", [(8, 300, 64), (5, 99, 96), (3, 130, 256),
                                   (4, 64, 8), (2, 40, 384)])
def test_hamming_distances_match_reference(q, n, d):
    xb, qb = _bits(q * n, n, d), _bits(q + n, q, d)
    ref = np.asarray(jbin.hamming_ref(jnp.asarray(qb), jnp.asarray(xb)))
    jx = np.asarray(jbin.hamming_xor(jbin.pack_bits(jnp.asarray(qb)),
                                     jbin.pack_bits(jnp.asarray(xb))))
    tq, tx = tbin.pack_bits(torch.from_numpy(qb)), tbin.pack_bits(
        torch.from_numpy(xb))
    t_ref = tbin.hamming_ref(torch.from_numpy(qb), torch.from_numpy(xb))
    t_xor = tbin.hamming_xor(tq, tx)
    t_mxu = tbin.hamming_mxu(torch.from_numpy(qb), torch.from_numpy(xb), d)
    for t in (t_ref, t_xor, t_mxu):
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), ref)
    assert np.array_equal(jx, ref)


def test_padded_words_matches_reference():
    for d in range(0, 300, 7):
        assert tbin.padded_words(d) == jbin.padded_words(d)


@pytest.mark.parametrize("bins", [5, 65, 257])
def test_kernel_oracles_match_reference(bins):
    xb, qb = _bits(11, 200, 256), _bits(12, 6, 256)
    jq = jbin.pack_bits(jnp.asarray(qb)).astype(jnp.int32)
    jx = jbin.pack_bits(jnp.asarray(xb)).astype(jnp.int32)
    tq, tx = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jx))
    assert np.array_equal(np.asarray(jref.hamming_distance_ref(jq, jx)),
                          tref.hamming_distance_ref(tq, tx).numpy())
    assert np.array_equal(np.asarray(jref.hamming_hist_ref(jq, jx, bins)),
                          tref.hamming_hist_ref(tq, tx, bins).numpy())
    assert np.array_equal(np.asarray(jref.bitpack_ref(jnp.asarray(xb))),
                          tref.bitpack_ref(torch.from_numpy(xb)).numpy())
