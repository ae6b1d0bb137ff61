"""PyTorch port vs the JAX reference: the materializing distance kernel K3
(``repro_torch.kernels.hamming``, ``ops.hamming_distance``) and the board
scan it runs under (``method="pallas"`` on the composite, counting and
bisect selects). The port runs K3's plain version on the CPU, the
reference its Pallas kernel in interpret mode; every output is an integer
and compared exactly."""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin, engine as jeng
from repro.kernels import ops as jops
from repro_torch import carry
from repro_torch.core import binary as tbin, engine as teng
from repro_torch.core import plan as tplan
from repro_torch.kernels import hamming as tham
from repro_torch.kernels import ops as tops

# tests/test_kernels.py's shapes
SHAPES = [(8, 128, 1), (16, 300, 2), (128, 2048, 8), (7, 100, 4),
          (1, 5000, 8), (33, 999, 3), (64, 64, 6)]


def _words(seed, n, w, high):
    """int31 words as tests/test_kernels.py draws them, or (``high``) the
    full uint32 range, top bits included."""
    rng = np.random.default_rng(seed)
    if high:
        return rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint32)
    return rng.integers(0, 2**31 - 1, size=(n, w), dtype=np.int64)


@pytest.mark.parametrize("q,n,w", SHAPES)
@pytest.mark.parametrize("dtype,high", [("int32", False), ("uint32", False),
                                        ("uint32", True)])
def test_hamming_distance_matches_reference(q, n, w, dtype, high):
    qa = _words(0, q, w, high).astype(dtype)
    xa = _words(1, n, w, high).astype(dtype)
    ref = np.asarray(jops.hamming_distance(jnp.asarray(qa), jnp.asarray(xa)))
    before = tham.hamming_distance_kernel.launches
    out = tops.hamming_distance(carry.codes(qa.view(np.int32), "cpu"),
                                carry.codes(xa.view(np.int32), "cpu"))
    assert out.dtype == torch.int32 and tuple(out.shape) == (q, n)
    assert np.array_equal(out.numpy(), ref)
    assert tham.hamming_distance_kernel.launches == before


def test_top_bit_counts_in_every_word():
    q = torch.full((8, 3), -1, dtype=torch.int32)        # 0xFFFFFFFF words
    x = torch.tensor([[0, 0, 0], [-(1 << 31), 0, 1], [-1, -1, -1]],
                     dtype=torch.int32)
    out = tops.hamming_distance(q, x)
    assert out[0].tolist() == [96, 94, 0]
    assert torch.equal(out, tbin.hamming_xor(q, x))


def test_kernel_wrapper_takes_the_tiled_shape_and_refuses_others():
    rng = np.random.default_rng(2)
    q = carry.codes(rng.integers(0, 1 << 32, (16, 5), dtype=np.uint32), "cpu")
    x = carry.codes(rng.integers(0, 1 << 32, (384, 5), dtype=np.uint32), "cpu")
    out = tham.hamming_distance_kernel(q, x, bq=8, bn=128)
    assert torch.equal(out, tham.hamming_distance_plain(q, x))
    assert torch.equal(out, tbin.hamming_xor(q, x))
    with pytest.raises(ValueError, match="does not tile"):
        tham.hamming_distance_kernel(q, x, bq=8, bn=100)
    with pytest.raises(ValueError, match="widths differ"):
        tham.hamming_distance_kernel(q, x[:, :4], bq=8, bn=128)
    # ops pads Q and N to the tile and slices the result back
    assert torch.equal(tops.hamming_distance(q[:5], x[:201], bq=8, bn=128),
                       tbin.hamming_xor(q[:5], x[:201]))
    assert tops.hamming_distance(q[:0], x).shape == (0, 384)


def _store(seed, n, q, d):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2, (6, d))
    bits = (centers[rng.integers(0, 6, n + q)]
            ^ (rng.random((n + q, d)) < 0.1)).astype(np.uint8)
    xj = jbin.pack_bits(jnp.asarray(bits[:n]))
    qj = jbin.pack_bits(jnp.asarray(bits[n:]))
    return (xj, qj, carry.codes(np.asarray(xj), device="cpu"),
            carry.codes(np.asarray(qj), device="cpu"))


@pytest.mark.parametrize("select", ["counting", "composite", "bisect"])
def test_board_scan_matches_reference(select):
    """search_chunked(method="pallas") equals repro's, the port's xor
    method and its fused select; chunk 300 leaves a ragged last chunk."""
    xj, qj, xt, qt = _store(3, 1000, 6, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jeng.search_chunked(xj, qj, 12, 96, chunk=300, method="pallas",
                                  select=select)
        tham.reset_launch_counts()
        out = teng.search_chunked(xt, qt, 12, 96, chunk=300, method="pallas",
                                  select=select)
        xor = teng.search_chunked(xt, qt, 12, 96, chunk=300, select=select)
        fused = teng.search_chunked(xt, qt, 12, 96, select="fused")
    assert tham.hamming_distance_kernel.launches == 0     # CPU tensors
    for got in (out, xor, fused):
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_engine_and_forced_plan_reach_k3():
    """KNNEngine.search(method="pallas") and force_plan "method=pallas"
    plan K3 on the materializing selects and answer like repro."""
    xj, qj, xt, qt = _store(4, 700, 5, 64)
    je = jeng.KNNEngine(codes=xj, d=64)
    te = teng.KNNEngine(codes=xt, d=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = je.search(qj, 9, chunk=256, method="pallas", select="counting")
        out = te.search(qt, 9, chunk=256, method="pallas", select="counting")
    assert np.array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
    p = te.query_plan(qt, 9, force="select=bisect,method=pallas")
    assert p.select.method == "pallas" and p.select.path == "bisect"
    assert "hamming_distance_kernel (K3, CUDA)" in p.explain()["kernels"][0]
    dd, ii = tplan.execute(p, qt, codes=xt)
    assert torch.equal(dd, out[0]) and torch.equal(ii, out[1])
