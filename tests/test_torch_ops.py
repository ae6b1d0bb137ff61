"""PyTorch port vs the JAX reference: ``ops.hamming_topk``, the single-shot
fused select, over tests/test_fused_topk.py's shapes and k values.

The port runs K1/K2's plain PyTorch versions on CPU tensors, the reference
its Pallas kernels in interpret mode; both run at the reference's
(bq, bn) geometry, and (dists, ids), the block-min summary and the
pruning stats (``return_stats``) must match exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.kernels import ops as jops
from repro_torch import carry
from repro_torch.kernels import ops as tops

# as in tests/test_fused_topk.py: aligned and ragged N, W from 1 to 8
# words, Q below one sublane tile
SHAPES = [(8, 1024, 64), (5, 999, 96), (16, 300, 32), (1, 4097, 256),
          (33, 130, 160)]


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
    t = tops.hamming_topk(qt, xt, k, bins, bq=bq, bn=bn, return_stats=True,
                          **kw)
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
@pytest.mark.parametrize("k", [1, 10, 64])
def test_hamming_topk_matches_reference(q, n, d, k):
    xj, qj, xt, qt = _codes(0, n, q, d)
    _same_topk(*_topk_both(xj, qj, xt, qt, k, d + 1))
