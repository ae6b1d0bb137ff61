"""PyTorch port vs the JAX reference: the statistical activation reduction
model (``core/hierarchy.py``, paper §6.3), the sharded merge's fanout and
tree-level arithmetic and its traffic hints (``kernels/tuning.py``).

On a grid of (k, R groups, k'): the binomial tail and the union bound
within 1e-12 relative (host floats, the same formula), the Monte Carlo
estimate draw for draw (the same ``np.random.default_rng(seed)``
stream), the bandwidth factor and the recommended k' exactly."""
import itertools

import pytest

from repro.core import hierarchy as jh
from repro.kernels import tuning as jtuning
from repro_torch.core import hierarchy as th
from repro_torch.kernels import tuning as ttuning

GRID = [(k, r, kp) for k, r in itertools.product((2, 4, 16, 32),
                                                  (2, 8, 64, 128))
        for kp in sorted({1, max(1, k // 4), k // 2 or 1, k})]


@pytest.mark.parametrize("k,r,kp", GRID)
def test_bounds_match_reference(k, r, kp):
    assert th.binomial_tail(k, r, kp) == pytest.approx(
        jh.binomial_tail(k, r, kp), rel=1e-12, abs=0)
    assert th.failure_bound(k, r, kp) == pytest.approx(
        jh.failure_bound(k, r, kp), rel=1e-12, abs=0)


@pytest.mark.parametrize("k,r,kp,seed", [(16, 8, 2, 0), (4, 2, 1, 3),
                                         (32, 64, 3, 7), (2, 2, 2, 1),
                                         (16, 128, 1, 5)])
def test_monte_carlo_matches_reference_draw_for_draw(k, r, kp, seed):
    assert th.failure_exact_mc(k, r, kp, trials=3000, seed=seed) == \
        jh.failure_exact_mc(k, r, kp, trials=3000, seed=seed)


@pytest.mark.parametrize("k,r,target", [(16, 64, 0.01), (16, 8, 0.1),
                                        (32, 128, 1e-3), (4, 2, 0.5)])
def test_recommended_kprime_matches_reference(k, r, target):
    kp = th.recommended_kprime(k, r, max_failure=target)
    assert kp == jh.recommended_kprime(k, r, max_failure=target)
    assert th.bandwidth_reduction(1024, kp) == jh.bandwidth_reduction(1024,
                                                                      kp)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 6, 8, 12, 16, 64, 100])
def test_merge_fanout_and_levels_match_reference(n_shards):
    assert ttuning.merge_fanout(n_shards) == jtuning.merge_fanout(n_shards)
    for fanout in (0, 2, 3, 4, 8):
        assert ttuning.tree_levels(n_shards, fanout) == \
            jtuning.tree_levels(n_shards, fanout)
    for strategy, fanout, k_local in (("hist_merge", 0, None),
                                      ("hist_tree", 2, None),
                                      ("hist_tree", 0, None),
                                      ("concat_sort", 0, 4)):
        assert ttuning.shard_hints(
            4096, 16, 257, n_shards, k_local=k_local, strategy=strategy,
            fanout=fanout) == jtuning.shard_hints(
            4096, 16, 257, n_shards, k_local=k_local, strategy=strategy,
            fanout=fanout)
