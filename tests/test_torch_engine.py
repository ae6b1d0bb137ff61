"""PyTorch port vs the JAX reference, end to end: ``search_chunked`` on
every select path, ``KNNEngine.with_layout().search`` (the main path) and
the state carried across with ``repro_torch.carry``. The port runs on the
CPU (``device="cpu"``), the reference with its Pallas kernels in interpret
mode; (dists, ids) must be bit-identical."""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin, engine as jeng
from repro_torch import carry
from repro_torch.core import engine as teng
from repro_torch.core import plan as tplan

SELECTS = ["auto", "composite", "counting", "bisect", "fused", "fused_scan"]


def _store(seed, n, q, d, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.integers(0, 2, (8, d))
        flip = rng.random((n + q, d)) < 0.08
        bits = centers[rng.integers(0, 8, n + q)] ^ flip
    else:
        bits = rng.integers(0, 2, (n + q, d))
    bits = bits.astype(np.uint8)
    xj = jbin.pack_bits(jnp.asarray(bits[:n]))
    qj = jbin.pack_bits(jnp.asarray(bits[n:]))
    return (xj, qj, carry.codes(np.asarray(xj), device="cpu"),
            carry.codes(np.asarray(qj), device="cpu"))


def _same(j, t):
    assert t[0].dtype == torch.int32 and t[1].dtype == torch.int32
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1]), t[1].numpy())


@pytest.mark.parametrize("select", SELECTS)
@pytest.mark.parametrize("n,q,d,k,chunk", [
    (500, 6, 64, 10, 130),      # ragged chunks: last chunk mostly padding
    (300, 4, 32, 400, 128),     # k > N through the scan merge
])
def test_search_chunked_matches_reference(select, n, q, d, k, chunk):
    xj, qj, xt, qt = _store(5, n, q, d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _same(jeng.search_chunked(xj, qj, k, d, chunk=chunk, select=select),
              teng.search_chunked(xt, qt, k, d, chunk=chunk, select=select))


@pytest.mark.parametrize("select", ["composite", "bisect"])
def test_mxu_distances_and_id_offset_match_reference(select):
    xj, qj, xt, qt = _store(6, 400, 5, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _same(jeng.search_chunked(xj, qj, 7, 96, chunk=150, method="mxu",
                                  id_offset=1000, select=select),
              teng.search_chunked(xt, qt, 7, 96, chunk=150, method="mxu",
                                  id_offset=1000, select=select))


@pytest.mark.parametrize("n,q,d", [(3000, 8, 64), (4097, 5, 256)])
def test_with_layout_search_matches_reference(n, q, d):
    """The main path: auto resolves to fused over the prebuilt layout."""
    xj, qj, xt, qt = _store(7, n, q, d, clustered=True)
    je = jeng.KNNEngine(codes=xj, d=d).with_layout()
    te = teng.KNNEngine(codes=xt, d=d).with_layout()
    assert np.array_equal(np.asarray(je.layout.perm), te.layout.perm.numpy())
    assert te.query_plan(qt, 16).compact() == je.query_plan(qj, 16).compact()
    assert te.query_plan(qt, 16).select.path == "fused"
    _same(je.search(qj, 16), te.search(qt, 16))


def test_layout_engine_forced_selects_match_reference():
    """A forced materializing select drops the layout (original order);
    fused_scan streams it."""
    xj, qj, xt, qt = _store(8, 700, 6, 64, clustered=True)
    je = jeng.KNNEngine(codes=xj, d=64).with_layout(n_buckets=8)
    te = teng.KNNEngine(codes=xt, d=64).with_layout(n_buckets=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for select in ("counting", "fused_scan"):
            _same(je.search(qj, 9, chunk=256, select=select),
                  te.search(qt, 9, chunk=256, select=select))


def test_local_sort_plan_matches_reference():
    """layout_policy='require' without a prebuilt layout: per-call
    local_sort, then the fused select and the permutation back."""
    from repro.core import plan as jplan

    xj, qj, xt, qt = _store(9, 900, 5, 128, clustered=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jplan.plan_local(jplan.stats_of(xj, qj, 128), 12,
                              layout_policy="require")
        tp = tplan.plan_local(tplan.stats_of(xt, qt, 128), 12,
                              layout_policy="require")
    assert tp.candidates.layout == jp.candidates.layout == "local_sort"
    _same(jplan.execute(jp, qj, codes=xj), tplan.execute(tp, qt, codes=xt))


def test_carry_builds_the_reference_engine_on_the_port():
    """repro's codes and prebuilt layout, carried as numpy arrays, search
    the same as the reference engine; codes keep their bit pattern."""
    xj, qj, _, _ = _store(10, 2000, 7, 256, clustered=True)
    je = jeng.KNNEngine(codes=xj, d=256).with_layout()
    lay = je.layout
    te = carry.engine(np.asarray(xj), 256,
                      layout_arrays=tuple(np.asarray(a) for a in
                                          (lay.codes, lay.perm, lay.inv,
                                           lay.starts)),
                      device="cpu")
    assert te.device == torch.device("cpu")
    assert np.array_equal(np.asarray(xj).view(np.int32), te.codes.numpy())
    assert te.layout.n_buckets == lay.n_buckets
    _same(je.search(qj, 16), te.search(carry.codes(np.asarray(qj), "cpu"), 16))
    with pytest.raises(TypeError):
        carry.codes(np.zeros((3, 2), np.float32), device="cpu")
