"""1024-bit codes (binary-quantised text embeddings) at k=40 on the CPU:
the main path, ``KNNEngine(codes, 1024).with_layout().search``, against
the benchmark's plain reference (``knnbench/references/
hamming_bruteforce.py``) and against ``repro``'s engine on the same numpy
inputs, and K1/K2's plain versions at W=32 in 16-row query blocks (the
geometry the card takes at 4096 x 10M, ``tests/test_torch_tuning.py``)
against ``repro``'s Pallas kernels in interpret mode. Ties at r* are
part of every store here: a group of equal distances that r* cuts is
larger than the slots left free for it."""
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin, engine as jeng
from repro.kernels import ops as jops
from repro.kernels.topk_select import hamming_emit_pallas, hamming_hist_pallas
from repro_torch import carry
from repro_torch.core import engine as teng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_select as tsel

D, K = 1024, 40
REF_PATH = (Path(__file__).resolve().parent.parent / "knnbench"
            / "references" / "hamming_bruteforce.py")


def _reference():
    spec = importlib.util.spec_from_file_location("hamming_bruteforce",
                                                  REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clustered(seed, n, q, centres):
    """n stored and q query codes, each a random centre with every bit
    flipped with p = 1/16 (the benchmark store's process) -> bits."""
    rng = np.random.default_rng(seed)
    cent = rng.integers(0, 2, (centres, D)).astype(np.uint8)
    bits = cent[rng.integers(0, centres, n + q)] ^ (
        rng.random((n + q, D)) < 1 / 16)
    return bits[:n].astype(np.uint8), bits[n:].astype(np.uint8), cent


def _copies_store(seed):
    """Every centre stored 60 times over a clustered store; each query is a
    centre with bit 0 flipped, itself stored once: one row below r* = 1
    and 39 free slots for a group of 60 ties."""
    x, _, cent = _clustered(seed, 2500, 0, 8)
    q = cent.copy()
    q[:, 0] ^= 1
    x = np.concatenate([np.repeat(cent, 60, axis=0), q, x])
    return x[np.random.default_rng(seed).permutation(x.shape[0])], q


def _packed(bits):
    j = jbin.pack_bits(jnp.asarray(bits))
    return j, carry.codes(np.asarray(j), device="cpu")


def _straddles(q_bits, x_bits, k):
    """(Q,) bool: the group at the k-th distance is larger than the slots
    left free for it; and the full distances."""
    full = (q_bits[:, None, :] != x_bits[None, :, :]).sum(axis=2)
    r_star = np.sort(full, axis=1)[:, k - 1]
    free = k - (full < r_star[:, None]).sum(axis=1)
    return (full == r_star[:, None]).sum(axis=1) > free, full


@pytest.mark.parametrize("store", ["clustered", "copies"])
def test_main_path_d1024_k40(store):
    if store == "clustered":
        x, q, _ = _clustered(33, 4000, 24, 16)
    else:
        x, q = _copies_store(34)
    straddle, full = _straddles(q, x, K)
    assert straddle.sum() >= q.shape[0] // 3
    xj, xt = _packed(x)
    qj, qt = _packed(q)
    te = teng.KNNEngine(codes=xt, d=D).with_layout()
    assert te.query_plan(qt, K).select.path == "fused"
    td, ti = te.search(qt, K)
    ref = _reference()
    assert torch.equal(td, ref.knn_distances(qt, xt, K))
    assert torch.equal(td, ref.distances_of(qt, xt, ti))
    np.testing.assert_array_equal(td.numpy(), np.sort(full, axis=1)[:, :K])
    assert all(len(set(row)) == K for row in ti.tolist())
    je = jeng.KNNEngine(codes=xj, d=D).with_layout()
    jd, ji = je.search(qj, K)
    assert np.array_equal(np.asarray(je.layout.perm), te.layout.perm.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_plain_k1_k2_at_w32_bq16_match_reference():
    """K1 with its per-run histograms and K2 split over the runs, at the
    card's bq = 16 for 1024-bit codes, against the Pallas kernels' single
    pass: histogram, block-min summary and every emitted slot."""
    x, q, _ = _clustered(35, 3000, 32, 12)
    straddle, _ = _straddles(q, x, K)
    assert straddle.any()
    xj, _ = _packed(x)
    qj, _ = _packed(q)
    bins, bq, bn = D + 1, 16, 256
    qp, xp, bq, bn, sub = jops._topk_blocked(qj, xj, bins, bq, bn, 8)
    nv = x.shape[0]
    jh, jb = hamming_hist_pallas(qp, xp, bins, jnp.int32(nv), bq=bq, bn=bn,
                                 sub=sub, interpret=True)
    qt, xt = carry.codes(np.asarray(qp), device="cpu"), carry.codes(
        np.asarray(xp), device="cpu")
    assert (qt.shape[1], qt.shape[0] // bq, xt.shape[0] // bn) == (32, 2, 12)
    runs = 5                                   # 12 tiles: 3, 3, 3, 3, 0
    th, tb, run_hist = tsel.hamming_hist_kernel(qt, xt, bins, nv, bq=bq,
                                                bn=bn, runs=runs)
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert torch.equal(run_hist.sum(dim=1), th)
    _, r, n_lt, _ = jops._radius_from_cum(jnp.cumsum(jh, axis=-1), K)
    jd, ji = hamming_emit_pallas(qp, xp, r, n_lt, bins, K, jnp.int32(nv),
                                 block_min=jb, bq=bq, bn=bn, sub=sub,
                                 interpret=True)
    rt, nlt = torch.tensor(np.asarray(r)), torch.tensor(np.asarray(n_lt))
    td, ti = tsel.hamming_emit_kernel(
        qt, xt, rt, nlt, bins, K, nv, block_min=tb, bq=bq, bn=bn,
        run_bases=tops._run_bases(run_hist, rt, nlt))
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
