"""The approximate tier (port of ``repro.kernels.approx_select``, the
single-device half): Hamming-as-matmul scoring on ±1 int8 bit planes and a
bucketed partial-reduce top-k with an analytical recall bound.

* **Scoring** — packed codes are bit-sliced into ±1 int8 planes, so the
  Hamming distance is one int8 product with int32 accumulation,
  ``dist = (d - Q_planes @ X_planesᵀ) >> 1`` (``torch._int_mm``; exact
  integer distances). The asymmetric path keeps the query as a float
  projection against the datastore's ±1 planes, in f32.
* **Partial reduce** — each ``bn``-row data block's (Q, bn) score tile is
  reduced to its best ``l`` candidates by (dist, position), and the pool
  of every block's candidates is merged by the same lexicographic order:
  ``ops.hamming_topk``'s contract (ascending, ties by index, (bins, N)
  sentinels last). ``l`` comes from the TPU-KNN bound
  (``l_for_recall``); ``recall_target=1.0`` keeps every row, so the result
  is bit-identical to the fused select.

``repro`` computes this with XLA ``dot_general`` and ``lax.sort`` outside
any Pallas kernel; the port does the same with PyTorch calls. Two things
differ in how, not in what is computed:

* ``torch._int_mm`` on CUDA needs more than 16 rows in its first operand
  and K, N multiples of 8, so the query planes are padded to
  ``_mm_rows(Q)`` rows (and the planes' other dims to multiples of 8)
  before the product and the result sliced back.
* The (Q, N) scores are never held whole: the blocks are scored a chunk
  at a time (and the queries a chunk at a time when one block row is
  already too wide), and each chunk's candidates are merged into a running
  top-k by the int64 key ``dist * (N + 1) + pos`` — the order of
  ``lax.sort(..., num_keys=2)`` over the whole pool, since keys of real
  candidates are distinct and every sentinel key is equal. At
  ``recall_target=1.0`` the pool is every row, so each chunk gives the
  merge its own best k rows instead of its blocks' pools.

* **Sharded merge** — ``approx_topk_sharded`` merges per-shard candidate
  pools hist_merge-style (``ops.hamming_topk_sharded``'s collectives):
  each rank histograms its pool's distances, one psum derives the global
  radius r*, and winners land in disjoint slots of the replicated (Q, k)
  output. Only a rank's best k candidates by (dist, id) can land in a
  slot below k, so each rank keeps, chunk by chunk, its pool's histogram
  and its pool's best k — never the pool itself.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.core import binary
from repro_torch.kernels import tuning

# elements of one chunk's (Q, rows) score tile, per backend
_CHUNK_ELEMS = {"gpu": 1 << 28, "cpu": 1 << 22}
# torch._int_mm on CUDA takes more than 16 rows in its first operand
_MM_MIN_ROWS = 32


# ---------------------------------------------------------------------------
# the analytical recall bound
# ---------------------------------------------------------------------------

def expected_recall(k: int, n_blocks: int, l: int) -> float:
    """E[recall@k] keeping the best ``l`` of each of ``n_blocks`` equal
    data blocks, under the TPU-KNN uniform-arrangement model: the i-th
    best item (i = 0..k-1) is kept iff fewer than ``l`` of the i better
    items land in its block — a binomial tail at p = 1/n_blocks. Host
    math, exact."""
    k = max(int(k), 1)
    l = int(l)
    if l <= 0:
        return 0.0
    n_blocks = max(int(n_blocks), 1)
    if n_blocks == 1:
        return min(l, k) / k
    p = 1.0 / n_blocks
    total = 0.0
    for i in range(k):
        surv = 0.0
        for j in range(min(l, i + 1)):
            surv += math.comb(i, j) * p ** j * (1.0 - p) ** (i - j)
        total += min(surv, 1.0)
    return total / k


def l_for_recall(k: int, n_blocks: int, block_rows: int,
                 recall_target: float) -> int:
    """Smallest per-block candidate count L whose analytical expected
    recall meets ``recall_target``. ``recall_target >= 1`` returns the
    full block (the pool is every row — exact, bit-identical to the fused
    counting select); L never needs to exceed k (at L = k the bound is
    exactly 1)."""
    block_rows = max(int(block_rows), 1)
    if recall_target >= 1.0:
        return block_rows
    l = 1
    cap = min(max(int(k), 1), block_rows)
    while l < cap and expected_recall(k, n_blocks, l) < recall_target:
        l += 1
    return l


# ---------------------------------------------------------------------------
# scoring: bit-sliced planes
# ---------------------------------------------------------------------------

def bit_planes(packed: torch.Tensor, d: int, signed: bool = True
               ) -> torch.Tensor:
    """Bit-slice packed codes into int8 planes: (..., W) int32 ->
    (..., d) int8 in {-1, +1} (``signed``) or {0, 1}."""
    bits = binary.unpack_bits(packed, d).to(torch.int8)
    return 2 * bits - 1 if signed else bits


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm_rows(m: int) -> int:
    """Rows the first operand of the int8 product is padded to."""
    return max(_MM_MIN_ROWS, _round_up(m, 8))


def _pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if a.shape == (rows, cols):
        return a.contiguous()
    out = a.new_zeros((rows, cols))
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) int8 -> (M, N) int32 = a @ bᵀ through
    ``torch._int_mm``, on shapes it takes on every backend: M padded to
    ``_mm_rows(M)``, K and N to multiples of 8 (zero planes add nothing)."""
    M, K = a.shape
    N = b.shape[0]
    kp = _round_up(K, 8)
    ap = _pad2(a, _mm_rows(M), kp)
    bp = _pad2(b, _round_up(N, 8), kp)
    return torch._int_mm(ap, bp.t())[:M, :N]


def hamming_scores_planes(q_planes: torch.Tensor, x_planes: torch.Tensor,
                          d: int) -> torch.Tensor:
    """Hamming distance as one int8 product: q (Q, d) ±1, x (N, d) ±1 ->
    (Q, N) int32, exact: ``<±q, ±x> = d - 2·hamming``, accumulated in
    int32."""
    return (d - _int8_dot(q_planes, x_planes)) >> 1


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def asymmetric_scores(v: torch.Tensor, x_planes: torch.Tensor
                      ) -> torch.Tensor:
    """Asymmetric float/int8 scoring for non-binary stores: the query stays
    the continuous rotated projection (``quantize.itq_project``), scored
    against the datastore's ±1 planes. Returns (Q, N) f32 inner products,
    descending = nearest. ``repro`` takes bf16 operands on a TPU only and
    f32 elsewhere; the port takes f32 with TF32 off."""
    with _no_tf32():
        return v.float() @ x_planes.float().t()


# ---------------------------------------------------------------------------
# the bucketed partial-reduce select
# ---------------------------------------------------------------------------

def _chunks(Q: int, n_blocks: int, bn: int, backend: str):
    """(query slice, first block, end block) chunks whose (rows, blocks·bn)
    score tile stays under the backend's element budget."""
    budget = _CHUNK_ELEMS.get(backend, 1 << 24)
    q_step = max(1, min(Q, budget // max(bn, 1)))
    for q0 in range(0, Q, q_step):
        q1 = min(Q, q0 + q_step)
        b_step = max(1, budget // max((q1 - q0) * bn, 1))
        for b0 in range(0, n_blocks, b_step):
            yield slice(q0, q1), b0, min(n_blocks, b0 + b_step)


def _block_dists(qpl: torch.Tensor, x_packed: torch.Tensor, bins: int,
                 bn: int, b0: int, b1: int, nv: int, bm) -> torch.Tensor:
    """(Qc, b1-b0, bn) int32 distances of the rows of blocks [b0, b1);
    rows past ``nv`` or in a disabled block read ``bins``. The planes hold
    bins - 1 bits, so no distance exceeds bins - 1 (``repro``'s clamp is
    a no-op here)."""
    N = x_packed.shape[0]
    d = bins - 1
    r0, r1 = b0 * bn, min(b1 * bn, N)
    dist = hamming_scores_planes(qpl, bit_planes(x_packed[r0:r1], d), d)
    nb = b1 - b0
    if r1 - r0 < nb * bn:
        dist = torch.nn.functional.pad(dist, (0, nb * bn - (r1 - r0)),
                                       value=bins)
    if bm is not None or nv < r1:
        gid = r0 + torch.arange(nb * bn, device=dist.device)
        ok = (gid < nv)[None, :]
        if bm is not None:
            ok = ok & (bm[:, b0:b1] > 0).repeat_interleave(bn, dim=1)
        dist = torch.where(ok, dist, bins)
    return dist.reshape(-1, nb, bn)


def _block_reduce(dist: torch.Tensor, l: int, bins: int, bn: int, r0: int,
                  N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best ``l`` of every block by (dist, in-block index): (Qc, nb, bn),
    the blocks' rows starting at row ``r0`` -> (dists, positions), each
    (Qc, nb·l); positions of sentinel slots are N."""
    Qc, nb, _ = dist.shape
    kdt = torch.int64 if (bins + 1) * bn >= (1 << 31) else torch.int32
    idx = torch.arange(bn, dtype=kdt, device=dist.device)
    key = dist.to(kdt) * bn + idx
    key = torch.topk(key, l, dim=-1, largest=False, sorted=True).values
    dd = (key // bn).to(torch.int32)
    blk = torch.arange(nb, device=dist.device)[None, :, None]
    pos = torch.where(dd < bins, (r0 + blk * bn + key % bn).to(torch.int32),
                      N)
    return dd.reshape(Qc, nb * l), pos.reshape(Qc, nb * l)


def _prepare(q_packed, N, bins, n_valid, block_mask, bn):
    n_blocks = -(-N // bn)
    nv = N if n_valid is None else int(n_valid)
    bm = None
    if block_mask is not None:
        bm = torch.as_tensor(block_mask, device=q_packed.device).to(
            torch.int32)
        if tuple(bm.shape) != (q_packed.shape[0], n_blocks):
            raise ValueError(f"block_mask shape {tuple(bm.shape)} != "
                             f"{(q_packed.shape[0], n_blocks)}")
    return n_blocks, nv, bm, bit_planes(q_packed, bins - 1)


def _pool(q_packed: torch.Tensor, x_packed: torch.Tensor, bins: int,
          bn: int, l: int, n_valid=None, block_mask=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole candidate pool, as ``repro``'s ``_pool`` returns it: dists
    (Q, n_blocks·l) int32 in [0, bins] (``bins`` = invalid), positions
    (Q, n_blocks·l) int32 (N in invalid slots), blocks in order. For
    inspection; ``approx_topk`` merges the pool chunk by chunk instead."""
    N = x_packed.shape[0]
    Q = q_packed.shape[0]
    n_blocks, nv, bm, qpl = _prepare(q_packed, N, bins, n_valid, block_mask,
                                     bn)
    dd = torch.empty((Q, n_blocks * l), dtype=torch.int32,
                     device=q_packed.device)
    pos = torch.empty_like(dd)
    backend = device_mod.backend_of(q_packed)
    for qs, b0, b1 in _chunks(Q, n_blocks, bn, backend):
        dist = _block_dists(qpl[qs], x_packed, bins, bn, b0, b1, nv,
                            None if bm is None else bm[qs])
        cd, cp = _block_reduce(dist, l, bins, bn, b0 * bn, N)
        dd[qs, b0 * l:b1 * l], pos[qs, b0 * l:b1 * l] = cd, cp
    return dd, pos


def _merge(best: torch.Tensor, dd: torch.Tensor, pos: torch.Tensor,
           N: int, k: int) -> torch.Tensor:
    """Running lexicographic (dist, pos) top-k over int64 keys."""
    key = dd.to(torch.int64) * (N + 1) + pos.to(torch.int64)
    cand = torch.cat([best, key], dim=1)
    return torch.topk(cand, min(k, cand.shape[1]), dim=1, largest=False,
                      sorted=True).values


def approx_topk(q_packed: torch.Tensor, x_packed: torch.Tensor, k: int,
                bins: int, *, recall_target: float = 1.0, n_valid=None,
                block_mask=None, bn: Optional[int] = None,
                l: Optional[int] = None, backend: str | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed partial-reduce approximate top-k.

    q: (Q, W), x: (N, W) packed int32 -> (dists (Q, k) ascending,
    positions (Q, k)) int32 with ``ops.hamming_topk``'s contract:
    distances clamped to bins-1, ties broken by index order, rows beyond
    min(k, n_valid) padded with (bins, N). The pool keeps the best
    ``l = l_for_recall(k, n_blocks, bn, recall_target)`` rows of every
    ``bn``-row block; at ``recall_target=1.0`` the pool is every row and
    the result is bit-identical to the fused select.

    ``block_mask``: optional per-query (Q, ceil(N/bn)) enable mask."""
    N, W = x_packed.shape
    Q = q_packed.shape[0]
    dev = q_packed.device
    k_k = min(k, N)
    if k_k <= 0:
        return (torch.full((Q, k), bins, dtype=torch.int32, device=dev),
                torch.full((Q, k), N, dtype=torch.int32, device=dev))
    be = backend or device_mod.backend_of(q_packed)
    if bn is None:
        bn = tuning.approx_blocks(Q, N, W, backend=be)
    bn = max(min(int(bn), N + (-N) % 8 if N >= 8 else N), 1)
    n_blocks = -(-N // bn)
    if l is None:
        l = l_for_recall(k_k, n_blocks, bn, recall_target)
    l = max(min(int(l), bn), 1)

    n_blocks, nv, bm, qpl = _prepare(q_packed, N, bins, n_valid, block_mask,
                                     bn)
    sentinel = bins * (N + 1) + N
    best = torch.full((Q, k), sentinel, dtype=torch.int64, device=dev)
    for qs, b0, b1 in _chunks(Q, n_blocks, bn, device_mod.backend_of(dev)):
        dist = _block_dists(qpl[qs], x_packed, bins, bn, b0, b1, nv,
                            None if bm is None else bm[qs])
        if l == bn:
            # the pool is every row: the chunk's own best k by (dist, row)
            # are all it can give the merge
            rows = dist.shape[1] * bn
            cd, cp = _block_reduce(dist.reshape(dist.shape[0], 1, rows),
                                   min(k, rows), bins, rows, b0 * bn, N)
        else:
            cd, cp = _block_reduce(dist, l, bins, bn, b0 * bn, N)
        best[qs] = _merge(best[qs], cd, cp, N, k)
    return ((best // (N + 1)).to(torch.int32),
            (best % (N + 1)).to(torch.int32))


def masked_approx_topk(layout, q_packed: torch.Tensor, k: int, d: int,
                       probe: Optional[torch.Tensor] = None,
                       cand_ids: Optional[torch.Tensor] = None,
                       recall_target: float = 1.0, bn: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index-probed approximate select over a bucket-clustered layout:
    probed bucket ids / original candidate ids become a PER-QUERY (bq = 1)
    block enable mask at ``bn = tuning.approx_blocks`` resolution, which
    gates the partial-reduce select. Returns (dists, ORIGINAL ids) with -1
    in sentinel slots."""
    from repro_torch.core import layout as layout_mod

    Q, W = q_packed.shape
    n = layout.n
    bins = d + 1
    if bn is None:
        bn = tuning.approx_blocks(Q, n, W,
                                  backend=device_mod.backend_of(q_packed))
    bn = max(min(int(bn), n), 1)
    n_blocks = -(-n // bn)
    mask = None
    if probe is not None:
        mask = layout_mod.probe_block_mask(layout, probe, 1, bn, Q, n_blocks)
    if cand_ids is not None:
        pmask = layout_mod.position_block_mask(layout, cand_ids, 1, bn,
                                               Q, n_blocks)
        mask = pmask if mask is None else torch.maximum(mask, pmask)
    dd, pos = approx_topk(q_packed, layout.codes, k, bins,
                          recall_target=recall_target, bn=bn,
                          block_mask=mask)
    return dd, layout_mod.original_ids(layout, dd, pos, d)


# ---------------------------------------------------------------------------
# the sharded hist_merge-style candidate merge
# ---------------------------------------------------------------------------

def approx_topk_sharded(q_packed: torch.Tensor, x_local: torch.Tensor,
                        k: int, bins: int, axis_names, *, mesh,
                        n_shards: int, recall_target: float = 1.0,
                        n_valid=None, id_base=None, n_total=None, perm=None,
                        participate=None, tree_fanout: int = 0,
                        bn: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed approximate select — hist_merge over per-shard candidate
    POOLS instead of per-shard rows. Every rank of ``mesh`` calls it.

    Per rank: the partial reduce shrinks the local slice to n_blocks·L
    candidates (L sized from the GLOBAL pool's block count, so the recall
    bound covers the whole sharded store). Merge, exactly like
    ``ops.hamming_topk_sharded``: (1) each rank histograms its pool's
    distances — a partial histogram of the global candidate race; (2) one
    psum merges them and the global radius r*, below-count and emit count
    derive via the SAME ``_radius_from_cum``; (3) a (Q, 2)-per-shard
    all-gather turns local below/tie counts into exclusive-scan slot bases;
    (4) winners land in disjoint slots of the replicated (Q, k) output in
    (dist, id) order and one psum assembles it.

    At ``recall_target=1.0`` the pool is every row: bit-identical to
    ``ops.hamming_topk_sharded`` / the single-device fused select.
    ``n_valid``/``id_base``/``n_total``/``participate``/``tree_fanout``:
    the contracts of ``ops.hamming_topk_sharded``. ``perm``: this rank's
    local layout permutation (winners report original ids; in-shard tie
    order then follows (dist, original id))."""
    from repro_torch.kernels import ops

    axes = tuple(axis_names)
    Q, W = q_packed.shape
    n_loc = x_local.shape[0]
    dev = q_packed.device
    k_k = min(k, n_shards * n_loc)
    if k_k <= 0:
        return (torch.full((Q, k), bins, dtype=torch.int32, device=dev),
                torch.full((Q, k), 0, dtype=torch.int32, device=dev))
    flat, nv, ib, nt = ops._shard_rows(mesh, axes, n_shards, n_loc, n_valid,
                                       id_base, n_total, participate, dev)
    psum = ((lambda v: ops._tree_psum(v, mesh, axes, tree_fanout))
            if tree_fanout >= 2 else (lambda v: ops._psum(v, mesh, axes)))

    backend = device_mod.backend_of(dev)
    if bn is None:
        bn = tuning.approx_blocks(Q, n_loc, W, backend=backend)
    bn = max(min(int(bn), n_loc), 1)
    n_blocks = -(-n_loc // bn)
    l = max(min(l_for_recall(k_k, n_shards * n_blocks, bn, recall_target),
                bn), 1)

    # the local pool, chunk by chunk: its histogram, and its best k_k by
    # the key dist·(n_loc+1) + local id (sentinels: bins, n_loc)
    _, nv, _, qpl = _prepare(q_packed, n_loc, bins, nv, None, bn)
    kdt = torch.int64 if (bins + 1) * (n_loc + 1) >= (1 << 31) else torch.int32
    stride = n_loc + 1
    sentinel = bins * stride + n_loc
    perm_t = None if perm is None else torch.as_tensor(perm, device=dev).long()
    hist_loc = torch.zeros((Q, bins), dtype=torch.int32, device=dev)
    best = torch.full((Q, k_k), sentinel, dtype=kdt, device=dev)
    for qs, b0, b1 in _chunks(Q, n_blocks, bn, backend):
        dist = _block_dists(qpl[qs], x_local, bins, bn, b0, b1, nv, None)
        if l == bn:
            # the pool is every row of the chunk
            cd = dist.reshape(dist.shape[0], -1)
            cp = b0 * bn + torch.arange(cd.shape[1], device=dev)[None, :]
        else:
            cd, cp = _block_reduce(dist, l, bins, bn, b0 * bn, n_loc)
        real = cd < bins
        hist_loc[qs] += torch.zeros_like(hist_loc[qs]).scatter_add_(
            1, torch.clamp(cd, max=bins - 1).long(), real.to(torch.int32))
        lid = cp.long().clamp(max=n_loc - 1)
        if perm_t is not None:
            lid = perm_t[lid]
        key = torch.where(real, cd.to(kdt) * stride + lid.to(kdt), sentinel)
        key = torch.topk(key, min(k_k, key.shape[1]), dim=1, largest=False,
                         sorted=True).values
        best[qs] = torch.topk(torch.cat([best[qs], key], dim=1), k_k, dim=1,
                              largest=False, sorted=True).values

    # (1)+(2): the candidate-pool histogram race, merged through one psum
    cum_g = torch.cumsum(psum(hist_loc), dim=-1, dtype=torch.int32)
    _, r_star, n_lt, n_emit = ops._radius_from_cum(cum_g, k_k)
    # (3): exclusive-scan slot bases from the tiny (Q, 2) per-shard counts
    base_lt, base_tie, _, _ = ops._slot_bases(hist_loc, r_star, n_lt, mesh,
                                              axes, n_shards, flat)

    # (4): this rank's best k_k in (dist, id) order into its disjoint
    # slots; the +1 offset makes 0 the "untouched" marker the psum keeps
    sd = (best // stride).to(torch.int32)
    si = torch.where(sd < bins, (best % stride).to(torch.int32) + ib, nt)
    lt = sd < r_star[:, None]
    tie = sd == r_star[:, None]
    rank_lt = torch.cumsum(lt, dim=-1, dtype=torch.int32) - 1
    rank_tie = torch.cumsum(tie, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(lt, base_lt[:, None] + rank_lt,
                       torch.where(tie, base_tie[:, None] + rank_tie, k_k))
    keep = slot < k_k
    slot = torch.where(keep, slot, 0).long()
    out = torch.zeros((2, Q, k_k), dtype=torch.int32, device=dev)
    out[0].scatter_add_(1, slot, torch.where(keep, sd + 1, 0))
    out[1].scatter_add_(1, slot, torch.where(keep, si + 1, 0))
    out = psum(out) - 1
    return ops._finalize_slots(out[0], out[1], n_emit, k, k_k, bins, nt)


# ---------------------------------------------------------------------------
# asymmetric top-k (non-binary stores)
# ---------------------------------------------------------------------------

def asymmetric_topk(v: torch.Tensor, x_packed: torch.Tensor, k: int, d: int,
                    *, recall_target: float = 1.0, bn: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k by MAXIMUM asymmetric score: the float query
    projection v (Q, d) against packed ±1 codes. The partial-reduce shape
    of ``approx_topk`` over f32 scores (per-block top-l, then the top-k of
    the pool, merged chunk by chunk; at l = bn every row is the pool).
    Returns (scores (Q, k) descending, ids (Q, k)); at recall_target=1.0
    the exact argmax ranking up to float ties."""
    N, W = x_packed.shape
    Q = v.shape[0]
    dev = v.device
    k_k = min(k, N)
    if bn is None:
        bn = tuning.approx_blocks(Q, N, W, backend=device_mod.backend_of(v))
    bn = max(min(int(bn), N), 1)
    n_blocks = -(-N // bn)
    l = max(min(l_for_recall(k_k, n_blocks, bn, recall_target), bn), 1)
    neg_inf = float("-inf")
    best_v = torch.full((Q, k_k), neg_inf, device=dev)
    best_i = torch.full((Q, k_k), N, dtype=torch.int32, device=dev)
    for qs, b0, b1 in _chunks(Q, n_blocks, bn, device_mod.backend_of(dev)):
        r0, r1 = b0 * bn, min(b1 * bn, N)
        nb = b1 - b0
        s = asymmetric_scores(v[qs], bit_planes(x_packed[r0:r1], d))
        if r1 - r0 < nb * bn:
            s = torch.nn.functional.pad(s, (0, nb * bn - (r1 - r0)),
                                        value=neg_inf)
        if l < bn:
            sv, si = torch.topk(s.reshape(-1, nb, bn), l, dim=-1,
                                sorted=True)
            blk = (b0 + torch.arange(nb, device=dev))[None, :, None]
            si = (blk * bn + si).reshape(sv.shape[0], -1)
            sv = sv.reshape(sv.shape[0], -1)
        else:
            sv = s
            si = r0 + torch.arange(s.shape[1], device=dev)[None, :]
        si = torch.where(sv > neg_inf, si, N).to(torch.int32)
        cand_v = torch.cat([best_v[qs], sv], dim=1)
        cand_i = torch.cat([best_i[qs], si], dim=1)
        tv, ti = torch.topk(cand_v, k_k, dim=1, sorted=True)
        best_v[qs], best_i[qs] = tv, torch.gather(cand_i, 1, ti)
    if k_k < k:
        best_v = torch.cat([best_v, torch.full((Q, k - k_k), neg_inf,
                                               device=dev)], dim=1)
        best_i = torch.cat([best_i, torch.full((Q, k - k_k), N,
                                               dtype=torch.int32,
                                               device=dev)], dim=1)
    return best_v, best_i


__all__ = ["approx_topk", "approx_topk_sharded", "asymmetric_scores", "asymmetric_topk",
           "bit_planes", "expected_recall", "hamming_scores_planes",
           "l_for_recall", "masked_approx_topk"]
