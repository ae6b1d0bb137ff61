"""Public wrappers around the kernels: the two-pass select, the
materializing distance kernel and flash attention (port of the
single-device half of ``repro.kernels.ops``).

Shapes are padded to block multiples here so the kernels stay simple;
padded dataset rows are masked exactly inside the kernels by ``n_valid``.
Block shapes come from ``topk_select.geometry`` (K1/K2) and
``tuning.distance_blocks`` (K3) for the backend of the tensors' device
unless explicitly overridden.

``hamming_topk`` is the engine's single-shot fused select: one K1 + one K2
launch over the WHOLE datastore for any N, with the pass-1 block-min
summary pruning pass-2 tiles that cannot hold a winner, and K1's per-run
histograms giving K2 the slot bases of each run of N tiles, so that pass 2
runs one CTA per query block and run.

``hamming_topk_sharded`` is the same two-pass select across the ranks of a
``torch.distributed`` device mesh: each rank runs K1 and K2 once over its
own slice, and the paper's counters being additive, one reduction of the
(Q, bins) partial histograms gives ONE global radius per query; each rank
then emits its winners into disjoint slots of the global (Q, k) output.

**Collectives.** Every collective of the merge is built from
``all_reduce(SUM)``: a psum is one over each mesh axis's group in turn, an
all-gather reduces a zeroed (n_shards, ...) buffer in which each rank
wrote only its own row, and ``_tree_psum``'s rounds reduce within
``new_group`` subgroups of ``repro``'s rotation spans. Gloo takes CUDA
tensors for ``all_reduce`` alone (not for ``all_gather``, ``send`` or
``recv``), and NCCL puts one rank on one card, so built this way the same
code runs on gloo over CPU tensors, on gloo over CUDA tensors with several
ranks on one card, and on NCCL across cards. The sums are of integers, so
every grouping gives the same bits.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.core.topk import sort_key_val
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 refuse_grad)
from repro_torch.kernels.hamming import hamming_distance_kernel
from repro_torch.kernels.topk_select import (default_runs, geometry,
                                             hamming_emit_kernel,
                                             hamming_hist_kernel)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(a: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return a


def hamming_distance(q_packed: torch.Tensor, x_packed: torch.Tensor,
                     bq: int | None = None,
                     bn: int | None = None) -> torch.Tensor:
    """(Q, W) x (N, W) packed -> (Q, N) int32 through K3. Arbitrary Q/N:
    both are padded here to the tile, and the result sliced back."""
    Q, W = q_packed.shape
    N = x_packed.shape[0]
    if Q == 0 or N == 0:
        return torch.zeros((Q, N), dtype=torch.int32, device=q_packed.device)
    hbq, hbn = tuning.distance_blocks(Q, N, W,
                                      backend=device_mod.backend_of(q_packed))
    bq, bn = bq or hbq, bn or hbn
    qp = _pad_rows(q_packed.to(torch.int32), _round_up(Q, bq))
    xp = _pad_rows(x_packed.to(torch.int32), _round_up(N, bn))
    return hamming_distance_kernel(qp, xp, bq=bq, bn=bn)[:Q, :N]


def topk_geometry(Q: int, N: int, W: int, lanes: int,
                  bq: int | None = None, bn: int | None = None,
                  backend: str | None = None, bucket_rows: int = 0):
    """The padded grid geometry ``hamming_topk`` will run under:
    (bq, bn, q_pad, n_pad), from ``topk_select.geometry`` where ``bq`` or
    ``bn`` is not given. ``lanes = max(bins, min(k, N))``. ``backend``
    names the backend to tile for; None uses
    ``device.default_backend()``. ``bucket_rows`` > 0 pulls bn toward a
    bucket-clustered layout's bucket size."""
    hbq, hbn = geometry(Q, N, W, lanes,
                        backend or device_mod.default_backend(), bucket_rows)
    bq, bn = bq or hbq, bn or hbn
    return bq, bn, _round_up(Q, bq), _round_up(N, bn)


def _topk_blocked(q_packed: torch.Tensor, x_packed: torch.Tensor, lanes: int,
                  bq: int | None, bn: int | None):
    """Shared pad-to-blocks prologue for the two-pass kernels, tiled for
    the backend of the tensors' device."""
    Q, W = q_packed.shape
    N = x_packed.shape[0]
    bq, bn, q_pad, n_pad = topk_geometry(
        Q, N, W, lanes, bq, bn, backend=device_mod.backend_of(q_packed))
    qp = _pad_rows(q_packed.to(torch.int32), q_pad)
    xp = _pad_rows(x_packed.to(torch.int32), n_pad)
    return qp, xp, bq, bn


def hamming_hist(q_packed: torch.Tensor, x_packed: torch.Tensor, bins: int,
                 n_valid=None, bq: int | None = None,
                 bn: int | None = None) -> torch.Tensor:
    """Fused distance+histogram: (Q, W) x (N, W) -> (Q, bins) int32.

    Pass 1 of the two-pass counting select. Rows with global id >= n_valid
    (default: all N rows valid) — including the block-alignment padding
    added here — are masked exactly inside the kernel."""
    Q, N = q_packed.shape[0], x_packed.shape[0]
    qp, xp, bq, bn = _topk_blocked(q_packed, x_packed, bins, bq, bn)
    nv = N if n_valid is None else int(n_valid)
    hist, _ = hamming_hist_kernel(qp, xp, bins, nv, bq=bq, bn=bn)
    return hist[:Q]


def _radius_from_cum(cum: torch.Tensor, k_k: int):
    """The counting select's "finish line": from a cumulative histogram,
    the per-query effective k, k-th-smallest radius r*, strict-below count
    and emit count. r* is the first bin whose count reaches k_eff, i.e. the
    number of bins still below it (cum is nondecreasing)."""
    k_eff = torch.clamp(cum[:, -1], max=k_k)                         # (Q,)
    r_star = (cum < k_eff[:, None]).sum(dim=-1, dtype=torch.int32)
    at = lambda c, i: torch.gather(c, 1, i[:, None].long())[:, 0]
    n_lt = torch.where(r_star > 0, at(cum, torch.clamp(r_star - 1, min=0)),
                       0).to(torch.int32)
    n_emit = torch.minimum(at(cum, r_star), k_eff)
    return k_eff, r_star, n_lt, n_emit


def _run_bases(run_hist: torch.Tensor, r_star: torch.Tensor,
               n_lt: torch.Tensor, slot_base=None):
    """Each (query, run)'s first below-r* and first tie slot, from K1's
    (Q, R, bins) per-run histograms: exclusive scans over the runs of the
    counts below r* and at r*, from ``slot_base`` (None = 0) and ``n_lt``.
    A query with r* < 0 (a padded row, which emits nothing) gets
    meaningless bases. -> (lt_base, tie_base), each (Q, R) int32."""
    bins = run_hist.shape[2]
    r = r_star.to(torch.int64)
    lt = torch.where(torch.arange(bins, device=run_hist.device)
                     < r[:, None, None], run_hist, 0).sum(
                         dim=2, dtype=torch.int32)
    tie = torch.gather(run_hist, 2, r.clamp(0, bins - 1)[:, None, None]
                       .expand(-1, run_hist.shape[1], 1))[:, :, 0]
    sb = 0 if slot_base is None else slot_base[:, None]
    lt_base = sb + torch.cumsum(lt, dim=1, dtype=torch.int32) - lt
    tie_base = n_lt[:, None] + torch.cumsum(tie, dim=1, dtype=torch.int32) - tie
    return lt_base.to(torch.int32), tie_base.to(torch.int32)


def _finalize_slots(out_d: torch.Tensor, out_i: torch.Tensor,
                    n_emit: torch.Tensor, k: int, k_k: int, bins: int,
                    sentinel_id: int):
    """Slot-ordered emit output -> the select contract: untouched slots
    become (bins, sentinel_id), one stable O(k log k) sort per row orders
    the winners, columns beyond k_k pad with the same sentinels."""
    Q = out_d.shape[0]
    dev = out_d.device
    live = (torch.arange(k_k, dtype=torch.int32, device=dev)[None, :]
            < n_emit[:, None])
    out_d = torch.where(live, out_d, bins)
    out_i = torch.where(live, out_i, sentinel_id)
    out_d, out_i = sort_key_val(out_d, out_i)
    if k_k < k:
        out_d = torch.cat([out_d, torch.full((Q, k - k_k), bins,
                                             dtype=torch.int32, device=dev)], 1)
        out_i = torch.cat([out_i, torch.full((Q, k - k_k), sentinel_id,
                                             dtype=torch.int32, device=dev)], 1)
    return out_d, out_i


def hamming_topk(q_packed: torch.Tensor, x_packed: torch.Tensor, k: int,
                 bins: int, n_valid=None, block_mask=None,
                 bq: int | None = None, bn: int | None = None,
                 return_stats: bool = False):
    """Single-shot fused two-pass top-k over the WHOLE datastore:
    (Q, W) x (N, W) -> (dists (Q, k), ids (Q, k)) int32.

    Pass 1 histograms distances into [0, bins) (clamped at bins-1) and
    writes the block-min summary; pass 2 re-reads the codes and emits the
    winners, skipping every tile whose summary proves it holds no winner.
    Semantics match ``topk.counting_topk`` on the clamped distances:
    ascending, ties broken by index order, rows beyond min(k, n_valid)
    padded with (bins, N). Rows with global id >= n_valid are excluded.

    ``block_mask``: optional (q_pad//bq, n_pad//bn) int32 enable mask
    (geometry from ``topk_geometry``); a zero tile is outside the candidate
    set of its query block.

    ``return_stats=True`` additionally returns a dict: ``blocks_total``
    (int, tiles per pass), ``p1_blocks_skipped`` (tiles the mask excluded
    from pass 1), ``blocks_skipped`` (tiles pass 2 pruned: mask composed
    with the block-min guard) and ``block_min`` (the summary itself)."""
    Q, N = q_packed.shape[0], x_packed.shape[0]
    dev = q_packed.device
    k_k = min(k, N)
    if k_k == 0:
        out = (torch.full((Q, k), bins, dtype=torch.int32, device=dev),
               torch.full((Q, k), N, dtype=torch.int32, device=dev))
        if return_stats:
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return out + ({"blocks_total": 0, "blocks_skipped": zero,
                           "p1_blocks_skipped": zero,
                           "block_min": torch.zeros((0, 0), dtype=torch.int32,
                                                    device=dev)},)
        return out
    qp, xp, bq, bn = _topk_blocked(q_packed, x_packed, max(bins, k_k), bq,
                                   bn)
    nv = N if n_valid is None else int(n_valid)

    # pass 1: the race -> per-query radius r*, the counts below it, the
    # block-min summary pass 2 prunes with, and each run's histogram
    runs = default_runs(qp.shape[0] // bq, xp.shape[0] // bn)
    hist, block_min, run_hist = hamming_hist_kernel(
        qp, xp, bins, nv, block_mask=block_mask, bq=bq, bn=bn, runs=runs)
    cum = torch.cumsum(hist[:Q], dim=-1, dtype=torch.int32)
    _, r_star, n_lt, n_emit = _radius_from_cum(cum, k_k)

    # pass 2: the reports, each run from its own slot bases — padded query
    # rows get r*=-1 so they emit nothing
    q_pad = qp.shape[0] - Q
    r_p = torch.nn.functional.pad(r_star, (0, q_pad), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, q_pad))
    out_d, out_i = hamming_emit_kernel(qp, xp, r_p, nlt_p, bins, k_k, nv,
                                       block_min=block_min,
                                       block_mask=block_mask,
                                       bq=bq, bn=bn,
                                       run_bases=_run_bases(run_hist, r_p,
                                                            nlt_p))
    out_d, out_i = _finalize_slots(out_d[:Q], out_i[:Q], n_emit, k, k_k,
                                   bins, N)
    if return_stats:
        # mirror the kernels' guards: pass 1 skips mask-disabled tiles;
        # pass 2 skips a tile iff it is disabled OR its min valid distance
        # exceeds every r* in its query block
        enabled = (torch.ones_like(block_min) if block_mask is None
                   else torch.as_tensor(block_mask, device=dev)) != 0
        max_r_b = r_p.reshape(-1, bq).amax(dim=1)
        skipped = (~enabled) | (block_min > max_r_b[:, None])
        return out_d, out_i, {
            "blocks_total": int(block_min.numel()),
            "blocks_skipped": skipped.sum(dtype=torch.int32),
            "p1_blocks_skipped": (~enabled).sum(dtype=torch.int32),
            "block_min": block_min}
    return out_d, out_i


# ---------------------------------------------------------------------------
# the mesh and the collectives of the sharded select
# ---------------------------------------------------------------------------

def axis_size(mesh, a: str) -> int:
    """Size of the mesh axis named ``a`` (``repro``: ``mesh.shape[a]``)."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(a)))


def n_shards_of(mesh, axes) -> int:
    """Product of the sizes of ``axes``: the number of shards."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def flat_index(mesh, axes) -> int:
    """This rank's flat shard index over ``axes``, row-major as the mesh
    (``repro``: the same product over ``jax.lax.axis_index``). It is the
    order ``engine.shard_datastore`` slices rows in."""
    flat = 0
    for a in axes:
        flat = flat * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return flat


def _psum_copy(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


class _Psum(torch.autograd.Function):
    """psum under autograd: the backward is the psum of the cotangent over
    the same axes, ``lax.psum``'s transpose."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _psum_copy(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum_copy(g, ctx.mesh, ctx.axes), None, None


def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes``: ``all_reduce(SUM)`` over
    each axis's group in turn, on a copy; under autograd its backward is
    the same psum of the cotangent."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Psum.apply(x, mesh, tuple(axes))
    return _psum_copy(x, mesh, axes)


def _all_gather(x: torch.Tensor, mesh, axes, n_shards: int,
                flat: int) -> torch.Tensor:
    """(n_shards, *x.shape): every rank's ``x`` in flat-shard order, as the
    sum of zeroed buffers in which each rank wrote only its own row."""
    buf = x.new_zeros((n_shards, *x.shape))
    buf[flat] = x
    for a in axes:
        dist.all_reduce(buf, group=mesh.get_group(a))
    return buf


def _round_group(mesh, a: str, s: int, f: int):
    """This rank's subgroup for the ``_tree_psum`` round at stride ``s``
    and width ``f`` over axis ``a``: the ranks at axis positions
    {b + off + j*s : j < f}, the other coordinates fixed. ``new_group`` is
    collective over the whole world, so every rank creates every group of
    the round, in the same order; the groups are kept on the mesh."""
    groups = mesh.__dict__.setdefault("_tree_round_groups", {})
    key = (a, s, f)
    if key not in groups:
        dim = list(mesh.mesh_dim_names).index(a)
        size = axis_size(mesh, a)
        lines = mesh.mesh.movedim(dim, -1).reshape(-1, size).tolist()
        me = dist.get_rank()
        mine = None
        for line in lines:
            for b in range(0, size, s * f):
                for off in range(s):
                    members = [line[b + off + j * s] for j in range(f)]
                    group = dist.new_group(members)
                    if me in members:
                        mine = group
        groups[key] = mine
    return groups[key]


def _tree_psum(x: torch.Tensor, mesh, axes, fanout: int) -> torch.Tensor:
    """Hierarchical all-reduce: a plain psum over the trailing (intra-host)
    axes, then rounds of ``fanout``-wide group sums over the leading axis.
    Integer addition is associative and commutative, so the result is
    bit-identical to ``_psum(x, mesh, axes)``.

    Round structure over the leading axis (size S), as ``repro``'s: at
    stride s (starting 1), the positions {b + off + j*s : j < f} form one
    group and sum within it, so after the round every position holds the
    sum of its span of s*f consecutive positions. Rounds run while s*f
    divides S; a final group round over the surviving S//s spans closes
    any non-power-of-``fanout`` remainder. ``repro`` sums a group by f-1
    rotation ``ppermute``s; here a group is a ``new_group`` subgroup and
    its sum one ``all_reduce`` — the same sums."""
    axes = tuple(axes)
    x = _psum(x, mesh, axes[1:])
    a = axes[0]
    size = axis_size(mesh, a)

    def group_round(x, s, f):
        dist.all_reduce(x, group=_round_group(mesh, a, s, f))
        return x

    s = 1
    while s * fanout <= size and size % (s * fanout) == 0:
        x = group_round(x, s, fanout)
        s *= fanout
    if s < size:
        x = group_round(x, s, size // s)
    return x


def _shard_rows(mesh, axes, n_shards: int, n_loc: int, n_valid, id_base,
                n_total, participate, dev):
    """(flat index, valid rows, id base, valid total) of this rank, as
    ints. ``participate`` zeroes a dead shard's rows; with no ``n_valid``
    the (masked) counts are replicated and need no gather, else the valid
    counts are all-gathered unless ``id_base`` and ``n_total`` are given
    (they must then account for the mask)."""
    flat = flat_index(mesh, axes)
    part = ([1] * n_shards if participate is None else
            [int(v) for v in torch.as_tensor(participate).reshape(
                n_shards).tolist()])
    if n_valid is None:
        nv_all = [n_loc * p for p in part]
        nv = nv_all[flat]
    else:
        nv = int(n_valid) * part[flat]
        nv_all = None
        if id_base is None or n_total is None:
            nv_all = _all_gather(torch.tensor(nv, dtype=torch.int64,
                                              device=dev), mesh, axes,
                                 n_shards, flat).tolist()
    ib = sum(nv_all[:flat]) if id_base is None else id_base
    nt = sum(nv_all) if n_total is None else n_total
    return flat, nv, int(ib), int(nt)


def _slot_bases(hist_loc: torch.Tensor, r_star: torch.Tensor,
                n_lt: torch.Tensor, mesh, axes, n_shards: int, flat: int):
    """This rank's first below-r* and first tie slot: the exclusive scans,
    over the shards before it, of each shard's below-r* and at-r* counts
    (from its LOCAL histogram), all-gathered as (n_shards, Q, 2). Returns
    (base_lt, base_tie, l_lt, l_tie), each (Q,) int32."""
    at = lambda c, i: torch.gather(c, 1, i[:, None].long())[:, 0]
    cum_l = torch.cumsum(hist_loc, dim=-1, dtype=torch.int32)
    l_lt = torch.where(r_star > 0, at(cum_l, torch.clamp(r_star - 1, min=0)),
                       0).to(torch.int32)
    l_tie = at(hist_loc, r_star)
    g_counts = _all_gather(torch.stack([l_lt, l_tie], dim=-1), mesh, axes,
                           n_shards, flat)
    base_lt = g_counts[:flat, :, 0].sum(dim=0, dtype=torch.int32)
    base_tie = n_lt + g_counts[:flat, :, 1].sum(dim=0, dtype=torch.int32)
    return base_lt, base_tie.to(torch.int32), l_lt, l_tie


def hamming_topk_sharded(q_packed: torch.Tensor, x_local: torch.Tensor,
                         k: int, bins: int, axis_names, *, mesh,
                         n_shards: int, n_valid=None, id_base=None,
                         n_total=None, perm=None, block_mask=None,
                         participate=None, tree_fanout: int = 0,
                         bq: int | None = None, bn: int | None = None,
                         emit: str = "split",
                         mark: Optional[Callable[[str], None]] = None):
    """Distributed counting select — the sharded fused top-k WITHOUT a
    concat/sort merge. Every rank of ``mesh`` calls it (SPMD); collectives
    run over ``axis_names`` (``n_shards`` = product of their sizes).

    q: (Q, W) replicated; x_local: (n_loc, W), this rank's slice, on the
    rank's device. The result (dists (Q, k), ids (Q, k)) is replicated and
    bit-identical to ``hamming_topk`` over the concatenation of every
    shard's valid rows (under ``perm`` the DISTANCES keep that guarantee
    but ties at the r* cut are picked in layout-position order):

    1. each rank runs K1 over its slice — its (Q, bins) histogram is a
       PARTIAL histogram of the global race (counters are additive);
    2. one psum merges them; the global r*, below-count n_lt and emit
       count derive exactly as in the single-device select;
    3. each rank derives its below-r*/tie counts from its LOCAL histogram;
       one tiny (Q, 2)-per-shard all-gather turns them into exclusive-scan
       slot bases, so every rank owns a disjoint slice of the global
       (Q, k) slot space, in global index order;
    4. each rank runs K2 over its slice with those bases and ``id_base``
       (split over runs of N tiles, as ``hamming_topk`` does, each run's
       bases from K1's per-run histograms plus the shard's; ``emit=
       "single"`` runs it as one run from the shard's bases), and a final
       psum assembles the disjoint slots.

    Cross-rank traffic is O(Q·bins) histogram counts + O(Q·n_shards) base
    counts + the O(Q·k) output — never O(n_shards·Q·k) candidates.

    ``n_valid``: this rank's valid-row count (an int; rows beyond it are
    padding). ``id_base``/``n_total``: this rank's exclusive prefix of
    valid rows and the global valid total, as ints — derived through an
    all-gather of the counts when None (even shards need neither).
    ``perm``: (n_loc,) local layout permutation (``layout.local_sort``);
    winners are emitted as layout positions and mapped back to ids on the
    slots this rank owns. ``block_mask``: this rank's (Q_pad/bq,
    n_loc_pad/bn) enable mask.

    ``participate``: optional (n_shards,) replicated 0/1 mask in flat-shard
    order. A shard with participate == 0 contributes no rows: its n_valid
    is zeroed, and id bases / n_total derive from the exclusive scan of the
    MASKED counts — on the host, since the mask is replicated — so ids
    renumber exactly as a store rebuilt from only the surviving rows. The
    result is bit-identical to ``hamming_topk`` over that store (the
    all-dead n_total == 0 edge included).

    ``tree_fanout``: 0 reduces histograms and outputs with one flat psum
    (strategy "hist_merge"); >= 2 uses ``_tree_psum`` (strategy
    "hist_tree") — bit-identical results. ``mark``: called with each
    phase's name as it starts ("k1", "hist_reduce", "counts", "k2",
    "out_reduce") and "end" after the last, for timing."""
    if emit not in ("split", "single"):
        raise ValueError(f"emit={emit!r} (split|single)")
    mark = mark or (lambda _phase: None)
    axes = tuple(axis_names)
    Q = q_packed.shape[0]
    n_loc = x_local.shape[0]
    dev = q_packed.device
    k_k = min(k, n_shards * n_loc)
    if k_k == 0:
        return (torch.full((Q, k), bins, dtype=torch.int32, device=dev),
                torch.full((Q, k), 0, dtype=torch.int32, device=dev))

    flat, nv, ib, nt = _shard_rows(mesh, axes, n_shards, n_loc, n_valid,
                                   id_base, n_total, participate, dev)
    psum = ((lambda v: _tree_psum(v, mesh, axes, tree_fanout))
            if tree_fanout >= 2 else (lambda v: _psum(v, mesh, axes)))

    qp, xp, bq, bn = _topk_blocked(q_packed, x_local, max(bins, k_k), bq,
                                   bn)

    # pass 1 locally, then merge the partial histograms: ONE global race
    mark("k1")
    runs = (default_runs(qp.shape[0] // bq, xp.shape[0] // bn)
            if emit == "split" else None)
    out1 = hamming_hist_kernel(qp, xp, bins, nv, block_mask=block_mask,
                               bq=bq, bn=bn, runs=runs)
    hist, block_min = out1[0], out1[1]
    hist_loc = hist[:Q]
    mark("hist_reduce")
    hist_glob = psum(hist_loc)
    cum_g = torch.cumsum(hist_glob, dim=-1, dtype=torch.int32)
    _, r_star, n_lt, n_emit = _radius_from_cum(cum_g, k_k)

    # this rank's below-r*/tie counts from its LOCAL histogram; exclusive
    # scan over the shard order = global-index-order slot bases
    mark("counts")
    base_lt, base_tie, l_lt, l_tie = _slot_bases(hist_loc, r_star, n_lt,
                                                 mesh, axes, n_shards, flat)

    # pass 2 locally: this rank's winners go straight into its disjoint
    # global slots (padded query rows carry r* = -1: no emission)
    mark("k2")
    pad = qp.shape[0] - Q
    r_p = torch.nn.functional.pad(r_star, (0, pad), value=-1)
    sb_p = torch.nn.functional.pad(base_lt, (0, pad))
    tb_p = torch.nn.functional.pad(base_tie, (0, pad))
    od, oi = hamming_emit_kernel(
        qp, xp, r_p, tb_p, bins, k_k, nv, block_min=block_min,
        block_mask=block_mask, slot_base=sb_p,
        id_base=None if perm is not None else ib, bq=bq, bn=bn,
        run_bases=(None if runs is None else
                   _run_bases(out1[2], r_p, tb_p, slot_base=sb_p)))
    od, oi = od[:Q], oi[:Q]
    if perm is not None:
        # winners were emitted as layout positions: map them back to local
        # ids on the slots THIS rank owns, zero elsewhere, so the psum
        # below still assembles disjoint ranges
        iota = torch.arange(k_k, dtype=torch.int32, device=dev)[None, :]
        owned = (((iota >= base_lt[:, None])
                  & (iota < (base_lt + l_lt)[:, None]))
                 | ((iota >= base_tie[:, None])
                    & (iota < (base_tie + l_tie)[:, None])))
        perm = torch.as_tensor(perm, device=dev).to(torch.int32)
        mapped = perm[torch.clamp(oi, max=n_loc - 1).long()] + ib
        oi = torch.where(owned, mapped, 0)
        od = torch.where(owned, od, 0)

    # one reduction assembles both outputs' disjoint slots
    mark("out_reduce")
    out = psum(torch.stack([od, oi]))
    mark("end")

    # untouched slots -> (bins, n_total) sentinels, one O(k log k) sort
    return _finalize_slots(out[0], out[1], n_emit, k, k_k, bins, nt)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 512, bk: int = 512) -> torch.Tensor:
    """Causal flash-attention forward. q: (B, S, H, hd); k, v: (B, S, KV, hd)
    -> (B, S, H, hd). Pads S to a block multiple (future positions are
    causally invisible); the kernel reads the (B, H, S, hd) views through
    their strides, so the transposes copy nothing. Forward only: raises
    when gradients are on and an input requires them."""
    refuse_grad(q, k, v)
    B, S, H, hd = q.shape
    s_pad = _round_up(S, max(bq, bk))
    if s_pad != S:
        pz = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, s_pad - S))
        q, k, v = pz(q), pz(k), pz(v)
    out = flash_attention_kernel(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bq=min(bq, s_pad), bk=min(bk, s_pad))
    return out.transpose(1, 2)[:, :S]
