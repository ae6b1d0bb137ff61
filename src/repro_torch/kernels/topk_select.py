"""The fused two-pass counting select (port of ``repro.kernels.topk_select``).

The (Q, N) distance matrix never leaves the kernels:

* **K1, pass 1** (``hamming_hist_kernel``, the "race"): XOR+popcount each
  (query block, data block) tile, accumulate the per-query distance
  histogram (Q, bins) and write the (Q/bq, N/bn) block-min summary — the
  minimum valid distance of each tile, ``bins`` for a disabled or
  all-padding tile.
* **K2, pass 2** (``hamming_emit_kernel``, the "reports"): recompute the
  distances of every tile that can hold a winner and scatter the winners
  into their output slots — dist < r* rows at ``slot_base`` + their running
  count, dist == r* ties at ``n_lt`` + theirs, both in global row order;
  slots >= k are dropped, ids get ``id_base`` added, untouched slots are 0.

Both take the valid-row count ``n_valid`` (rows with global id >= n_valid
are excluded exactly), a per-tile enable mask (a zero tile is outside the
candidate set) and the (bq, bn) geometry, which ``geometry`` chooses
unless the caller sets it.

**Runs.** The N tiles split into R runs of ``ceil(N/bn / R)`` consecutive
tiles (the last runs may be empty). K1 can also return the (Q, R, bins)
histogram of each run; ``run_bases`` turns it into each (query, run)'s
first below-r* and first tie slot, and K2 given those bases emits each run
on its own (one CTA per query block and run) into exactly the slots the
single-run emit fills: the arithmetic of ``repro``'s sharded hist_merge
with a run in place of a shard.

Each wrapper runs its CUDA kernel (``csrc/topk_select.cu``, built at first
use) for CUDA tensors and its plain PyTorch version for CPU tensors, and
counts its kernel launches in ``<wrapper>.launches``. The CUDA route is
a ``torch.library`` operator (``repro_torch::k1_hist``, ``::k2_emit``)
with a fake implementation, so tracing on fake tensors sees each call and
its output shapes (``launch/op_analysis.py`` charges it with
``hamming_hist_cost`` / ``hamming_emit_cost``) and launches nothing; a
launch is counted where it is made, on real tensors only. The plain versions
compute the same function tile for tile, one chunk of whole query blocks at
a time so the (chunk, N) distance tensor stays bounded; ``chip_smoke.py``
holds each kernel against its plain version on the card.

**Spans and counters** (``repro_torch.spans``, only while a torch
profiler records): each wrapper runs inside its span (``spans.K1``,
``spans.K2``: argument preparation, the operator's dispatch, the launch)
and counts the call's tiles, (Q/bq)·(N/bn), in ``spans.K1_TILES`` or
``spans.K2_TILES``. Each launch on the card also adds its tiles to
``spans.K1_TILES_CUDACORE`` or ``spans.K2_TILES_CUDACORE`` when it took
the CUDA-core kernels, and 0 when it took the tensor-core ones: the
library's ``topk_tc_route``, the rule both launchers dispatch by, says
which. K2's wrapper also passes ``spans.device_counter`` as the
operator's mutated optional ``pruned`` argument: each CTA of the kernel
ends by adding the tiles of its run that its block-min guard skipped,
with one atomic, and the plain version adds its count of skipped tiles.
With no profiler recording the counter is None, the kernel gets a null
pointer and nothing more is written or launched.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.core.binary import hamming_xor

_SOURCE = "topk_select.cu"
# plain versions: whole query blocks per chunk, so (chunk, N) stays under
# this many elements
_PLAIN_CHUNK_ELEMS = 1 << 27
# K1: threads per CTA ~ 256 (bq * rows in flight); runs: CTAs per launch
# ~ this many (query blocks x runs)
_HIST_THREADS = 256
_TARGET_CTAS = 2048
_SMEM_LIMIT = 232448
# geometry's rows, per backend: (budget of 4 * bq * step * lanes bytes,
# most data blocks before bn grows, bytes of a grown bn's code tile)
_GEOMETRY = {"gpu": (1 << 20, 1024, 2 << 20), "cpu": (4 << 20, 16, 1 << 20)}


def _check_geometry(Q: int, N: int, bq: int, bn: int):
    bq, bn = min(bq, Q), min(bn, N)
    if Q % bq or N % bn:
        raise ValueError(f"geometry does not tile: Q={Q} N={N} bq={bq} "
                         f"bn={bn}")
    return bq, bn


def _tile_mask(mask, shape, fill: int, dev) -> torch.Tensor:
    if mask is None:
        return torch.full(shape, fill, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, device=dev).to(torch.int32).contiguous()
    if tuple(mask.shape) != shape:
        raise ValueError(f"tile mask shape {tuple(mask.shape)} != {shape}")
    return mask


def _vec(v, Q: int, fill: int, dev) -> torch.Tensor:
    if v is None:
        return torch.full((Q,), fill, dtype=torch.int32, device=dev)
    return torch.as_tensor(v, device=dev).to(torch.int32).reshape(Q).contiguous()


def _codes(a: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.int32).contiguous()
    # kernels read rows of 4 or 8 words as 16-byte vectors
    if a.shape[1] % 4 == 0 and a.data_ptr() % 16:
        a = a.clone()
    return a


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _run_span(n_nblocks: int, runs: int) -> int:
    return -(-n_nblocks // runs)


def default_runs(n_qblocks: int, n_nblocks: int) -> int:
    """The run count K1 splits its tiles into when not told: about
    ``_TARGET_CTAS`` CTAs in all, and every run non-empty."""
    want = max(1, min(n_nblocks, -(-_TARGET_CTAS // max(n_qblocks, 1))))
    return max(1, _run_span(n_nblocks, _run_span(n_nblocks, want)))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _round_down(n: int, m: int) -> int:
    return max(m, n // m * m)


def geometry(Q: int, N: int, W: int, lanes: int, backend: str,
             bucket_rows: int = 0) -> tuple[int, int]:
    """(bq, bn): the query and data block K1 and K2 run a (Q, W) x (N, W)
    select under on ``backend`` ("gpu" or "cpu"; any other raises),
    ``lanes = max(bins, min(k, N))``.

    Both passes take the same geometry, so the block-min summary means the
    same tiles in both. bq is at most 32, so W = 2, 4, 8 and 32 take the
    tensor-core kernels (``topk_tc_route``). bn is a multiple of a rounding
    step that keeps 4 * bq * step * lanes bytes within the row's budget;
    it is at most 512 rows until the store holds more than the row's
    block count of tiles, then grows up to the row's code-tile bytes.
    With ``bucket_rows`` (a bucket-clustered layout, whose enable mask is
    per data block) bn is pulled down toward the bucket size. These are
    the tiles ``repro``'s rule gives the same shapes (tests hold them to
    it and pin the benchmark cells'): a change of the card's geometry is
    an edit of the ``"gpu"`` row here."""
    if backend not in _GEOMETRY:
        raise ValueError(f"no K1/K2 geometry for backend {backend!r} "
                         f"(have {sorted(_GEOMETRY)})")
    budget, max_blocks, tile_bytes = _GEOMETRY[backend]
    lanes = max(lanes, 1)
    bq = min(_round_up(Q, 8), 32)
    step = min(_round_down(budget // (4 * bq * lanes), 8), 256)
    while bq > 8 and 4 * bq * step * lanes > budget:
        bq = _round_down(bq // 2, 8)
    bn = min(_round_up(N, step), _round_down(512, step))
    if N > bn * max_blocks:
        want = _round_up(-(-N // max_blocks), step)
        bn = max(bn, min(want, _round_down(tile_bytes // (4 * max(W, 1)),
                                           step)))
    if bucket_rows > 0:
        bn = max(step, min(bn, _round_up(bucket_rows, step)))
    return bq, bn


def _run_of_row(N: int, bn: int, runs: int, dev) -> torch.Tensor:
    """(N,) int64: the run of each data row."""
    span = _run_span(N // bn, runs)
    return torch.arange(N, device=dev) // bn // span


# the C entry points' argument types: pointers (and the stream) as void*,
# everything else as int
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "topk_hist_launch": [_P] * 6 + [_I] * 8 + [_P],
    "topk_emit_launch": [_P] * 10 + [_I] * 10 + [_P],
    "topk_tc_route": [_I, _I],
}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _I
        lib._argtypes_set = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _count_cudacore(name: str, W: int, bq: int, tiles: int) -> None:
    """While a profiler records, add to the counter ``name`` the ``tiles``
    of a launch of W-word codes in bq-row query blocks if the launcher's
    route (``topk_tc_route``) gave it the CUDA-core kernels, else 0."""
    if spans.recording():
        spans.count(name, 0 if _lib().topk_tc_route(W, bq) else tiles)


def _query_chunks(nqb: int, bq: int, N: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(bq * N, 1))
    for qb0 in range(0, nqb, step):
        yield qb0, min(nqb, qb0 + step)


def _expand_tiles(tiles: torch.Tensor, bq: int, bn: int) -> torch.Tensor:
    """(nq, nn) per-tile flags -> (nq*bq, nn*bn) per-(query, row) flags."""
    return tiles.repeat_interleave(bq, dim=0).repeat_interleave(bn, dim=1)


# ---------------------------------------------------------------------------
# K1: pass 1, distance histogram + block-min summary (the "race")
# ---------------------------------------------------------------------------

def hamming_hist_plain(q: torch.Tensor, x: torch.Tensor, bins: int,
                       n_valid: int, en: torch.Tensor, bq: int, bn: int,
                       runs: int | None = None):
    """Plain PyTorch K1 on padded, tiled inputs -> (hist, block_min), and
    the (Q, runs, bins) per-run histograms third when ``runs`` is given."""
    Q, N = q.shape[0], x.shape[0]
    dev = q.device
    nqb, nnb = Q // bq, N // bn
    hist = torch.zeros((Q, bins), dtype=torch.int32, device=dev)
    bmin = torch.empty((nqb, nnb), dtype=torch.int32, device=dev)
    run_hist = (None if runs is None else
                torch.zeros((Q, runs * bins), dtype=torch.int32, device=dev))
    valid = torch.arange(N, device=dev) < n_valid
    enabled = en != 0
    for qb0, qb1 in _query_chunks(nqb, bq, N):
        rows = slice(qb0 * bq, qb1 * bq)
        dist = torch.clamp(hamming_xor(q[rows], x), max=bins - 1)
        counted = (_expand_tiles(enabled[qb0:qb1], bq, bn) & valid).to(
            torch.int32)
        hist[rows].scatter_add_(1, dist.long(), counted)
        if runs is not None:
            slot = _run_of_row(N, bn, runs, dev) * bins + dist
            run_hist[rows].scatter_add_(1, slot, counted)
        tile_min = torch.where(valid, dist, bins).reshape(
            qb1 - qb0, bq, nnb, bn).amin(dim=(1, 3))
        bmin[qb0:qb1] = torch.where(enabled[qb0:qb1], tile_min, bins)
    if runs is None:
        return hist, bmin
    return hist, bmin, run_hist.reshape(Q, runs, bins)


def hamming_hist_kernel(q_packed: torch.Tensor, x_packed: torch.Tensor,
                        bins: int, n_valid=None, block_mask=None,
                        bq: int = 64, bn: int = 1024,
                        runs: int | None = None):
    """q: (Q, W), x: (N, W) -> (hist (Q, bins) int32,
    block_min (Q/bq, N/bn) int32). Replaces ``hamming_hist_pallas``.

    Rows with global id >= n_valid (default N) are excluded from both
    outputs; ``block_mask`` (Q/bq, N/bn) disables tiles (None = all
    enabled). Q and N must be multiples of bq and bn. ``runs=R`` splits the
    tiles into R runs (module docstring) and returns, third, the (Q, R,
    bins) int32 histogram of each run, which sums to ``hist``. CUDA
    tensors go through the operator ``repro_torch::k1_hist``. Span
    ``spans.K1``; while a profiler records, the call adds its tiles to
    ``spans.K1_TILES``, and a launch adds them to
    ``spans.K1_TILES_CUDACORE`` if it took the CUDA-core kernels."""
    with spans.span(spans.K1):
        dev = _device_of(q_packed, x_packed)
        Q, W = q_packed.shape
        N = x_packed.shape[0]
        bq, bn = _check_geometry(Q, N, bq, bn)
        nv = N if n_valid is None else int(n_valid)
        en = _tile_mask(block_mask, (Q // bq, N // bn), 1, dev)
        nqb, nnb = Q // bq, N // bn
        if runs is not None and int(runs) < 1:
            raise ValueError(f"runs must be >= 1, got {runs}")
        spans.count(spans.K1_TILES, nqb * nnb)
        if dev.type == "cpu":
            return hamming_hist_plain(_codes(q_packed), _codes(x_packed),
                                      bins, nv, en, bq, bn,
                                      None if runs is None else int(runs))

        if bq > _HIST_THREADS * 4 or 4 * (bq * bins + 1) > _SMEM_LIMIT:
            raise ValueError(f"K1 takes bq <= 1024 and bq * bins <= 58111; "
                             f"got bq={bq} bins={bins}")
        if nqb > 65535:
            raise ValueError(f"K1 takes at most 65535 query blocks, got "
                             f"{nqb}")
        R = default_runs(nqb, nnb) if runs is None else int(runs)
        args = (q_packed, x_packed, en, nv, bins, bq, bn, R,
                runs is not None)
        hist, bmin, run_hist = _k1_op(*args)
        return (hist, bmin) if runs is None else (hist, bmin, run_hist)


@torch.library.custom_op("repro_torch::k1_hist", mutates_args=(),
                         device_types="cuda")
def _k1_op(q: torch.Tensor, x: torch.Tensor, en: torch.Tensor, n_valid: int,
           bins: int, bq: int, bn: int, runs: int,
           want_runs: bool) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K1's CUDA route as an operator that tracing sees (``_k1_cuda``)."""
    return _k1_cuda(q, x, en, n_valid, bins, bq, bn, runs, want_runs)


def _k1_cuda(q, x, en, n_valid, bins, bq, bn, runs, want_runs):
    """One K1 launch, counted: (hist, block_min, run_hist), the last (0,)
    unless ``want_runs``."""
    q32, x32 = _codes(q), _codes(x)
    Q, W = q32.shape
    N = x32.shape[0]
    hist = torch.zeros((Q, bins), dtype=torch.int32, device=q.device)
    bmin = torch.empty((Q // bq, N // bn), dtype=torch.int32,
                       device=q.device)
    run_hist = torch.empty((Q, runs, bins) if want_runs else (0,),
                           dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().topk_hist_launch(
        q32.data_ptr(), x32.data_ptr(), en.data_ptr(), hist.data_ptr(),
        bmin.data_ptr(), run_hist.data_ptr() if want_runs else 0,
        Q, N, W, n_valid, bins, bq, bn, runs, stream)
    _raise_on(err, "K1 (topk_hist_launch)")
    hamming_hist_kernel.launches += 1
    _count_cudacore(spans.K1_TILES_CUDACORE, W, bq, (Q // bq) * (N // bn))
    return hist, bmin, run_hist


@_k1_op.register_fake
def _k1_fake(q, x, en, n_valid, bins, bq, bn, runs, want_runs):
    Q, N = q.shape[0], x.shape[0]
    new = lambda *shape: q.new_empty(shape, dtype=torch.int32)
    return (new(Q, bins), new(Q // bq, N // bn),
            new(Q, runs, bins) if want_runs else new(0))


def hamming_hist_cost(q, x, en, n_valid, bins, bq, bn, runs,
                      want_runs) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one K1 call as ``repro``'s jaxpr analysis
    charges its ``pallas_call`` (a 2-D grid): the operands (n_valid, the
    tile mask, the int32 codes) and the first output (the histogram) once
    each, no FLOPs."""
    Q, W = q.shape
    N = x.shape[0]
    return 0.0, float(4 * (1 + en.numel() + Q * W + N * W + Q * bins))


hamming_hist_kernel.launches = 0


# ---------------------------------------------------------------------------
# K2: pass 2, in-order emit of the winners (the "reports")
# ---------------------------------------------------------------------------

def hamming_emit_plain(q: torch.Tensor, x: torch.Tensor, r_star, n_lt,
                       bins: int, k: int, n_valid: int, bm: torch.Tensor,
                       en: torch.Tensor, slot_base, id_base: int, bq: int,
                       bn: int, run_bases=None, pruned=None):
    """Plain PyTorch K2 on padded, tiled inputs -> (dists, ids) (Q, k).

    A winner's slot adds into the output, as the Pallas kernel's one-hot
    sum does; on consistent inputs (r*, n_lt and slot_base from the pass-1
    histogram) every slot has at most one winner. ``run_bases=(lt_base,
    tie_base)``, each (Q, R), numbers each run's winners from its own bases
    (``slot_base`` and ``n_lt`` are then not read); None is one run from
    ``slot_base`` and ``n_lt``. ``pruned`` (an int64 scalar, or None) gets
    the count of tiles the block-min guard skips added to it."""
    Q, N = q.shape[0], x.shape[0]
    dev = q.device
    nqb = Q // bq
    if run_bases is None:
        run_bases = (slot_base[:, None], n_lt[:, None])
    lt_base, tie_base = run_bases
    runs = lt_base.shape[1]
    col_run = _run_of_row(N, bn, runs, dev)
    # each run's first column, for the count of winners before it
    first = (torch.arange(runs, device=dev) * _run_span(N // bn, runs)
             * bn).clamp(max=N)
    out_d = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    out_i = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    gid = torch.arange(N, dtype=torch.int32, device=dev)
    valid = gid < n_valid
    max_r = r_star.reshape(nqb, bq).amax(dim=1)
    active_tiles = (en != 0) & (bm <= max_r[:, None])
    if pruned is not None:
        pruned += (~active_tiles).sum()

    def rank(flags, base):
        cum = torch.cumsum(flags, dim=1, dtype=torch.int32)
        before = torch.where(first > 0, cum[:, (first - 1).clamp(min=0)], 0)
        return (base - before)[:, col_run] + cum - 1

    for qb0, qb1 in _query_chunks(nqb, bq, N):
        rows = slice(qb0 * bq, qb1 * bq)
        dist = torch.clamp(hamming_xor(q[rows], x), max=bins - 1)
        active = _expand_tiles(active_tiles[qb0:qb1], bq, bn) & valid
        r = r_star[rows, None]
        is_lt = active & (dist < r)
        is_tie = active & (dist == r)
        slot = torch.where(is_lt, rank(is_lt, lt_base[rows]),
                           torch.where(is_tie, rank(is_tie, tie_base[rows]),
                                       k))
        qi, ri = torch.nonzero((slot >= 0) & (slot < k), as_tuple=True)
        s = slot[qi, ri].long()
        qi = qi + qb0 * bq
        out_d.index_put_((qi, s), dist[qi - qb0 * bq, ri], accumulate=True)
        out_i.index_put_((qi, s), ri.to(torch.int32) + id_base,
                         accumulate=True)
    return out_d, out_i


def hamming_emit_kernel(q_packed: torch.Tensor, x_packed: torch.Tensor,
                        r_star, n_lt, bins: int, k: int, n_valid=None,
                        block_min=None, block_mask=None, slot_base=None,
                        id_base=None, bq: int = 64, bn: int = 1024,
                        run_bases=None):
    """Emit the top-k winners given the pass-1 radius. Replaces
    ``hamming_emit_pallas``.

    q: (Q, W), x: (N, W); r_star/n_lt: (Q,) int32. ``block_min``: the
    (Q/bq, N/bn) pruning summary from K1 (None = every tile runs);
    ``block_mask``: the same enable mask pass 1 ran under (None = all
    enabled). ``slot_base`` (Q,) starts the below-r* counter (None =
    zeros); ``id_base`` is added to every emitted row id (None = 0).

    ``run_bases=(lt_base, tie_base)``, each (Q, R) int32 (from
    ``ops._run_bases``), splits the tiles into R runs (module docstring)
    and starts run j's below-r* and tie counters at column j; the kernel
    then runs one CTA per query block and run. None is one run that starts
    at ``slot_base`` and ``n_lt``.

    Returns (dists (Q, k), ids (Q, k)) int32, slot-ordered: dist < r* rows
    in index order from ``slot_base``, then r*-ties in index order from
    ``n_lt``; untouched slots are 0. CUDA tensors go through the operator
    ``repro_torch::k2_emit``.

    Span ``spans.K2``. While a profiler records, the call adds its tiles,
    (Q/bq)·(N/bn), to the counter ``spans.K2_TILES``, and the kernel (or
    the plain version) adds the tiles its block-min guard skipped to
    ``spans.device_counter``: ``spans.K2_TILES_PRUNED``, which equals
    ``ops.hamming_topk(return_stats=True)``'s ``blocks_skipped``; a launch
    adds its tiles to ``spans.K2_TILES_CUDACORE`` if it took the CUDA-core
    kernels. Otherwise the kernel gets a null counter and writes nothing
    more."""
    with spans.span(spans.K2):
        dev = _device_of(q_packed, x_packed)
        Q, W = q_packed.shape
        N = x_packed.shape[0]
        bq, bn = _check_geometry(Q, N, bq, bn)
        nv = N if n_valid is None else int(n_valid)
        ib = 0 if id_base is None else int(id_base)
        tiles = (Q // bq, N // bn)
        bm = _tile_mask(block_min, tiles, 0, dev)
        en = _tile_mask(block_mask, tiles, 1, dev)
        r = _vec(r_star, Q, 0, dev)
        nlt = _vec(n_lt, Q, 0, dev)
        sb = _vec(slot_base, Q, 0, dev)
        if run_bases is None:
            lt_base, tie_base = sb[:, None], nlt[:, None]
        else:
            lt_base, tie_base = (torch.as_tensor(b, device=dev)
                                 .to(torch.int32).contiguous()
                                 for b in run_bases)
            if (lt_base.dim() != 2 or lt_base.shape[0] != Q
                    or lt_base.shape != tie_base.shape
                    or lt_base.shape[1] < 1):
                raise ValueError(f"run_bases must be two (Q={Q}, R) arrays, "
                                 f"got {tuple(lt_base.shape)}, "
                                 f"{tuple(tie_base.shape)}")
        spans.count(spans.K2_TILES, tiles[0] * tiles[1])
        pruned = spans.device_counter(dev)
        if dev.type == "cpu":
            return hamming_emit_plain(_codes(q_packed), _codes(x_packed), r,
                                      nlt, bins, k, nv, bm, en, sb, ib, bq,
                                      bn, (lt_base, tie_base), pruned)

        if Q // bq > 65535:
            raise ValueError(f"K2 takes at most 65535 query blocks, got "
                             f"{Q // bq}")
        args = (q_packed, x_packed, en, bm, r, lt_base, tie_base, nv, ib,
                bins, k, bq, bn, pruned)
        return _k2_op(*args)


@torch.library.custom_op("repro_torch::k2_emit", mutates_args=("pruned",),
                         device_types="cuda")
def _k2_op(q: torch.Tensor, x: torch.Tensor, en: torch.Tensor,
           bm: torch.Tensor, r: torch.Tensor, lt_base: torch.Tensor,
           tie_base: torch.Tensor, n_valid: int, id_base: int, bins: int,
           k: int, bq: int, bn: int, pruned: Optional[torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's CUDA route as an operator that tracing sees (``_k2_cuda``);
    ``pruned``, an int64 scalar or None, is the counter it adds to. It has
    no default: the dispatcher drops a trailing argument equal to its
    default, and torch 2.11's version bump of a mutated argument then
    indexes past the end."""
    return _k2_cuda(q, x, en, bm, r, lt_base, tie_base, n_valid, id_base,
                    bins, k, bq, bn, pruned)


def _k2_cuda(q, x, en, bm, r, lt_base, tie_base, n_valid, id_base, bins,
             k, bq, bn, pruned):
    """One K2 launch, counted: (dists, ids). The kernel adds the tiles it
    skipped to ``pruned`` (int64) unless it is None (a null pointer)."""
    q32, x32 = _codes(q), _codes(x)
    Q, W = q32.shape
    N = x32.shape[0]
    out_d = torch.zeros((Q, k), dtype=torch.int32, device=q.device)
    out_i = torch.zeros((Q, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().topk_emit_launch(
        q32.data_ptr(), x32.data_ptr(), en.data_ptr(), bm.data_ptr(),
        r.data_ptr(), lt_base.data_ptr(), tie_base.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(),
        0 if pruned is None else pruned.data_ptr(), Q, N, W, n_valid,
        id_base, bins, k, bq, bn, lt_base.shape[1], stream)
    _raise_on(err, "K2 (topk_emit_launch)")
    hamming_emit_kernel.launches += 1
    _count_cudacore(spans.K2_TILES_CUDACORE, W, bq, (Q // bq) * (N // bn))
    return out_d, out_i


@_k2_op.register_fake
def _k2_fake(q, x, en, bm, r, lt_base, tie_base, n_valid, id_base, bins, k,
             bq, bn, pruned):
    Q = q.shape[0]
    return (q.new_empty((Q, k), dtype=torch.int32),
            q.new_empty((Q, k), dtype=torch.int32))


def hamming_emit_cost(q, x, en, bm, r, lt_base, tie_base, n_valid, id_base,
                      bins, k, bq, bn, pruned) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one K2 call as ``repro``'s jaxpr analysis
    charges its ``pallas_call`` (a 2-D grid): its operands (n_valid,
    id_base, the tile mask and block-min summary, the int32 codes, r*,
    n_lt and slot_base) and the first output (the (Q, k) distances) once
    each, no FLOPs. The run bases stand in for ``repro``'s (Q,) n_lt and
    slot_base, which is what it charges. A pruned-tile counter, which
    ``repro`` has not, adds its 8 bytes."""
    Q, W = q.shape
    N = x.shape[0]
    return 0.0, float(4 * (2 + en.numel() + bm.numel() + Q * W + N * W
                           + 3 * Q + Q * k)
                      + (0 if pruned is None else 8))


hamming_emit_kernel.launches = 0


def reset_launch_counts() -> None:
    hamming_hist_kernel.launches = 0
    hamming_emit_kernel.launches = 0
