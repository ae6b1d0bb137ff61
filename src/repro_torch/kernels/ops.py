"""Public wrappers around the kernels: the two-pass select, the
materializing distance kernel and flash attention (port of the
single-device half of ``repro.kernels.ops``).

Shapes are padded to block multiples here so the kernels stay simple;
padded dataset rows are masked exactly inside the kernels by ``n_valid``.
Block shapes come from ``kernels/tuning.py`` for the backend of the
tensors' device unless explicitly overridden.

``hamming_topk`` is the engine's single-shot fused select: one K1 + one K2
launch over the WHOLE datastore for any N, with the pass-1 block-min
summary pruning pass-2 tiles that cannot hold a winner, and K1's per-run
histograms giving K2 the slot bases of each run of N tiles, so that pass 2
runs one CTA per query block and run.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.core.topk import sort_key_val
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.hamming import hamming_distance_kernel
from repro_torch.kernels.topk_select import (default_runs,
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
                  sub: int | None = None, backend: str | None = None):
    """The padded grid geometry ``hamming_topk`` will run under:
    (bq, bn, sub, q_pad, n_pad). ``lanes = max(bins, min(k, N))``.
    ``backend`` pins the heuristic to a named backend; None uses
    ``device.default_backend()``."""
    hbq, hbn, hsub = tuning.topk_blocks(Q, N, W, lanes, backend=backend)
    bq, bn, sub = bq or hbq, bn or hbn, sub or hsub
    sub = min(sub, bn)
    return bq, bn, sub, _round_up(Q, bq), _round_up(N, bn)


def _topk_blocked(q_packed: torch.Tensor, x_packed: torch.Tensor, lanes: int,
                  bq: int | None, bn: int | None, sub: int | None):
    """Shared pad-to-blocks prologue for the two-pass kernels, tiled for
    the backend of the tensors' device."""
    Q, W = q_packed.shape
    N = x_packed.shape[0]
    bq, bn, sub, q_pad, n_pad = topk_geometry(
        Q, N, W, lanes, bq, bn, sub, backend=device_mod.backend_of(q_packed))
    qp = _pad_rows(q_packed.to(torch.int32), q_pad)
    xp = _pad_rows(x_packed.to(torch.int32), n_pad)
    return qp, xp, bq, bn, sub


def hamming_hist(q_packed: torch.Tensor, x_packed: torch.Tensor, bins: int,
                 n_valid=None, bq: int | None = None, bn: int | None = None,
                 sub: int | None = None) -> torch.Tensor:
    """Fused distance+histogram: (Q, W) x (N, W) -> (Q, bins) int32.

    Pass 1 of the two-pass counting select. Rows with global id >= n_valid
    (default: all N rows valid) — including the block-alignment padding
    added here — are masked exactly inside the kernel."""
    Q, N = q_packed.shape[0], x_packed.shape[0]
    qp, xp, bq, bn, sub = _topk_blocked(q_packed, x_packed, bins, bq, bn, sub)
    nv = N if n_valid is None else int(n_valid)
    hist, _ = hamming_hist_kernel(qp, xp, bins, nv, bq=bq, bn=bn, sub=sub)
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
                 sub: int | None = None, return_stats: bool = False):
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
    qp, xp, bq, bn, sub = _topk_blocked(q_packed, x_packed,
                                        max(bins, k_k), bq, bn, sub)
    nv = N if n_valid is None else int(n_valid)

    # pass 1: the race -> per-query radius r*, the counts below it, the
    # block-min summary pass 2 prunes with, and each run's histogram
    runs = default_runs(qp.shape[0] // bq, xp.shape[0] // bn)
    hist, block_min, run_hist = hamming_hist_kernel(
        qp, xp, bins, nv, block_mask=block_mask, bq=bq, bn=bn, sub=sub,
        runs=runs)
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
                                       bq=bq, bn=bn, sub=sub,
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 512, bk: int = 512) -> torch.Tensor:
    """Causal flash-attention forward. q: (B, S, H, hd); k, v: (B, S, KV, hd)
    -> (B, S, H, hd). Pads S to a block multiple (future positions are
    causally invisible); the kernel reads the (B, H, S, hd) views through
    their strides, so the transposes copy nothing."""
    B, S, H, hd = q.shape
    s_pad = _round_up(S, max(bq, bk))
    if s_pad != S:
        pz = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, s_pad - S))
        q, k, v = pz(q), pz(k), pz(v)
    out = flash_attention_kernel(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bq=min(bq, s_pad), bk=min(bk, s_pad))
    return out.transpose(1, 2)[:, :S]
