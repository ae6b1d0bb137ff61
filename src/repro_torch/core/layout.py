"""Layout-aware datastore (port of ``repro.core.layout`` up to the mutable
arena): bucket-clustered physical reordering of the packed codes, and the
translation from probed index buckets to the fused kernels' per-(query
block, data block) enable mask.

Physically reordering the codes so that similar codes share grid tiles lets
a full fused scan prune even on uniform data: each tile then holds one
bucket's worth of mutually-near codes, so most tiles' min distance to a
query block clears the block-min bound. A :class:`BucketLayout` carries the
reordered codes plus the permutation and its inverse, so every search path
still returns ORIGINAL ids; ties at equal distance break by layout
position, not original id.

Masking semantics: a disabled tile is outside the candidate set. The mask
granularity is the grid tile, so probed buckets are rounded OUTWARD to
tile boundaries — the masked candidate set is a superset of the probed
buckets, and queries in one query block share the union of their probes.
The mask therefore depends on (bq, bn): the planner's geometry for the
tensors' backend unless given.

The mutable face of a layout, the :class:`Arena` (bucket regions with
reserved slack for online appends, core/mutable.py), is host numpy, as in
``repro``: it is what mutations touch, never what the kernels stream.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod, spans
from repro_torch.core import binary


class BucketLayout(NamedTuple):
    """Bucket-contiguous physical layout of a packed datastore.

    ``codes[pos] == original_codes[perm[pos]]``; bucket ``b`` occupies the
    contiguous row range ``[starts[b], starts[b+1])`` of ``codes``.
    """

    codes: torch.Tensor     # (N, W) int32, reordered bucket-contiguous
    perm: torch.Tensor      # (N,) int32: perm[pos] = original id
    inv: torch.Tensor       # (N,) int32: inv[original id] = pos
    starts: torch.Tensor    # (B+1,) int32 bucket offsets into codes

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.starts.shape[0] - 1

    @property
    def mean_bucket_rows(self) -> int:
        return max(1, self.n // max(self.n_buckets, 1))


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """O(N) scatter inverse — ``inv[perm[pos]] = pos``."""
    n = perm.shape[0]
    inv = torch.zeros((n,), dtype=torch.int32, device=perm.device)
    inv[perm.long()] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return inv


def reorder_by_assignment(codes: torch.Tensor, assign: torch.Tensor,
                          n_buckets: int) -> BucketLayout:
    """Physically cluster ``codes`` by bucket id. assign: (N,) int in
    [0, n_buckets). Stable: within a bucket, original id order survives."""
    assign = torch.as_tensor(assign, device=codes.device).to(torch.int64)
    perm = torch.argsort(assign, stable=True).to(torch.int32)
    inv = invert_permutation(perm)
    counts = torch.bincount(assign, minlength=n_buckets)[:n_buckets]
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=codes.device),
                        torch.cumsum(counts, 0).to(torch.int32)])
    return BucketLayout(codes=codes[perm.long()], perm=perm, inv=inv,
                        starts=starts)


# bytes of the temporaries one chunk of rows may take while the prefix
# key is built: while the bits are counted, two (rows, 4W) uint8 bit
# planes and the int64 copy of one that the sum makes on the card; while
# the key bits are gathered, three (rows, bits) int32
_CHUNK_BYTES = 256 << 20


def _row_chunks(codes: torch.Tensor, row_bytes: int):
    """Consecutive row slices of ``codes``, each of at most
    ``_CHUNK_BYTES // row_bytes`` rows."""
    step = max(1, _CHUNK_BYTES // max(row_bytes, 1))
    for r0 in range(0, codes.shape[0], step):
        yield codes[r0:r0 + step]


def _bit_counts(codes: torch.Tensor, d: int) -> torch.Tensor:
    """(d,) int64: the ones of each bit position over all rows, counted
    exactly a chunk of rows at a time, from the codes' bytes: byte k of a
    row holds bits 8k..8k+7 (little-endian words), and one pass counts
    bit b of every byte."""
    w = codes.shape[1]
    counts = torch.zeros((4 * w, 8), dtype=torch.int64, device=codes.device)
    for chunk in _row_chunks(codes, 40 * w):
        by = chunk.to(torch.int32).contiguous().view(torch.uint8)
        for b in range(8):
            counts[:, b] += ((by >> b) & 1).sum(dim=0, dtype=torch.int64)
    return counts.reshape(-1)[:d]


def _prefix_key(codes: torch.Tensor, words: torch.Tensor,
                shifts: torch.Tensor) -> torch.Tensor:
    """(N,) int32 key of each packed row: bit j is bit ``shifts[j]`` of
    word ``words[j]`` ((bits,) int64 and int32 on the codes' device),
    gathered straight from the packed words, never unpacking them."""
    dev = codes.device
    weights = 1 << torch.arange(words.shape[0], dtype=torch.int32, device=dev)
    key = torch.empty((codes.shape[0],), dtype=torch.int32, device=dev)
    r0 = 0
    for chunk in _row_chunks(codes, 12 * max(words.shape[0], 1)):
        sel = (chunk.to(torch.int32)[:, words] >> shifts) & 1
        key[r0:r0 + chunk.shape[0]] = (sel * weights).sum(dim=-1,
                                                          dtype=torch.int32)
        r0 += chunk.shape[0]
    return key


def hamming_prefix_assign(codes: torch.Tensor, d: int, bits: int,
                          positions: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure-Hamming bucketing — no float vectors required.

    Picks the ``bits`` most *balanced* bit positions (empirical mean
    closest to 1/2) and groups codes by that key. The means are exact
    integer counts times the f32 reciprocal of N — how ``jnp.mean``
    computes them on XLA's CPU backend — so equal and near-equal means
    order identically in both packages and ``perm`` agrees bit-for-bit.
    The store is never unpacked whole: the counts and the key are built a
    chunk of rows at a time (``_CHUNK_BYTES``).

    Returns (assign (N,) int32 in [0, 2^bits), positions (bits,) int32)."""
    if positions is None:
        n = max(codes.shape[0], 1)  # no rows: every mean ties, as NaN do
        recip = torch.tensor(np.float32(1.0) / np.float32(n),
                             dtype=torch.float32, device=codes.device)
        means = _bit_counts(codes, d).to(torch.float32) * recip
        positions = torch.argsort(torch.abs(means - 0.5),
                                  stable=True)[:bits].to(torch.int32)
    # the positions' words and shifts are worked out on the host: set-up
    # then loads no kernel module that the store and the reorder do not
    # load anyway (a first use costs tens of ms on the card)
    pos = torch.as_tensor(positions).tolist()
    words = torch.tensor([p // binary.WORD for p in pos], dtype=torch.int64,
                         device=codes.device)
    shifts = torch.tensor([p % binary.WORD for p in pos], dtype=torch.int32,
                          device=codes.device)
    return _prefix_key(codes, words, shifts), positions


def default_bits(n: int) -> int:
    """Heuristic key width for the Hamming fallback: ~256 rows per bucket,
    clamped to [1, 12]."""
    return max(1, min(12, int(np.log2(max(n // 256, 2)))))


def build_layout(codes: torch.Tensor, d: int, n_buckets: int | None = None,
                 assign: torch.Tensor | None = None) -> BucketLayout:
    """Build a bucket-clustered layout. With ``assign`` (e.g. k-means/IVF
    cluster ids) the reorder follows the index's own buckets (``n_buckets``
    defaults to max(assign) + 1); without, the pure-Hamming prefix fallback
    buckets by LSH key. Runs on the codes' device."""
    if assign is None:
        bits = (n_buckets - 1).bit_length() if n_buckets else (
            default_bits(codes.shape[0]))
        assign, _ = hamming_prefix_assign(codes, d, bits)
        n_buckets = 1 << bits
    else:
        assign = torch.as_tensor(assign, device=codes.device)
        hi = int(assign.max()) + 1
        n_buckets = hi if n_buckets is None else n_buckets
        # an out-of-range bucket id would fall off `starts` and its rows
        # would silently vanish from every masked probe — refuse instead
        if hi > n_buckets:
            raise ValueError(f"assign ids reach {hi - 1} >= {n_buckets}")
        if int(assign.min()) < 0:
            raise ValueError("negative bucket id")
    return reorder_by_assignment(codes, assign, n_buckets)


def local_sort(codes: torch.Tensor, d: int, bits: int | None = None,
               n_valid=None):
    """Reorder by ``bits`` evenly spaced code bits (static positions) and
    stable-sort. Returns (codes_sorted, perm) with perm[pos] = local id.

    ``n_valid``: rows at local id >= n_valid are padding — their key is
    forced past every real key, so they stay at positions [n_valid, n)."""
    n = codes.shape[0]
    bits = bits if bits is not None else default_bits(n)
    bits = max(1, min(bits, d))
    pos = torch.arange(bits, dtype=torch.int64,
                       device=codes.device) * (d // bits)
    key = _prefix_key(codes, pos // binary.WORD,
                      (pos % binary.WORD).to(torch.int32))
    if n_valid is not None:
        key = torch.where(torch.arange(n, device=codes.device) < int(n_valid),
                          key, 1 << 30)
    perm = torch.argsort(key, stable=True).to(torch.int32)
    return codes[perm.long()], perm


def to_original_ids(perm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Map layout positions to original ids through ``perm``; sentinel rows
    (position >= N) pass through unchanged. Span ``spans.ORIGINAL_IDS``."""
    with spans.span(spans.ORIGINAL_IDS):
        n = perm.shape[0]
        return torch.where(ids < n, perm[torch.clamp(ids, max=n - 1).long()],
                           ids)


def original_ids(layout: BucketLayout, dists: torch.Tensor, ids: torch.Tensor,
                 d: int) -> torch.Tensor:
    """Map kernel-space positions back to original ids; sentinel slots
    (dist > d or position >= N) become -1."""
    real = (ids < layout.n) & (dists <= d)
    return torch.where(real, to_original_ids(layout.perm, ids), -1)


# ---------------------------------------------------------------------------
# probed buckets -> grid enable mask
# ---------------------------------------------------------------------------

def _blocks_to_tiles(qmask: torch.Tensor, bq: int, n_qblocks: int
                     ) -> torch.Tensor:
    """(Q, n_nblocks) per-query flags -> (n_qblocks, n_nblocks) int32, a
    tile enabled iff any query of its block enables it (padding rows
    enable nothing)."""
    q, n_nblocks = qmask.shape
    qmask = torch.nn.functional.pad(qmask, (0, 0, 0, n_qblocks * bq - q))
    return qmask.reshape(n_qblocks, bq, n_nblocks).any(dim=1).to(torch.int32)


def probe_block_mask(layout: BucketLayout, probe: torch.Tensor, bq: int,
                     bn: int, n_qblocks: int, n_nblocks: int) -> torch.Tensor:
    """Per-query probed bucket ids (Q, P) -> the kernels' enable mask
    (n_qblocks, n_nblocks) int32. Bucket ranges round OUTWARD to block
    boundaries; empty buckets enable nothing. An interval scatter (+1 at
    the first block, -1 past the last) and a running sum, instead of a
    (Q, P, n_nblocks) broadcast."""
    probe = probe.to(layout.starts.device).long()
    q = probe.shape[0]
    lo = layout.starts[probe].long()                       # (Q, P)
    hi = layout.starts[probe + 1].long()                   # exclusive
    first = lo // bn
    last = torch.maximum(hi - 1, lo) // bn                 # inclusive
    live = (hi > lo).to(torch.int32)                       # empty -> no-op
    rows = torch.arange(q, device=probe.device)[:, None].expand_as(first)
    inc = torch.zeros((q, n_nblocks + 1), dtype=torch.int32,
                      device=probe.device)
    # only an empty bucket can point past the last column; it adds 0
    inc.index_put_((rows, torch.clamp(first, max=n_nblocks)), live,
                   accumulate=True)
    inc.index_put_((rows, torch.clamp(last + 1, max=n_nblocks)), -live,
                   accumulate=True)
    qmask = torch.cumsum(inc[:, :n_nblocks], dim=1) > 0
    return _blocks_to_tiles(qmask, bq, n_qblocks)


def position_block_mask(layout: BucketLayout, cand: torch.Tensor, bq: int,
                        bn: int, n_qblocks: int, n_nblocks: int
                        ) -> torch.Tensor:
    """Enable mask from explicit candidate ids (Q, C), ORIGINAL ids, -1
    padded (multi-table indexes whose extra tables cannot all be
    layout-contiguous): each candidate enables the data block holding its
    reordered position."""
    return position_block_mask_from_inv(layout.inv, cand, bq, bn,
                                        n_qblocks, n_nblocks)


def position_block_mask_from_inv(inv: torch.Tensor, cand: torch.Tensor,
                                 bq: int, bn: int, n_qblocks: int,
                                 n_nblocks: int) -> torch.Tensor:
    """The id->position mask body, keyed by a bare inverse permutation."""
    cand = cand.to(inv.device).long()
    pos = inv[torch.clamp(cand, min=0)].long()             # (Q, C)
    blk = torch.where(cand >= 0, pos // bn, n_nblocks)     # pad -> dropped
    qmask = torch.zeros((cand.shape[0], n_nblocks + 1), dtype=torch.bool,
                        device=inv.device)
    qmask.scatter_(1, blk, True)
    return _blocks_to_tiles(qmask[:, :n_nblocks], bq, n_qblocks)


# ---------------------------------------------------------------------------
# the index-driven fused select
# ---------------------------------------------------------------------------

def _enable_mask(layout: BucketLayout, Q: int, W: int, k: int, d: int,
                 probe=None, cand_ids=None, bq=None, bn=None, backend=None):
    """The geometry ``masked_topk`` runs under and its enable mask:
    (mask or None, bq, bn). ``bn`` defaults to ``topk_select.geometry``'s
    for the mean bucket size when there is a probe."""
    from repro_torch.kernels import ops

    n = layout.n
    lanes = max(d + 1, min(k, n))
    probed = probe is not None or cand_ids is not None
    bq, bn, q_pad, n_pad = ops.topk_geometry(
        Q, n, W, lanes, bq, bn, backend=backend,
        bucket_rows=layout.mean_bucket_rows if probed else 0)
    n_qblocks, n_nblocks = q_pad // bq, n_pad // bn
    mask = None
    if probe is not None:
        mask = probe_block_mask(layout, probe, bq, bn, n_qblocks, n_nblocks)
    if cand_ids is not None:
        pmask = position_block_mask(layout, cand_ids, bq, bn, n_qblocks,
                                    n_nblocks)
        mask = pmask if mask is None else torch.maximum(mask, pmask)
    return mask, bq, bn


def masked_topk(layout: BucketLayout, q_packed: torch.Tensor, k: int, d: int,
                probe: torch.Tensor | None = None,
                cand_ids: torch.Tensor | None = None,
                bq: int | None = None, bn: int | None = None,
                return_stats: bool = False):
    """Index-probed top-k straight through the fused kernel pair (K1 + K2).

    ``probe`` ((Q, P) bucket ids) and/or ``cand_ids`` ((Q, C) original
    ids, -1 padded) select the candidate set (both: the union);
    ``None``/``None`` is an unmasked full scan of the reordered codes.

    Returns (dists, ids[, stats]): (Q, k) ascending, ORIGINAL ids, -1 in
    sentinel slots, over exactly the rows the mask enables. Block sizes
    default to the geometry of ``q_packed``'s backend."""
    from repro_torch.kernels import ops

    Q, W = q_packed.shape
    mask, bq, bn = _enable_mask(
        layout, Q, W, k, d, probe, cand_ids, bq, bn,
        backend=device_mod.backend_of(q_packed))
    out = ops.hamming_topk(q_packed, layout.codes, k, d + 1,
                           block_mask=mask, bq=bq, bn=bn,
                           return_stats=return_stats)
    dd, ii = out[0], out[1]
    ids = original_ids(layout, dd, ii, d)
    return (dd, ids, out[2]) if return_stats else (dd, ids)


def enabled_positions(layout: BucketLayout, mask_row, bn: int) -> np.ndarray:
    """Host helper (tests, chip_smoke.py): the reordered row positions a
    mask row enables, ascending — the exact candidate set, in scan order,
    of every query in that query block."""
    mask_row = np.asarray(torch.as_tensor(mask_row).cpu())
    pos = [np.arange(j * bn, min((j + 1) * bn, layout.n))
           for j in np.flatnonzero(mask_row)]
    return (np.concatenate(pos) if pos
            else np.zeros((0,), np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# mutable arena: bucket regions with reserved slack (core/mutable.py)
# ---------------------------------------------------------------------------

class Arena(NamedTuple):
    """Host-side bucket arena with per-bucket spare slack for online
    inserts (the mutable face of :class:`BucketLayout`; core/mutable.py).

    Bucket ``b`` OWNS the capacity region ``[cap_starts[b],
    cap_starts[b+1])``; its first ``n_used[b]`` slots are occupied — live
    rows interleaved with tombstones (``ids == -1``) — and the rest is
    slack reserved at build time via ``slack_frac``. Appends fill slack in
    place; deletes tombstone in place (positions of surviving rows never
    move, which is what keeps the within-bucket ascending-id order — the
    invariant that makes an installed epoch bit-identical to a rebuild).
    All arrays are numpy: this is the mutation side, never what kernels
    stream — searches run against the dense epoch ``core/mutable.py``
    gathers from the live rows."""

    codes: np.ndarray       # (cap, W) uint32
    ids: np.ndarray         # (cap,) int64 external ids; -1 = dead/slack
    values: np.ndarray      # (cap,) int32 payload (e.g. next-token ids)
    cap_starts: np.ndarray  # (B+1,) int64 capacity offsets
    n_used: np.ndarray      # (B,) int64 occupied prefix per bucket
    positions: np.ndarray   # (bits,) int32 FIXED hamming-prefix key bits
    d: int                  # code bits

    @property
    def n_buckets(self) -> int:
        return self.cap_starts.shape[0] - 1

    @property
    def capacity(self) -> int:
        return int(self.cap_starts[-1])

    def live_mask(self) -> np.ndarray:
        """(cap,) bool: occupied AND not tombstoned."""
        used = np.zeros(self.capacity, bool)
        for b in range(self.n_buckets):
            s = int(self.cap_starts[b])
            used[s:s + int(self.n_used[b])] = True
        return used & (self.ids >= 0)

    @property
    def n_live(self) -> int:
        return int(np.count_nonzero(self.live_mask()))

    @property
    def n_tombstones(self) -> int:
        return int(self.n_used.sum()) - self.n_live


def hamming_key_host(codes: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`hamming_prefix_assign`'s keying for FIXED
    ``positions`` — the online-insert hot path must not re-derive the key
    bits (re-derivation drifts as data drifts, and a drifted key would
    silently re-bucket existing rows). Bit ``p`` lives at word ``p // 32``,
    bit ``p % 32`` (binary.pack_bits convention)."""
    codes = np.asarray(codes, np.uint32)
    positions = np.asarray(positions, np.int64)
    bits = (codes[:, positions // 32] >> (positions % 32).astype(np.uint32))
    bits = (bits & 1).astype(np.int64)                     # (N, nbits)
    return bits @ (np.int64(1) << np.arange(positions.shape[0],
                                            dtype=np.int64))


def bucket_capacities(counts: np.ndarray, slack_frac: float,
                      min_slack: int) -> np.ndarray:
    """Per-bucket capacity = live count + reserved slack. Every bucket —
    including an empty one — gets at least ``min_slack`` spare slots, so a
    fresh arena can always absorb appends into ANY bucket before the next
    compaction rebalances."""
    counts = np.asarray(counts, np.int64)
    slack = np.maximum(np.ceil(counts * slack_frac).astype(np.int64),
                       min_slack)
    return counts + slack


def build_arena(codes: np.ndarray, d: int, *, ids: np.ndarray,
                values: Optional[np.ndarray] = None,
                n_buckets: int | None = None,
                positions: Optional[np.ndarray] = None,
                slack_frac: float = 0.5, min_slack: int = 8) -> Arena:
    """Build a slack-reserving arena from dense rows (the mutable analogue
    of :func:`build_layout`; the ``slack_frac`` knob is THE build-time
    reservation for online appends).

    ``positions=None`` derives the hamming-prefix key bits from ``codes``
    once (the same greedy balanced selection ``build_layout`` uses) and
    stores them in the arena: every later insert and every compaction keys
    by these frozen positions, so bucket assignment is a pure function of
    a row's code for the arena's whole lifetime. Rows must arrive in
    ascending external-id order (asserted): the arena's bit-identity
    contract leans on within-bucket id order."""
    codes = np.asarray(codes, np.uint32)
    ids = np.asarray(ids, np.int64)
    if codes.ndim != 2 or ids.shape != (codes.shape[0],):
        raise ValueError(f"codes {codes.shape} and ids {ids.shape} differ")
    if ids.size and (not np.all(np.diff(ids) > 0) or int(ids[0]) < 0):
        raise ValueError("arena rows must be id-ascending and >= 0")
    values = (np.zeros(ids.shape, np.int32) if values is None
              else np.asarray(values, np.int32))
    if positions is None:
        bits = (n_buckets - 1).bit_length() if n_buckets else (
            default_bits(max(codes.shape[0], 1)))
        _, pos = hamming_prefix_assign(
            torch.from_numpy(np.ascontiguousarray(codes).view(np.int32)), d,
            bits)
        positions = pos.numpy().astype(np.int32)
    else:
        positions = np.asarray(positions, np.int32)
    B = 1 << positions.shape[0]
    assign = hamming_key_host(codes, positions)
    counts = np.bincount(assign, minlength=B).astype(np.int64)
    caps = bucket_capacities(counts, slack_frac, min_slack)
    cap_starts = np.zeros(B + 1, np.int64)
    np.cumsum(caps, out=cap_starts[1:])
    W = codes.shape[1]
    a_codes = np.zeros((int(cap_starts[-1]), W), np.uint32)
    a_ids = np.full(int(cap_starts[-1]), -1, np.int64)
    a_values = np.zeros(int(cap_starts[-1]), np.int32)
    # stable scatter: within a bucket, input (ascending-id) order survives
    if codes.shape[0]:
        order = np.argsort(assign, kind="stable")
        srt = assign[order]
        dense_starts = np.concatenate(
            ([0], np.cumsum(counts)))                       # (B+1,)
        rank = np.arange(order.shape[0]) - dense_starts[srt]
        slots = cap_starts[srt] + rank
        a_codes[slots] = codes[order]
        a_ids[slots] = ids[order]
        a_values[slots] = values[order]
    return Arena(codes=a_codes, ids=a_ids, values=a_values,
                 cap_starts=cap_starts, n_used=counts.copy(),
                 positions=positions, d=d)
