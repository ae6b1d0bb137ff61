"""Crash-safe mutable datastore (port of ``repro.core.mutable``): online
append/delete over the bucket arena, epoch-swapped searchable snapshots,
write-ahead intent logging, and an integrity audit.

The arena, the WAL records and the snapshots are host numpy with
``repro``'s byte layouts, so a store root written by either package
recovers in the other to the same epoch checksum. An installed epoch's
codes and values are tensors on the store's device (CUDA unless
``device="cpu"``), and ``search`` runs one K1 + one K2 launch over them.

Why epochs instead of in-place tombstone masking
------------------------------------------------
The fused kernels can exactly exclude exactly two shapes of rows with the
EXISTING machinery: whole tiles (``block_mask``) and a global row suffix
(``n_valid``). An interior tombstone is neither — no sentinel code can
guarantee a maximal distance to every query, and over-fetching k+T then
post-filtering breaks the tie-order determinism every equivalence test
pins. So mutation and search are split:

* the **arena** (``layout.Arena``, host numpy) absorbs mutations in place:
  appends fill per-bucket slack reserved at build time (``slack_frac``),
  deletes tombstone in place (``ids[slot] = -1`` — surviving rows never
  move);
* ``flush()`` gathers the live rows into a dense **epoch** — a
  ``BucketLayout`` with identity perm over exactly the live rows — and
  installs it atomically (readers pin the epoch object for the duration of
  a search; an installed epoch is immutable). Tombstones and slack are
  *expressed to the kernels* the only exact way possible: they are simply
  not in the dense arrays, and the epoch's bucket ``starts`` drive the
  same ``block_mask`` probing, while any pad the kernels add is masked by
  the existing ``n_valid`` contract — zero kernel changes.

Because (a) appends carry strictly increasing external ids, (b) deletes
never move survivors, and (c) compaction is a stable re-scatter keyed by
the arena's FROZEN hamming-prefix bit positions, the live rows of any
epoch sit in ascending-external-id order within each bucket — exactly the
order ``layout.build_arena`` produces from scratch. A mutated store's
epoch is therefore bit-identical to a from-scratch rebuild of the same
logical contents (pinned by tests/test_mutable_store.py).

Durability: every mutation is appended to the WAL (checkpoint/wal.py) and
fsynced BEFORE it touches the arena or is acknowledged; snapshots
(checkpoint/manager.py) bound replay length, and ``recover()`` = last
committed snapshot + WAL tail replay + ``flush()`` + ``audit()``. Fault
sites: ``wal_append`` (before the record is written — a fired fault means
"never acked, never durable"), ``compact_build`` (before the rebuilt
arena is swapped in), ``epoch_install`` (before the new epoch is swapped
in); a crash at any of them loses no acknowledged mutation.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt
from repro_torch.checkpoint import wal as wal_mod
from repro_torch.core import layout as layout_mod
from repro_torch.core.layout import Arena, BucketLayout


class AuditError(RuntimeError):
    """An arena/epoch invariant failed verification."""


class StoreFull(RuntimeError):
    """Append could not be placed and deferred compaction is backlogged."""


class Epoch(NamedTuple):
    """One immutable searchable snapshot. ``layout.perm`` is the identity:
    epoch positions ARE the ids the kernels report, and ``store_ids``
    translates them to external ids. Readers that captured this object
    keep a complete, consistent view no matter what the store does next."""

    seq: int                # monotonically increasing install counter
    applied_seq: int        # highest WAL seq folded into this epoch
    layout: BucketLayout    # dense live rows (int32 codes), identity perm
    store_ids: np.ndarray   # (n,) int64: epoch position -> external id
    values: torch.Tensor    # (n,) int32 aligned with layout.codes
    checksum: int           # crc32 over the dense host arrays

    @property
    def n(self) -> int:
        return self.store_ids.shape[0]


# -- WAL payload codecs (schema owned here, framing owned by wal.py) --------

def _encode_append(ids: np.ndarray, values: np.ndarray,
                   codes: np.ndarray) -> bytes:
    n, w = codes.shape
    return (struct.pack("<II", n, w) + ids.astype("<i8").tobytes()
            + values.astype("<i4").tobytes()
            + codes.astype("<u4").tobytes())


def _decode_append(payload: bytes):
    n, w = struct.unpack_from("<II", payload)
    off = 8
    ids = np.frombuffer(payload, "<i8", n, off).copy()
    off += 8 * n
    values = np.frombuffer(payload, "<i4", n, off).copy()
    off += 4 * n
    codes = np.frombuffer(payload, "<u4", n * w, off).reshape(n, w).copy()
    return ids, values, codes


def _encode_delete(ids: np.ndarray) -> bytes:
    return struct.pack("<I", ids.shape[0]) + ids.astype("<i8").tobytes()


def _decode_delete(payload: bytes) -> np.ndarray:
    (n,) = struct.unpack_from("<I", payload)
    return np.frombuffer(payload, "<i8", n, 4).copy()


def _epoch_checksum(codes: np.ndarray, ids: np.ndarray, values: np.ndarray,
                    starts: np.ndarray) -> int:
    c = zlib.crc32(np.ascontiguousarray(codes).tobytes())
    c = zlib.crc32(np.ascontiguousarray(ids).tobytes(), c)
    c = zlib.crc32(np.ascontiguousarray(values).tobytes(), c)
    return zlib.crc32(np.ascontiguousarray(starts).tobytes(), c)


_META_FIELDS = 5  # d, applied_seq, next_id, epoch_seq, has_itq


class MutableStore:
    """Online append/delete/flush over a slack arena with WAL durability.

    ``root=None`` runs purely in memory (no WAL, no snapshots — unit-test
    mode); with a root, ``<root>/wal.log`` is the intent log and
    ``<root>/snap`` holds manager-committed snapshots. ``fault_injector``
    (runtime/faults.py) arms the three sites documented in the module
    docstring. Mutations are visible to ``search``/``datastore_view`` only
    after ``flush()`` — acknowledged-durable and searchable are distinct
    states, exactly as in an LSM memtable. Epochs live on ``device``
    (CUDA unless ``device="cpu"``)."""

    def __init__(self, arena: Arena, *, root: Optional[str] = None,
                 itq=None, fault_injector=None,
                 tombstone_frac: float = 0.25, slack_frac: float = 0.5,
                 min_slack: int = 8, max_pending: int = 1024,
                 fault_scope: Optional[str] = None, device=None,
                 _recovering: bool = False):
        self.device = device_mod.resolve(device)
        self.arena = arena
        self.root = root
        self.itq = itq
        self.faults = fault_injector
        # tenant-scoped fault attribution: every site this store arms is
        # keyed "<site>@<scope>" so a multi-tenant soak can poison (and
        # count) one tenant's faults without touching its neighbours
        self.fault_scope = fault_scope
        self.tombstone_frac = tombstone_frac
        self.slack_frac = slack_frac
        self.min_slack = min_slack
        self.max_pending = max_pending
        self._wal: Optional[wal_mod.WriteAheadLog] = None
        if root is not None:
            hook = (fault_injector.hook("wal_append", fault_scope)
                    if fault_injector is not None else None)
            self._wal = wal_mod.WriteAheadLog(self.wal_path, fault_hook=hook)
        self._id_map = {}           # external id -> arena slot
        self._n_live = 0
        self._rebuild_id_map()
        self._overflow: List[Tuple[int, int, np.ndarray]] = []
        self._applied_seq = -1
        self._next_seq = 0
        self._next_id = (int(self.arena.ids.max()) + 1
                         if self._n_live else 0)
        self._epoch: Optional[Epoch] = None
        self._epoch_seq = 0
        self._dirty = 0             # mutations since the installed epoch
        # buckets mutated since the installed epoch; None = the previous
        # epoch cannot seed an incremental gather (startup, post-compact)
        self._dirty_buckets: Optional[set] = None
        self._epoch_host = None     # (codes, ids, values, starts) host copy
        self._need_compact = False
        self.counters = {"appended": 0, "deleted": 0, "flushes": 0,
                         "compactions": 0, "audits": 0, "wal_records": 0,
                         "bucket_gathers": 0, "incremental_flushes": 0}
        if not _recovering:
            if root is not None:
                self.snapshot()     # recovery base covering bootstrap rows
            self.flush()

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, codes, d: int, *, ids=None, values=None,
               n_buckets: Optional[int] = None, root: Optional[str] = None,
               **kw) -> "MutableStore":
        """Bootstrap from dense rows (codes id-ascending; ids default to
        0..n-1). The bootstrap rows are covered by the initial snapshot,
        not the WAL. ``codes``: (n, W) packed, numpy or a tensor."""
        codes = _host_codes(codes)
        ids = (np.arange(codes.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64))
        slack = kw.get("slack_frac", 0.5)
        mins = kw.get("min_slack", 8)
        arena = layout_mod.build_arena(
            codes, d, ids=ids, values=values, n_buckets=n_buckets,
            slack_frac=slack, min_slack=mins)
        return cls(arena, root=root, **kw)

    @property
    def wal_path(self) -> str:
        return os.path.join(self._need_root(), "wal.log")

    @property
    def snap_root(self) -> str:
        return os.path.join(self._need_root(), "snap")

    def _need_root(self) -> str:
        if self.root is None:
            raise ValueError("an in-memory store has no WAL or snapshots")
        return self.root

    @property
    def d(self) -> int:
        return self.arena.d

    @property
    def n_live(self) -> int:
        return self._n_live + len(self._overflow)

    @property
    def epoch(self) -> Optional[Epoch]:
        return self._epoch

    @property
    def epoch_seq(self) -> int:
        return self._epoch.seq if self._epoch is not None else -1

    @property
    def pending_mutations(self) -> int:
        """Mutations acked-durable but not yet searchable: the compaction
        backlog plus everything since the last flush."""
        return len(self._overflow) + self._dirty

    @property
    def backlog_full(self) -> bool:
        """Admission-control signal: compaction has fallen behind. The
        server sheds appends while this holds (Server.submit_append)."""
        return len(self._overflow) >= self.max_pending

    @property
    def needs_compact(self) -> bool:
        if self._overflow or self._need_compact:
            return True
        used = int(self.arena.n_used.sum())
        return used > 0 and (used - self._n_live) / used > self.tombstone_frac

    def _rebuild_id_map(self):
        slots = np.flatnonzero(self.arena.live_mask())
        self._id_map = dict(zip(self.arena.ids[slots].tolist(),
                                slots.tolist()))
        self._n_live = len(self._id_map)

    # -- WAL ----------------------------------------------------------------

    def _log(self, kind: int, payload: bytes) -> int:
        seq = self._next_seq
        if self._wal is not None:
            self._wal.append(kind, payload, seq)   # fault site: wal_append
        self._next_seq = seq + 1
        self.counters["wal_records"] += 1
        return seq

    # -- mutations ----------------------------------------------------------

    def append(self, codes, ids=None, values=None) -> np.ndarray:
        """Durably append rows; returns their external ids. The WAL record
        lands (fsynced) before the arena changes — when this returns, the
        rows survive any crash; they become searchable at the next flush.
        Ids must be fresh and strictly greater than every id ever used
        (auto-assigned when omitted) — the bit-identity ordering contract.
        """
        codes = np.atleast_2d(_host_codes(codes))
        n = codes.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        else:
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if ids.shape != (n,) or (n > 1 and not np.all(np.diff(ids) > 0)):
                raise ValueError(f"append ids {ids.shape} must be {n} "
                                 f"ascending ids")
            if int(ids[0]) < self._next_id:
                raise ValueError(f"append ids must exceed every prior id "
                                 f"(< {self._next_id})")
        values = (np.zeros(n, np.int32) if values is None
                  else np.atleast_1d(np.asarray(values, np.int32)))
        seq = self._log(wal_mod.APPEND, _encode_append(ids, values, codes))
        self._apply_append(ids, values, codes)
        self._applied_seq = seq
        self.counters["appended"] += n
        return ids

    def _apply_append(self, ids, values, codes):
        a = self.arena
        assign = layout_mod.hamming_key_host(codes, a.positions)
        for i in range(ids.shape[0]):
            b = int(assign[i])
            used = int(a.n_used[b])
            cap = int(a.cap_starts[b + 1] - a.cap_starts[b])
            if used < cap:
                slot = int(a.cap_starts[b]) + used
                a.codes[slot] = codes[i]
                a.ids[slot] = int(ids[i])
                a.values[slot] = int(values[i])
                a.n_used[b] = used + 1
                self._id_map[int(ids[i])] = slot
                self._n_live += 1
                if self._dirty_buckets is not None:
                    self._dirty_buckets.add(b)
            else:
                # bucket slack exhausted: defer to compaction (the row is
                # already durable in the WAL; backpressure is the caller's
                # admission decision via `backlog_full`)
                self._overflow.append((int(ids[i]), int(values[i]),
                                       codes[i].copy()))
                self._need_compact = True
        self._next_id = max(self._next_id, int(ids[-1]) + 1)
        self._dirty += ids.shape[0]

    def delete(self, ids) -> int:
        """Durably delete; returns how many ids were actually present.
        Deletes tombstone in place — survivors never move, so epoch order
        (and with it bit-identity to a rebuild) is preserved."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        seq = self._log(wal_mod.DELETE, _encode_delete(ids))
        hit = self._apply_delete(ids)
        self._applied_seq = seq
        self.counters["deleted"] += hit
        return hit

    def _apply_delete(self, ids) -> int:
        hit = 0
        overflow_ids = None
        for i in ids:
            slot = self._id_map.pop(int(i), None)
            if slot is not None:
                self.arena.ids[slot] = -1
                self._n_live -= 1
                hit += 1
                if self._dirty_buckets is not None:
                    b = int(np.searchsorted(self.arena.cap_starts, slot,
                                            side="right")) - 1
                    self._dirty_buckets.add(b)
            else:
                if overflow_ids is None:
                    overflow_ids = {t[0] for t in self._overflow}
                if int(i) in overflow_ids:
                    self._overflow = [t for t in self._overflow
                                      if t[0] != int(i)]
                    overflow_ids.discard(int(i))
                    hit += 1
        if hit:
            self._dirty += hit
        return hit

    # -- compaction / epoch install -----------------------------------------

    def _live_rows(self):
        """All live rows (arena + overflow) sorted by external id."""
        a = self.arena
        mask = a.live_mask()
        ids = a.ids[mask]
        codes = a.codes[mask]
        values = a.values[mask]
        if self._overflow:
            o_ids = np.array([t[0] for t in self._overflow], np.int64)
            o_vals = np.array([t[1] for t in self._overflow], np.int32)
            o_codes = np.stack([t[2] for t in self._overflow])
            ids = np.concatenate([ids, o_ids])
            values = np.concatenate([values, o_vals])
            codes = np.concatenate([codes, o_codes])
        order = np.argsort(ids, kind="stable")
        return codes[order], ids[order], values[order]

    def compact(self) -> None:
        """Re-cluster into a fresh arena (frozen key positions, fresh
        slack), folding the overflow backlog in and dropping tombstones.
        Crash-safe: the fault site fires before the swap, so a crash
        leaves the old arena intact and every mutation still in the WAL."""
        if self.faults is not None:
            self.faults.check("compact_build", self.fault_scope)
        self._log(wal_mod.COMPACT_BEGIN, b"")
        codes, ids, values = self._live_rows()
        arena = layout_mod.build_arena(
            codes, self.d, ids=ids, values=values,
            positions=self.arena.positions, slack_frac=self.slack_frac,
            min_slack=self.min_slack)
        # the commit record "applies" trivially (compaction is derived
        # state), so it advances applied_seq like any mutation
        self._applied_seq = self._log(wal_mod.COMPACT_COMMIT, b"")
        self.arena = arena
        self._overflow = []
        self._need_compact = False
        self._rebuild_id_map()
        self.counters["compactions"] += 1
        self._dirty += 1            # the epoch no longer matches the arena
        self._dirty_buckets = None  # every bucket moved: next flush is full

    def maybe_compact(self) -> bool:
        """Cooperative background compaction: the server calls this once
        per tick; it runs only when needed."""
        if self.needs_compact:
            self.compact()
            return True
        return False

    def flush(self) -> Epoch:
        """Install a fresh epoch covering every acknowledged mutation.
        Folds the compaction backlog first, so after any flush the epoch
        IS the store's full logical contents. Readers holding the previous
        epoch keep a complete consistent view (epoch pinning)."""
        if self.needs_compact:
            self.compact()
        if self._epoch is not None and self._dirty == 0:
            return self._epoch
        a = self.arena
        incremental = (self._dirty_buckets is not None
                       and self._epoch_host is not None
                       and a.n_buckets > 0)
        if incremental:
            # re-gather ONLY buckets mutated since the last epoch; clean
            # buckets are sliced straight out of the previous epoch's host
            # arrays. Bit-identical to the full gather because the frozen
            # key positions confine every mutation to its own bucket, so a
            # clean bucket's dense rows cannot have changed.
            p_codes, p_ids, p_values, p_starts = self._epoch_host
            parts_c, parts_i, parts_v = [], [], []
            counts = np.zeros(a.n_buckets, np.int64)
            for b in range(a.n_buckets):
                if b in self._dirty_buckets:
                    s, used = int(a.cap_starts[b]), int(a.n_used[b])
                    seg_ids = a.ids[s:s + used]
                    m = seg_ids >= 0
                    parts_c.append(a.codes[s:s + used][m])
                    parts_i.append(seg_ids[m])
                    parts_v.append(a.values[s:s + used][m])
                else:
                    lo, hi = int(p_starts[b]), int(p_starts[b + 1])
                    parts_c.append(p_codes[lo:hi])
                    parts_i.append(p_ids[lo:hi])
                    parts_v.append(p_values[lo:hi])
                counts[b] = parts_i[-1].shape[0]
            codes = np.ascontiguousarray(np.concatenate(parts_c))
            ids = np.ascontiguousarray(np.concatenate(parts_i))
            values = np.ascontiguousarray(np.concatenate(parts_v))
            self.counters["bucket_gathers"] += len(self._dirty_buckets)
            self.counters["incremental_flushes"] += 1
        else:
            mask = a.live_mask()
            codes = np.ascontiguousarray(a.codes[mask])
            ids = np.ascontiguousarray(a.ids[mask])
            values = np.ascontiguousarray(a.values[mask])
            # per-bucket live counts -> dense bucket starts
            counts = np.array(
                [int(np.count_nonzero(
                    mask[int(a.cap_starts[b]):int(a.cap_starts[b + 1])]))
                 for b in range(a.n_buckets)], np.int64)
            self.counters["bucket_gathers"] += a.n_buckets
        starts = np.zeros(a.n_buckets + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        starts = starts.astype(np.int32)   # what the layout (and the
        checksum = _epoch_checksum(codes, ids, values, starts)  # audit) sees
        n = codes.shape[0]
        dev = self.device
        ident = torch.arange(n, dtype=torch.int32, device=dev)
        layout = BucketLayout(
            codes=torch.from_numpy(codes.view(np.int32).reshape(
                n, a.codes.shape[1])).to(dev),
            perm=ident, inv=ident, starts=torch.from_numpy(starts).to(dev))
        if self.faults is not None:
            # crash -> old epoch holds (and the dirty set keeps
            # accumulating, so the retried flush gathers everything owed)
            self.faults.check("epoch_install", self.fault_scope)
        self._epoch_seq += 1
        self._epoch = Epoch(seq=self._epoch_seq,
                            applied_seq=self._applied_seq, layout=layout,
                            store_ids=ids,
                            values=torch.from_numpy(values).to(dev),
                            checksum=checksum)
        self._dirty = 0
        self._dirty_buckets = set()
        self._epoch_host = (codes, ids, values, starts)
        self.counters["flushes"] += 1
        return self._epoch

    # -- search -------------------------------------------------------------

    def _pinned(self) -> Epoch:
        if self._epoch is None:
            raise RuntimeError("flush() before searching or taking a view")
        return self._epoch

    def search(self, q_packed, k: int):
        """Top-k over the installed epoch (pinned for the whole call), one
        K1 + one K2 launch. ``q_packed``: (Q, W) packed codes, a tensor or
        numpy (uint32 or int32). Returns numpy (dists (Q, k) int32,
        external ids (Q, k) int64), sentinel slots -> -1."""
        ep = self._pinned()
        q = _query_tensor(q_packed, self.device)
        if ep.n == 0:
            # an empty epoch has no layout to plan over; the kernel-path
            # sentinel contract (dist bins, id -1) applies verbatim
            return (np.full((q.shape[0], k), self.d + 1, np.int32),
                    np.full((q.shape[0], k), -1, np.int64))
        from repro_torch.core import engine as engine_mod
        eng = engine_mod.KNNEngine.from_epoch(ep, self.d)
        dists, pos = eng.search(q, k)
        dists = dists.cpu().numpy()
        pos = pos.cpu().numpy()
        # surplus slots (k > live rows) carry sentinel distance bins and a
        # clipped position — the distance, not the position, marks them
        valid = (pos >= 0) & (dists <= self.d)
        ext = np.where(valid,
                       ep.store_ids[np.clip(pos, 0, max(ep.n - 1, 0))]
                       if ep.n else -1, -1)
        return np.asarray(dists), ext

    def datastore_view(self, itq=None):
        """The installed epoch as a retrieval.DataStore: identity-perm
        layout, values aligned to epoch positions, and the arena's FROZEN
        key positions carried along so degraded probing keys queries the
        way the arena was actually bucketed."""
        from repro_torch.core import retrieval as retrieval_mod
        ep = self._pinned()
        itq = itq if itq is not None else self.itq
        if itq is None:
            raise ValueError("datastore_view needs ITQ params")
        return retrieval_mod.DataStore(
            codes=ep.layout.codes, values=ep.values, itq=itq,
            layout=ep.layout,
            key_positions=torch.from_numpy(
                np.asarray(self.arena.positions, np.int32)).to(self.device))

    # -- durability ---------------------------------------------------------

    def snapshot(self) -> int:
        """Write a committed snapshot of the full mutation state (arena +
        overflow via pre-fold) and truncate the WAL to the records it does
        not cover. Returns the snapshot step."""
        self._need_root()
        a = self.arena
        meta = np.array([self.d, self._applied_seq, self._next_id,
                         self._epoch_seq, int(self.itq is not None)],
                        np.int64)
        leaves = [a.codes, a.ids, a.values, a.cap_starts, a.n_used,
                  a.positions, meta]
        if self._overflow:
            o_ids = np.array([t[0] for t in self._overflow], np.int64)
            o_vals = np.array([t[1] for t in self._overflow], np.int32)
            o_codes = np.stack([t[2] for t in self._overflow])
        else:
            o_ids = np.zeros(0, np.int64)
            o_vals = np.zeros(0, np.int32)
            o_codes = np.zeros((0, a.codes.shape[1]), np.uint32)
        leaves += [o_ids, o_vals, o_codes]
        if self.itq is not None:
            leaves += [x.detach().cpu().numpy() for x in
                       (self.itq.mean, self.itq.proj, self.itq.rot)]
        step = self._applied_seq + 1
        hook = (self.faults.hook("ckpt_save", self.fault_scope)
                if self.faults is not None else None)
        ckpt.save(self.snap_root, step, leaves, blocking=True,
                  fault_hook=hook)
        ckpt.garbage_collect(self.snap_root, keep=2)
        if self._wal is not None:
            # rewrite() replaces the inode — reopen so later appends land
            # in the truncated log, not the unlinked file
            self._wal.close()
            wal_mod.rewrite(self.wal_path, wal_mod.replay(
                self.wal_path, after_seq=self._applied_seq))
            hook = (self.faults.hook("wal_append", self.fault_scope)
                    if self.faults is not None else None)
            self._wal = wal_mod.WriteAheadLog(self.wal_path,
                                              fault_hook=hook)
        return step

    @classmethod
    def recover(cls, root: str, *, fault_injector=None, device=None,
                **kw) -> "MutableStore":
        """Last committed snapshot + WAL tail replay + flush + audit.
        Corrupt/truncated snapshots fall back to the previous committed
        step (checkpoint.manager), whose longer WAL tail then replays —
        either way no acknowledged mutation is lost."""
        from repro_torch.core import quantize
        dev = device_mod.resolve(device)
        snap_root = os.path.join(root, "snap")
        step, leaves = ckpt.restore_latest_arrays(snap_root)
        if leaves is None:
            raise FileNotFoundError(f"no committed snapshot under {root}")
        (codes, ids, values, cap_starts, n_used, positions, meta,
         o_ids, o_vals, o_codes) = leaves[:10]
        d, applied_seq, next_id, epoch_seq, has_itq = (int(x) for x in meta)
        itq = None
        if has_itq:
            mean, proj, rot = leaves[10:13]
            itq = quantize.ITQParams(*(torch.from_numpy(
                np.asarray(x, np.float32).copy()).to(dev)
                for x in (mean, proj, rot)))
        arena = Arena(codes=np.asarray(codes, np.uint32),
                      ids=np.asarray(ids, np.int64),
                      values=np.asarray(values, np.int32),
                      cap_starts=np.asarray(cap_starts, np.int64),
                      n_used=np.asarray(n_used, np.int64),
                      positions=np.asarray(positions, np.int32), d=d)
        store = cls(arena, root=root, itq=itq,
                    fault_injector=fault_injector, device=dev,
                    _recovering=True, **kw)
        store._applied_seq = applied_seq
        store._next_id = next_id
        store._epoch_seq = epoch_seq
        for i in range(o_ids.shape[0]):
            store._overflow.append((int(o_ids[i]), int(o_vals[i]),
                                    np.asarray(o_codes[i], np.uint32)))
        if store._overflow:
            store._need_compact = True
        # replay the WAL tail the snapshot does not cover
        max_seq = applied_seq
        for rec in wal_mod.replay(store.wal_path, after_seq=applied_seq):
            if rec.kind == wal_mod.APPEND:
                a_ids, a_vals, a_codes = _decode_append(rec.payload)
                fresh = np.array([i not in store._id_map
                                  for i in a_ids.tolist()])
                if fresh.all():
                    store._apply_append(a_ids, a_vals, a_codes)
                elif fresh.any():   # partial overlap cannot happen, but
                    store._apply_append(a_ids[fresh], a_vals[fresh],
                                        a_codes[fresh])
            elif rec.kind == wal_mod.DELETE:
                store._apply_delete(_decode_delete(rec.payload))
            # COMPACT_*/SNAPSHOT are informational: compaction is a pure
            # function of arena state, so replaying mutations reproduces
            # the logical contents and any needed compaction re-triggers
            max_seq = max(max_seq, rec.seq)
        store._applied_seq = max_seq
        store._next_seq = max_seq + 1
        store.flush()
        store.audit()
        return store

    # -- integrity ----------------------------------------------------------

    def audit(self, strict: bool = True) -> dict:
        """Verify arena + epoch + WAL invariants; raises AuditError (or
        returns the report with ``ok=False`` when ``strict=False``).
        Run after every recovery and periodically by the server."""
        problems: List[str] = []
        a = self.arena
        if not np.all(np.diff(a.cap_starts) >= 0) or int(a.cap_starts[0]):
            problems.append("cap_starts not monotonic from 0")
        caps = np.diff(a.cap_starts)
        if np.any(a.n_used < 0) or np.any(a.n_used > caps):
            problems.append("n_used out of [0, capacity]")
        if (np.unique(a.positions).size != a.positions.size
                or np.any(a.positions < 0) or np.any(a.positions >= a.d)):
            problems.append("key positions not unique in [0, d)")
        live_ids: List[int] = []
        for b in range(a.n_buckets):
            s, used = int(a.cap_starts[b]), int(a.n_used[b])
            seg = a.ids[s:s + used]
            if np.any(a.ids[s + used:int(a.cap_starts[b + 1])] >= 0):
                problems.append(f"bucket {b}: live id in slack region")
            seg_live = seg[seg >= 0]
            if seg_live.size > 1 and not np.all(np.diff(seg_live) > 0):
                problems.append(f"bucket {b}: live ids not ascending")
            if seg_live.size:
                keys = layout_mod.hamming_key_host(
                    a.codes[s:s + used][seg >= 0], a.positions)
                if np.any(keys != b):
                    problems.append(f"bucket {b}: row keyed elsewhere")
            live_ids.extend(int(i) for i in seg_live)
        if len(set(live_ids)) != len(live_ids):
            problems.append("duplicate live external ids")
        if len(live_ids) != self._n_live or set(live_ids) != set(self._id_map):
            problems.append("id_map inconsistent with arena")
        ep = self._epoch
        if ep is not None:
            st = ep.layout.starts.cpu().numpy()
            if not np.all(np.diff(st) >= 0) or int(st[0]) != 0:
                problems.append("epoch starts not monotonic from 0")
            perm = ep.layout.perm.cpu().numpy()
            inv = ep.layout.inv.cpu().numpy()
            if not (np.array_equal(perm[inv], np.arange(ep.n))
                    and np.array_equal(inv[perm], np.arange(ep.n))):
                problems.append("epoch perm/inv round-trip failed")
            got = _epoch_checksum(ep.layout.codes.cpu().numpy(),
                                  ep.store_ids, ep.values.cpu().numpy(), st)
            if got != ep.checksum:
                problems.append("epoch checksum mismatch")
            if int(st[-1]) != ep.n:
                problems.append("epoch starts[-1] != epoch rows")
            if self._dirty == 0 and not self._overflow:
                # a clean store's epoch must be exactly the live rows
                if ep.n != self._n_live:
                    problems.append("clean epoch row count != arena live")
                elif not set(int(i) for i in ep.store_ids) == set(
                        self._id_map):
                    problems.append("clean epoch ids != arena live ids")
        if self._wal is not None:
            disk_seq = wal_mod.last_seq(self.wal_path)
            if disk_seq > self._applied_seq:
                problems.append("WAL holds records beyond applied_seq")
        self.counters["audits"] += 1
        report = {"ok": not problems, "problems": problems,
                  "n_live": self._n_live, "epoch_seq": self.epoch_seq,
                  "tombstones": self.arena.n_tombstones}
        if strict and problems:
            raise AuditError("; ".join(problems))
        return report

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        a = self.arena
        used = int(a.n_used.sum())
        return {
            "n_live": self.n_live,
            "capacity": a.capacity,
            "tombstones": used - self._n_live,
            "tombstone_frac": (used - self._n_live) / max(used, 1),
            "pending_mutations": self.pending_mutations,
            "overflow": len(self._overflow),
            "epoch_seq": self.epoch_seq,
            "applied_seq": self._applied_seq,
            **self.counters,
        }

    def close(self):
        if self._wal is not None:
            self._wal.close()


def _host_codes(codes) -> np.ndarray:
    """Packed codes (numpy or a tensor on any device) -> uint32 numpy,
    same bits."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().to("cpu", torch.int32).numpy()
    a = np.ascontiguousarray(np.asarray(codes))
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _query_tensor(q_packed, dev) -> torch.Tensor:
    """(Q, W) packed queries -> int32 tensor on ``dev``, same bits."""
    if isinstance(q_packed, torch.Tensor):
        return q_packed.to(device=dev, dtype=torch.int32)
    a = np.ascontiguousarray(np.atleast_2d(np.asarray(q_packed)))
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed codes must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(dev)
