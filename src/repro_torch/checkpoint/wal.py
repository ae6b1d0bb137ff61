"""Write-ahead intent log for the mutable datastore (the port's own copy
of ``repro.checkpoint.wal``, which is pure Python: the same byte format,
so a log written by either package replays in the other).

Durability contract: a mutation is ACKNOWLEDGED only after its record is
appended, flushed, and fsynced here — so "acked" means "replayable". The
arena, the epoch, and every snapshot are derived state; a crash at any
point between the fsync and the next snapshot loses nothing that was
acked, because recovery replays the tail of this log on top of the last
committed snapshot (core/mutable.py).

Record framing (little-endian, self-delimiting):

    [u32 magic][u64 seq][u8 kind][u32 payload_len][payload][u32 crc32]

The CRC (zlib.crc32) covers seq..payload. Replay stops cleanly at the
first bad magic, short read, or CRC mismatch — a torn tail from a crash
mid-append truncates to the last whole record instead of poisoning the
log. Records carry opaque payload bytes; the codecs for append/delete
payloads live with the store that owns their schema.

``fault_hook`` runs BEFORE anything is written: an injected fault at the
``wal_append`` site means the record never reached the file, the caller
never acked, and recovery owes the client nothing for it.

Tenant namespaces (core/tenant.py): a multi-tenant arena keeps ONE log
per tenant under ``<root>/tenants/<tenant>/`` (:func:`namespace_root`,
:func:`list_namespaces`), so corruption in one tenant's log can never
poison another's replay. :func:`verify` triages a log before replay: a
*torn tail* (partial final record; nothing parseable follows the bad
frame) recovers normally, while *interior corruption* (a whole valid
record survives past the bad frame, i.e. tolerant replay would silently
drop acked records) marks the namespace for quarantine.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Iterator, List, NamedTuple, Optional

MAGIC = 0x57414C31          # "WAL1"
_HEADER = struct.Struct("<IQBI")    # magic, seq, kind, payload_len
_CRC = struct.Struct("<I")

# record kinds (payload schema owned by core/mutable.py)
APPEND = 1
DELETE = 2
COMPACT_BEGIN = 3
COMPACT_COMMIT = 4
SNAPSHOT = 5

KIND_NAMES = {APPEND: "append", DELETE: "delete",
              COMPACT_BEGIN: "compact_begin",
              COMPACT_COMMIT: "compact_commit", SNAPSHOT: "snapshot"}

# refuse absurd payloads during replay: a corrupt length field must not
# turn into a multi-GiB read before the CRC gets a chance to reject it
MAX_PAYLOAD = 1 << 30


class Record(NamedTuple):
    seq: int
    kind: int
    payload: bytes


class WalCorrupt(RuntimeError):
    """An interior record failed validation (not a clean torn tail)."""


class WriteAheadLog:
    """Append-only intent log. One writer; readers use :func:`replay`."""

    def __init__(self, path: str,
                 fault_hook: Optional[Callable[[], None]] = None):
        self.path = path
        self._fault_hook = fault_hook
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")

    def append(self, kind: int, payload: bytes, seq: int) -> None:
        """Durably append one record (flush + fsync before returning)."""
        if self._fault_hook is not None:
            self._fault_hook()
        crc = zlib.crc32(_HEADER.pack(MAGIC, seq, kind, len(payload))[4:])
        crc = zlib.crc32(payload, crc)
        self._f.write(_HEADER.pack(MAGIC, seq, kind, len(payload)))
        self._f.write(payload)
        self._f.write(_CRC.pack(crc))
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_records(path: str, strict: bool = False) -> Iterator[Record]:
    """Yield whole records; stop at the torn tail.

    A partial final record (crash mid-append) is normal and silently ends
    iteration. ``strict=True`` raises :class:`WalCorrupt` instead — used
    by audits that want to distinguish "clean tail" from "torn tail":
    iteration position is the byte offset of the first bad frame either
    way."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            head = f.read(_HEADER.size)
            if len(head) == 0:
                return                      # clean end
            if len(head) < _HEADER.size:
                _torn(strict, "short header")
                return
            magic, seq, kind, plen = _HEADER.unpack(head)
            if magic != MAGIC or plen > MAX_PAYLOAD:
                _torn(strict, f"bad magic/length at seq~{seq}")
                return
            payload = f.read(plen)
            tail = f.read(_CRC.size)
            if len(payload) < plen or len(tail) < _CRC.size:
                _torn(strict, "short payload/crc")
                return
            crc = zlib.crc32(head[4:])
            crc = zlib.crc32(payload, crc)
            if _CRC.unpack(tail)[0] != crc:
                _torn(strict, f"crc mismatch at seq {seq}")
                return
            yield Record(seq, kind, payload)


def _torn(strict: bool, what: str) -> None:
    if strict:
        raise WalCorrupt(what)


def replay(path: str, after_seq: int = -1) -> List[Record]:
    """All whole records with ``seq > after_seq``, in log order."""
    return [r for r in iter_records(path) if r.seq > after_seq]


def last_seq(path: str) -> int:
    """Highest seq among whole records, or -1 for an empty/missing log."""
    seq = -1
    for r in iter_records(path):
        seq = max(seq, r.seq)
    return seq


def namespace_root(root: str, name: str) -> str:
    """Filesystem namespace for one tenant's durable state (its own
    ``wal.log`` + ``snap/``) under a multi-tenant root. Names must be
    plain path components — a separator would let one tenant alias
    another's namespace."""
    name = str(name)
    if (not name or "/" in name or "\\" in name
            or name in (".", "..")):
        raise ValueError(f"bad namespace name {name!r}")
    return os.path.join(root, "tenants", name)


def list_namespaces(root: str) -> List[str]:
    """All tenant namespaces under ``root``, sorted (empty when none)."""
    base = os.path.join(root, "tenants")
    if not os.path.isdir(base):
        return []
    return sorted(n for n in os.listdir(base)
                  if os.path.isdir(os.path.join(base, n)))


def verify(path: str) -> dict:
    """Triage a log without replaying it: ``status`` is ``"ok"`` (every
    byte parses), ``"torn_tail"`` (a bad frame with nothing parseable
    after it — the normal crash artifact; tolerant replay recovers every
    whole record), or ``"corrupt"`` (a whole valid record survives PAST
    the bad frame: tolerant replay would silently drop acked records, so
    the namespace must be quarantined instead of replayed). Also returns
    ``records``/``last_seq`` over the clean prefix and ``bad_offset``."""
    if not os.path.exists(path):
        return {"status": "ok", "records": 0, "last_seq": -1,
                "bad_offset": -1}
    with open(path, "rb") as f:
        data = f.read()
    off, n_rec, last = 0, 0, -1

    def _parse_at(pos: int):
        """(seq, end_offset) of a whole valid record at pos, else None."""
        if pos + _HEADER.size > len(data):
            return None
        magic, seq, kind, plen = _HEADER.unpack_from(data, pos)
        if magic != MAGIC or plen > MAX_PAYLOAD:
            return None
        end = pos + _HEADER.size + plen + _CRC.size
        if end > len(data):
            return None
        crc = zlib.crc32(data[pos + 4:pos + _HEADER.size])
        crc = zlib.crc32(data[pos + _HEADER.size:end - _CRC.size], crc)
        if _CRC.unpack_from(data, end - _CRC.size)[0] != crc:
            return None
        return seq, end

    while off < len(data):
        got = _parse_at(off)
        if got is None:
            break
        last, off = got[0], got[1]
        n_rec += 1
    if off >= len(data):
        return {"status": "ok", "records": n_rec, "last_seq": last,
                "bad_offset": -1}
    # bad frame at `off`: corruption iff any whole valid record parses
    # anywhere past it (acked data exists beyond what replay would yield)
    magic_bytes = _HEADER.pack(MAGIC, 0, 0, 0)[:4]
    probe = off + 1
    status = "torn_tail"
    while True:
        probe = data.find(magic_bytes, probe)
        if probe < 0:
            break
        if _parse_at(probe) is not None:
            status = "corrupt"
            break
        probe += 1
    return {"status": status, "records": n_rec, "last_seq": last,
            "bad_offset": off}


def rewrite(path: str, records: List[Record]) -> None:
    """Atomically replace the log with ``records`` (post-snapshot
    truncation: drop everything a committed snapshot already covers).
    Written to a tmp file, fsynced, then renamed over the original."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for r in records:
            crc = zlib.crc32(
                _HEADER.pack(MAGIC, r.seq, r.kind, len(r.payload))[4:])
            crc = zlib.crc32(r.payload, crc)
            f.write(_HEADER.pack(MAGIC, r.seq, r.kind, len(r.payload)))
            f.write(r.payload)
            f.write(_CRC.pack(crc))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
