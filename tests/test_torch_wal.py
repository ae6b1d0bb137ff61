"""PyTorch port vs the JAX reference: the write-ahead log
(``repro_torch.checkpoint.wal``, the port's own copy of
``repro.checkpoint.wal``).

The byte format is the contract: a log written by either package replays
in the other record for record, torn tails end replay at the same whole
record in both, ``verify`` triages the same damage the same way, and
``rewrite`` produces the same bytes."""
import contextlib
import os

import numpy as np
import pytest

from repro.checkpoint import wal as jwal
from repro_torch.checkpoint import wal as twal

PKGS = {"repro": jwal, "port": twal}


def _write(mod, path, n=6, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    with mod.WriteAheadLog(path) as log:
        for seq in range(n):
            kind = [mod.APPEND, mod.DELETE, mod.COMPACT_BEGIN][seq % 3]
            payload = rng.integers(0, 256, int(rng.integers(0, 40)),
                                   dtype=np.uint8).tobytes()
            log.append(kind, payload, seq)
            recs.append((seq, kind, payload))
    return recs


@pytest.mark.parametrize("writer,reader", [("repro", "port"),
                                           ("port", "repro"),
                                           ("port", "port")])
def test_log_written_by_one_package_replays_in_the_other(tmp_path, writer,
                                                         reader):
    path = str(tmp_path / "wal.log")
    recs = _write(PKGS[writer], path)
    got = [tuple(r) for r in PKGS[reader].replay(path)]
    assert got == recs
    assert PKGS[reader].last_seq(path) == 5
    assert [tuple(r) for r in PKGS[reader].replay(path, after_seq=3)] == \
        recs[4:]
    assert PKGS[reader].verify(path) == PKGS[writer].verify(path)


def test_same_bytes_and_constants(tmp_path):
    a, b = str(tmp_path / "a.log"), str(tmp_path / "b.log")
    _write(jwal, a, seed=3)
    _write(twal, b, seed=3)
    assert open(a, "rb").read() == open(b, "rb").read()
    for name in ("MAGIC", "APPEND", "DELETE", "COMPACT_BEGIN",
                 "COMPACT_COMMIT", "SNAPSHOT", "MAX_PAYLOAD", "KIND_NAMES"):
        assert getattr(twal, name) == getattr(jwal, name), name
    assert twal._HEADER.format == jwal._HEADER.format
    recs = twal.replay(b)
    twal.rewrite(a, recs[2:])
    jwal.rewrite(b, jwal.replay(b)[2:])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_torn_tail_at_every_offset_stops_at_the_same_record(tmp_path):
    path = str(tmp_path / "wal.log")
    _write(twal, path, n=3, seed=1)
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.log")
    for end in range(len(data)):
        with open(cut, "wb") as f:
            f.write(data[:end])
        t = [tuple(r) for r in twal.replay(cut)]
        assert t == [tuple(r) for r in jwal.replay(cut)], end
        assert twal.verify(cut) == jwal.verify(cut), end
        assert twal.verify(cut)["status"] in ("ok", "torn_tail")
        torn = twal.verify(cut)["status"] == "torn_tail"
        with (pytest.raises(twal.WalCorrupt) if torn
              else contextlib.nullcontext()):
            list(twal.iter_records(cut, strict=True))


def test_verify_triage_ok_torn_corrupt_match_reference(tmp_path):
    path = str(tmp_path / "wal.log")
    _write(jwal, path, n=5, seed=2)
    assert twal.verify(path)["status"] == "ok"
    data = bytearray(open(path, "rb").read())
    torn = str(tmp_path / "torn.log")
    with open(torn, "wb") as f:
        f.write(data[:-3])
    assert twal.verify(torn) == jwal.verify(torn)
    assert twal.verify(torn)["status"] == "torn_tail"
    data[twal._HEADER.size + 1] ^= 0x10      # the first record's seq
    bad = str(tmp_path / "bad.log")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    assert twal.verify(bad) == jwal.verify(bad)
    assert twal.verify(bad)["status"] == "corrupt"
    assert twal.replay(bad) == []
    assert twal.verify(str(tmp_path / "missing.log"))["status"] == "ok"


def test_fault_hook_fires_before_any_byte_and_namespaces(tmp_path):
    path = str(tmp_path / "wal.log")

    def boom():
        raise RuntimeError("injected")

    log = twal.WriteAheadLog(path, fault_hook=boom)
    with pytest.raises(RuntimeError):
        log.append(twal.APPEND, b"x", 0)
    log.close()
    assert os.path.getsize(path) == 0
    root = str(tmp_path)
    for name in ("t0", "t1"):
        assert (twal.namespace_root(root, name)
                == jwal.namespace_root(root, name))
        os.makedirs(twal.namespace_root(root, name))
    assert twal.list_namespaces(root) == jwal.list_namespaces(root) == [
        "t0", "t1"]
    for bad in ("", "a/b", "..", "."):
        with pytest.raises(ValueError, match="bad namespace"):
            twal.namespace_root(root, bad)
