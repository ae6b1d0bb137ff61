"""PyTorch port vs the JAX reference: block geometry and the measured
autotune cache (repro_torch.kernels.tuning). Pure host arithmetic — the
two packages must tile every store identically and share one cache file
format."""
import json

import pytest

from repro.kernels import tuning as jtuning
from repro_torch.kernels import tuning as ttuning

SHAPES = [(1, 100, 1, 9), (256, 1 << 17, 8, 257), (64, 4096, 4, 129),
          (7, 50, 2, 33), (4096, 1 << 20, 8, 257), (4096, 1 << 24, 8, 257),
          (33, 4097, 5, 161), (8, 10, 1, 5000), (3, 37, 2, 65)]
BACKENDS = ["cpu", "gpu", "tpu", "unknown"]


@pytest.fixture
def empty_caches(monkeypatch):
    monkeypatch.setattr(jtuning, "_CACHE", jtuning.AutotuneCache(""))
    monkeypatch.setattr(ttuning, "_CACHE", ttuning.AutotuneCache(""))


@pytest.mark.parametrize("backend", BACKENDS)
def test_topk_blocks_match_reference(empty_caches, backend):
    for shape in SHAPES:
        assert (ttuning.topk_blocks(*shape, backend=backend)
                == jtuning.topk_blocks(*shape, backend=backend)), shape
        assert (ttuning._topk_blocks_default(*shape, backend)
                == jtuning._topk_blocks_default(*shape, backend)), shape


@pytest.mark.parametrize("bucket_rows", [0, 100, 256, 5000])
def test_layout_and_distance_blocks_match_reference(empty_caches,
                                                    bucket_rows):
    for backend in BACKENDS:
        for shape in SHAPES:
            assert (ttuning.layout_blocks(*shape, bucket_rows, backend=backend)
                    == jtuning.layout_blocks(*shape, bucket_rows,
                                             backend=backend))
            Q, N, W, _ = shape
            assert (ttuning.distance_blocks(Q, N, W, backend=backend)
                    == jtuning.distance_blocks(Q, N, W, backend=backend))


@pytest.mark.parametrize("path", ["fused", "fused_scan", "composite",
                                  "counting"])
def test_cost_hints_match_reference(empty_caches, path):
    for backend in ("cpu", "gpu"):
        for chunk, bucket_rows in ((0, 0), (4096, 0), (0, 256)):
            for shape in SHAPES:
                kw = dict(path=path, chunk=chunk, bucket_rows=bucket_rows,
                          backend=backend)
                assert (ttuning.cost_hints(*shape, **kw)
                        == jtuning.cost_hints(*shape, **kw)), (shape, kw)


def test_main_path_gpu_geometry(empty_caches):
    """Q=4096, N=2^20, W=8, bins=257 on the card: 32 x 257 int32 shared
    histogram per CTA, 1017 data blocks of 1032 rows."""
    assert ttuning.topk_blocks(4096, 1 << 20, 8, 257, backend="gpu") == (
        32, 1032, 24)


def test_cache_file_is_shared_between_packages(tmp_path, empty_caches):
    """An entry either package measures is read back by the other, under
    the same key, and both write the same JSON."""
    entry = {"bq": 16, "bn": 2048, "sub": 32, "us": 12.5}
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    tc, jc = ttuning.AutotuneCache(str(tp)), jtuning.AutotuneCache(str(jp))
    for c in (tc, jc):
        c.put("gpu", "topk", 4096, 1 << 20, 8, 257, entry)
    assert tp.read_text() == jp.read_text()
    assert (jtuning.AutotuneCache(str(tp)).get("gpu", "topk", 4000,
                                               1_000_000, 8, 300) == entry)
    assert (ttuning.AutotuneCache(str(jp)).get("gpu", "topk", 4000,
                                               1_000_000, 8, 300) == entry)
    assert len(ttuning.AutotuneCache(str(jp))) == 1
    assert (ttuning.AutotuneCache.key("gpu", "topk", 33, 4097, 5, 161)
            == jtuning.AutotuneCache.key("gpu", "topk", 33, 4097, 5, 161))


def test_measured_entry_overrides_default_identically(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({jtuning.AutotuneCache.key(
        "gpu", "topk", 64, 4096, 4, 129): {"bq": 13, "bn": 1000, "sub": 20}}))
    monkeypatch.setattr(jtuning, "_CACHE", jtuning.AutotuneCache(str(path)))
    monkeypatch.setattr(ttuning, "_CACHE", ttuning._CACHE)   # restored after
    cache = ttuning.configure(str(path))
    assert ttuning.autotune_cache() is cache
    got = ttuning.topk_blocks(64, 4096, 4, 129, backend="gpu")
    assert got == jtuning.topk_blocks(64, 4096, 4, 129, backend="gpu")
    assert got == (16, 1008, 24)                     # sanitized onto tiles
    for backend in ("gpu", "cpu"):
        assert (ttuning.hint_source(backend, "topk", 64, 4096, 4, 129)
                == jtuning.hint_source(backend, "topk", 64, 4096, 4, 129))
    assert ttuning.hint_source("gpu", "topk", 64, 4096, 4, 129) == "measured"


def test_corrupt_or_missing_cache_is_empty(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert len(ttuning.AutotuneCache(str(bad))) == 0
    assert len(ttuning.AutotuneCache(str(tmp_path / "missing.json"))) == 0
    mem = ttuning.AutotuneCache("")
    mem.put("gpu", "topk", 1, 1, 1, 1, {"bq": 8, "bn": 8, "sub": 8})
    assert len(mem) == 1 and not list(tmp_path.glob("*.tmp"))
    mem.clear()
    assert len(mem) == 0
