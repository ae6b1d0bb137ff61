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


@pytest.mark.parametrize("backend", BACKENDS)
def test_topk_candidates_match_reference(empty_caches, backend):
    for shape in SHAPES:
        assert (ttuning.topk_candidates(*shape, backend=backend)
                == jtuning.topk_candidates(*shape, backend=backend)), shape


def test_approx_blocks_measured_entry_matches_reference(empty_caches):
    """A measured approx entry overrides both packages' defaults alike, on
    every backend row; the gpu default is the port's own row."""
    for be in ("cpu", "tpu", "gpu"):
        for pkg in (ttuning, jtuning):
            pkg._CACHE.put(be, "approx", 64, 1 << 16, 4, 1,
                           {"bn": 999, "us": 5.0}, persist=False)
        assert (ttuning.approx_blocks(64, 1 << 16, 4, backend=be)
                == jtuning.approx_blocks(64, 1 << 16, 4, backend=be) == 1024)
        assert ttuning.hint_source(be, "approx", 64, 1 << 16, 4, 1) == \
            "measured"
    assert ttuning.approx_blocks(64, 1 << 20, 4, backend="gpu") == 1 << 15
    assert ttuning.approx_blocks(64, 1 << 20, 4, backend="cpu") == 8192


def test_measure_with_fake_timer_matches_reference(tmp_path, monkeypatch):
    """The same fake clock picks the same winner in both packages, and
    each writes an entry the other's cache reads back."""
    cands = [{"bq": 16, "bn": 256, "sub": 64},
             {"bq": 16, "bn": 512, "sub": 64},
             {"bq": 16, "bn": 1024, "sub": 64},
             {"bq": 0, "bn": 0, "sub": 0}]
    out = {}
    for name, pkg in (("t", ttuning), ("j", jtuning)):
        monkeypatch.setattr(pkg, "_CACHE",
                            pkg.AutotuneCache(str(tmp_path / f"{name}.json")))
        t = [0.0]
        calls = []

        def runner(cand):
            if not cand["bn"]:
                raise ValueError("not a shape")
            calls.append(dict(cand))
            t[0] += 1e-6 if cand["bn"] == 512 else 1e-3

        out[name] = pkg.measure(runner, cands, backend="gpu", kind="topk",
                                Q=64, N=1 << 15, W=4, lanes=129,
                                timer=lambda: t[0])
        assert len(calls) == 4 * 3
        assert pkg.topk_blocks(64, 1 << 15, 4, 129, backend="gpu") == (
            16, 512, 64)
    assert out["t"] == out["j"] and out["t"]["bn"] == 512
    assert ((tmp_path / "t.json").read_text()
            == (tmp_path / "j.json").read_text())
    with pytest.raises(ValueError, match="no candidate"):
        ttuning.measure(lambda c: 1 / 0, cands[:1], backend="gpu",
                        kind="topk", Q=1, N=1, W=1, lanes=1, persist=False)
