"""CPU tests of ``repro_torch.spans``: off without a profiler (one shared
null context, nothing counted, no K2 counter), on under
``torch.profiler.profile`` (the six spans of a search nested under
``repro_torch.search``, self times that add up), and K2's pruned-tile count
equal to ``hamming_topk(return_stats=True)``'s mirror. Tiny stores, plain
K1/K2."""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.engine import KNNEngine
from repro_torch.kernels import ops
from repro_torch.kernels import topk_select as tsel

SIX = (spans.SEARCH, spans.PLAN, spans.EXECUTE, spans.K1, spans.K2,
       spans.ORIGINAL_IDS)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _codes(kind: str, n: int, d: int, seed: int, clusters: int = 16):
    """(n, d/32) int32 codes: uniform bits, or ``clusters`` runs of
    consecutive rows, each its centre with about 1/16 of the bits flipped."""
    rng = np.random.default_rng(seed)
    w = d // 32
    if kind == "uniform":
        return torch.from_numpy(rng.integers(0, 1 << 32, (n, w),
                                             dtype=np.uint32).view(np.int32))
    centres = rng.integers(0, 1 << 32, (clusters, w), dtype=np.uint32)
    flips = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    for _ in range(4):      # four ANDed words: each bit set with p = 1/16
        flips &= rng.integers(0, 1 << 32, (n, w), dtype=np.uint32)
    rows = centres[np.arange(n) * clusters // n] ^ flips
    return torch.from_numpy(rows.view(np.int32))


@pytest.fixture
def engine():
    spans.reset()
    yield KNNEngine(_codes("clustered", 3000, 256, 0), 256).with_layout()
    spans.reset()


def test_off_without_a_profiler(engine, monkeypatch):
    """No profiler: the shared null context, no record_function built, no
    counter written, a null K2 counter handed down; the answer unchanged."""
    assert not spans.recording()
    assert spans.span(spans.SEARCH) is spans.span("anything else")
    assert spans.device_counter("cpu") is None
    built, handed = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: built.append(a))
    plain = tsel.hamming_emit_plain

    def emit_plain(*args):
        handed.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(tsel, "hamming_emit_plain", emit_plain)
    q = engine.layout.codes[:40]
    dd, ii = engine.search(q, 8)
    spans.count(spans.K2_TILES, 5)
    assert built == [] and handed == [None]
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    monkeypatch.undo()
    with _profile():
        d2, i2 = engine.search(q, 8)
    assert torch.equal(dd, d2) and torch.equal(ii, i2)


def test_flag_flips_under_the_profiler():
    assert not spans.recording()
    with _profile():
        assert spans.recording()
        assert spans.device_counter("cpu") is spans.device_counter("cpu")
    assert not spans.recording()
    spans.reset()


def test_search_spans_nest_under_search(engine):
    q = engine.layout.codes[100:164]
    calls = 3
    with _profile() as prof:
        for _ in range(calls):
            engine.search(q, 16)
    events = [e for e in prof.events() if e.name in SIX]
    assert {e.name for e in events} == set(SIX)
    for e in events:
        if e.name == spans.SEARCH:
            continue
        up = e.cpu_parent
        while up is not None and up.name != spans.SEARCH:
            up = up.cpu_parent
        assert up is not None, e.name
    snap = spans.snapshot()
    assert {n: s["count"] for n, s in snap["spans"].items()} == dict.fromkeys(
        SIX, calls)


def test_self_times_add_up(engine):
    """Plan and execute are the search's only children; K1, K2 and the id
    map the executor's: the self times are the inclusive ones less them,
    to the nanosecond."""
    with _profile():
        engine.search(engine.layout.codes[:64], 16)
        engine.search(engine.layout.codes[500:520], 4)
    s = {n: v for n, v in spans.snapshot()["spans"].items()}
    incl = {n: v["inclusive_ns"] for n, v in s.items()}
    assert s[spans.SEARCH]["self_ns"] == (incl[spans.SEARCH]
                                          - incl[spans.PLAN]
                                          - incl[spans.EXECUTE])
    assert s[spans.EXECUTE]["self_ns"] == (incl[spans.EXECUTE]
                                           - incl[spans.K1] - incl[spans.K2]
                                           - incl[spans.ORIGINAL_IDS])
    for leaf in (spans.PLAN, spans.K1, spans.K2, spans.ORIGINAL_IDS):
        assert s[leaf]["self_ns"] == incl[leaf] > 0


@pytest.mark.parametrize("store", ["clustered", "uniform"])
@pytest.mark.parametrize("d", [128, 256])
def test_k2_pruned_count_equals_return_stats(d, store):
    x = _codes(store, 4096, d, 1)
    # query block b (16 rows) from cluster 5b, a tile (256 rows) one
    # cluster: on the clustered store the other clusters' tiles hold no
    # winner of the block
    i = torch.arange(48)
    q = x[i // 16 * 5 * 256 + i % 16].contiguous()
    spans.reset()
    with _profile():
        dd, ii, st = ops.hamming_topk(q, x, 8, d + 1, bq=16, bn=256,
                                      sub=64, return_stats=True)
    c = spans.snapshot()["counters"]
    spans.reset()
    assert c[spans.K2_TILES] == st["blocks_total"] == 3 * 16
    assert c[spans.K2_TILES_PRUNED] == int(st["blocks_skipped"])
    if store == "clustered":
        assert c[spans.K2_TILES_PRUNED] > 0
    d0, i0 = ops.hamming_topk(q, x, 8, d + 1, bq=16, bn=256, sub=64)
    assert torch.equal(dd, d0) and torch.equal(ii, i0)


def test_k2_launch_gets_a_null_counter_without_one(monkeypatch):
    """The CUDA route's launch (its library stood in for) gets 0 for the
    counter without one and the counter's address with one."""
    args = []
    lib = SimpleNamespace(topk_emit_launch=lambda *a: args.append(a) or 0)
    monkeypatch.setattr(tsel, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    launches = tsel.hamming_emit_kernel.launches
    q, x = _codes("uniform", 16, 256, 2), _codes("uniform", 512, 256, 3)
    ones = torch.ones((1, 2), dtype=torch.int32)
    r = torch.full((16,), 100, dtype=torch.int32)
    base = torch.zeros((16, 1), dtype=torch.int32)
    operands = (q, x, ones, ones, r, base, base, 512, 0, 257, 8, 16, 256)
    tsel._k2_cuda(*operands, None)
    counter = torch.zeros((), dtype=torch.int64)
    tsel._k2_cuda(*operands, counter)
    tsel.hamming_emit_kernel.launches = launches
    assert [a[9] for a in args] == [0, counter.data_ptr()]
    assert len(args[0]) == len(tsel.ARGTYPES["topk_emit_launch"])


def test_k2_cost_charges_the_counter():
    q, x = torch.zeros((64, 8), dtype=torch.int32), torch.zeros(
        (1024, 8), dtype=torch.int32)
    tiles = torch.zeros((1, 1), dtype=torch.int32)
    r = torch.zeros(64, dtype=torch.int32)
    b = torch.zeros((64, 1), dtype=torch.int32)
    cost = lambda *p: tsel.hamming_emit_cost(q, x, tiles, tiles, r, b, b,
                                             1024, 0, 257, 16, 64, 1024, *p)
    assert cost(torch.zeros((), dtype=torch.int64))[1] == cost(None)[1] + 8


def test_a_thread_the_profiler_does_not_record_records_nothing():
    """The profiler records the thread that started it: another thread's
    spans stay off, and leave the recording thread's totals alone."""
    spans.reset()
    seen = []

    def work():
        seen.append(spans.recording())
        with spans.span("outer"):
            spans.count("n", 1)

    with _profile():
        with spans.span("outer"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive() and seen == [False]
    snap = spans.snapshot()
    spans.reset()
    assert snap["counters"] == {}
    outer = snap["spans"]["outer"]
    assert outer["count"] == 1 and outer["self_ns"] == outer["inclusive_ns"]
