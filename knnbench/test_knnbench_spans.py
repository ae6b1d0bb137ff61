"""CPU tests of the readers of the program's spans and K2 counter
(``program_spans.py`` and its five metrics): a value on a traced run with
device events, None without, and the four host times adding up to the
search's. Tiny store, plain K1/K2, searches under the CPU profiler."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from knnbench import harness, program_spans  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core.engine import KNNEngine  # noqa: E402

SPEC = harness.load_spec(ROOT)
HOST = ["engine_host_ms", "glue_host_ms", "layout_host_ms", "launch_host_ms"]
READERS = HOST + ["k2_pruned_share"]
CELL = {"": "tagspace-10m.bulk4096", ".cudacore": "sift-10m.bulk4096"}
SEARCHES = 3


def _run(device_events=7):
    return SimpleNamespace(trace={"device_events": device_events})


@pytest.fixture
def recorded():
    """The recorder after SEARCHES profiled searches over a clustered
    store with its layout."""
    rng = np.random.default_rng(0)
    centres = rng.integers(0, 1 << 32, (8, 8), dtype=np.uint32)
    flips = rng.integers(0, 1 << 32, (2048, 8), dtype=np.uint32)
    flips &= rng.integers(0, 1 << 32, (2048, 8), dtype=np.uint32)
    flips &= rng.integers(0, 1 << 32, (2048, 8), dtype=np.uint32)
    codes = centres[np.arange(2048) % 8] ^ flips
    eng = KNNEngine(torch.from_numpy(codes.view(np.int32)), 256).with_layout()
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(SEARCHES):
            eng.search(eng.layout.codes[64 * i:64 * i + 64], 16)
    yield spans.snapshot()
    spans.reset()


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run(name, recorded):
    value = harness.reader(name).read(_run())
    assert value is not None and value >= 0
    if name != "k2_pruned_share":
        assert value > 0


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_device_events(name, recorded):
    read = harness.reader(name).read
    assert read(_run(device_events=0)) is None
    assert read(SimpleNamespace(trace=None)) is None
    spans.reset()
    assert read(_run()) is None                # no search recorded


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_the_recorder(
        name, recorded, monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.reader(name).read(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_cudacore_name_takes_the_base_reader(name, recorded):
    assert not (HERE / "metrics" / f"{name}.cudacore.py").exists()
    run = _run()
    assert (harness.reader(f"{name}.cudacore").read(run)
            == harness.reader(name).read(run))


def test_host_metrics_add_up_to_the_search(recorded):
    total = sum(harness.reader(n).read(_run()) for n in HOST)
    search = recorded["spans"][program_spans.SEARCH]
    assert search["count"] == SEARCHES
    assert total == pytest.approx(search["inclusive_ns"] / SEARCHES / 1e6,
                                  rel=1e-12)


def test_pruned_share_is_the_counters_ratio(recorded):
    c = recorded["counters"]
    assert c[program_spans.K2_TILES] > 0
    assert harness.reader("k2_pruned_share").read(_run()) == pytest.approx(
        100.0 * c[program_spans.K2_TILES_PRUNED] / c[program_spans.K2_TILES])


def test_names_match_the_program():
    for name in ("SEARCH", "PLAN", "EXECUTE", "K1", "K2", "ORIGINAL_IDS",
                 "K2_TILES", "K2_TILES_PRUNED"):
        assert getattr(program_spans, name) == getattr(spans, name)


@pytest.mark.parametrize("group", sorted(CELL))
@pytest.mark.parametrize("name", READERS)
def test_benchmark_entry(name, group):
    """Each metric's entry: read only in its group's cell, from the
    profiler's trace run, moving that group's end-to-end metric."""
    m = next(m for m in SPEC["per_layer"] if m["name"] == name + group)
    assert m["workloads"] == [CELL[group]]
    assert m["source"] == "device_trace"
    moves = "qps" if name == "k2_pruned_share" else "search_p95_ms"
    assert m["moves"] == moves + group
    assert any(e["name"] == m["moves"] and CELL[group] in e["workloads"]
               for e in SPEC["end_to_end"])
