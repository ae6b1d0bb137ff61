"""CPU tests of what the kNN-WordEmbed cell adds to the benchmark: its
roofline arithmetic, and the reader of ``cudacore_tile_share`` (the share
of K1's and K2's tiles the CUDA-core kernels scored): its arithmetic on
the program's counters, its 0.0 where no tile took the CUDA cores, no
reading from a program without the counters, and its entry."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from knnbench import harness, program_spans  # noqa: E402
from knnbench.test_knnbench_harness import (  # noqa: E402
    test_select_roofline_arithmetic as roofline_case)
from repro_torch import spans  # noqa: E402

SPEC = harness.load_spec(ROOT)
CELL = "wordembed-10m.bulk4096"
SHARE = "cudacore_tile_share"
READ = harness.reader(SHARE).read


def test_select_roofline_arithmetic_wordembed():
    """2·64·4096·10^7 operations at 1,979 TOP/s, by the harness's own
    case."""
    roofline_case(CELL, 2.649257200606367)


def _recorded(monkeypatch, counters, searches=3):
    snap = {"spans": {program_spans.SEARCH: {"count": searches}},
            "counters": counters}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return SimpleNamespace(trace={"device_events": 7})


@pytest.mark.parametrize("counters,share", [
    # every launch on the CUDA cores (d=64), on the tensor cores (d=128)
    ({"k1.tiles": 800, "k2.tiles": 800, "k1.tiles_cudacore": 800,
      "k2.tiles_cudacore": 800, "k2.tiles_pruned": 100}, 100.0),
    ({"k1.tiles": 800, "k2.tiles": 800, "k1.tiles_cudacore": 0,
      "k2.tiles_cudacore": 0}, 0.0),
    # the counters unwritten: no tile took the CUDA cores
    ({"k1.tiles": 800, "k2.tiles": 800}, 0.0),
    # a mix of launches, and K1 alone on the CUDA cores
    ({"k1.tiles": 300, "k2.tiles": 100, "k1.tiles_cudacore": 100,
      "k2.tiles_cudacore": 60}, 40.0),
    ({"k1.tiles": 200, "k2.tiles": 200, "k1.tiles_cudacore": 200}, 50.0),
])
def test_share_is_the_counters_ratio(monkeypatch, counters, share):
    value = READ(_recorded(monkeypatch, counters))
    assert value == pytest.approx(share, rel=1e-15, abs=0)
    assert isinstance(value, float)


def test_no_reading_without_the_counters(monkeypatch):
    """A program that counts K2's tiles and not K1's (one without these
    counters) gives no reading; nor does a run without device events."""
    assert READ(_recorded(monkeypatch, {"k2.tiles": 800,
                                        "k2.tiles_pruned": 8})) is None
    assert READ(_recorded(monkeypatch, {})) is None
    assert READ(SimpleNamespace(trace={"device_events": 0})) is None
    assert READ(SimpleNamespace(trace=None)) is None


def test_names_match_the_program():
    mod = harness.reader(SHARE)
    for name in ("K1_TILES", "K1_TILES_CUDACORE", "K2_TILES_CUDACORE"):
        assert getattr(mod, name) == getattr(spans, name)


@pytest.mark.parametrize("name,cells", [
    (SHARE, ["tagspace-10m.bulk4096", CELL]),
    (SHARE + ".cudacore", ["sift-10m.bulk4096"]),
])
def test_share_entry(name, cells):
    """Read in each of its cells, from the profiler's trace run, moving
    the qps of its group, which each of its cells reports; ``.cudacore``
    takes the base reader."""
    m = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert m["workloads"] == cells
    assert (m["unit"], m["better"], m["source"], m["layer"]) == (
        "%", "lower", "device_trace", "K1/K2")
    assert m["moves"] == "qps" + name[len(SHARE):]
    for cell in cells:
        assert m["moves"] in {e["name"] for e in
                              harness.cell_metrics(SPEC, cell, False)}
    assert not (HERE / "metrics" / f"{SHARE}.cudacore.py").exists()


def test_cell_reports_the_qps_group():
    """The cell's six runs spread wider than half of ``qps.cudacore``'s
    bound, so it reports ``qps`` and ``search_p95_ms`` and their group's
    per-layer metrics."""
    plain = {e["name"] for e in harness.cell_metrics(SPEC, CELL, False)}
    assert plain == {"qps", "search_p95_ms", "peak_device_gib", "setup_s"}
    traced = {e["name"] for e in harness.cell_metrics(SPEC, CELL, True)}
    assert traced == {"device_idle_share", "select_roofline",
                      "kernels_per_search", SHARE}
