"""CPU tests of what the binary-quantised embedding cell adds to the
benchmark: its roofline arithmetic, the metrics it reports in each kind of
run, and its configuration's one cut of scale, the same in both files."""
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from knnbench import harness  # noqa: E402
from knnbench.test_knnbench_harness import (  # noqa: E402
    test_select_roofline_arithmetic as roofline_case)

SPEC = harness.load_spec(ROOT)
CELL = "binembed1024-10m.bulk4096"
CONFIG = "binembed1024-10m"


def test_select_roofline_arithmetic_binembed():
    """2·1024·4096·10^7 operations at 1,979 TOP/s, by the harness's own
    case: 42.388 ms, the operations' term, not the 0.383 ms of bytes."""
    roofline_case(CELL, 42.38811520970187)


def test_cell_reports_the_qps_group():
    """The end-to-end metrics of the tagspace and wordembed cells, and of
    their per-layer metrics the three that read the device's trace alone:
    not the CUDA-core tile share, nor the host and pruning metrics."""
    plain = {e["name"] for e in harness.cell_metrics(SPEC, CELL, False)}
    assert plain == {"qps", "search_p95_ms", "peak_device_gib", "setup_s"}
    traced = {e["name"] for e in harness.cell_metrics(SPEC, CELL, True)}
    assert traced == {"device_idle_share", "select_roofline",
                      "kernels_per_search"}


def test_configuration_cuts_only_n():
    """The source's 41M texts cut to 10M; the width, k and the store's
    process as published."""
    entry = next(c for c in SPEC["configs"] if c["name"] == CONFIG)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == cfg["reduced"] == ["n"]
    assert entry["source"] == cfg["source"]
    assert "41M" in cfg["source"] and "41M" in cfg["assumed"]["n"]
    assert (cfg["d"], cfg["k"], cfg["n"]) == (1024, 40, 10_000_000)
    cell = next(c for c in SPEC["workloads"] if c["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "bulk4096", 1)
