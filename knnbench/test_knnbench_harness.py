"""CPU tests of the benchmark's harness: the parts are found by name, the
reference equals a numpy brute force, the roofline arithmetic, the result
line, the trace reduction and the import guard. Small stores, plain K1/K2."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from knnbench import compare, devtrace, gen, harness, roofline  # noqa: E402

SPEC = harness.load_spec(ROOT)
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
SMALL = {"n": 6000, "batch": 128, "pool_queries": 512}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def np_hamming(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Bit by bit: unpack both sides and count differing bits."""
    qb = np.unpackbits(q.view(np.uint8), axis=1)
    xb = np.unpackbits(x.view(np.uint8), axis=1)
    return (qb[:, None, :] != xb[None, :, :]).sum(axis=2)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    entry, cfg, traffic = harness.cell_parts(SPEC, cell)
    assert cfg["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    assert (HERE / "configs" / f"{cfg['name']}.json").is_file()
    assert hasattr(harness.reference_of(cfg), "knn_distances")
    assert callable(harness.store_of(cfg).make)
    builder = harness.builder_of(cfg)
    assert all(callable(getattr(builder, f))
               for f in ("build", "search", "control"))
    assert "source" in traffic and "assumed" in traffic
    assert cfg["reduced"] == next(c["reduced"] for c in SPEC["configs"]
                                  if c["name"] == cfg["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_split_metric_takes_its_base_reader():
    run = type("Run", (), {"queries": 300, "window_s": 2.0})
    assert harness.reader("qps.cudacore").read(run) == 150.0


def test_cell_metrics_follow_workloads_key():
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"].append({"name": "only_one", "workloads": [CELLS[0]]})
    names = [m["name"] for m in harness.cell_metrics(spec, CELLS[1], True)]
    assert "only_one" not in names
    assert "only_one" in [m["name"] for m in
                          harness.cell_metrics(spec, CELLS[0], True)]


@pytest.mark.parametrize("d,k,n", [(64, 2, 300), (128, 4, 1000),
                                   (256, 16, 2500)])
def test_reference_equals_numpy_brute_force(d, k, n):
    g = torch.Generator().manual_seed(d + n)
    x = gen.random_words(g, n, d // 32)
    q = gen.random_words(g, 40, d // 32)
    want = np.sort(np_hamming(q.numpy(), x.numpy()), axis=1)[:, :k]
    ref = harness.reference_of({"reference": "hamming_bruteforce"})
    got = ref.knn_distances(q, x, k)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = torch.randint(0, n, (40, k), generator=g)
    full = np_hamming(q.numpy(), x.numpy())
    np.testing.assert_array_equal(ref.distances_of(q, x, ids).numpy(),
                                  np.take_along_axis(full, ids.numpy(), 1))


def test_reference_blocks_rows():
    ref = harness.reference_of({"reference": "hamming_bruteforce"})
    g = torch.Generator().manual_seed(5)
    x = gen.random_words(g, 3000, 8)
    q = gen.random_words(g, 70, 8)
    whole = ref.knn_distances(q, x, 16)
    old = ref.BLOCK_ELEMS
    try:
        ref.BLOCK_ELEMS = 64 * 700       # several row blocks a query block
        np.testing.assert_array_equal(ref.knn_distances(q, x, 16).numpy(),
                                      whole.numpy())
    finally:
        ref.BLOCK_ELEMS = old


@pytest.mark.parametrize("cell,least_ms", [
    ("tagspace-10m.bulk4096", 10.597028802425468),
    ("sift-10m.bulk4096", 5.298514401212734),
])
def test_select_roofline_arithmetic(cell, least_ms):
    _, cfg, traffic = harness.cell_parts(SPEC, cell)
    q, n, d, k = traffic["batch"], cfg["n"], cfg["d"], cfg["k"]
    assert roofline.search_ops(q, n, d) == 2 * d * q * n
    assert roofline.search_bytes(q, n, d, k) == (4 * (d // 32) * (n + q)
                                                 + 8 * q * k)
    assert roofline.least_seconds(q, n, d, k) * 1e3 == pytest.approx(
        least_ms, rel=1e-12)
    # the operations bound every cell
    assert (roofline.search_bytes(q, n, d, k) / roofline.HBM_BYTES_PER_S
            < 0.2 * least_ms / 1e3)
    run = type("Run", (), {"batch": q, "n": n, "d": d, "k": k, "trace": {
        "kernels": 10, "kernel_s": 2 * least_ms / 1e3, "searches": 1}})
    assert harness.reader("select_roofline").read(run) == pytest.approx(50.0)


def test_store_and_pool_follow_the_seed():
    _, cfg, traffic = harness.cell_parts(SPEC, CELLS[0])
    make = harness.store_of(cfg).make
    a = make(cfg, 2 ** 31 + 9, "cpu", 500)
    b = make(cfg, 2 ** 31 + 9, "cpu", 500)
    c = make(cfg, 2 ** 31 + 10, "cpu", 500)
    assert torch.equal(a.codes, b.codes)
    assert not torch.equal(a.codes, c.codes)
    assert a.codes.shape == c.codes.shape == (500, cfg["d"] // 32)
    pa = gen.make_pool(traffic, a, 2 ** 31 + 9, pool_queries=1000)
    assert torch.equal(pa, gen.make_pool(traffic, b, 2 ** 31 + 9, 1000))
    assert pa.shape[0] % traffic["batch"] == 0 and pa.device.type == "cpu"
    ba = gen.Batches(pa, 100, 3)
    assert sorted(ba.order) == list(range(pa.shape[0] // 100))
    assert torch.equal(ba(len(ba.order)), ba(0))


def test_clustered_flip_rate():
    g = torch.Generator().manual_seed(1)
    centres = torch.zeros((1, 8), dtype=torch.int32)
    clustered = harness.store_of({"codes": {"kind": "clustered"}}).clustered
    codes = clustered(g, 4000, centres, 4)
    ones = np.unpackbits(codes.numpy().view(np.uint8)).mean()
    assert abs(ones - 1 / 16) < 0.005


@pytest.mark.parametrize("kind", ["store", "uniform"])
def test_pool_kinds(kind):
    _, cfg, _ = harness.cell_parts(SPEC, CELLS[0])
    store = harness.store_of(cfg).make(cfg, 4, "cpu", 300)
    pool = gen.make_pool({"batch": 64, "pool_queries": 200,
                          "queries": kind}, store, 4)
    assert pool.shape == (192, cfg["d"] // 32)
    # queries of the store's process lie near its centres, uniform ones not
    dist = np.unpackbits((pool[:, None, :] ^ store.centres[None]).numpy()
                         .view(np.uint8), axis=2).sum(axis=2).min(axis=1)
    near = (dist < cfg["d"] // 4).mean()
    assert near == 1.0 if kind == "store" else near == 0.0


def test_unknown_pool_kind():
    _, cfg, _ = harness.cell_parts(SPEC, CELLS[0])
    store = harness.store_of(cfg).make(cfg, 4, "cpu", 300)
    with pytest.raises(ValueError, match="queries kind"):
        gen.make_pool({"batch": 64, "pool_queries": 64, "queries": "x"},
                      store, 4)


def test_malformed_rows():
    dd = np.array([[1, 2, 3], [3, 2, 1], [0, 1, 9], [0, 0, 0]])
    ii = np.array([[0, 1, 2], [0, 1, 2], [0, 1, 2], [4, 4, 5]])
    bad = compare.malformed_rows(dd, ii, d=8, n=10, k=3)
    assert bad.tolist() == [False, True, True, True]


def test_trace_summary():
    raw = [
        (devtrace.WINDOW, False, 0, 100, 1),
        (devtrace.SEARCH, False, 0, 40, 1), ("aten::cat", False, 2, 8, 1),
        (devtrace.TO_HOST, False, 40, 60, 1),
        (devtrace.SEARCH, False, 60, 95, 1),
        ("k1", True, 10, 30, 7), ("k2", True, 25, 50, 7),
        ("Memcpy DtoH", True, 50, 55, 7), ("k1", True, 70, 90, 7),
        ("other thread", False, 0, 100, 2),
        # the profiler's device-side range of a host span
        (devtrace.SEARCH, True, 0, 99, 7),
    ]
    events = devtrace.classify(raw)
    assert [e.kind for e in events if e.kind != devtrace.HOST] == [
        devtrace.KERNEL, devtrace.KERNEL, devtrace.COPY, devtrace.KERNEL]
    s = devtrace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(65e-9)        # 10-55, 70-90
    assert s["kernels"] == 3 and s["device_events"] == 4
    assert s["kernel_s"] == pytest.approx(65e-9)      # 20 + 25 + 20
    assert s["searches"] == 2
    assert dict(s["device_ops"]) == pytest.approx(
        {"k1": 40e-9, "k2": 25e-9, "Memcpy DtoH": 5e-9})
    # gaps 0-10 (mid 5: inside aten::cat), 55-70 (mid 62: a search),
    # 90-100 (mid 95: the search's end)
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::cat": 10e-9, devtrace.SEARCH: 25e-9})
    assert devtrace.summarize(events[1:]) is None


def _keys_in_order(line: dict):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    line, lines = harness.run_cell(SPEC, cell, 3_000_000_001, 0.2, trace,
                                   device="cpu", sizes=SMALL)
    _keys_in_order(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, trace)}
    # on the CPU nothing reads a device metric or the card's memory
    assert set(line["metrics"]) == (set() if trace
                                    else want - {"peak_device_gib"})
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert lines == compare.lines({k: v["value"]
                                   for k, v in line["checks"].items()})
    json.dumps(line)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_import_guard(path):
    names = _top_level_imports(path)
    assert not names & FORBIDDEN, names
    if "references" in path.parts:
        assert "repro_torch" not in names and "knnbench" not in names


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core.engine", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jaxlib.xla_client", "flax", "jax"]) == [
            "flax", "jax", "jaxlib", "repro"]


def _run_py(cwd: Path):
    """run.py in a copy of the benchmark at ``cwd``, which writes its
    caches there and not into this tree."""
    shutil.copy(ROOT / "BENCHMARK.json", cwd)
    shutil.copytree(HERE, cwd / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "knnbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


def test_run_refuses_without_the_program(tmp_path):
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "program" in out.stderr


def test_run_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is for hosts without")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "repro_torch").symlink_to(ROOT / "src"
                                                  / "repro_torch")
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
