"""PyTorch port vs the JAX reference: block geometry
(repro_torch.kernels.topk_select.geometry for K1/K2,
repro_torch.kernels.tuning for the rest). Pure host arithmetic — the two
packages must tile every store identically on the "gpu" and "cpu" rows,
and the benchmark's cells keep the tiles they have run under."""
import pytest

from repro.kernels import tuning as jtuning
from repro_torch.kernels import topk_select as tsel
from repro_torch.kernels import tuning as ttuning

SHAPES = [(1, 100, 1, 9), (256, 1 << 17, 8, 257), (64, 4096, 4, 129),
          (7, 50, 2, 33), (4096, 1 << 20, 8, 257), (4096, 1 << 24, 8, 257),
          (33, 4097, 5, 161), (8, 10, 1, 5000), (3, 37, 2, 65)]
BACKENDS = ["cpu", "gpu"]
# the reference's TPU sub-step is not part of the port's geometry, nor its
# one-hot footprint or autotune cache
REF_ONLY_HINTS = ("sub", "onehot_bytes", "hint_source")


@pytest.fixture
def empty_caches(monkeypatch):
    monkeypatch.setattr(jtuning, "_CACHE", jtuning.AutotuneCache(""))


def ref_hints(hints: dict) -> dict:
    return {k: v for k, v in hints.items() if k not in REF_ONLY_HINTS}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_geometry_matches_reference(empty_caches, shape, backend):
    assert (tsel.geometry(*shape, backend)
            == jtuning.topk_blocks(*shape, backend=backend)[:2])
    with pytest.raises(ValueError, match="no K1/K2 geometry"):
        tsel.geometry(*shape, "tpu")


@pytest.mark.parametrize("shape,want", [
    ((4096, 10_000_000, 8, 257), (32, 9768)),     # tagspace-10m
    ((4096, 10_000_000, 4, 129), (32, 9800)),     # sift-10m
    ((4096, 10_000_000, 2, 65), (32, 9840)),      # wordembed-10m
    ((4096, 1 << 20, 8, 257), (32, 1032)),        # the main shape, N = 2^20
], ids=["tagspace", "sift", "wordembed", "n2p20"])
def test_cell_geometry_on_the_card(shape, want):
    """The benchmark's cells on the card: bq = 32 (a 32 x lanes int32
    shared histogram per K1 CTA) and 128 query blocks split into 16 runs."""
    Q, N = shape[:2]
    bq, bn = tsel.geometry(*shape, "gpu")
    assert (bq, bn) == want
    assert tsel.default_runs(-(-Q // bq), -(-N // bn)) == 16


@pytest.mark.parametrize("bucket_rows", [0, 100, 256, 5000])
def test_layout_and_distance_blocks_match_reference(empty_caches,
                                                    bucket_rows):
    for backend in BACKENDS:
        for shape in SHAPES:
            assert (tsel.geometry(*shape, backend, bucket_rows)
                    == jtuning.layout_blocks(*shape, bucket_rows,
                                             backend=backend)[:2])
            Q, N, W, _ = shape
            assert (ttuning.distance_blocks(Q, N, W, backend=backend)
                    == jtuning.distance_blocks(Q, N, W, backend=backend))


@pytest.mark.parametrize("path", ["fused", "fused_scan", "composite",
                                  "counting"])
def test_cost_hints_match_reference(empty_caches, path):
    for backend in BACKENDS:
        for chunk, bucket_rows in ((0, 0), (4096, 0), (0, 256)):
            for shape in SHAPES:
                kw = dict(path=path, chunk=chunk, bucket_rows=bucket_rows,
                          backend=backend)
                assert (ttuning.cost_hints(*shape, **kw)
                        == ref_hints(jtuning.cost_hints(*shape, **kw))), (
                            shape, kw)
