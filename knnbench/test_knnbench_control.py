"""The comparison that decides ``correct`` has to fail the control and each
fault the cells can have, driven through a whole run on the CPU at a small
size (the chip check is skipped, the timed path broken underneath):

* the control: the builder's ``control`` in place of its search (the
  program's approximate tier, ``builders/hamming_prefix.py``);
* an answer altered where it is produced: the k-th distance, or the k-th
  id, of every row that ``ops.hamming_topk`` returns;
* half of the batch left out: ``ops.hamming_topk`` answers the first half
  of the queries and repeats those answers for the rest.

A cell has no state that a step carries and no exchange between chips, so
those faults do not apply.
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from knnbench import harness  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SPEC = harness.load_spec(ROOT)
CELLS = [c["name"] for c in SPEC["workloads"]]
SMALL = {"n": 6000, "batch": 128, "pool_queries": 512}
SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)
REAL_TOPK = ops.hamming_topk


def _run(cell, seed, **kw):
    return harness.run_cell(SPEC, cell, seed, 0.1, False, device="cpu",
                            sizes=SMALL, **kw)[0]


def _kth_dist(*a, **kw):
    dd, ii = REAL_TOPK(*a, **kw)
    dd = dd.clone()
    dd[:, -1] += 1
    return dd, ii


def _kth_id(*a, **kw):
    dd, ii = REAL_TOPK(*a, **kw)
    ii = ii.clone()
    ii[:, -1] = (ii[:, -1] + 1) % a[1].shape[0]
    return dd, ii


def _half_batch(q, *a, **kw):
    half = q.shape[0] // 2
    dd, ii = REAL_TOPK(q[:half], *a, **kw)
    rest = q.shape[0] - half
    return torch.cat([dd, dd[:rest]]), torch.cat([ii, ii[:rest]])


FAULTS = {"kth_distance_altered": _kth_dist, "kth_id_altered": _kth_id,
          "half_batch_left_out": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell, SEEDS[0])
    assert line["correct"] is True
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    line = _run(cell, seed, control=True)
    assert line["correct"] is False
    assert line["checks"]["sample_dist_rows_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(ops, "hamming_topk", FAULTS[fault])
    line = _run(cell, SEEDS[1])
    assert line["correct"] is False
