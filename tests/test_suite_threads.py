"""The suite's worker processes each run one torch intra-op thread (the
root ``conftest.py``), in ``tests/`` and in ``knnbench/`` alike. Without
it six workers oversubscribe the host's cores and the suite outgrows its
clock."""
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
# a test of knnbench/ that takes milliseconds
KNNBENCH_TEST = ("knnbench/test_knnbench_harness.py::"
                 "test_forbidden_modules_compare_whole_names")

_PROBE = """
import sys, pytest, torch
seen = []
class Probe:
    def pytest_runtest_call(self, item):
        seen.append(torch.get_num_threads())
rc = pytest.main(["-q", "-p", "no:cacheprovider", {test!r}],
                 plugins=[Probe()])
print("THREADS", seen)
sys.exit(int(rc))
"""


def test_one_torch_thread_in_a_test():
    assert torch.get_num_threads() == 1


def test_one_torch_thread_in_a_knnbench_test():
    """A fresh pytest run of one ``knnbench/`` test: its process starts at
    torch's default thread count, and the root conftest alone sets one."""
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(test=KNNBENCH_TEST)],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "THREADS [1]" in proc.stdout, proc.stdout
