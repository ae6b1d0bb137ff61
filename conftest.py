"""Root conftest: pytest loads it for every test directory of the checkout
(``tests/`` and ``knnbench/``).

The suite runs as several worker processes on one host (``pytest -n 6``).
Each worker uses one torch intra-op thread, as the gloo ranks of
``tests/_torch_world.py`` and the benchmark's ``knnbench/run.py`` do: with
torch's default of a thread per core, six workers oversubscribe the cores
and small CPU ops spin in the thread pool instead of working. A run of the
JAX reference's tests alone needs no torch.
"""
try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(1)
