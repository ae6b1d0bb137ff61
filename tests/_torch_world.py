"""A world of gloo ranks on the CPU for the port's sharded tests.

``World(n)`` spawns n processes (the ``spawn`` start method), each joining
one ``torch.distributed`` gloo process group through a file in a fresh
temporary directory (no ports, so concurrent test workers never clash),
and then serving tasks: ``World.run(fn, *args)`` has every rank call
``fn(*args)`` — a module-level function, importable in the ranks — and
returns the ranks' results in rank order, or raises with every failing
rank's traceback. A collective that a rank never joins fails after
``TIMEOUT_S`` (gloo's own timeout), so a broken case cannot hang the
suite.

Ranks build their device meshes with ``mesh(shape, names)``, cached per
rank so every task reuses the same subgroups. Only ``torch``, ``numpy``
and ``repro_torch`` are imported in the ranks.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import traceback

TIMEOUT_S = 120
_MESHES: dict = {}


def mesh(shape, names):
    """This rank's ``DeviceMesh`` of ``shape`` over the world, axes named
    ``names`` (cached: every rank must build the same meshes in the same
    order, which running the same tasks guarantees)."""
    from torch.distributed.device_mesh import init_device_mesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def _serve(rank: int, world: int, init_file: str, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args = task
            try:
                conn.send(("ok", fn(*args)))
            except Exception:                 # reported to the test
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class World:
    """n gloo ranks serving tasks; close() (or the context) ends them."""

    def __init__(self, n: int):
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self._dir = tempfile.mkdtemp(prefix="gloo_world_")
        init_file = os.path.join(self._dir, "init")
        self._conns, self._procs = [], []
        for rank in range(n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve,
                               args=(rank, n, init_file, child), daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn, *args):
        """Every rank calls ``fn(*args)``; their results in rank order."""
        for conn in self._conns:
            conn.send((fn, args))
        out, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(TIMEOUT_S + 30):
                self.close()
                raise TimeoutError(f"rank {rank} gave no answer to "
                                   f"{fn.__name__}")
            status, value = conn.recv()
            if status == "ok":
                out.append(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError(f"{fn.__name__} failed on {len(errors)} of "
                                 f"{self.n} ranks:\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
