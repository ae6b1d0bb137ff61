"""The collectives a rank issues in one traced step (the counterpart of
the collective half of ``repro.launch.hlo``: ``COLLECTIVES``,
``collective_bytes``, ``collective_counts``).

``repro`` reads its collectives off XLA's compiled per-device module. The
port runs eagerly, so a step's collectives are the ``c10d`` operators its
rank issues, as a dispatch mode sees them (``launch/op_analysis.py``
feeds every one to a ``Tally``). They are counted as the port issues
them: the sharded search's gathers are ``all_reduce``s over zeroed
buffers at n times the bytes, and the MoE all-to-all is
``all_to_all_single`` on NCCL and on a fake world (``moe.a2a_transport``)
and an ``all_reduce`` of n times the bytes on gloo with CUDA tensors.
A payload is the bytes a rank hands the operator (its input tensors).

``hlo.py``'s other half — loop-expanded FLOPs and bytes of the compiled
module — has no counterpart: eager PyTorch has no compiled module, so the
dry run's record has no ``hlo_flops`` / ``hlo_io_bytes``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast", "send", "recv")

# c10d operator name -> (kind, index of the argument holding the payload)
_C10D = {
    "allreduce_": ("all_reduce", 0),
    "allreduce_coalesced_": ("all_reduce", 0),
    "allgather_": ("all_gather", 1),
    "_allgather_base_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "reduce_scatter_": ("reduce_scatter", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "alltoall_base_": ("all_to_all", 1),
    "alltoall_": ("all_to_all", 1),
    "broadcast_": ("broadcast", 0),
    "send": ("send", 0),
    "recv_": ("recv", 0),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def classify(func, args):
    """(kind, payload bytes) of a ``c10d`` operator call, or None for any
    other operator (barriers and the like move no payload)."""
    if func.namespace != "c10d":
        return None
    hit = _C10D.get(func._opname)
    if hit is None:
        return None
    kind, at = hit
    return kind, _nbytes(args[at])


class Tally:
    """Bytes and calls per collective kind: ``coll_bytes()`` and
    ``coll_counts()`` are ``hlo.analyze``'s ``coll_bytes`` ({kind: bytes,
    "total": bytes}) and ``coll_counts`` (``hlo.collective_bytes`` /
    ``collective_counts``), kinds in ``COLLECTIVES`` order."""

    def __init__(self):
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, float] = defaultdict(float)

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.counts[kind] += 1

    def coll_bytes(self) -> Dict[str, float]:
        out = {k: self.bytes[k] for k in COLLECTIVES if k in self.bytes}
        out["total"] = float(sum(self.bytes.values()))
        return out

    def coll_counts(self) -> Dict[str, float]:
        return {k: self.counts[k] for k in COLLECTIVES if k in self.counts}
