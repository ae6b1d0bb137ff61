"""Production meshes, a fake world to plan them without cards, and the
H100's roofline constants (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group): single-pod (16, 16) over ("data", "model") — 256 cards —
or multi-pod (2, 16, 16) over ("pod", "data", "model") — 512 cards, the
"pod" axis the outer data axis between the two halves. It is a
``DeviceMesh`` over the process group ``torchrun`` set up (one process
per card), or over the fake one ``fake_world`` opens for a dry run.

``repro``'s constants are a TPU v5e's; none of them carries over. These
are NVIDIA's H100 SXM5 80GB data sheet's, at its 700 W power limit.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# NVIDIA H100 SXM5 80GB (data sheet, 700 W), one card
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
PEAK_OPS_INT8 = 1.979e15       # op/s, dense int8 tensor cores
HBM_BW = 3.35e12               # bytes/s, HBM3
HBM_BYTES = 80e9               # capacity
NVLINK_BW = 450e9              # bytes/s each way, to the other 7 of a node
NIC_BW = 50e9                  # bytes/s: one 400 Gb/s NIC per card (DGX H100)
NODE_CARDS = 8                 # cards joined by NVLink in one node

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, axes):
    n = math.prod(shape)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs a world of {n} ranks; this "
                         f"world has {world}")
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over the initialized process group, whose world
    must hold exactly 256 / 512 ranks (raises ``ValueError`` naming it)."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return _mesh(shape, axes)


def make_host_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")):
    """A small mesh over however many (gloo or fake) ranks exist — for
    CI-scale dry runs; the world must hold exactly its ranks."""
    return _mesh(shape, axes)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks in which this process is
    ``rank``: collectives return at once and move nothing, so a rank's
    program can be traced without its peers or cards. Refuses if a group
    is already initialized; destroys the group on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; a fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()

