"""Carry ``repro``'s state across to the port.

``repro`` hands its state over as numpy arrays: packed codes (uint32), and
optionally a ``BucketLayout``'s ``codes``/``perm``/``inv``/``starts``. These
functions return the port's tensors, ``BucketLayout`` and ``KNNEngine`` on
the given device (CUDA unless ``device="cpu"`` is asked for; with no
device given and no CUDA device present they raise). Codes keep their bit
pattern: uint32 words are reinterpreted as int32, not converted.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.engine import KNNEngine
from repro_torch.core.layout import BucketLayout


def codes(packed, device=None) -> torch.Tensor:
    """(…, W) uint32 or int32 packed codes -> int32 tensor, same bits."""
    dev = device_mod.resolve(device)
    a = np.ascontiguousarray(np.asarray(packed))
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed codes must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(dev)


def _int32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(dev)


def layout(layout_codes, perm, inv, starts, device=None) -> BucketLayout:
    """A ``repro`` BucketLayout's arrays -> the port's BucketLayout."""
    dev = device_mod.resolve(device)
    return BucketLayout(codes=codes(layout_codes, dev), perm=_int32(perm, dev),
                        inv=_int32(inv, dev), starts=_int32(starts, dev))


def engine(packed, d: int, layout_arrays=None, device=None) -> KNNEngine:
    """``repro`` engine state -> the port's KNNEngine. ``layout_arrays``:
    optional (codes, perm, inv, starts) of a prebuilt BucketLayout."""
    dev = device_mod.resolve(device)
    lay = None if layout_arrays is None else layout(*layout_arrays, device=dev)
    return KNNEngine(codes=codes(packed, dev), d=d, layout=lay)
