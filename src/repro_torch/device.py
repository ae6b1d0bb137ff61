"""Device resolution and the backend name the planner and tuning read.

The counterpart of what ``repro`` takes from ``jax.default_backend()``:
the port names its backends ``"gpu"`` (a CUDA device) and ``"cpu"``, the
same keys ``kernels/tuning.py`` sizes block geometry by.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    With no device given and no CUDA device present this raises rather
    than running on the CPU: a CPU run must be asked for
    (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


def same(a, b) -> bool:
    """Whether two devices are one: ``cuda`` and ``cuda:<current>`` are."""
    def canon(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return canon(a) == canon(b)


def backend_of(dev) -> str:
    """Backend name of a device (or of a tensor's device)."""
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    return "gpu" if torch.device(dev).type == "cuda" else "cpu"


def default_backend() -> str:
    """Backend used where no tensor says which: ``"gpu"`` when a CUDA
    device is present, else ``"cpu"`` (plan introspection only)."""
    return "gpu" if torch.cuda.is_available() else "cpu"
