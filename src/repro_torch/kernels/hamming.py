"""K3: the materializing bit-packed Hamming distance (port of
``repro.kernels.hamming``).

This is the paper's compute phase (the "Hamming macros"): (Q, W) x (N, W)
packed codes -> the (Q, N) int32 matrix of XOR+popcount distances, which
the materializing selects (composite, counting, bisect) then rank one
board-sized chunk at a time (``method="pallas"``).

``hamming_distance_kernel`` runs the CUDA kernel (``csrc/hamming.cu``,
built at first use) for CUDA tensors and ``hamming_distance_plain`` for
CPU tensors, and counts its kernel launches in
``hamming_distance_kernel.launches``; the CUDA route is the
``torch.library`` operator ``repro_torch::k3_hamming`` with a fake
implementation (tracing sees each call, ``hamming_distance_cost`` charges
it). Codes are int32 carrying ``repro``'s
uint32 bit patterns; both versions count all 32 bits of every word.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binary import hamming_xor
from repro_torch.kernels.topk_select import _codes, _device_of, _raise_on

_SOURCE = "hamming.cu"
# the plain version: query rows per chunk keep (rows, N) under this many
# elements of each temporary
_PLAIN_CHUNK_ELEMS = 1 << 27
_THREADS = 256
_SMEM_STATIC = 48 * 1024


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hamming_launch.argtypes = [p] * 3 + [i] * 6 + [p]
        lib.hamming_launch.restype = i
        lib._argtypes_set = True
    return lib


def hamming_distance_plain(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: q (Q, W), x (N, W) int32 -> (Q, N) int32, XOR and
    ``binary.popcount32`` summed over W, a chunk of query rows at a time."""
    Q, N = q.shape[0], x.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device=q.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(N, 1))
    for r0 in range(0, Q, step):
        out[r0:r0 + step] = hamming_xor(q[r0:r0 + step], x)
    return out


def hamming_distance_kernel(q_packed: torch.Tensor, x_packed: torch.Tensor,
                            bq: int = 128, bn: int = 512) -> torch.Tensor:
    """q: (Q, W), x: (N, W) packed int32 -> (Q, N) int32. Replaces
    ``hamming_distance_pallas``. Q and N must be multiples of min(bq, Q)
    and min(bn, N) (``ops.hamming_distance`` pads). CUDA tensors go
    through the operator ``repro_torch::k3_hamming``."""
    dev = _device_of(q_packed, x_packed)
    Q, W = q_packed.shape
    N = x_packed.shape[0]
    if x_packed.shape[1] != W:
        raise ValueError(f"code widths differ: {W} and {x_packed.shape[1]}")
    bq, bn = min(bq, Q), min(bn, N)
    if bq <= 0 or bn <= 0 or Q % bq or N % bn:
        raise ValueError(f"geometry does not tile: Q={Q} N={N} bq={bq} "
                         f"bn={bn}")
    if dev.type == "cpu":
        return hamming_distance_plain(_codes(q_packed), _codes(x_packed))

    if 4 * bq * W > _SMEM_STATIC or Q // bq > 65535:
        raise ValueError(f"K3 takes bq * W <= 12288 and at most 65535 query "
                         f"blocks; got bq={bq} W={W} Q={Q}")
    return _k3_op(q_packed, x_packed, bq, bn)


@torch.library.custom_op("repro_torch::k3_hamming", mutates_args=(),
                         device_types="cuda")
def _k3_op(q: torch.Tensor, x: torch.Tensor, bq: int,
           bn: int) -> torch.Tensor:
    """K3's CUDA route as an operator that tracing sees (``_k3_cuda``)."""
    return _k3_cuda(q, x, bq, bn)


def _k3_cuda(q, x, bq: int, bn: int) -> torch.Tensor:
    """One K3 launch, counted."""
    q32, x32 = _codes(q), _codes(x)
    Q, W = q32.shape
    N = x32.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device=q.device)
    threads = min(_THREADS, -(-bn // 32) * 32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().hamming_launch(q32.data_ptr(), x32.data_ptr(),
                                out.data_ptr(), Q, N, W, bq, bn, threads,
                                stream)
    _raise_on(err, "K3 (hamming_launch)")
    hamming_distance_kernel.launches += 1
    return out


@_k3_op.register_fake
def _k3_fake(q, x, bq, bn):
    return q.new_empty((q.shape[0], x.shape[0]), dtype=torch.int32)


def hamming_distance_cost(q, x, bq: int, bn: int) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one K3 call as ``repro``'s jaxpr analysis
    charges its ``pallas_call`` (a 2-D grid): the int32 codes and the
    (Q, N) int32 output once each, no FLOPs."""
    Q, W = q.shape
    N = x.shape[0]
    return 0.0, float(4 * (Q * W + N * W + Q * N))


hamming_distance_kernel.launches = 0


def reset_launch_counts() -> None:
    hamming_distance_kernel.launches = 0
