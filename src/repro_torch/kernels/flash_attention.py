"""K4: causal GQA flash-attention forward (port of
``repro.kernels.flash_attention``).

q (B, H, S, hd); k, v (B, KV, S, hd) -> (B, H, S, hd) in q's dtype
(float32 or bfloat16). q is upcast to f32 and then scaled by hd^-0.5; the
scores are f32, masked to NEG_INF = -1e30 where kpos > qpos; the softmax
is exp(s - max) with the ``s > NEG_INF / 2`` guard, divided by
max(l, 1e-30); query head h reads kv head h // (H // KV).

``flash_attention_kernel`` runs the CUDA kernels (``csrc/flash_attention.cu``,
built at first use) for CUDA tensors and ``flash_attention_plain`` for CPU
tensors, and counts its kernel launches in
``flash_attention_kernel.launches``; the CUDA route is the
``torch.library`` operator ``repro_torch::k4_flash_attention`` with a
fake implementation, so tracing on fake tensors sees each call
(``launch/op_analysis.py`` charges it with ``flash_attention_cost``) and
counts no launch. ``bq``/``bk`` are the TPU kernel's
VMEM tiles: S must be a multiple of both (``ops.flash_attention`` pads),
as there; the CUDA kernels pick their own tiles. bfloat16 runs on
Hopper's ``wgmma`` (two warpgroups of 64 query rows x 64 keys a CTA,
``bf16_tile``; fed by ``cp.async`` in 16-byte copies, so the wrapper
hands it 16-byte aligned tensors); float32 on the CUDA cores (32 x 32,
f32 FMAs). It is forward-only, as the Pallas kernel is: serving paths
only.
"""
from __future__ import annotations

import ctypes

import torch

_SOURCE = "flash_attention.cu"
NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 80, 112, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
           bk: int):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q (B, H, S, hd) and k, v (B, KV, S, hd) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd) or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"S={S} is not a multiple of bq={bq} and bk={bk}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"tensors on {dev}, {k.device} and {v.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bq: int = 512, bk: int = 512) -> torch.Tensor:
    """Plain PyTorch K4: the same function with the (S, S) scores
    materialized for one batch row at a time."""
    _check(q, k, v, bq, bk)
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = hd ** -0.5
    pos = torch.arange(S, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    out = torch.empty_like(q)
    for b in range(B):
        qf = q[b].float() * scale                                # (H, S, hd)
        kf = k[b].float().repeat_interleave(G, dim=0)
        vf = v[b].float().repeat_interleave(G, dim=0)
        s = torch.where(causal, qf @ kf.transpose(-1, -2), NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[b] = ((p @ vf) / l).to(q.dtype)
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its hd axis is contiguous and its base pointer and the
    strides of its other non-unit axes are multiples of 16 bytes (the
    bf16 kernel's cp.async copies), else a fresh contiguous copy."""
    nbytes = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * nbytes % 16 == 0
                    for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``flash_attention_launch``'s C signature on ``lib``."""
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = ([p] * 4 + [i] * 6
                                               + [p, ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib._argtypes_set = True
    return lib


def bf16_tile(hd: int) -> dict:
    """The bf16 kernel's tile at head dim ``hd``, as its source sets it:
    query rows, keys, warpgroups and K/V stages of a CTA, and the width of
    the swizzled shared-memory panels."""
    out = (ctypes.c_int * 5)()
    lib = _lib()
    lib.flash_attention_tile.argtypes = [ctypes.c_int, ctypes.c_void_p]
    if lib.flash_attention_tile(hd, out):
        raise ValueError(f"K4's bf16 kernel does not take hd={hd}")
    return dict(zip(("bq", "bk", "warpgroups", "stages", "panel"), out))


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    return _bind(_build.load(_SOURCE))


def _launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """One launch of ``lib``'s K4 on checked CUDA tensors; raises on a
    launch error."""
    B, H, S, hd = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    st = (ctypes.c_longlong * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
        k.shape[1], S, hd, int(q.dtype == torch.bfloat16),
        ctypes.cast(st, ctypes.c_void_p), hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"K4 (flash_attention_launch) failed: CUDA error "
                           f"{err}")
    return out


def refuse_grad(*ts: torch.Tensor) -> None:
    """Raise when autograd would need K4's backward, which does not exist:
    training takes the blockwise path (``attn_impl="xla"``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "K4 (flash attention) is forward-only: its output would carry "
            "no gradient. Train with the blockwise path (attn_impl='xla', "
            "models/attention.blockwise_causal_attention)")


@torch.library.custom_op("repro_torch::k4_flash_attention", mutates_args=(),
                         device_types="cuda")
def _k4_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
           bk: int) -> torch.Tensor:
    """K4's CUDA route as an operator that tracing sees (``bq``/``bk``
    only size its cost, ``flash_attention_cost``)."""
    return _k4_cuda(q, k, v)


def _k4_cuda(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """One K4 launch, counted."""
    out = _launch(_lib(), q, k, v)
    flash_attention_kernel.launches += 1
    return out


@_k4_op.register_fake
def _k4_fake(q, k, v, bq, bk):
    return torch.empty_like(q)


def flash_attention_cost(q, k, v, bq: int, bk: int) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one K4 call as ``repro``'s jaxpr analysis
    charges its ``pallas_call`` on the grid (B, H, S/bq, S/bk): q and the
    output once, k and v once per query block; FLOPs 4·B·H·S·S_k·hd·0.5
    (the causal half)."""
    B, H, S, hd = q.shape
    nbytes = lambda t: t.numel() * t.element_size()
    nq = S // min(bq, S)
    io = 2 * nbytes(q) + nq * (nbytes(k) + nbytes(v))
    return 4.0 * B * H * S * k.shape[2] * hd * 0.5, float(io)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bq: int = 512,
                           bk: int = 512) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd). Replaces
    ``flash_attention_fwd``. The inputs may be strided views (the hd axis
    contiguous); the output has q's memory layout. Forward only, as in
    ``repro``: with gradients on and an input that requires them it
    raises rather than return an output with no graph. CUDA tensors go
    through the operator ``repro_torch::k4_flash_attention`` (fake tensors
    get its output's shape, and no launch)."""
    refuse_grad(q, k, v)
    dev = _check(q, k, v, bq, bk)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, bq, bk)

    B, H, S, hd = q.shape
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"K4 takes float32/bfloat16 and hd in {_HEAD_DIMS}; "
                         f"got {q.dtype}, hd={hd}")
    if B > 65535 or H > 65535:
        raise ValueError(f"K4 takes B, H <= 65535; got B={B} H={H}")
    return _k4_op(q, k, v, min(bq, S), min(bk, S))


flash_attention_kernel.launches = 0


def reset_launch_counts() -> None:
    flash_attention_kernel.launches = 0
