"""PyTorch port vs the JAX reference: K4, the causal GQA flash-attention
forward (``ops.flash_attention`` and ``flash_attention_kernel``).

On CPU tensors the port runs K4's plain version; the reference runs its
Pallas kernel in interpret mode. Inputs come from a numpy seed.
Tolerances: float32 atol 3e-6 / rtol 1e-5 against the reference kernel
(tests/test_kernels.py's bound against the blockwise oracle: only the
summation order differs); bfloat16 within 0.05 of the f32 blockwise oracle
(the reference's own bf16 bound) and within one bf16 ulp plus 1e-6 of the
reference kernel's bf16 output (both compute in f32 and round once)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# tests/test_kernels.py's shapes (ragged S=200, bq != bk) plus gemma-2b's
# head: hd=256 with one KV head
SHAPES = [(2, 256, 4, 2, 64, 64, 64), (2, 256, 4, 2, 64, 128, 64),
          (1, 192, 4, 4, 64, 64, 128), (2, 200, 2, 1, 32, 64, 64),
          (1, 160, 8, 1, 256, 64, 32)]


# the f32 log2(e) the bf16 kernel's exponentials take
LOG2E = 1.4426950408889634


def _qkv(shape, seed=0):
    B, S, H, KV, hd = shape[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32))


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_f32_matches_reference(shape):
    bq, bk = shape[5:]
    q, k, v = _qkv(shape)
    ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bq=bq, bk=bk)
    out = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), bq=bq,
                               bk=bk)
    assert out.shape == tuple(ref.shape) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_bf16_within_reference_bounds(shape):
    bq, bk = shape[5:]
    q, k, v = _qkv(shape, seed=1)
    truth = np.asarray(jattn.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=64))
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    out = tops.flash_attention(qt, kt, vt, bq=bq, bk=bk)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert np.abs(got - truth).max() < 0.05
    ref = np.asarray(jops.flash_attention(qj, kj, vj, bq=bq, bk=bk),
                     np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp + 1e-6)


def test_kernel_wrapper_takes_the_kernel_layout_and_checks_tiles():
    """``flash_attention_kernel`` is ``flash_attention_fwd``'s counterpart:
    (B, H, S, hd) in, the same output, and S must tile by bq and bk."""
    B, S, H, KV, hd = 2, 128, 4, 1, 64
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, S, hd), np.float32)
    k = rng.standard_normal((B, KV, S, hd), np.float32)
    v = rng.standard_normal((B, KV, S, hd), np.float32)
    ref = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), bq=64, bk=32,
                                  interpret=True)
    out = tfa.flash_attention_kernel(*map(torch.from_numpy, (q, k, v)),
                                     bq=64, bk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-6,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention_kernel(*map(torch.from_numpy, (q, k, v)),
                                   bq=48, bk=32)


def test_padding_is_invisible_and_sliced_off():
    """A ragged S pads to max(bq, bk) with future positions: every real
    row equals the unpadded attention, whatever the tile."""
    q, k, v = map(torch.from_numpy, _qkv((1, 37, 2, 1, 32), seed=3))
    a = tops.flash_attention(q, k, v, bq=16, bk=64)
    b = tops.flash_attention(q, k, v, bq=512, bk=512)
    assert a.shape == (1, 37, 2, 32)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_single_token():
    q, k, v = _qkv((2, 1, 4, 2, 64), seed=4)
    out = tops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    # one key: the output is that key's value for every head of its group
    np.testing.assert_allclose(out.numpy(), np.repeat(v, 2, axis=2),
                               atol=1e-6)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    return torch.exp2(torch.floor(torch.log2(torch.clamp(x.abs(),
                                                         min=1e-30))) - 7)


def _tensor_core_emulation(q, k, v, halves=True):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch, in one pass:
    bf16 q and k multiplied in f32 with hd^-0.5 applied after the product,
    p = exp(s - m) taken as 2^((s - m) log2 e) in f32 (the kernel's
    ex2.approx adds at most 2 ulps), split into bf16 hi + lo (hi alone if
    not ``halves``), P V summed in f32, l the f32 sum of p. (B, H, S, hd)
    in and out."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5
    pos = torch.arange(S)
    s = torch.where(pos[None, :] <= pos[:, None], s, tfa.NEG_INF)
    p = torch.where(s > tfa.NEG_INF / 2,
                    torch.exp2((s - s.amax(dim=-1, keepdim=True)) * LOG2E),
                    0.0)
    hi = p.bfloat16().float()
    pv = hi @ vf
    if halves:
        pv = pv + (p - hi).bfloat16().float() @ vf
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (pv / l).bfloat16()


@pytest.mark.parametrize("shape", SHAPES + [(1, 512, 8, 1, 256, 512, 512)],
                         ids=str)
def test_bf16_probability_halves_stay_within_the_card_gate(shape):
    """P as two bf16 halves keeps the bf16 kernel within chip_smoke.py's
    gate (2 bf16 ulps + 1e-5) of the f32 plain version; P rounded once to
    bf16 would not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
               for a in _qkv(shape, seed=5))
    ref = tfa.flash_attention_plain(q, k, v).float()
    gate = 2 * _bf16_ulp(ref) + 1e-5
    got = _tensor_core_emulation(q, k, v).float()
    assert bool(((got - ref).abs() <= gate).all())
    one_half = _tensor_core_emulation(q, k, v, halves=False).float()
    assert not bool(((one_half - ref).abs() <= gate).all())


def test_cp_async_alignment_copies_only_misaligned_tensors():
    """The bf16 kernel copies 16 bytes at a time: the wrapper passes
    aligned strided views through untouched and hands a fresh contiguous
    copy for a misaligned base pointer or row stride."""
    base = torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16)
    view = base.transpose(1, 2)                     # (B, H, S, hd), strided
    assert tfa._aligned(view) is view
    buf = torch.randn(16384).to(torch.bfloat16)
    shape = (2, 2, 40, 32)
    for t in (buf.as_strided(shape, (2 * 40 * 36, 40 * 36, 36, 1)),
              buf[4:].as_strided(shape, (2 * 40 * 32, 40 * 32, 32, 1)),
              buf.as_strided(shape, (2 * 40 * 64, 40 * 64, 64, 2))):
        # a 72-byte row stride; a base 8 bytes off; hd not contiguous
        got = tfa._aligned(t)
        assert got is not t and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    # a unit axis's stride is never used, so it forces no copy
    one = buf.as_strided((1, 1, 40, 32), (3, 5, 32, 1))
    assert tfa._aligned(one) is one


@pytest.mark.parametrize("hd", [80, 112])
def test_plain_k4_at_zamba2_and_kimi_head_dims(hd):
    """hd 80 (zamba2-2.7b) and 112 (kimi-k2), multiples of 16 but not of
    32: the plain K4 against the Pallas kernel in interpret mode, f32."""
    B, H, KV, S = 1, 2, 1, 128
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, H, S, hd), np.float32)
    k, v = (rng.standard_normal((B, KV, S, hd), np.float32)
            for _ in range(2))
    ref = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), bq=64, bk=32,
                                  interpret=True)
    out = tfa.flash_attention_kernel(*map(torch.from_numpy, (q, k, v)),
                                     bq=64, bk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_head_dims_cover_every_registered_config():
    """K4's CUDA kernels are built for every head dim a registered config
    of either package resolves to (attention-free rwkv6's 0 aside)."""
    from repro.configs import ALL_ARCHS, get_config as jget_config
    from repro_torch.configs import get_config

    dims = {jget_config(a).resolved_head_dim for a in ALL_ARCHS} - {0}
    assert dims == {64, 80, 112, 128, 256}
    assert dims <= set(tfa._HEAD_DIMS)
    from repro_torch.configs import ALL_ARCHS as T_ARCHS
    assert {get_config(a).resolved_head_dim for a in T_ARCHS} - {0} <= dims
