"""``launch/op_analysis`` against ``repro``'s ``jaxpr_analysis`` on the
same cells: the prefill, decode and train steps of five families at
``scaled_down`` widths (tracing only on both sides: ``repro``'s jitted
step on a (1, 1) mesh, the port's on meta tensors), and the four kernels'
cost functions against ``repro``'s ``pallas_call`` branch on the same
shapes (the port's operators on fake CUDA tensors).

Prefill and decode FLOPs equal ``repro``'s to 1e-9. A train step's FLOPs
equal ``repro``'s less one named gap, to 1e-9: ``repro``'s ``lax.scan``
over the recurrent chunks transposes its carried state in every
iteration, while the port's unrolled chunk loop takes no gradient into
the first chunk's constant zero state nor out of the last chunk's state,
which the loss never reads (``carry_gap``; ROADMAP queue 3). HBM bytes
stay within 0.8-1.25x of ``repro``'s in every cell.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import compat
from repro import configs as rconfigs
from repro.dist import steps as rsteps
from repro.kernels import flash_attention as rfa
from repro.kernels import hamming as rham
from repro.kernels import topk_select as rsel
from repro.launch import jaxpr_analysis
from repro.launch import specs as rspecs
from repro_torch import configs as tconfigs
from repro_torch.dist import steps as tsteps
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hamming as tham
from repro_torch.kernels import topk_select as tsel
from repro_torch.launch import op_analysis, specs as tspecs
from repro_torch.models import rwkv6

ARCHS = ("gemma-2b", "zamba2-2.7b", "rwkv6-1.6b", "arctic-480b",
         "llava-next-mistral-7b")
B, S = 2, 128
IO_RANGE = (0.8, 1.25)


def repro_counts(arch: str, kind: str) -> dict:
    cfg = rconfigs.scaled_down(rconfigs.get_config(arch))
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    shape = rconfigs.ShapeConfig("cell", seq_len=S, global_batch=B,
                                 step=getattr(rconfigs.StepKind, kind))
    tc = rconfigs.TrainConfig()
    args = rspecs.input_specs(cfg, shape, tc)
    with mesh:
        if kind == "TRAIN":
            fn = rsteps.make_train_step(cfg, mesh, tc, donate=False)[0]
        elif kind == "PREFILL":
            fn = rsteps.make_prefill_step(cfg, mesh, S)[0]
        else:
            fn = rsteps.make_serve_step(cfg, mesh, S, global_batch=B)[0]
        return jaxpr_analysis.analyze_step(fn, args, 1)


def port_counts(arch: str, kind: str):
    cfg = tconfigs.scaled_down(tconfigs.get_config(arch))
    shape = tconfigs.ShapeConfig("cell", seq_len=S, global_batch=B,
                                 step=getattr(tconfigs.StepKind, kind))
    tc = tconfigs.TrainConfig()
    args = tspecs.input_specs(cfg, shape, tc, device="meta")
    if kind == "TRAIN":
        fn = tsteps.make_train_step(cfg, tc, device="meta")
    elif kind == "PREFILL":
        fn = tsteps.make_prefill_step(cfg, S, device="meta")
    else:
        fn = tsteps.make_serve_step(cfg, S)
    return op_analysis.trace_step(fn, args)[1]


def carry_gap(cfg) -> float:
    """FLOPs of ``repro``'s scan-carry transposes the port's train step
    does not run (module docstring): per RWKV6 layer the state's
    cotangent into the first chunk's readout and the last chunk's state
    update (two products); per Mamba2 layer the same, the update being
    the 3-operand einsum of two pairwise products."""
    if cfg.rwkv is not None:
        hd = cfg.rwkv.head_dim
        H, L = cfg.d_model // hd, min(rwkv6.WKV_CHUNK, S)
        return cfg.num_layers * 3 * 2.0 * B * H * hd * hd * L
    if cfg.ssm is not None:
        P, N = cfg.ssm.head_dim, cfg.ssm.state_dim
        H, L = cfg.ssm.expand * cfg.d_model // P, min(cfg.ssm.chunk_size, S)
        per = (2.0 * B * H * P * N * L + 2 * (2.0 * B * L * H * N)
               + 2 * (2.0 * B * L * H * P * N))
        return cfg.num_layers * per
    return 0.0


@pytest.mark.parametrize("kind", ["PREFILL", "DECODE", "TRAIN"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_match_repros_jaxpr_analysis(arch, kind):
    ref = repro_counts(arch, kind)
    got = port_counts(arch, kind)
    gap = 0.0
    if kind == "TRAIN":
        gap = carry_gap(tconfigs.scaled_down(tconfigs.get_config(arch)))
        assert abs(got.flops / ref["flops"] - 1) < 0.01
    assert abs(got.flops + gap - ref["flops"]) <= 1e-9 * ref["flops"], (
        got.flops, gap, ref["flops"])
    ratio = got.io_bytes / ref["io_bytes"]
    assert IO_RANGE[0] <= ratio <= IO_RANGE[1], (ratio, dict(got.io_by))
    assert not got.kernel_calls and got.coll.coll_bytes()["total"] == 0


def _fake_cuda(*shapes, dtype=torch.int32):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


def _port_kernel(fn):
    before = (tsel.hamming_hist_kernel.launches,
              tsel.hamming_emit_kernel.launches,
              tham.hamming_distance_kernel.launches,
              tfa.flash_attention_kernel.launches)
    with FakeTensorMode():
        _, c = op_analysis.trace_step(fn, ())
    assert before == (tsel.hamming_hist_kernel.launches,
                      tsel.hamming_emit_kernel.launches,
                      tham.hamming_distance_kernel.launches,
                      tfa.flash_attention_kernel.launches)
    return c


def _repro_kernel(fn, *args):
    return jaxpr_analysis.analyze_jaxpr(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("b,h,kv,s,hd,bq", [(1, 8, 1, 2048, 256, 512),
                                            (2, 4, 2, 384, 64, 128)])
def test_k4_cost_is_repros_pallas_branch(b, h, kv, s, hd, bq):
    def port():
        q, = _fake_cuda((b, h, s, hd), dtype=torch.bfloat16)
        k, v = _fake_cuda((b, kv, s, hd), (b, kv, s, hd),
                          dtype=torch.bfloat16)
        return tfa.flash_attention_kernel(q, k, v, bq=bq, bk=bq)

    got = _port_kernel(port)
    q = jax.ShapeDtypeStruct((b, h, s, hd), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((b, kv, s, hd), jnp.bfloat16)
    ref = _repro_kernel(lambda q, k, v: rfa.flash_attention_fwd(
        q, k, v, bq=bq, bk=bq, interpret=True), q, k, k)
    assert dict(got.kernel_calls) == {"K4": 1}
    assert got.flops == ref["flops"] == 4.0 * b * h * s * s * hd * 0.5
    assert got.io_bytes == ref["io_bytes"]


def test_k1_k2_k3_costs_are_repros_pallas_branch():
    Q, N, W, bins, k, bq, bn = 128, 4096, 8, 257, 16, 64, 1024

    def port():
        q, x = _fake_cuda((Q, W), (N, W))
        hist, bmin = tsel.hamming_hist_kernel(q, x, bins, bq=bq, bn=bn)
        r = torch.zeros((Q,), dtype=torch.int32, device="cuda")
        base = torch.zeros((Q, 1), dtype=torch.int32, device="cuda")
        # run_bases given: a fake CUDA tensor cannot be indexed here
        tsel.hamming_emit_kernel(q, x, r, r, bins, k, block_min=bmin,
                                 bq=bq, bn=bn, run_bases=(base, base))
        return tham.hamming_distance_kernel(q, x, bq=bq, bn=bn)

    got = _port_kernel(port)
    assert dict(got.kernel_calls) == {"K1": 1, "K2": 1, "K3": 1}
    q = jax.ShapeDtypeStruct((Q, W), jnp.uint32)
    x = jax.ShapeDtypeStruct((N, W), jnp.uint32)
    r = jax.ShapeDtypeStruct((Q,), jnp.int32)
    bm = jax.ShapeDtypeStruct((Q // bq, N // bn), jnp.int32)
    ref = sum(_repro_kernel(f, *a)["io_bytes"] for f, a in (
        (lambda q, x: rsel.hamming_hist_pallas(q, x, bins, bq=bq, bn=bn,
                                               interpret=True), (q, x)),
        (lambda q, x, r, bm: rsel.hamming_emit_pallas(
            q, x, r, r, bins, k, block_min=bm, bq=bq, bn=bn,
            interpret=True), (q, x, r, bm)),
        (lambda q, x: rham.hamming_distance_pallas(q, x, bq=bq, bn=bn,
                                                   interpret=True), (q, x))))
    assert got.flops == 0.0 and got.io_bytes == ref


def test_einsum_pairs_charge_the_reference_products():
    a = torch.empty((2, 3, 4), device="meta")
    b = torch.empty((2, 3, 5), device="meta")
    c = torch.empty((2, 3, 4, 6), device="meta")
    # (bsh,bsn) -> bshn has nothing to sum: K = 1; then sum over s
    (f1, io1, _), (f2, io2, _) = op_analysis.einsum_pairs(
        "bsh,bsn,bshp->bhpn", [a, b, c])
    assert f1 == 2.0 * 2 * 3 * 4 * 5 and f2 == 2.0 * (2 * 4 * 6 * 5) * 3
    assert io1 == 4 * (24 + 30 + 120)
    assert io2 == 4 * (120 + 144 + 240)
    assert math.isclose(sum(f for f, _, _ in op_analysis.einsum_pairs(
        "ab,bc->ac", [torch.empty((7, 9)), torch.empty((9, 11))])),
        2.0 * 7 * 11 * 9)
    assert np.isfinite(f1 + f2)


def test_einsum_products_compute_their_equations(monkeypatch):
    # each einsum_product call site in rwkv6: compute() == its equation,
    # in f32 (the model's dtype) to f32's rounding of sums of a few terms
    seen = set()

    def checked(equation, compute, *operands):
        got = compute()
        torch.testing.assert_close(got, torch.einsum(equation, *operands),
                                   rtol=1e-5, atol=1e-5)
        seen.add(equation)
        return got

    monkeypatch.setattr(rwkv6, "einsum_product", checked)
    rng = np.random.default_rng(0)
    B, S_, H, hd = 2, 8, 2, 4
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32))
    r, k, v = t(B, S_, H, hd), t(B, S_, H, hd), t(B, S_, H, hd)
    logw = -torch.exp(t(B, S_, H, hd))
    bonus = t(H, hd)
    rwkv6._wkv_chunked(r, k, v, logw, bonus, chunk=4)
    rwkv6._wkv_steps(r, k, v, logw, bonus, t(B, H, hd, hd))
    assert seen == {"bthi,btshi,bshi->btsh", "bthi,hi,bthi,bthj->bthj",
                    "bhi,hi,bhi,bhj->bhj"}
