"""The port's launch specs and roofline against ``repro``'s: every step
input of the 32 runnable (arch x shape) cells has ``repro``'s shapes and
dtypes under ``carry``'s name mapping, ``analytic_model_flops`` is
``repro``'s for every cell, and ``build_report`` applies the H100's
constants."""
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import roofline as rroofline
from repro.launch import specs as rspecs
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troofline
from repro_torch.launch import specs as tspecs

CELLS, SKIPPED = rconfigs.runnable_cells(
    [rconfigs.get_config(a) for a in rconfigs.ALL_ARCHS])


def test_cells_are_repros():
    cells, skipped = tconfigs.runnable_cells(
        [tconfigs.get_config(a) for a in tconfigs.ALL_ARCHS])
    assert len(CELLS) == 32 and len(SKIPPED) == 8
    assert cells == CELLS and skipped == SKIPPED


def _dtype(x) -> str:
    return (str(x).replace("torch.", "") if isinstance(x, torch.dtype)
            else np.dtype(x).name)


def _sig(a) -> tuple:
    return tuple(a.shape), _dtype(a.dtype)


def _stand_in(sds):
    """A zero-stride numpy view of a ShapeDtypeStruct (nothing allocated),
    so ``carry``'s numpy indexing can split stacked leaves."""
    return np.broadcast_to(np.zeros((), sds.dtype), sds.shape)


def _params_of(tree, n_layers: int) -> dict:
    stand = {k: _stand_in(v) for k, v in carry._leaves(tree)}

    def rebuild(d, prefix=""):
        return {k: rebuild(v, f"{prefix}{k}.") if isinstance(v, dict)
                else stand[prefix + k] for k, v in d.items()}

    return {k: _sig(v) for k, v in
            carry._flat_lm_tree(rebuild(tree), n_layers).items()}


def _named(params) -> dict:
    return {k: _sig(v) for k, v in params.items()}


def _leaves(x, path=""):
    """(path, leaf) of a decode state / store / batch of either package."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}.{k}")
    elif hasattr(x, "_fields"):
        for k in x._fields:
            yield from _leaves(getattr(x, k), f"{path}.{k}")
    elif x is not None:
        yield path, x


def _same_leaves(ref, port, ints_as_codes=False):
    got = dict(_leaves(port))
    want = dict(_leaves(ref))
    # key_positions is a mutable store's field, None here
    assert set(got) == set(want), set(got) ^ set(want)
    for k, r in want.items():
        shape, dt = _sig(r)
        if ints_as_codes and dt == "uint32":
            dt = "int32"          # codes keep their bits as int32
        assert _sig(got[k]) == (shape, dt), k


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda c: str(c))
def test_input_specs_match_repro(arch, shape):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    rshape, tshape = rconfigs.get_shape(shape), tconfigs.get_shape(shape)
    ref = rspecs.input_specs(rcfg, rshape)
    got = tspecs.input_specs(tcfg, tshape)
    assert len(got) == len(ref)
    model = got[0]
    assert all(p.device.type == "meta" for p in model.parameters())
    n = len(model.blocks)
    assert _named(dict(model.named_parameters())) == _params_of(ref[0], n)
    kind = tshape.step
    if kind == tconfigs.StepKind.TRAIN:
        ropt, topt = ref[1], got[1]
        assert _named(topt.mu) == _params_of(ropt.mu, n)
        assert _named(topt.nu) == _params_of(ropt.nu, n)
        assert _sig(topt.count) == _sig(ropt.count) == ((), "int32")
        assert topt.ef is None and ropt.ef is None
        _same_leaves(ref[2], got[2])
        assert _sig(got[3]) == _sig(ref[3])
    elif kind == tconfigs.StepKind.PREFILL:
        _same_leaves(ref[1], got[1])
    else:
        for r, t in zip(ref[1:4], got[1:4]):
            _same_leaves(r, t)
        if len(ref) > 4:
            _same_leaves(ref[4], got[4], ints_as_codes=True)


def test_specs_allocate_nothing_and_take_a_device():
    cfg = tconfigs.get_config("kimi-k2-1t-a32b")
    model, opt, batch, step = tspecs.input_specs(
        cfg, tconfigs.get_shape("train_4k"), rows=2)
    assert batch["tokens"].shape == (2, 4096)
    assert all(t.device.type == "meta" for t in opt.mu.values())
    assert lm_params(model) > 1e12
    small = tspecs.input_specs(tconfigs.scaled_down(cfg),
                               tconfigs.get_shape("decode_32k"),
                               device="cpu", rows=3)
    assert small[1].shape == (3, 1) and small[1].device.type == "cpu"


def lm_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda c: str(c))
def test_analytic_model_flops_is_repros(arch, shape):
    got = troofline.analytic_model_flops(tconfigs.get_config(arch),
                                         tconfigs.get_shape(shape))
    want = rroofline.analytic_model_flops(rconfigs.get_config(arch),
                                          rconfigs.get_shape(shape))
    assert got == want


@pytest.mark.parametrize("chips,rate", [(8, tmesh.NVLINK_BW),
                                        (256, tmesh.NIC_BW)])
def test_build_report_uses_the_h100s_constants(chips, rate):
    cfg = tconfigs.get_config("gemma-2b")
    shape = tconfigs.get_shape("train_4k")
    stats = {"flops": 3.0e15, "io_bytes": 2.0e12,
             "coll_bytes": {"all_reduce": 1.0e10, "total": 1.0e10},
             "coll_counts": {"all_reduce": 9}}
    rep = troofline.build_report(cfg, shape, "16x16", chips, stats)
    assert rep.compute_s == 3.0e15 / 989e12
    assert rep.memory_s == 2.0e12 / 3.35e12
    assert rep.collective_s == 1.0e10 / rate
    assert rep.step_time_bound_s == max(rep.compute_s, rep.memory_s,
                                        rep.collective_s)
    assert rep.dominant == max(("compute", rep.compute_s),
                               ("memory", rep.memory_s),
                               ("collective", rep.collective_s),
                               key=lambda t: t[1])[0]
    mf = troofline.analytic_model_flops(cfg, shape)
    assert rep.useful_ratio == mf / (chips * 3.0e15)
    assert rep.roofline_frac == mf / (chips * 989e12) / rep.step_time_bound_s
    assert rep.collective_detail == {"all_reduce": 1.0e10}
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.HBM_BYTES) == (
        989e12, 3.35e12, 80e9)
