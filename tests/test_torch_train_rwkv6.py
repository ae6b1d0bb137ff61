"""PyTorch port vs the JAX reference: training RWKV6 (``scaled_down``
rwkv6-1.6b) — the loss gradients, three train steps in f32, with
int8_ef compression and with int8 moments (``_torch_train_family.py``
states the tolerances) — and a bf16 model's f32 leaves staying f32
through the in-place update.
"""
import pytest
import torch

import _torch_train_family as fam
from repro_torch.configs import TrainConfig, get_config, scaled_down
from repro_torch.data import pipeline
from repro_torch.dist import steps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt

F32_LEAVES = ("mu", "decay_base", "decay_b", "bonus", "ln_scale", "mu_c")


@pytest.fixture(scope="module")
def env():
    return fam.Env("rwkv6-1.6b")


def test_loss_gradients_match_reference(env):
    fam.check_grads(env)


@pytest.mark.parametrize("mode", list(fam.MODES))
def test_train_step_matches_reference(env, mode):
    fam.check_steps(env, mode)


@pytest.mark.parametrize("opt_int8", [False, True])
def test_bf16_model_keeps_its_f32_leaves(opt_int8):
    """``repro`` keeps the time-mix's mixing and decay leaves f32 in a
    bf16 model; after a train step they are still f32 and moved, the
    matrices still bf16."""
    cfg = scaled_down(get_config("rwkv6-1.6b"))
    model = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tc = TrainConfig(total_steps=4, warmup_steps=0, opt_int8=opt_int8)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = topt.init(dict(model.named_parameters()), tc)
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                             global_batch=2)
    model, state, met = steps.make_train_step(cfg, tc, device="cpu")(
        model, state, pipeline.make_batch(dc, 0), 0)
    assert torch.isfinite(met["loss"])
    leaves = set()
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        assert p.dtype == before[name].dtype, name
        assert not torch.equal(p, before[name]), name
        if leaf in F32_LEAVES:
            assert p.dtype == torch.float32, name
            leaves.add(leaf)
        elif leaf.startswith("w_"):
            assert p.dtype == torch.bfloat16, name
    assert leaves == set(F32_LEAVES)
