"""PyTorch port vs the JAX reference: training an MoE model on one device
(``scaled_down`` kimi-k2: 8 experts, top 2, one shared expert; and
arctic-480b's dense residual) through ``moe_reference`` — the loss
gradients, three train steps in f32, with int8_ef compression and with
int8 moments (``_torch_train_family.py`` states the tolerances) — and
the optimizer's expert leaves.
"""
import pytest

import _torch_train_family as fam
from repro_torch.optim import optimizer as topt


@pytest.fixture(scope="module")
def env():
    return fam.Env("kimi-k2-1t-a32b")


def test_loss_gradients_match_reference(env):
    fam.check_grads(env)


def test_dense_residual_gradients_match_reference():
    fam.check_grads(fam.Env("arctic-480b"))


@pytest.mark.parametrize("mode", list(fam.MODES))
def test_train_step_matches_reference(env, mode):
    fam.check_steps(env, mode)


def test_expert_leaves(env):
    params = dict(env.model().named_parameters())
    experts = {k for k in params if topt.is_expert(k)}
    assert experts == {f"blocks.{i}.moe.{w}" for i in range(2)
                       for w in ("w_gate", "w_up", "w_out")}
    assert topt._leaf("blocks.1.moe.w_up") == "blocks.*.moe.w_up"
    assert not topt.is_expert("blocks.0.moe.router")
    assert not topt.is_expert("blocks.0.moe.shared.w_up")
    # the (L, E, ...) leaves and the (L, d, E) router decay
    assert {"blocks.0.moe.w_out", "blocks.1.moe.router"} <= topt.decayed(
        params)
