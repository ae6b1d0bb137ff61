"""PyTorch port vs the JAX reference: training the Mamba2 hybrid
(``scaled_down`` zamba2-2.7b: 2 groups of 2 Mamba2 blocks, one shared
attention block) — the loss gradients, three train steps in f32, with
int8_ef compression and with int8 moments
(``_torch_train_family.py`` states the tolerances), and the optimizer's
leaves: ``blocks.<g>.<i>.<rest>`` lie in ``repro``'s (groups, per_group)
leaf, the one ``shared_attn`` in its own.
"""
import pytest
import torch

import _torch_train_family as fam
from repro_torch.configs import TrainConfig
from repro_torch.optim import optimizer as topt


@pytest.fixture(scope="module")
def env():
    return fam.Env("zamba2-2.7b")


def test_loss_gradients_match_reference(env):
    fam.check_grads(env)


@pytest.mark.parametrize("mode", list(fam.MODES))
def test_train_step_matches_reference(env, mode):
    fam.check_steps(env, mode)


def test_leaves_and_decay(env):
    params = dict(env.model().named_parameters())
    assert topt._leaf("blocks.1.0.mamba.w_x") == "blocks.*.*.mamba.w_x"
    assert topt._leaf("blocks.0.1.ln.scale") == "blocks.*.*.ln.scale"
    assert topt._leaf("shared_attn.ln1.scale") == "shared_attn.ln1.scale"
    names = topt.decayed(params)
    # stacked on (groups, per_group): every block leaf decays, the 1-d
    # ones too; the shared block's norms do not
    assert {"blocks.0.0.ln.scale", "blocks.1.1.mamba.a_log",
            "blocks.0.1.mamba.d_skip"} <= names
    assert "shared_attn.ln1.scale" not in names
    assert "shared_attn.attn.wq" in names
    assert "final_norm.scale" not in names


def test_int8_ef_scale_is_one_per_stacked_leaf(env):
    """Every block of a (groups, per_group) leaf is coded at the one scale
    of the whole leaf: the largest |g| anywhere in it sits on code 127."""
    params = dict(env.model().named_parameters())
    grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
    grads["blocks.1.1.mamba.w_x"][0, 0] = 5.0
    tc = TrainConfig(grad_compression="int8_ef", learning_rate=0.0)
    state = topt.init(params, tc)
    topt.update(grads, state, params, tc, 0)
    scale = 5.0 / 127
    for k in ("blocks.0.0.mamba.w_x", "blocks.1.0.mamba.w_x"):
        # 1e-3 is below half a step of 5/127: coded 0, all of it residual
        torch.testing.assert_close(state.ef[k], grads[k], rtol=0, atol=0)
    assert float(state.ef["blocks.1.1.mamba.w_x"][0, 0]) == pytest.approx(
        5.0 - 127 * scale, abs=1e-6)
    # an unstacked leaf has its own scale: 1e-3 is its max, coded exactly
    assert float(state.ef["shared_attn.attn.wq"].abs().max()) < 1e-9
