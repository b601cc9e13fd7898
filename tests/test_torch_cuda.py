"""Kernels B1 and B2 against their plain torch twins on a CUDA GPU.

These need the card and skip elsewhere. The GPU machine has no JAX, so run
them there without tests/conftest.py (which imports it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no JAX. Batches of 1000 envs leave a ragged last tile.
"""

import pytest
import torch

from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.models import ActorMLP
from cartpoleplusplus_tpu_torch.ops import fused_rollout as fr
from cartpoleplusplus_tpu_torch.ops import policy_rollout as pr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

pytestmark = pytest.mark.cuda

B = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("params", [CartPoleParams(), continuous_params()],
                         ids=["discrete", "continuous"])
def test_b1_matches_twin(cuda, params):
    env = CartPole3D(params, num_envs=B, device=cuda)
    state, _ = env.reset(5)
    before = fr.fused_rollout.launches
    k_state, k_acc = fr.fused_rollout(env, state, 25)
    r_state, r_acc = fr.reference_rollout(env, state, 25)
    assert fr.fused_rollout.launches == before + 1
    # tests/test_ops.py's kernel-vs-twin tolerances.
    for name, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                      ("sd", 5e-4)):
        torch.testing.assert_close(getattr(k_state.phys, name),
                                   getattr(r_state.phys, name), rtol=tol,
                                   atol=tol)
    assert torch.equal(k_state.steps, r_state.steps)
    assert torch.equal(k_state.episode, r_state.episode)
    assert abs(float(k_acc) - float(r_acc)) / abs(float(r_acc)) < 1e-4


@pytest.mark.parametrize("hidden", [(256, 256), (64,), (32, 48, 16)])
def test_b2_matches_twin(cuda, hidden):
    env = CartPole3D(continuous_params(), num_envs=B, device=cuda)
    state, obs = env.reset(9)
    g = torch.Generator().manual_seed(1)
    actor = ActorMLP(42, 2, hidden, generator=g)
    with torch.no_grad():
        for prm in actor.head.parameters():
            prm.copy_(0.5 * torch.randn(prm.shape, generator=g))
    actor = actor.to(cuda)
    noise = torch.zeros((B, 2), device=cuda)
    args = (env, actor, 0.15, state, obs, noise, 7, 0.2, 3)
    k = pr.policy_rollout(*args)
    r = pr.reference_policy_rollout(*args)
    # tests/test_policy_rollout.py's tolerances.
    for a, b in zip(k[3][:3], r[3][:3]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[3][3], r[3][3])
    for a, b in zip((*k[0].phys, k[1], k[2]), (*r[0].phys, r[1], r[2])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[0].steps, r[0].steps)
    assert torch.equal(k[0].episode, r[0].episode)


def test_b2_rejects_uncovered_shapes(cuda):
    env = CartPole3D(continuous_params(), num_envs=64, device=cuda)
    state, obs = env.reset(0)
    actor = ActorMLP(42, 2, (8,) * 5).to(cuda)
    with pytest.raises(ValueError):
        pr.policy_rollout(env, actor, 0.15, state, obs,
                          torch.zeros((64, 2), device=cuda), 0, 0.2, 2)
