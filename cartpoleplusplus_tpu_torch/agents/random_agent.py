"""Random-action baseline agent (cartpoleplusplus_tpu/agents/random_agent.py
in torch): uniform-random actions, the env's smoke test and baseline.

The reference draws from `jax.random` keys, which the port does not
reproduce; here the draws come from an explicit `torch.Generator` on the
env's device, so the two agree in distribution, not in their samples. No
kernel exists for this agent in either package: on a GPU it runs the plain
env step by step.
"""

from __future__ import annotations

import torch

from ..env import CartPole3D
from .common import evaluate_policy


class RandomAgent:
    """Uniform-random policy; `evaluate` is the batched smoke-test rollout."""

    def __init__(self, env: CartPole3D):
        self.env = env

    def policy(self, obs, generator: torch.Generator):
        """Uniform int32 actions in [0, 5) on the discrete env, U[-1, 1)^2
        on the continuous one, drawn from `generator` (on obs' device)."""
        b = obs.shape[0]
        if self.env.params.discrete_actions:
            return torch.randint(0, self.env.num_actions, (b,),
                                 generator=generator, device=obs.device,
                                 dtype=torch.int32)
        u = torch.rand((b, self.env.action_dim), generator=generator,
                       device=obs.device)
        return 2.0 * u - 1.0

    @torch.no_grad()
    def evaluate(self, seed: int, num_steps: int = 200):
        """Run `num_steps` random steps over the full batch from
        `env.reset(seed)`; returns per-step mean reward and exact
        per-episode statistics (agents/common.py::evaluate_policy)."""
        g = torch.Generator(device=self.env.device).manual_seed(seed)
        stats = evaluate_policy(self.env, self.policy, seed, num_steps,
                                generator=g)
        # Back-compat alias for the historical key name.
        stats["steps_per_episode"] = stats["mean_episode_length"]
        return stats
