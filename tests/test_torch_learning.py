"""Learning assertions for the port's DQN and DDPG on the CPU: the torch
copies of tests/test_learning.py's tests, same configs and budgets,
against the JAX package's random-agent baseline on the same env."""

import jax
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import RandomAgent
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.agents import DQN, DQNConfig


def test_dqn_learns_discrete():
    """DQN (discrete, config-2 shape): after 2k per-env steps the greedy
    policy must balance at least 2x longer than random (the reference's
    bar; uniform sampling and lr 5e-4 as there). The plain learner runs
    (learner "auto" on the CPU). Measured greedy 14.8 against random
    5.1 at these seeds."""
    torch.set_num_threads(1)
    env = CartPole3D(CartPoleParams(), num_envs=64)
    agent = DQN(env, DQNConfig(hidden=(64, 64), rollout_steps=16,
                               updates_per_step=8, batch_size=128,
                               replay_capacity_per_env=512, lr=5e-4,
                               eps_decay_env_steps=1200, eps_end=0.05,
                               warmup_env_steps=32, sample="uniform"))
    st = agent.init(0)
    for _ in range(2000 // 16):
        st, _ = agent.train_step(st)
    stats = agent.evaluate(st, 400, 7)
    greedy = float(stats["mean_episode_length"])
    jenv = JCartPole3D(JCartPoleParams(), num_envs=64)
    random_len = float(jax.jit(RandomAgent(jenv).evaluate,
                               static_argnums=(1,))(
        jax.random.PRNGKey(7), 400)["mean_episode_length"])
    assert int(stats["episodes"]) > 0
    assert greedy > 2.0 * random_len, (
        f"greedy {greedy:.1f} vs random {random_len:.1f} — DQN did not "
        "learn (loss sign / target / replay regression?)")


def test_ddpg_learns_continuous():
    """DDPG (continuous config 3, pushes + shaped reward): after 3k
    per-env steps the greedy actor must balance at least 3x longer than
    random and reach episodes beyond 40 steps (the reference's bars,
    tests/test_learning.py, same config and budget). The plain learner and
    rollout run (the CPU). Measured greedy 30.1 (max 68) against random
    5.35 at these seeds."""
    from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu_torch.physics.params import continuous_params
    from cartpoleplusplus_tpu.physics.params import (
        continuous_params as jcontinuous_params)

    torch.set_num_threads(1)
    env = CartPole3D(continuous_params(), num_envs=64)
    agent = DDPG(env, DDPGConfig(hidden=(64, 64), rollout_steps=16,
                                 updates_per_step=8, batch_size=128,
                                 replay_capacity_per_env=512,
                                 ou_sigma_decay_env_steps=2000,
                                 warmup_env_steps=32))
    st = agent.init(0)
    for _ in range(3000 // 16):
        st, _ = agent.train_step(st)
    stats = agent.evaluate(st, 400, 7)
    greedy = float(stats["mean_episode_length"])
    jenv = JCartPole3D(jcontinuous_params(), num_envs=64)
    random_len = float(jax.jit(RandomAgent(jenv).evaluate,
                               static_argnums=(1,))(
        jax.random.PRNGKey(7), 400)["mean_episode_length"])
    assert greedy > 3.0 * random_len, (
        f"greedy {greedy:.1f} vs random {random_len:.1f} — DDPG did not "
        "learn (actor/critic loss or Polyak regression?)")
    assert float(stats["max_episode_length"]) > 40.0
