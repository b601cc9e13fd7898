"""Three faults of the port against the reference, pinned on the CPU: the
unaligned replay insert (it raised), the env reset seeds of `init` and
`evaluate` (the port reset with the integer seed itself), and the plain
rollout on the card where no rollout kernel covers the config (the CLI
exited 2)."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import DDPG as JDDPG
from cartpoleplusplus_tpu.agents import DQN as JDQN
from cartpoleplusplus_tpu.agents import LRPG as JLRPG
from cartpoleplusplus_tpu.agents import NAF as JNAF
from cartpoleplusplus_tpu.agents import DDPGConfig as JDDPGConfig
from cartpoleplusplus_tpu.agents import DQNConfig as JDQNConfig
from cartpoleplusplus_tpu.agents import LRPGConfig as JLRPGConfig
from cartpoleplusplus_tpu.agents import NAFConfig as JNAFConfig
from cartpoleplusplus_tpu.agents.replay import ReplayBuffer as JReplayBuffer
from cartpoleplusplus_tpu.env.cartpole import to_seed
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import (DDPG, DQN, LRPG, NAF,
                                               DDPGConfig, DQNConfig,
                                               LRPGConfig, NAFConfig,
                                               RandomAgent, ReplayBuffer)
from cartpoleplusplus_tpu_torch.models.from_jax import ddpg_state_from_jax
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from cartpoleplusplus_tpu_torch.utils import prng


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- A2: the reset seeds --------------------------------------------------


def test_threefry_split_matches_jax():
    """The numpy threefry2x32 split gives jax.random.split's raw keys under
    the JAX config this repo runs (threefry_partitionable on), and the XOR
    fold gives the reference's to_seed."""
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 1, 7, 42, 12345, 2 ** 31 - 1):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
        for num in (2, 3, 4, 7):
            want = np.asarray(jax.random.split(key, num))
            got = prng.split_key(prng.prng_key(seed), num)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
            for i in range(num):
                assert prng.split_seed(seed, num, i) == int(to_seed(want[i]))


_SMALL = {"ddpg": dict(hidden=(16, 16), replay_capacity_per_env=16),
          "dqn": dict(hidden=(16, 16), replay_capacity_per_env=16),
          "naf": dict(hidden=(16, 16), replay_capacity_per_env=16),
          "lrpg": dict(hidden=(16, 16))}
_AGENTS = {"ddpg": (JDDPG, JDDPGConfig, DDPG, DDPGConfig, True),
           "dqn": (JDQN, JDQNConfig, DQN, DQNConfig, False),
           "naf": (JNAF, JNAFConfig, NAF, NAFConfig, True),
           "lrpg": (JLRPG, JLRPGConfig, LRPG, LRPGConfig, False)}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(_AGENTS))
def test_init_env_state_matches_reference(name, seed):
    """Each agent's `init` resets the envs the reference's `init` resets
    at the same seed: per-env seeds exact, fresh states and the first
    observation within float rounding."""
    jcls, jcfg, tcls, tcfg, cont = _AGENTS[name]
    jp = jparams.continuous_params() if cont else jparams.CartPoleParams()
    tp = continuous_params() if cont else CartPoleParams()
    jagent = jcls(JCartPole3D(jp, num_envs=16), jcfg(**_SMALL[name]))
    agent = tcls(CartPole3D(tp, num_envs=16), tcfg(**_SMALL[name]))
    jst, st = jagent.init(seed), agent.init(seed)
    np.testing.assert_array_equal(
        st.env_state.env_seed.numpy(),
        np.asarray(jst.env_state.env_seed).astype(np.int64))
    for got, want in zip(st.env_state.phys, jst.env_state.phys):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(st.obs.numpy(), np.asarray(jst.obs),
                               rtol=1e-6, atol=1e-7)


def test_evaluate_matches_reference_episodes():
    """`evaluate` of a DDPG state carried over from the reference runs the
    reference's episodes: completed-episode count, mean, median and max
    length exact, reward and done fraction within float rounding."""
    kw = dict(hidden=(16, 16), replay_capacity_per_env=16, rollout_steps=4,
              warmup_env_steps=0, updates_per_step=1, batch_size=32)
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(), num_envs=64),
                   JDDPGConfig(learner="xla", **kw))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=64),
                 DDPGConfig(learner="xla", **kw))
    jst, _ = jax.jit(jagent.train_step)(jagent.init(0))
    pst = ddpg_state_from_jax(agent, jax.device_get(jst))
    for seed in (3, 11):
        want = jax.jit(jagent.evaluate, static_argnums=(1, 2))(jst, 60, seed)
        got = agent.evaluate(pst, 60, seed)
        for key in ("episodes", "mean_episode_length",
                    "median_episode_length", "max_episode_length"):
            assert float(got[key]) == float(want[key]), key
        for key in ("reward_mean", "done_frac"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(got["episodes"]) > 0


def test_random_agent_resets_as_the_reference(monkeypatch):
    """The random agent evaluates from the envs the reference's resets
    (split(PRNGKey(seed))[0] folded); its actions stay its own draws."""
    env = CartPole3D(CartPoleParams(), num_envs=8)
    seeds = []
    reset = env.reset
    monkeypatch.setattr(env, "reset",
                        lambda s, *a: seeds.append(s) or reset(s, *a))
    RandomAgent(env).evaluate(5, 3)
    want = int(to_seed(jax.random.split(jax.random.PRNGKey(5))[0]))
    assert seeds == [want]


# --- A1: the unaligned replay insert ----------------------------------------


@pytest.mark.parametrize("capacity,t", [(64, 24), (16, 24), (16, 16),
                                        (12, 5)])
def test_unaligned_insert_matches_jax(capacity, t):
    """Three inserts of T-step chunks into rings whose capacity T does not
    divide (or exceeds): the reference's slow path, cursor and fill, with
    every buffer equal to JAX's add_trajectory."""
    b, obs_dim = 4, 3
    jrb = JReplayBuffer(num_envs=b, capacity_per_env=capacity,
                        obs_dim=obs_dim, action_dim=2, discrete=False)
    rb = ReplayBuffer(b, capacity, obs_dim, 2)
    jrs, rs = jrb.init(), rb.init()
    rng = np.random.RandomState(capacity + t)
    for _ in range(3):
        chunk = (rng.normal(size=(t, b, obs_dim)).astype(np.float32),
                 rng.normal(size=(t, b, 2)).astype(np.float32),
                 rng.normal(size=(t, b)).astype(np.float32),
                 rng.uniform(size=(t, b)) < 0.2)
        jrs = jrb.add_trajectory(jrs, *(jnp.asarray(x) for x in chunk))
        rs = rb.add_trajectory(rs, *(torch.from_numpy(x) for x in chunk))
        assert (rs.cursor, rs.filled) == (int(jrs.cursor), int(jrs.filled))
        for name in ("obs", "action", "reward", "done"):
            np.testing.assert_array_equal(getattr(rs, name).numpy(),
                                          np.asarray(getattr(jrs, name)),
                                          err_msg=name)


def test_unaligned_insert_cli_runs():
    """The fault's input: 8 envs, rollout 24 into the default 1024-slot
    ring, 2 train steps; the reference exits 0 there, and so does the
    port, with finite metrics."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--device", "cpu", "--num-envs", "8",
                          "--ddpg.rollout-steps", "24", "--ddpg.hidden", "16",
                          "16", "--total-env-steps", "48"])
    assert rc == 0
    m = json.loads(out.getvalue().splitlines()[-1])
    assert m["train_step"] == 2 and m["env_steps"] == 48.0
    assert all(np.isfinite(v) for v in m.values())
    assert m["critic_loss"] > 0.0
