"""The plain reference held to the program's own plain twins at a tiny size
on the CPU, piece by piece: the rollout (B2's and B4's twins through the
env), the replay's column draw, and one learner update (the plain
learners' `_update_once`). A later change to the program's semantics
cannot part the two without this failing."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness, weights
from port_bench.drivers import train_step
from port_bench.reference.env import EnvParams
from port_bench.reference.replay import Ring

SEED = 2 ** 31 + 7
SMALL = {"num_envs": 48, "agent_config": {
    "hidden": [24, 16], "batch_size": 40, "updates_per_step": 2,
    "replay_capacity_per_env": 256, "learner": "xla", "rollout_steps": 8,
    "warmup_env_steps": 0}}
CPU = torch.device("cpu")


def _pair(name: str):
    """(cell, the program's agent and state, the reference) from one seed
    and the same initial weights."""
    cell = harness.load_cell(name, SMALL)
    agent = train_step.build_agent(cell, CPU)
    state = agent.init(SEED)
    init = train_step.initial_weights(cell, SEED, CPU)
    train_step.load_weights(cell, state, init)
    ref = train_step.reference_module(cell).Reference(
        cell.settings, EnvParams(**cell.config["env"]), cell.num_envs, init,
        SEED, CPU, weights.ADAM_V0)
    return cell, agent, state, ref


def _same(a, b, atol=0.0):
    assert a.shape == b.shape and a.dtype == b.dtype
    if atol:
        torch.testing.assert_close(a, b, rtol=0.0, atol=atol)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["ddpg.default", "dqn.suite"])
def test_the_rollout_matches_the_programs_twin(name):
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import (
        reference_policy_rollout)
    from cartpoleplusplus_tpu_torch.ops.q_rollout import reference_q_rollout

    cell, agent, st, ref = _pair(name)
    c = agent.cfg
    for _ in range(2):
        if name.startswith("ddpg"):
            env_state, obs, noise, traj = reference_policy_rollout(
                agent.env, st.actor, c.ou_theta, st.env_state, st.obs,
                st.noise, st.env_steps, agent._sigma(st.env_steps),
                c.rollout_steps)
            st = st._replace(noise=noise)
        else:
            env_state, obs, traj = reference_q_rollout(
                agent.env, st.q, st.env_state, st.obs, st.env_steps,
                agent.epsilon(st.env_steps), c.rollout_steps)
        st = st._replace(env_state=env_state, obs=obs,
                         env_steps=st.env_steps + c.rollout_steps)
        want = ref._rollout()
        ref.env_steps += c.rollout_steps
        for a, b in zip(traj, want):
            _same(a, b)
        _same(obs, ref.obs)


# Rings of 64 slots (three chunks of 8: no wrap), 16 (the third chunk
# wraps to slot 0 on the aligned insert) and 20 (8 does not divide 20:
# chunks wrap mid-chunk, and draws whose successor slot is slot 0).
@pytest.mark.parametrize("capacity, chunks", [(64, 3), (16, 3), (20, 7)])
@pytest.mark.parametrize("batch", [40, 48, 100])
def test_the_column_draw_matches_the_programs(batch, capacity, chunks):
    from cartpoleplusplus_tpu_torch.agents.replay import ReplayBuffer

    b, t = 48, 8
    g = torch.Generator().manual_seed(5)
    traj = (torch.randn((t, b, 42), generator=g),
            torch.rand((t, b, 2), generator=g),
            torch.rand((t, b), generator=g),
            torch.rand((t, b), generator=g) < 0.1)
    prog = ReplayBuffer(b, capacity, 42, 2)
    rs = prog.init()
    ring = Ring(b, capacity)
    for i in range(chunks):
        chunk = tuple(x + i if x.dtype != torch.bool else x for x in traj)
        rs = prog.add_trajectory(rs, *chunk)
        ring.add(*chunk)
    assert (rs.cursor, rs.filled) == (ring.cursor, ring.filled)
    for a, x in zip((rs.obs, rs.action, rs.reward, rs.done), ring.data):
        _same(a, x)
    got = prog.presample_columns(rs, batch, 4,
                                 generator=torch.Generator().manual_seed(9))
    want = ring.columns(4, batch, torch.Generator().manual_seed(9))
    for a, x in zip(got, want):
        _same(a, x)


@pytest.mark.parametrize("name", ["ddpg.default", "dqn.suite"])
def test_one_update_matches_the_plain_learner(name):
    cell, agent, st, ref = _pair(name)
    traj = ref._rollout()
    ref.ring.add(*traj)
    ref.ring.add(*ref._rollout())
    batch = tuple(x[0] for x in ref.ring.columns(
        1, cell.settings["batch_size"], torch.Generator().manual_seed(3)))
    st, metrics = agent._update_once(st, batch)
    losses = ref._update(batch)
    got = [float(metrics[k]) for k in cell.config["losses"]]
    assert got == pytest.approx(list(losses) if isinstance(losses, tuple)
                                else [losses], rel=1e-6)
    for net, spec in cell.config["nets"].items():
        params = dict(getattr(st, spec["module"]).named_parameters())
        for k, p in ref.online[net].items():
            _same(params[k].detach(), p.detach(), atol=1e-6)
