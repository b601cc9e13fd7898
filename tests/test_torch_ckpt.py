"""The port's checkpoints (cartpoleplusplus_tpu_torch/ckpt) on the CPU:
round trip, bit-exact resume of every agent's whole state (parameters,
Adam moments, replay, generator, env state), the interval and retention
policy held to orbax's own manager call for call, weights-only saves both
ways, and checkpoints crossing the learner layouts (the kernel learners'
twins and the plain learners). Every comparison is exact (torch.equal):
the same arithmetic on the same inputs."""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.agents import (DDPG, DQN, LRPG, NAF,
                                               DDPGConfig, DQNConfig,
                                               LRPGConfig, NAFConfig)
from cartpoleplusplus_tpu_torch.ckpt import (CheckpointManager,
                                             restore_checkpoint,
                                             save_checkpoint)
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

AGENTS = ("ddpg", "dqn", "naf", "lrpg")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _agent(name, learner="xla", num_envs=16):
    """Small agents: 16 envs, hidden (16, 16), no warmup."""
    replay = dict(updates_per_step=2, batch_size=16,
                  replay_capacity_per_env=8, warmup_env_steps=0)
    if name == "ddpg":
        env = CartPole3D(continuous_params(), num_envs=num_envs)
        return DDPG(env, DDPGConfig(hidden=(16, 16), rollout_steps=2,
                                    learner=learner, **replay))
    if name == "naf":
        env = CartPole3D(continuous_params(), num_envs=num_envs)
        return NAF(env, NAFConfig(hidden=(16, 16), rollout_steps=2,
                                  learner=learner, **replay))
    env = CartPole3D(CartPoleParams(), num_envs=num_envs)
    if name == "dqn":
        return DQN(env, DQNConfig(hidden=(16, 16), rollout_steps=2,
                                  learner=learner, **replay))
    return LRPG(env, LRPGConfig(hidden=(16, 16), rollout_steps=4,
                                learner=learner))


def _assert_tree_equal(a, b, path="state"):
    """Exact equality of two checkpoint trees (to_tree of two states)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for j, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{j}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _steps(agent, st, n):
    metrics = []
    for _ in range(n):
        st, m = agent.train_step(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics


@pytest.mark.parametrize("name", AGENTS)
def test_save_restore_roundtrip(tmp_path, name):
    agent = _agent(name)
    st, _ = _steps(agent, agent.init(0), 2)
    save_checkpoint(str(tmp_path / "ck"), st)
    restored = restore_checkpoint(str(tmp_path / "ck"), agent.init(1))
    _assert_tree_equal(to_tree(st), to_tree(restored))
    assert sorted(to_tree(st)) == sorted(torch.load(
        tmp_path / "ck" / "state.pt", weights_only=True))


@pytest.mark.parametrize("learner", ("xla", "kernel"))
@pytest.mark.parametrize("name", AGENTS)
def test_resume_is_bit_exact(tmp_path, name, learner):
    """n train steps straight == k steps, a save, a restore into a fresh
    agent's state (another seed), then n - k steps: parameters, moments,
    replay and cursor, the generator, the env state and every metric."""
    n, k = 5, 2
    agent = _agent(name, learner)
    st_straight, m_straight = _steps(agent, agent.init(0), n)

    st, m_first = _steps(agent, agent.init(0), k)
    with CheckpointManager(str(tmp_path / "runs")) as mgr:
        assert mgr.save(k - 1, st)
    del st
    resumer = _agent(name, learner)
    with CheckpointManager(str(tmp_path / "runs")) as mgr:
        assert mgr.latest_step() == k - 1
        st = mgr.restore(resumer.init(7))
    st, m_rest = _steps(resumer, st, n - k)
    _assert_tree_equal(to_tree(st_straight), to_tree(st))
    assert m_straight == m_first + m_rest


def test_manager_interval_retention_resume(tmp_path):
    agent = _agent("ddpg")
    st = agent.init(0)
    with CheckpointManager(str(tmp_path / "runs"), save_interval_steps=2,
                           max_to_keep=2) as mgr:
        saves = [mgr.save(i, st) for i in range(5)]
        mgr.wait_until_finished()
        assert saves == [True, False, True, False, True]
        assert mgr.latest_step() == 4 and mgr.all_steps() == [2, 4]
        restored = mgr.restore(agent.init(1))
        _assert_tree_equal(to_tree(st), to_tree(restored))
        with pytest.raises(ValueError):
            mgr.save(4, st, force=True)   # never overwrites a step
    assert sorted(os.listdir(tmp_path / "runs")) == ["2", "4"]
    with CheckpointManager(str(tmp_path / "runs")) as mgr2:
        assert mgr2.latest_step() == 4   # discovery across processes


def test_restore_missing_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore(_agent("ddpg").init(0))


class _Tiny(NamedTuple):
    x: torch.Tensor


_STATE = _Tiny(torch.zeros(2))


def _window_saves(mgr, state, n_calls, spd, start=0):
    """train.py's save cadence: a forced save at the end of each window
    of `spd` calls in which the policy would save, then the final one."""
    saved = []
    i = start
    while i < n_calls:
        k = min(spd, n_calls - i)
        i += k
        if any(mgr.should_save(j) for j in range(i - k, i)):
            saved.append((i - 1, mgr.save(i - 1, state, force=True)))
    if mgr.latest_step() != n_calls - 1:
        saved.append((n_calls - 1, mgr.save(n_calls - 1, state, force=True)))
    return saved


@pytest.mark.parametrize("case", [
    # (interval, max_to_keep, [(n_calls, steps_per_dispatch), ...]: runs
    #  resuming in one directory, each at the latest step + 1)
    (5, 3, [(128, 16)]),
    (10000, 3, [(32, 16)]),
    (3, 3, [(8, 3), (12, 3)]),
    (16, 3, [(64, 32), (96, 32)]),
    (4, 2, [(17, 1)]),
    (7, 3, [(40, 6), (41, 6), (90, 4), (30, 4)]),
])
def test_saved_steps_equal_orbax(tmp_path, case):
    """The port's manager and the reference's orbax manager, given the
    same calls (train.py's windowed cadence over runs resumed in one
    directory, a run with a smaller budget among them, then plain policy
    saves): the same returns, latest step and steps (in orbax's order)
    after every run."""
    from cartpoleplusplus_tpu.ckpt import CheckpointManager as JManager

    interval, keep, runs = case

    class _JTiny(NamedTuple):
        x: np.ndarray

    jstate = _JTiny(np.zeros(2, np.float32))
    got, want = [], []
    start = 0
    for r, (n_calls, spd) in enumerate(runs):
        plain = range(n_calls, n_calls + 9) if r == len(runs) - 1 else ()
        with CheckpointManager(str(tmp_path / "t"), interval, keep) as t:
            got.append((_window_saves(t, _STATE, n_calls, spd, start),
                        [t.save(s, _STATE) for s in plain],
                        t.latest_step(), t.all_steps()))
        with JManager(str(tmp_path / "j"), interval, keep) as j:
            w = _window_saves(j, jstate, n_calls, spd, start)
            p = [j.save(s, jstate) for s in plain]
            j.wait_until_finished()
            want.append((w, p, j.latest_step(), list(j._mgr.all_steps())))
        assert sorted(os.listdir(tmp_path / "t")) == sorted(
            d for d in os.listdir(tmp_path / "j") if d.isdigit())
        start = got[-1][2] + 1
    assert got == want


@pytest.mark.parametrize("name", ("ddpg", "naf"))
def test_weights_only_checkpoint(tmp_path, name):
    """exclude=("replay",): saves skip the ring; a restore takes weights
    and env state from disk and the fresh target's empty ring."""
    agent = _agent(name)
    st, _ = _steps(agent, agent.init(0), 2)
    with CheckpointManager(str(tmp_path / "w"), exclude=("replay",)) as mgr:
        assert mgr.save(0, st)
        assert "replay" not in mgr.saved_keys()
        fresh = agent.init(1)
        fresh_ring = to_tree(fresh)["replay"]
        restored = mgr.restore(fresh)
    tree, back = to_tree(st), to_tree(restored)
    for key in tree:
        if key != "replay":
            _assert_tree_equal(tree[key], back[key], key)
    _assert_tree_equal(fresh_ring, back["replay"])
    assert restored.replay.filled == 0


def test_restore_adapts_to_weights_only_save(tmp_path, capsys):
    """A weights-only save restores through a manager without the
    exclusion: the fields on disk load, the missing ones keep the fresh
    target's values, with the reference's stderr note."""
    agent = _agent("ddpg")
    st, _ = _steps(agent, agent.init(0), 2)
    with CheckpointManager(str(tmp_path / "w"),
                           exclude=("replay", "env_state", "obs",
                                    "noise")) as mgr:
        assert mgr.save(0, st)
    fresh = agent.init(1)
    obs_fresh = fresh.obs.clone()
    with CheckpointManager(str(tmp_path / "w")) as mgr2:
        restored = mgr2.restore(fresh)
    err = capsys.readouterr().err
    assert ("ckpt: env_state, noise, obs, replay not in checkpoint "
            "(weights-only save?); keeping fresh values") in err
    _assert_tree_equal(to_tree(st)["actor"], to_tree(restored)["actor"])
    assert torch.equal(restored.obs, obs_fresh)
    assert restored.replay.filled == 0


def test_weights_only_restore_of_full_save(tmp_path):
    """The reverse: a full save restored with exclude=("replay",) reads
    just the requested fields."""
    agent = _agent("ddpg")
    st, _ = _steps(agent, agent.init(0), 2)
    save_checkpoint(str(tmp_path / "full"), st)
    fresh = agent.init(1)
    fresh_ring = to_tree(fresh)["replay"]
    restored = restore_checkpoint(str(tmp_path / "full"), fresh,
                                  exclude=("replay",))
    _assert_tree_equal(to_tree(st)["critic"], to_tree(restored)["critic"])
    _assert_tree_equal(fresh_ring, to_tree(restored)["replay"])


@pytest.mark.parametrize("direction", ("kernel->xla", "xla->kernel"))
@pytest.mark.parametrize("name", AGENTS)
def test_checkpoint_crosses_learner_layouts(tmp_path, name, direction):
    """A checkpoint of the kernel learner (its group buffers behind the
    modules' parameters) restores into a plain-learner agent with equal
    parameters and moments, and the other way round; in kernel mode the
    restore writes into the group buffers' views without rebinding them,
    so the learner keeps reading the restored values."""
    src, dst = direction.split("->")
    a_src, a_dst = _agent(name, src), _agent(name, dst)
    st, _ = _steps(a_src, a_src.init(0), 3)
    save_checkpoint(str(tmp_path / "ck"), st)
    target = a_dst.init(5)
    groups = target.groups
    restored = restore_checkpoint(str(tmp_path / "ck"), target)
    _assert_tree_equal(to_tree(st), to_tree(restored))
    if dst == "kernel":
        assert restored.groups is groups
        module = next(m for m in restored if isinstance(m, torch.nn.Module))
        first = next(module.parameters())
        assert first.data_ptr() == groups[0].data_ptr()
        assert torch.equal(groups[0][:first.numel()], first.reshape(-1))
    # One more step each from equal states: the two learners agree within
    # float32 rounding (they sum in other orders), rtol 2e-4 / atol 1e-5.
    s1, m1 = a_src.train_step(st)
    s2, m2 = a_dst.train_step(restored)
    for key in ("critic_loss", "loss"):
        if key in m1:
            np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                       rtol=2e-4, atol=1e-5)
