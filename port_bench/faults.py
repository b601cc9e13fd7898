"""Faults planted in the program's timed path, for the control's readings
and the tests that see `correct` come out false. The benchmark's own runs
never plant one. Each takes (cell, agent) and returns the train step to
drive in place of `agent.train_step`.

- unchanged: a step that returns its state unchanged;
- half_batch: every minibatch cut to its first half, the learner's mean
  taken over the rest;
- reward: every reward raised by 0.01 where the rollout hands it on.

A cell can have `unchanged` and each fault whose hook its configuration
names under "faults" (hooks.py): `half_batch` wraps the draw of the
minibatches, which returns tensors (K, batch, ...); `reward` wraps the
insert of a rollout, which takes (state, obs, action, reward, done).
"""

from __future__ import annotations

from . import hooks


def _hooked(cell, agent, fault: str, make) -> None:
    target, attr = cell.config["faults"][fault]
    obj = hooks.resolve(agent, target)
    setattr(obj, attr, make(getattr(obj, attr)))


def unchanged(cell, agent):
    zero = {k: 0.0 for k in cell.config["losses"]}
    return lambda st: (st, dict(zero))


def half_batch(cell, agent):
    def make(draw):
        def half(*args, **kwargs):
            return tuple(x[:, :x.shape[1] // 2]
                         for x in draw(*args, **kwargs))
        return half
    _hooked(cell, agent, "half_batch", make)
    return agent.train_step


def reward(cell, agent):
    def make(insert):
        def altered(rs, obs, action, rew, done):
            return insert(rs, obs, action, rew + 0.01, done)
        return altered
    _hooked(cell, agent, "reward", make)
    return agent.train_step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "reward": reward}


def applicable(cell) -> list:
    """The faults a cell can have."""
    return ["unchanged"] + [f for f in FAULTS
                            if f in cell.config.get("faults", {})]
