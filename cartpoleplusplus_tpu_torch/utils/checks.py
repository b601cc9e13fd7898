"""Numerical guards (cartpoleplusplus_tpu/utils/checks.py in torch).

`checked_step` wraps an env's step so that NaN/Inf or out-of-chart states
surface as hard errors with a named check instead of silently corrupting
a batch of thousands of envs. Every check of a step is one element of a
stacked boolean tensor, fetched to the host once per step; the error
object keeps the reference's call shape (`err.throw()` raises the first
failed check, in the reference's order, with its message). No production
path imports this module.
"""

from __future__ import annotations

import torch

_FIELDS = ("pos", "vel", "s", "sd")


class CheckError(ValueError):
    """A failed check (the reference raises checkify's JaxRuntimeError,
    a ValueError)."""


class Error:
    """The outcome of a checked call: `get()` is the first failed check's
    message or None, `throw()` raises it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise CheckError(self.message)


def _state_checks(env, state) -> list:
    """[(ok, message)] over an EnvState, each ok a 0-d bool tensor."""
    p, ph = env.params, state.phys
    checks = [(torch.isfinite(getattr(ph, name)).all(),
               f"non-finite {name} in EnvState") for name in _FIELDS]
    checks.append(((ph.s * ph.s).sum(-1).le(p.s_norm_max ** 2 + 1e-6).all(),
                   "pole direction left the |s| chart"))
    checks.append((ph.vel.abs().le(p.vel_max + 1e-3).all(),
                   "velocity exceeded vel_max clamp"))
    checks.append((state.steps.ge(0).all(), "negative step counter"))
    return checks


def _first_failure(checks) -> Error:
    """One host fetch of every check: the first that failed, or none."""
    ok = torch.stack([c for c, _ in checks]).cpu()
    bad = (~ok).nonzero()
    return Error(checks[int(bad[0])][1] if len(bad) else None)


def check_state(env, state) -> None:
    """Raise CheckError on the first failed check over an EnvState."""
    _first_failure(_state_checks(env, state)).throw()


def checked_step(env):
    """An env.step twin that reports numerical corruption.

    Returns fn(state, action) -> (err, (state, obs, reward, done, info));
    call `err.throw()` to raise. For debugging sessions and soak tests,
    not the hot path.
    """

    def step(state, action):
        new_state, obs, reward, done, info = env.step(state, action)
        checks = _state_checks(env, new_state) + [
            (torch.isfinite(obs).all(), "non-finite observation"),
            (torch.isfinite(reward).all(), "non-finite reward")]
        return _first_failure(checks), (new_state, obs, reward, done, info)

    return step


def _leaves(tree, path=""):
    """(path, tensor) for every tensor or array of a nested structure of
    dicts, sequences, named tuples and modules (their state dicts)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finite check over any nested structure of tensors, arrays
    and numbers (post-fetch debugging)."""
    bad = []
    for path, leaf in _leaves(tree):
        x = torch.as_tensor(leaf)
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")
