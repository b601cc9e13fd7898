"""The driver of an agent's train step: the window drives
`agent.train_step(state)` of the program's agent, built by
`cartpoleplusplus_tpu_torch.train.build` from the cell's flags, back to
back as the training CLI calls it, with no event log and no checkpoints.

Set-up loads the weights that the benchmark made from the seed into each
net (and its target net, where the configuration names one), starts each
net's Adam from the second moment weights.ADAM_V0, and drives the compared
steps; then the warm-up, until the agent's state has filled (the replay
ring has wrapped once, for an agent that has one). The agent's plain
reference, `reference/<agent>.py`, follows the compared steps from the
same seed and weights; compare.py gives the numbers.
"""

from __future__ import annotations

import importlib

from .. import compare, weights
from ..faults import FAULTS
from ..reference.env import EnvParams

numbers = compare.numbers


def reference_module(cell):
    return importlib.import_module(f"port_bench.reference.{cell.agent}")


def schedule(cell) -> tuple:
    """(the first train step that learns, the compared steps, set-up's
    steps). The agent's reference gives the first and the steps until the
    agent's state has filled (`schedule(settings)`: its warm-up and its
    ring's wrap); an agent whose reference gives none learns from the
    first step and fills nothing. The reference follows the first three
    steps, or as far as the first that learns."""
    fn = getattr(reference_module(cell), "schedule", None)
    first, fill = fn(cell.settings) if fn else (1, 0)
    compared = max(3, first)
    return first, compared, max(fill, compared)


def work_per_step(cell) -> int:
    """Env-steps of one train step."""
    return cell.num_envs * cell.settings["rollout_steps"]


def _flag(name: str, value) -> list:
    flag = "--" + name.replace("_", "-")
    if value is None:
        return []
    if isinstance(value, bool):
        return [flag if value else flag.replace("--", "--no-", 1)]
    if isinstance(value, list):
        return [flag] + [str(v) for v in value]
    return [flag, str(value)]


def program_argv(cell, device, precision: str | None = None) -> list:
    """The training CLI's flags of the cell; `precision` sets the learner's
    product precision (the control's lower precision)."""
    settings = dict(cell.settings)
    if precision is not None:
        settings["learner_precision"] = precision
    argv = ["--agent", cell.agent, "--num-envs", str(cell.num_envs),
            "--obs-mode", cell.config["obs_mode"], "--device", str(device)]
    for k, v in cell.config["env"].items():
        argv += _flag(f"env.{k}", v)
    for k, v in settings.items():
        argv += _flag(f"{cell.agent}.{k}", v)
    return argv


def build_agent(cell, device, precision: str | None = None):
    """The program's agent, built by its training CLI's `build`."""
    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import (RunConfig, explicit_dests,
                                                   from_args)

    argv = program_argv(cell, device, precision)
    args = train.build_parser().parse_args(argv)
    provided = explicit_dests(train.build_parser(), argv)
    _, agent = train.build(from_args(RunConfig, args), args, provided)
    return agent


def build(cell, device, precision: str | None = None,
          fault: str | None = None) -> tuple:
    """(agent, the train step to drive): `fault` plants one of
    faults.FAULTS, `precision` sets the learner's product precision."""
    agent = build_agent(cell, device, precision)
    step = (agent.train_step if fault is None
            else FAULTS[fault](cell, agent))
    return agent, step


def initial_weights(cell, seed: int, device) -> dict:
    return weights.make(reference_module(cell).shapes(
        cell.settings, cell.config["obs_dim"]), seed, device)


def _named(module) -> dict:
    return dict(module.named_parameters())


def load_weights(cell, state, init: dict) -> None:
    """Copy the initial weights into each net and, where the configuration
    names one, its target net, by name, and start each net's Adam from the
    second moment weights.ADAM_V0."""
    import torch

    with torch.no_grad():
        for net, spec in cell.config["nets"].items():
            for v in getattr(state, spec["opt"]).nu:
                v.fill_(weights.ADAM_V0)
            for role in ("module", "target"):
                if role not in spec:
                    continue
                params = _named(getattr(state, spec[role]))
                if {k: tuple(v.shape) for k, v in params.items()} != {
                        k: tuple(v.shape) for k, v in init[net].items()}:
                    raise ValueError(f"{net}: the program's parameters do "
                                     f"not match the reference's shapes")
                for k, p in params.items():
                    p.copy_(init[net][k])


def _moments(cell, state) -> dict:
    out = {}
    for net, spec in cell.config["nets"].items():
        names = [k for k, _ in getattr(state, spec["module"])
                 .named_parameters()]
        mu = getattr(state, spec["opt"]).mu
        out[net] = {k: m.detach().clone() for k, m in zip(names, mu)}
    return out


def _weights(cell, state) -> dict:
    return {net: {k: p.detach().clone() for k, p in
                  _named(getattr(state, spec["module"])).items()}
            for net, spec in cell.config["nets"].items()}


def first_steps(cell, step, state):
    """Drive the program's compared train steps: (state, Readings of the
    losses of the first that learns, the first moments after it and the
    weights after the last, the last step's metrics)."""
    first, compared, _ = schedule(cell)
    for i in range(1, compared + 1):
        state, metrics = step(state)
        if i == first:
            losses = {k: float(metrics[k]) for k in cell.config["losses"]}
            moments = _moments(cell, state)
    return (state, compare.Readings(losses, moments, _weights(cell, state)),
            metrics)


def setup(cell, agent, step, seed: int, device, warm: bool = True):
    """From the seed's weights through the compared steps and, with
    `warm`, the warm-up: (state, the program's Readings, the initial
    weights, notes: which implementation ran the rollout and the
    learner)."""
    state = agent.init(seed)
    init = initial_weights(cell, seed, device)
    load_weights(cell, state, init)
    state, prog, metrics = first_steps(cell, step, state)
    if warm:
        _, compared, steps = schedule(cell)
        for _ in range(steps - compared):
            state, metrics = step(state)
    notes = {k: float(metrics[k]) for k in ("rollout_impl", "learner_impl")
             if k in metrics}
    return state, prog, init, notes


def reference(cell, seed: int, init: dict, device) -> compare.Readings:
    """The plain reference over the compared steps, from the same seed and
    initial weights."""
    first, compared, _ = schedule(cell)
    ref = reference_module(cell).Reference(
        cell.settings, EnvParams(**cell.config["env"]), cell.num_envs, init,
        seed, device, weights.ADAM_V0)
    for i in range(1, compared + 1):
        out = ref.train_step()
        if i == first:
            losses = out
            moments = {n: {k: v.clone() for k, v in ref.m[n].items()}
                       for n in ref.nets}
    return compare.Readings(losses, moments, {
        n: {k: v.detach().clone() for k, v in ref.online[n].items()}
        for n in ref.nets})
