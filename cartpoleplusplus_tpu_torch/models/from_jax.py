"""Bridges from the JAX reference's state to the port's, for parity tests
and for evaluating weights trained by the reference.

Every input is a tree of numpy arrays (`jax.device_get` of the reference's
state); nothing here imports JAX. flax Dense kernels are (in, out) and are
transposed into torch's Linear (out, in) layout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..env.cartpole import EnvState
from ..physics.dynamics import PhysState
from .nets import ActorMLP, CriticMLP


def _t(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)  # a copy


def _dense(sd, name, d, device):
    sd[f"{name}.weight"] = _t(np.asarray(d["kernel"]).T.copy(), device)
    sd[f"{name}.bias"] = _t(d["bias"], device)


def _norm(sd, name, d, device):
    sd[f"{name}.weight"] = _t(d["scale"], device)
    sd[f"{name}.bias"] = _t(d["bias"], device)


def actor_state_dict(tree, hidden: Sequence[int], device=None) -> dict:
    """flax ActorMLP params -> ActorMLP state dict."""
    p = tree["params"]
    torso = p["_Torso_0"]
    sd = {}
    for i in range(len(hidden)):
        _dense(sd, f"torso.{i}", torso[f"Dense_{i}"], device)
        _norm(sd, f"norms.{i}", torso[f"LayerNorm_{i}"], device)
    _dense(sd, "head", p["Dense_0"], device)
    return sd


def critic_state_dict(tree, hidden: Sequence[int], device=None) -> dict:
    """flax CriticMLP params -> CriticMLP state dict."""
    p = tree["params"]
    sd = {}
    for i in range(len(hidden)):
        _dense(sd, f"torso.{i}", p[f"Dense_{i}"], device)
        _norm(sd, f"norms.{i}", p[f"LayerNorm_{i}"], device)
    _dense(sd, "head", p[f"Dense_{len(hidden)}"], device)
    return sd


def actor_from_flax(tree, obs_dim: int, action_dim: int,
                    hidden: Sequence[int], device=None) -> ActorMLP:
    net = ActorMLP(obs_dim, action_dim, hidden).to(device)
    net.load_state_dict(actor_state_dict(tree, hidden, device))
    return net


def critic_from_flax(tree, obs_dim: int, action_dim: int,
                     hidden: Sequence[int], device=None) -> CriticMLP:
    net = CriticMLP(obs_dim, action_dim, hidden).to(device)
    net.load_state_dict(critic_state_dict(tree, hidden, device))
    return net


def _in_param_order(module: torch.nn.Module, sd: dict) -> list:
    """State-dict tensors in `module.parameters()` order (Adam moments)."""
    return [sd[name].clone() for name, _ in module.named_parameters()]


def env_state_from_jax(st, device=None) -> EnvState:
    """JAX EnvState (numpy leaves) -> the port's EnvState."""
    ph = st.phys
    return EnvState(
        phys=PhysState(*(_t(np.asarray(a, np.float32), device)
                         for a in (ph.pos, ph.vel, ph.s, ph.sd))),
        steps=_t(np.asarray(st.steps, np.int32), device),
        env_seed=_t(np.asarray(st.env_seed, np.uint32).astype(np.int64),
                    device),
        episode=_t(np.asarray(st.episode, np.int32), device))


def ddpg_state_from_jax(agent, st, generator=None):
    """JAX DDPGState of a tree-layout (learner='xla') agent, numpy leaves
    -> the port's DDPGState for `agent` (a port DDPG of the same config).
    Optimizer moments, replay ring and counters carry over; the replay
    sampling generator is the given one (or a fresh one)."""
    from ..agents.ddpg import AdamState, DDPGState
    from ..agents.replay import ReplayState

    c, env, dev = agent.cfg, agent.env, agent.env.device
    h, obs_dim, act_dim = tuple(c.hidden), env.obs_size, env.action_dim
    actor = actor_from_flax(st.actor, obs_dim, act_dim, h, dev)
    critic = critic_from_flax(st.critic, obs_dim, act_dim, h, dev)

    def adam(opt, module, to_sd):
        adam_state = opt[0]
        return AdamState(
            count=int(np.asarray(adam_state.count)),
            mu=_in_param_order(module, to_sd(adam_state.mu, h, dev)),
            nu=_in_param_order(module, to_sd(adam_state.nu, h, dev)))

    rs = st.replay
    return DDPGState(
        actor=actor,
        critic=critic,
        actor_target=actor_from_flax(st.actor_target, obs_dim, act_dim, h,
                                     dev),
        critic_target=critic_from_flax(st.critic_target, obs_dim, act_dim,
                                       h, dev),
        actor_opt=adam(st.actor_opt, actor, actor_state_dict),
        critic_opt=adam(st.critic_opt, critic, critic_state_dict),
        replay=ReplayState(
            obs=_t(np.asarray(rs.obs, np.float32), dev),
            action=_t(np.asarray(rs.action, np.float32), dev),
            reward=_t(np.asarray(rs.reward, np.float32), dev),
            done=_t(np.asarray(rs.done, bool), dev),
            cursor=int(np.asarray(rs.cursor)),
            filled=int(np.asarray(rs.filled))),
        env_state=env_state_from_jax(st.env_state, dev),
        obs=_t(np.asarray(st.obs, np.float32), dev),
        noise=_t(np.asarray(st.noise, np.float32), dev),
        generator=generator if generator is not None else torch.Generator(),
        env_steps=int(np.asarray(st.env_steps)))
