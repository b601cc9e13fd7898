"""Bridges from the JAX reference's state to the port's, for parity tests
and for evaluating weights trained by the reference.

Every input is a tree of numpy arrays (`jax.device_get` of the reference's
state); nothing here imports JAX. flax Dense kernels are (in, out) and are
transposed into torch's Linear (out, in) layout; flax Conv kernels are
(kh, kw, in, out) and become torch's (out, in, kh, kw). flax keeps the
parameters of a bfloat16 net in float32 (`param_dtype`), so one bridge
serves both compute dtypes: the `dtype` argument of the builders only
selects the module's compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..env.cartpole import EnvState
from ..physics.dynamics import PhysState
from .nets import (ActorMLP, CriticMLP, NafNet, PolicyMLP, QNetMLP,
                   VisualActor, VisualCritic, VisualNafNet, VisualPolicy,
                   VisualQNet, compute_dtype)


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


def encoder_state_dict(p, device=None) -> dict:
    """flax PixelEncoder or PatchEncoder params (the `PixelEncoder_0` or
    `PatchEncoder_0` subtree of a Visual* net) -> the port encoder's state
    dict."""
    sd = {}
    if "PixelEncoder_0" in p:
        convs = p["PixelEncoder_0"]
        for i in range(len(convs)):
            k = np.asarray(convs[f"Conv_{i}"]["kernel"])
            sd[f"convs.{i}.weight"] = _t(k.transpose(3, 2, 0, 1).copy(),
                                         device)
            sd[f"convs.{i}.bias"] = _t(convs[f"Conv_{i}"]["bias"], device)
        return sd
    enc = p["PatchEncoder_0"]
    for i in range(len(enc) // 2):
        _dense(sd, f"dense.{i}", enc[f"Dense_{i}"], device)
        _norm(sd, f"norms.{i}", enc[f"LayerNorm_{i}"], device)
    return sd


def _visual_state_dict(tree, hidden, mlp_name, mlp_sd, device) -> dict:
    p = tree["params"]
    sd = {f"encoder.{k}": v for k, v in encoder_state_dict(p, device).items()}
    sd.update({f"mlp.{k}": v for k, v in mlp_sd(
        {"params": p[mlp_name]}, hidden, device).items()})
    return sd


def visual_actor_state_dict(tree, hidden: Sequence[int],
                            device=None) -> dict:
    """flax VisualActor params -> VisualActor state dict."""
    return _visual_state_dict(tree, hidden, "ActorMLP_0", actor_state_dict,
                              device)


def visual_critic_state_dict(tree, hidden: Sequence[int],
                             device=None) -> dict:
    """flax VisualCritic params -> VisualCritic state dict."""
    return _visual_state_dict(tree, hidden, "CriticMLP_0",
                              critic_state_dict, device)


def visual_qnet_state_dict(tree, hidden: Sequence[int],
                           device=None) -> dict:
    """flax VisualQNet params -> VisualQNet state dict."""
    return _visual_state_dict(tree, hidden, "QNetMLP_0", qnet_state_dict,
                              device)


def visual_naf_state_dict(tree, hidden: Sequence[int],
                          device=None) -> dict:
    """flax VisualNafNet params -> VisualNafNet state dict (NafNet's
    three heads packed into one, as `naf_state_dict` packs them)."""
    return _visual_state_dict(tree, hidden, "NafNet_0", naf_state_dict,
                              device)


def visual_policy_state_dict(tree, hidden: Sequence[int],
                             device=None) -> dict:
    """flax VisualPolicy params -> VisualPolicy state dict."""
    return _visual_state_dict(tree, hidden, "PolicyMLP_0",
                              policy_state_dict, device)


def qnet_state_dict(tree, hidden: Sequence[int], device=None) -> dict:
    """flax QNetMLP params -> QNetMLP state dict (the actor's tree
    structure: `_Torso_0` and a `Dense_0` head)."""
    return actor_state_dict(tree, hidden, device)


def policy_state_dict(tree, hidden: Sequence[int], device=None) -> dict:
    """flax PolicyMLP params -> PolicyMLP state dict (QNetMLP's tree)."""
    return actor_state_dict(tree, hidden, device)


def naf_state_dict(tree, hidden: Sequence[int], device=None) -> dict:
    """flax NafNet params -> NafNet state dict: the torso, and the V
    (`Dense_0`), mu (`Dense_1`) and L-entry (`Dense_2`) heads packed into
    the one head of rows [v, mu0, mu1, l0, l1, l2]."""
    p = tree["params"]
    torso = p["_Torso_0"]
    sd = {}
    for i in range(len(hidden)):
        _dense(sd, f"torso.{i}", torso[f"Dense_{i}"], device)
        _norm(sd, f"norms.{i}", torso[f"LayerNorm_{i}"], device)
    heads = [p[f"Dense_{i}"] for i in range(3)]
    sd["head.weight"] = _t(np.concatenate(
        [np.asarray(h["kernel"]).T for h in heads]), device)
    sd["head.bias"] = _t(np.concatenate(
        [np.asarray(h["bias"]) for h in heads]), device)
    return sd


def unflatten_naf(flat, hidden: Sequence[int]):
    """The reference's kernel-mode flat operand list of a NafNet (as
    `unflatten_qnet`'s, with the head rows [v, mu0, mu1, l0, l1, l2, 0,
    0]; ops/learner_kernel.py::flatten_naf) -> the flax tree, in numpy
    (the reference's `unflatten_naf`, which drops the 2 pad rows)."""
    flat = [np.asarray(x) for x in flat]
    ws, wh, rows, bh = flat[:-3], flat[-3], flat[-2], flat[-1]
    p = unflatten_qnet(ws + [wh, rows, bh], hidden, 1)["params"]
    for i, (lo, hi) in enumerate([(0, 1), (1, 3), (3, 6)]):
        p[f"Dense_{i}"] = {"kernel": wh[lo:hi].T, "bias": bh[0, lo:hi]}
    return {"params": p}


def unflatten_qnet(flat, hidden: Sequence[int], num_actions: int = 5):
    """The reference's kernel-mode flat operand list of a QNetMLP or a
    PolicyMLP ([W_0..W_{n-1} (in, out), head W^T padded to (8, H), packed
    rows of (bias, LN scale, LN bias) per layer, head bias (1, 8)];
    ops/learner_kernel.py::flatten_actor) -> the flax tree, in numpy (the
    reference's `unflatten_actor(..., action_dim=5)`)."""
    flat = [np.asarray(x) for x in flat]
    ws, wh, rows, bh = flat[:-3], flat[-3], flat[-2], flat[-1]
    torso = {}
    for i, h in enumerate(hidden):
        torso[f"Dense_{i}"] = {"kernel": ws[i], "bias": rows[3 * i, :h]}
        torso[f"LayerNorm_{i}"] = {"scale": rows[3 * i + 1, :h],
                                   "bias": rows[3 * i + 2, :h]}
    return {"params": {"_Torso_0": torso,
                       "Dense_0": {"kernel": wh[:num_actions].T,
                                   "bias": bh[0, :num_actions]}}}


def actor_from_flax(tree, obs_dim: int, action_dim: int,
                    hidden: Sequence[int], device=None,
                    dtype=torch.float32) -> ActorMLP:
    net = ActorMLP(obs_dim, action_dim, hidden, dtype=dtype).to(device)
    net.load_state_dict(actor_state_dict(tree, hidden, device))
    return net


def critic_from_flax(tree, obs_dim: int, action_dim: int,
                     hidden: Sequence[int], device=None,
                     dtype=torch.float32) -> CriticMLP:
    net = CriticMLP(obs_dim, action_dim, hidden, dtype=dtype).to(device)
    net.load_state_dict(critic_state_dict(tree, hidden, device))
    return net


def visual_actor_from_flax(tree, obs_shape, action_dim: int,
                           hidden: Sequence[int], features=(16, 32, 32),
                           encoder: str = "conv", device=None,
                           dtype=torch.float32) -> VisualActor:
    net = VisualActor(obs_shape, action_dim, hidden, features, encoder,
                      dtype=dtype).to(device)
    net.load_state_dict(visual_actor_state_dict(tree, hidden, device))
    return net


def visual_critic_from_flax(tree, obs_shape, action_dim: int,
                            hidden: Sequence[int], features=(16, 32, 32),
                            encoder: str = "conv", device=None,
                            dtype=torch.float32) -> VisualCritic:
    net = VisualCritic(obs_shape, action_dim, hidden, features, encoder,
                       dtype=dtype).to(device)
    net.load_state_dict(visual_critic_state_dict(tree, hidden, device))
    return net


def qnet_from_flax(tree, obs_dim: int, num_actions: int,
                   hidden: Sequence[int], device=None,
                   dtype=torch.float32) -> QNetMLP:
    net = QNetMLP(obs_dim, num_actions, hidden, dtype=dtype).to(device)
    net.load_state_dict(qnet_state_dict(tree, hidden, device))
    return net


def policy_from_flax(tree, obs_dim: int, num_actions: int,
                     hidden: Sequence[int], device=None,
                     dtype=torch.float32) -> PolicyMLP:
    net = PolicyMLP(obs_dim, num_actions, hidden, dtype=dtype).to(device)
    net.load_state_dict(policy_state_dict(tree, hidden, device))
    return net


def naf_from_flax(tree, obs_dim: int, action_dim: int,
                  hidden: Sequence[int], device=None,
                  dtype=torch.float32) -> NafNet:
    net = NafNet(obs_dim, action_dim, hidden, dtype=dtype).to(device)
    net.load_state_dict(naf_state_dict(tree, hidden, device))
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


def _obs_from_jax(obs, device):
    """An observation batch: uint8 frames stay uint8, the rest float32."""
    obs = np.asarray(obs)
    return _t(obs if obs.dtype == np.uint8 else obs.astype(np.float32),
              device)


def _replay_from_jax(rs, device):
    from ..agents.replay import ReplayState

    action = np.asarray(rs.action)
    return ReplayState(
        obs=_obs_from_jax(rs.obs, device),  # a pixel ring stays uint8
        action=_t(action.astype(np.int32 if action.ndim == 2
                                else np.float32), device),
        reward=_t(np.asarray(rs.reward, np.float32), device),
        done=_t(np.asarray(rs.done, bool), device),
        cursor=int(np.asarray(rs.cursor)),
        filled=int(np.asarray(rs.filled)))


def ddpg_state_from_jax(agent, st, generator=None):
    """JAX DDPGState in the tree layout (learner='xla', or a kernel-mode
    state through the reference's `state_to_tree`), numpy leaves -> the
    port's DDPGState for `agent` (a port DDPG of the same config), in the
    agent's native layout. Optimizer moments, replay ring (uint8 for
    pixels) and counters carry over; the replay sampling generator is the
    given one (or a fresh one)."""
    from ..agents.common import AdamState
    from ..agents.ddpg import DDPGState

    c, env, dev = agent.cfg, agent.env, agent.env.device
    h, act_dim = tuple(c.hidden), env.action_dim
    dt = compute_dtype(c.dtype)
    if env.obs_mode == "pixels":
        vis = (env.obs_shape, act_dim, h, tuple(c.conv_features), c.encoder)

        def actor_from(t):
            return visual_actor_from_flax(t, *vis, device=dev, dtype=dt)

        def critic_from(t):
            return visual_critic_from_flax(t, *vis, device=dev, dtype=dt)

        actor_sd, critic_sd = visual_actor_state_dict, visual_critic_state_dict
    else:
        def actor_from(t):
            return actor_from_flax(t, env.obs_size, act_dim, h, dev, dt)

        def critic_from(t):
            return critic_from_flax(t, env.obs_size, act_dim, h, dev, dt)

        actor_sd, critic_sd = actor_state_dict, critic_state_dict
    actor, critic = actor_from(st.actor), critic_from(st.critic)

    def adam(opt, module, to_sd):
        adam_state = opt[0]
        return AdamState(
            count=int(np.asarray(adam_state.count)),
            mu=_in_param_order(module, to_sd(adam_state.mu, h, dev)),
            nu=_in_param_order(module, to_sd(adam_state.nu, h, dev)))

    return agent.state_from_tree(DDPGState(
        actor=actor,
        critic=critic,
        actor_target=actor_from(st.actor_target),
        critic_target=critic_from(st.critic_target),
        actor_opt=adam(st.actor_opt, actor, actor_sd),
        critic_opt=adam(st.critic_opt, critic, critic_sd),
        replay=_replay_from_jax(st.replay, dev),
        env_state=env_state_from_jax(st.env_state, dev),
        obs=_obs_from_jax(st.obs, dev),
        noise=_t(np.asarray(st.noise, np.float32), dev),
        generator=generator if generator is not None else torch.Generator(),
        env_steps=int(np.asarray(st.env_steps))))


def _net_bridge(agent, n_out: int, flat, visual, unflatten):
    """(net_from, sd_of) for one network of `agent`: a flax tree (or the
    reference's kernel-mode flat list, through `unflatten`) -> a module of
    the agent's obs mode on its device, and -> that module's state dict
    (for the Adam moments). `flat` and `visual` are (module class,
    state-dict bridge) for state and pixel observations."""
    c, env, dev = agent.cfg, agent.env, agent.env.device
    h, dt = tuple(c.hidden), compute_dtype(c.dtype)
    if env.obs_mode == "pixels":
        cls, to_sd = visual

        def make():
            return cls(env.obs_shape, n_out, h, tuple(c.conv_features),
                       c.encoder, dtype=dt)
    else:
        cls, to_sd = flat

        def make():
            return cls(env.obs_size, n_out, h, dtype=dt)

    def sd_of(x):
        if isinstance(x, (list, tuple)):
            x = unflatten(x, h)
        return to_sd(x, h, dev)

    def net_from(x):
        net = make().to(dev)
        net.load_state_dict(sd_of(x))
        return net
    return net_from, sd_of


def dqn_state_from_jax(agent, st, generator=None):
    """JAX DQNState (numpy leaves) -> the port's DQNState for `agent` (a
    port DQN of the same config, state or pixel obs), in the agent's native
    layout. Both of the reference's layouts are taken: the flax trees of
    its XLA learner and the flat operand lists of its kernel mode. Adam
    moments, replay ring (uint8 for pixels) and counters carry over; the
    replay sampling generator is the given one (or a fresh one)."""
    from ..agents.common import AdamState
    from ..agents.dqn import DQNState

    na, dev = agent.env.num_actions, agent.env.device
    net_from, sd_of = _net_bridge(
        agent, na, (QNetMLP, qnet_state_dict),
        (VisualQNet, visual_qnet_state_dict),
        lambda x, h: unflatten_qnet(x, h, na))
    q = net_from(st.q)
    adam_state = st.opt[0]
    return agent.state_from_tree(DQNState(
        q=q,
        q_target=net_from(st.q_target),
        opt=AdamState(count=int(np.asarray(adam_state.count)),
                      mu=_in_param_order(q, sd_of(adam_state.mu)),
                      nu=_in_param_order(q, sd_of(adam_state.nu))),
        replay=_replay_from_jax(st.replay, dev),
        env_state=env_state_from_jax(st.env_state, dev),
        obs=_obs_from_jax(st.obs, dev),
        generator=generator if generator is not None else torch.Generator(),
        env_steps=int(np.asarray(st.env_steps))))


def lrpg_state_from_jax(agent, st):
    """JAX LRPGState (numpy leaves) -> the port's LRPGState for `agent` (a
    port LRPG of the same config, state or pixel obs), in the agent's
    native layout. Both of the reference's layouts are taken: the flax tree
    of its XLA learner and the flat operand list of its kernel mode.
    Policy, Adam moments and count, return baseline, env state, obs (uint8
    frames stay uint8) and counters carry over."""
    from ..agents.common import AdamState
    from ..agents.lrpg import LRPGState

    na, dev = agent.env.num_actions, agent.env.device
    net_from, sd_of = _net_bridge(
        agent, na, (PolicyMLP, policy_state_dict),
        (VisualPolicy, visual_policy_state_dict),
        lambda x, h: unflatten_qnet(x, h, na))
    policy = net_from(st.params)
    adam_state = st.opt[0]
    return agent.state_from_tree(LRPGState(
        policy=policy,
        opt=AdamState(count=int(np.asarray(adam_state.count)),
                      mu=_in_param_order(policy, sd_of(adam_state.mu)),
                      nu=_in_param_order(policy, sd_of(adam_state.nu))),
        baseline=_t(np.asarray(st.baseline, np.float32), dev),
        env_state=env_state_from_jax(st.env_state, dev),
        obs=_obs_from_jax(st.obs, dev),
        env_steps=int(np.asarray(st.env_steps))))


def naf_state_from_jax(agent, st, generator=None):
    """JAX NAFState (numpy leaves) -> the port's NAFState for `agent` (a
    port NAF of the same config, state or pixel obs), in the agent's native
    layout. Both of the reference's layouts are taken (the flax trees of
    its XLA learner, the flat operand lists of its kernel mode), and both
    optax nestings: the Adam state sits at opt[1][0] behind the global-norm
    clip (max_grad_norm > 0) and at opt[0] without it (the reference's
    NAF._adam_state). Parameters, target, Adam moments and count, replay
    ring (uint8 for pixels), env state, obs and counters carry over; the
    replay sampling generator is the given one (or a fresh one)."""
    from ..agents.common import AdamState
    from ..agents.naf import NAFState

    dev = agent.env.device
    net_from, sd_of = _net_bridge(
        agent, agent.env.action_dim, (NafNet, naf_state_dict),
        (VisualNafNet, visual_naf_state_dict), unflatten_naf)
    net = net_from(st.params)
    adam_state = (st.opt[1][0] if agent.cfg.max_grad_norm > 0.0
                  else st.opt[0])
    return agent.state_from_tree(NAFState(
        net=net,
        target=net_from(st.target),
        opt=AdamState(count=int(np.asarray(adam_state.count)),
                      mu=_in_param_order(net, sd_of(adam_state.mu)),
                      nu=_in_param_order(net, sd_of(adam_state.nu))),
        replay=_replay_from_jax(st.replay, dev),
        env_state=env_state_from_jax(st.env_state, dev),
        obs=_obs_from_jax(st.obs, dev),
        generator=generator if generator is not None else torch.Generator(),
        env_steps=int(np.asarray(st.env_steps))))
