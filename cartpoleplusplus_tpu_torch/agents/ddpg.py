"""DDPG actor-learner (cartpoleplusplus_tpu/agents/ddpg.py in torch).

One `train_step` runs `rollout_steps` env-steps with the actor and OU
exploration in the loop (kernel B2 on a CUDA device where it covers the
config, else the plain rollout; its plain twin on the CPU), inserts the
chunk into the device replay, and then runs `updates_per_step` critic +
actor + Polyak updates on presampled column, block or uniform
minibatches.

Pixel observations (`env.obs_mode == "pixels"`) put a conv (or patch)
encoder in front of both nets (VisualActor, VisualCritic), keep the ring
quantized to uint8, and insert each rollout AFTER the update phase, as the
reference does: its first learning step samples the pre-insert ring. No
rollout kernel covers pixels (the env's render runs kernel B10), and the
learner is the plain one.

Sharded (dist/): built on this rank's envs with `group` and `num_shards`,
the agent takes the SPMD learner (`spmd=True`: global replay draws, the
minibatch assembled from every rank's rows, the unsharded program's
result) or the shardmap learner (per-shard draws of batch_size /
num_shards rows, the critic's and the actor's (loss, gradient) each
all-reduced to their mean, or on the kernel route the K minibatches
all-gathered so that every rank runs B3 on the union batch).

The updates run in one of two learners, resolved once at construction
(`learner`): kernel B3 (ops/learner_kernel.py, the whole K-update phase as
one launch; its plain twin on CPU tensors), or the plain learner, torch
autograd with an Adam written as optax.adam computes it (bias correction
by power, eps added outside the square root), so a step from a converted
reference state reproduces the reference's XLA learner.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..env import CartPole3D, EnvState
from ..models import ActorMLP, CriticMLP, VisualActor, VisualCritic, polyak
from ..models.nets import compute_dtype
from ..ops import learner_kernel as lk
from ..ops.policy_rollout import (fusable, policy_rollout,
                                  reference_policy_rollout)
from ..utils import spans
from ..utils.prng import split_seed
from .common import (AdamState, adam_init, adam_update, bind_group,
                     bind_moments, check_block_batch, dist_presample,
                     dist_setup, evaluate_policy, gated_update_scan,
                     gather_batches, global_means, local_batch, lr_schedule,
                     pmean, resolve_learner, resolve_rollout, scheduled_lr)
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """The reference's DDPGConfig, every field kept so that flags and
    configs carry over. `_SUPPORTED` below lists the values the port
    implements; any other value is rejected at construction."""

    hidden: tuple = (256, 256)
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01                # Polyak rate
    batch_size: int = 256            # learner minibatch
    rollout_steps: int = 8           # env-steps per train_step
    updates_per_step: int = 16       # gradient updates per train_step
    replay_capacity_per_env: int = 1024
    ou_theta: float = 0.15           # OU mean-reversion
    ou_sigma: float = 0.2            # OU noise scale
    ou_sigma_min: float = 0.02       # floor after decay
    ou_sigma_decay_env_steps: int = 20000  # linear decay horizon (0 = constant)
    warmup_env_steps: int = 16       # slots to fill before learning starts
    dtype: str = "float32"
    sample: str = "column"           # column | block | uniform
    actor_grad_critic: str = "updated"
    polyak_cadence: str = "per_update"
    # "kernel": B3 (its plain twin on the CPU); "xla": the plain torch
    # learner; "auto": B3 on a CUDA device when `kernel_learner_ok`, else
    # the plain learner (with one stderr line on a CUDA device).
    learner: str = "auto"
    learner_block: int = 512         # TPU kernel tiling; unused here
    # The kernel learner's product precision (ops.learner_kernel.mm_mode);
    # the plain learner ignores it.
    learner_precision: str | None = None
    lr_decay_env_steps: int = 0
    lr_end_frac: float = 0.1
    encoder: str = "conv"            # pixel obs only: "conv" | "patch"
    conv_features: tuple = (16, 32, 32)  # the conv encoder's widths


# Fields whose other values select behaviour the port does not have yet.
_SUPPORTED = {
    "dtype": ("float32", "bfloat16"),
    "sample": ("column", "block", "uniform"),
    "actor_grad_critic": ("updated", "pre"),
    "polyak_cadence": ("per_update", "per_step"),
    "learner": ("auto", "kernel", "xla"),
    "learner_precision": lk.PRECISIONS,
    "encoder": ("conv", "patch"),
}


class DDPGState(NamedTuple):
    actor: ActorMLP            # VisualActor on pixel obs
    critic: CriticMLP          # VisualCritic on pixel obs
    actor_target: ActorMLP
    critic_target: CriticMLP
    actor_opt: AdamState
    critic_opt: AdamState
    replay: ReplayState
    env_state: EnvState
    obs: torch.Tensor          # (B, *obs_shape) current observation
    noise: torch.Tensor        # (B, act_dim) OU noise state
    generator: torch.Generator  # replay sampling (CPU)
    env_steps: int             # env-steps taken (per env)
    # Kernel mode: the 8 group buffers (actor, critic, actor_target,
    # critic_target, then the Adam moments m_a, v_a, m_c, v_c) whose views
    # are the modules' parameters and the AdamStates' moments
    # (ops/learner_kernel.py documents the layout). None otherwise.
    groups: tuple | None = None


class DDPG:
    """DDPG agent over a batched CartPole3D on one device (this rank's
    shard of the envs when `group` is given)."""

    def __init__(self, env: CartPole3D, config: DDPGConfig = DDPGConfig(),
                 group=None, num_shards: int = 1, spmd: bool = False):
        """group / num_shards: a dist.mesh.Mesh of num_shards ranks when
        the agent runs one rank's shard of the envs (env is then the
        per-rank env); spmd picks the SPMD learner, else the shardmap
        learner (the reference's dist_axis)."""
        if env.params.discrete_actions:
            raise ValueError("DDPG needs the continuous env "
                             "(CartPoleParams(discrete_actions=False))")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"DDPGConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        self.env = env
        self.cfg = config
        dist_setup(self, group, num_shards, spmd)
        check_block_batch(config.sample, self.local_batch_size,
                          env.num_envs * (self.num_shards if spmd else 1),
                          "ddpg")
        pixels = env.obs_mode == "pixels"
        self.replay = ReplayBuffer(env.num_envs,
                                   config.replay_capacity_per_env,
                                   env.obs_size, env.action_dim, env.device,
                                   obs_shape=env.obs_shape,
                                   quantize_obs=pixels)
        on_cuda = env.device.type == "cuda"
        # Resolved once: the kernel learner keeps its state in the 8 group
        # buffers (state_from_tree), so the choice shapes init().
        self.kernel_mode = resolve_learner(
            config.learner, self.kernel_learner_ok(), on_cuda)
        self.kernel_rollout = resolve_rollout(
            "ddpg", "B2", self.fusable(), on_cuda,
            "ops.policy_rollout.fusable")

    @property
    def local_batch_size(self) -> int:
        """Rows this rank samples per update: batch_size / num_shards under
        the shardmap learner, else the whole batch."""
        return local_batch(self.cfg.batch_size,
                           1 if self.spmd else self.num_shards)

    def kernel_learner_ok(self) -> bool:
        """Whether kernel B3 covers this config: state observations, at
        least two hidden layers (the action joins at layer 1; any depth and
        width), float32, the per-update Polyak cadence (per_step runs on the plain
        learner only, as in the reference), at least one update, and under
        the shardmap learner a batch that splits evenly over the shards."""
        c = self.cfg
        return (self.env.obs_mode != "pixels"
                and (self.spmd or c.batch_size % self.num_shards == 0)
                and lk.covers(self.env.obs_size, c.hidden)
                and c.updates_per_step >= 1
                and c.actor_grad_critic in ("updated", "pre")
                and c.polyak_cadence == "per_update"
                and c.dtype == "float32")

    # --- init ---------------------------------------------------------------
    def init(self, seed: int) -> DDPGState:
        """Fresh state: networks from a torch.Generator seeded with `seed`,
        envs reset as the reference's `init` resets them (its key
        split(PRNGKey(seed), 4)[2]), empty replay."""
        env, c, dev = self.env, self.cfg, self.env.device
        g = torch.Generator().manual_seed(seed)
        h, dt = tuple(c.hidden), compute_dtype(c.dtype)
        if env.obs_mode == "pixels":
            vis = dict(features=tuple(c.conv_features), encoder=c.encoder,
                       generator=g, dtype=dt)
            actor = VisualActor(env.obs_shape, env.action_dim, h, **vis)
            critic = VisualCritic(env.obs_shape, env.action_dim, h, **vis)
        else:
            actor = ActorMLP(env.obs_size, env.action_dim, h, generator=g,
                             dtype=dt)
            critic = CriticMLP(env.obs_size, env.action_dim, h, generator=g,
                               dtype=dt)
        actor, critic = actor.to(dev), critic.to(dev)
        env_state, obs = env.reset(split_seed(seed, 4, 2), self.index_offset)
        st = DDPGState(
            actor=actor,
            critic=critic,
            actor_target=copy.deepcopy(actor),
            critic_target=copy.deepcopy(critic),
            actor_opt=adam_init(actor),
            critic_opt=adam_init(critic),
            replay=self.replay.init(),
            env_state=env_state,
            obs=obs,
            noise=torch.zeros((env.num_envs, env.action_dim),
                              dtype=torch.float32, device=dev),
            generator=torch.Generator().manual_seed(seed + 1),
            env_steps=0)
        return self.state_from_tree(st)

    def state_from_tree(self, st: DDPGState) -> DDPGState:
        """A state whose modules own their parameters -> this agent's native
        layout. In kernel mode the parameters, targets and Adam moments are
        copied into the 8 group buffers and rebound as views of them (the
        modules, B2's pack_actor, evaluate and the plain learner keep
        working on them); otherwise, and for a state already bound, it is
        the identity."""
        if not self.kernel_mode or st.groups is not None:
            return st
        obs_dim, h = self.env.obs_size, tuple(self.cfg.hidden)
        lay_a, lay_c = lk.actor_layout(obs_dim, h), lk.critic_layout(obs_dim,
                                                                     h)
        nets = [bind_group(net, lay) for net, lay in (
            (st.actor, lay_a), (st.critic, lay_c), (st.actor_target, lay_a),
            (st.critic_target, lay_c))]
        opts, moments = [], []
        for opt, lay in ((st.actor_opt, lay_a), (st.critic_opt, lay_c)):
            (m_buf, mu), (v_buf, nu) = (bind_moments(opt.mu, lay),
                                        bind_moments(opt.nu, lay))
            opts.append(opt._replace(mu=mu, nu=nu))
            moments += [m_buf, v_buf]
        return st._replace(actor_opt=opts[0], critic_opt=opts[1],
                           groups=tuple(nets + moments))

    # --- acting -------------------------------------------------------------
    def fusable(self) -> bool:
        """Whether kernel B2 covers this env/config shape."""
        return fusable(self.env, tuple(self.cfg.hidden))

    def _sigma(self, env_steps: int) -> float:
        """OU sigma, decayed linearly in float32 as the reference does."""
        c = self.cfg
        if c.ou_sigma_decay_env_steps <= 0:
            return float(np.float32(c.ou_sigma))
        frac = np.float32(env_steps) / np.float32(c.ou_sigma_decay_env_steps)
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c.ou_sigma)
                     + frac * np.float32(c.ou_sigma_min - c.ou_sigma))

    # --- learning -----------------------------------------------------------
    def _critic_loss(self, critic, actor_target, critic_target, batch):
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        with torch.no_grad():
            a_next = actor_target(next_obs)
            q_next = critic_target(next_obs, a_next)
            y = reward + c.gamma * (1.0 - done.to(torch.float32)) * q_next
        q = critic(obs, action)
        return torch.mean(torch.square(q - y))

    def _actor_loss(self, actor, critic, obs):
        return -torch.mean(critic(obs, actor(obs)))

    def _learner_step(self, st: DDPGState, closs, obs):
        """Critic Adam step on `closs`, then the actor's: through the critic
        as updated ("updated") or as it was before it ("pre", whose actor
        gradient is taken before the critic moves)."""
        c = self.cfg
        sched = lr_schedule(c)
        critic_lr = scheduled_lr(c.critic_lr, sched, st.critic_opt.count)
        cgrad = torch.autograd.grad(closs, list(st.critic.parameters()))
        closs, cgrad = pmean(self, closs, cgrad)
        pre = c.actor_grad_critic == "pre"
        if not pre:
            copt = adam_update(st.critic, cgrad, st.critic_opt, critic_lr)
        aloss = self._actor_loss(st.actor, st.critic, obs)
        agrad = torch.autograd.grad(aloss, list(st.actor.parameters()))
        aloss, agrad = pmean(self, aloss, agrad)
        if pre:
            copt = adam_update(st.critic, cgrad, st.critic_opt, critic_lr)
        aopt = adam_update(st.actor, agrad, st.actor_opt,
                           scheduled_lr(c.actor_lr, sched, st.actor_opt.count))
        return (st._replace(actor_opt=aopt, critic_opt=copt),
                {"critic_loss": closs.detach(), "actor_loss": aloss.detach()})

    def _update_once(self, st: DDPGState, batch):
        """Critic TD step, actor step, then Polyak on both targets (per
        update; the per_step cadence pulls once after the phase)."""
        c = self.cfg
        closs = self._critic_loss(st.critic, st.actor_target,
                                  st.critic_target, batch)
        st, m = self._learner_step(st, closs, batch[0])
        if c.polyak_cadence == "per_update":
            polyak(st.actor_target, st.actor, c.tau)
            polyak(st.critic_target, st.critic, c.tau)
        return st, m

    def _frozen_target_update_scan(self, st: DDPGState, batches):
        """per_step-Polyak plain learner: the targets are frozen across the
        K updates, so the TD targets of all K minibatches are one (K*B)-row
        pass through the target nets; then the K critic and actor steps."""
        c = self.cfg
        obs, action, reward, next_obs, done = batches
        kk, bs = reward.shape
        with torch.no_grad():
            nobs = next_obs.reshape((kk * bs,) + next_obs.shape[2:])
            q_next = st.critic_target(nobs, st.actor_target(nobs))
            y = (reward.reshape(-1) + c.gamma
                 * (1.0 - done.reshape(-1).to(torch.float32))
                 * q_next).reshape(kk, bs)
        metrics = []
        for k in range(kk):
            closs = torch.mean(torch.square(
                st.critic(obs[k], action[k]) - y[k]))
            st, m = self._learner_step(st, closs, obs[k])
            metrics.append(m)
        return st, {key: torch.stack([m[key] for m in metrics]).mean()
                    for key in metrics[0]}

    def _kernel_update_phase(self, st: DDPGState, batches):
        """The K-update phase through B3's wrapper: the 8 group buffers
        updated in place, the Adam counts advanced by K (under shardmap on
        the all-gathered union batches)."""
        c = self.cfg
        batches = gather_batches(self, batches)
        t0 = st.actor_opt.count
        closs, aloss = lk.ddpg_update_phase(
            st.groups, tuple(x.contiguous() for x in batches), t0, c.hidden,
            actor_lr=c.actor_lr,
            critic_lr=c.critic_lr, gamma=c.gamma, tau=c.tau,
            actor_grad_critic=c.actor_grad_critic,
            lr_schedule=lr_schedule(c), mm_precision=c.learner_precision)
        count = t0 + c.updates_per_step
        st = st._replace(actor_opt=st.actor_opt._replace(count=count),
                         critic_opt=st.critic_opt._replace(count=count))
        return st, {"critic_loss": closs.mean(), "actor_loss": aloss.mean()}

    def greedy_policy(self, st: DDPGState):
        """Deterministic actor fn(obs) -> action (no OU noise)."""
        return st.actor

    def evaluate(self, st: DDPGState, num_steps: int = 200, seed: int = 0):
        """Deterministic-actor evaluation (no OU noise): episode stats (over
        every rank's envs when sharded)."""
        return evaluate_policy(self.env, st.actor, seed, num_steps,
                               index_offset=self.index_offset,
                               mesh=self.group, spmd=self.spmd)

    # --- the actor-learner step ---------------------------------------------
    def train_step(self, st: DDPGState, fused=None, indices=None,
                   capture: bool = False):
        """rollout_steps env-steps + replay insert + updates_per_step
        gradient updates. Networks and the replay ring are updated in
        place; the returned state carries the new counters and tensors.

        fused: None runs the rollout resolved at construction (B2 on a
        CUDA device where it covers the config, else the plain rollout);
        True runs it through B2's wrapper, which launches the kernel for
        CUDA tensors (and raises for a shape the kernel does not cover) and
        runs the plain twin for CPU tensors; False runs the plain rollout
        on any device. `rollout_impl` reports which ran. The updates run in
        the learner resolved at construction; `learner_impl` reports which
        (1.0 B3's wrapper, 0.0 the plain learner). indices: optional
        presample draws ((slots, offs) for column and block sampling,
        (env_idx, slot) for uniform) in place of the state's generator
        (under shardmap this rank's draws over its ring, under SPMD the
        global draws).

        A quantized (pixel) ring takes the rollout after the update phase,
        as the reference's late insert does. capture=True adds the rollout's time-major trajectory (obs, action,
        reward, done) to the metrics as "traj", the event-log sink's
        input (the reference's `make_train_step(capture=True)`)."""
        c = self.cfg
        env_steps = st.env_steps + c.rollout_steps
        with spans.span("cp.train_step", str(env_steps)):
            sigma = self._sigma(st.env_steps)
            kernel = self.kernel_rollout if fused is None else fused
            run = policy_rollout if kernel else reference_policy_rollout
            with spans.span("cp.rollout"):
                env_state, obs, noise, traj = run(
                    self.env, st.actor, c.ou_theta, st.env_state, st.obs,
                    st.noise, st.env_steps, sigma, c.rollout_steps)
            late_insert = self.replay.quantize_obs
            if not late_insert:
                with spans.span("cp.replay.insert"):
                    st = st._replace(
                        replay=self.replay.add_trajectory(st.replay, *traj))
            st = st._replace(env_state=env_state, obs=obs, noise=noise,
                             env_steps=env_steps)
            ready = (c.warmup_env_steps <= 0
                     or env_steps >= c.warmup_env_steps)
            zero = torch.zeros((), dtype=torch.float32,
                               device=self.env.device)
            losses = {"critic_loss": zero, "actor_loss": zero}
            presample = dist_presample(self, c.batch_size, indices, c.sample)
            if ready and c.updates_per_step > 0:
                with spans.span("cp.learner"):
                    if self.kernel_mode:
                        st, losses = self._kernel_update_phase(
                            st, presample(st, c.updates_per_step))
                    elif c.polyak_cadence == "per_step":
                        st, losses = self._frozen_target_update_scan(
                            st, presample(st, c.updates_per_step))
                    else:
                        st, losses = gated_update_scan(
                            st, self._update_once, c.updates_per_step, True,
                            losses, presample=presample)
            if late_insert:
                with spans.span("cp.replay.insert"):
                    st = st._replace(
                        replay=self.replay.add_trajectory(st.replay, *traj))
            if c.polyak_cadence == "per_step" and ready:
                # Compounded pull: K per-update Polyaks at rate tau move a
                # target by 1-(1-tau)^K toward a fixed online net.
                tau_eff = float(np.float32(1.0 - (1.0 - c.tau)
                                           ** c.updates_per_step))
                polyak(st.actor_target, st.actor, tau_eff)
                polyak(st.critic_target, st.critic, tau_eff)
            metrics = dict(losses)
            metrics["reward_mean"], metrics["done_frac"] = global_means(
                self, traj[2], traj[3])
            metrics["env_steps"] = env_steps
            # 1.0 = kernel B2 ran the rollout, 0.0 = the plain twin did.
            metrics["rollout_impl"] = float(self.env.device.type == "cuda"
                                            and kernel)
            # 1.0 = kernel B3's wrapper ran the learner (its twin on the
            # CPU), 0.0 = the plain learner did.
            metrics["learner_impl"] = float(self.kernel_mode)
            if capture:
                metrics["traj"] = traj
            return st, metrics
