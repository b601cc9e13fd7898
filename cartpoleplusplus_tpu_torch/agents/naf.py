"""NAF (Normalized Advantage Function) on the continuous env
(cartpoleplusplus_tpu/agents/naf.py in torch).

One `train_step` runs `rollout_steps` env-steps with NAF's mu head and
Gaussian exploration in the loop (kernel B6 on a CUDA device where it
covers the config, else the plain rollout; its plain twin on the CPU),
inserts the chunk into the device replay, presamples the K minibatches
(column, block or uniform), and past the warmup runs `updates_per_step`
NAF updates: MSE TD toward r + gamma (1 - done) V'(s'), the global-norm
gradient clip (`max_grad_norm`), Adam under the linear lr schedule, Polyak
on the target.

Pixel observations (`env.obs_mode == "pixels"`) put a conv (or patch)
encoder in front of the net (VisualNafNet), keep the ring quantized to
uint8, and insert each rollout AFTER the update phase, as the reference
does. No rollout kernel covers pixels (the env's render runs kernel B10),
and the learner is the plain one.

The updates run in one of two learners, resolved once at construction
(`learner`): kernel B7 (ops/learner_kernel.py, the whole K-update phase as
one launch; its plain twin on CPU tensors), or the plain learner, torch
autograd through NafNet, optax's clip and optax-exact Adam. The default is
the plain learner ("xla"), as in the reference: NAF's recipes sit on a
basin boundary where the choice of matmul arithmetic alone reroutes whole
runs (docs/design.md §16), and the reference kernel's Q reads the raw mu
rows where NafNet applies tanh (ops/learner_kernel.py::naf_q), so the two
learners are different arithmetic on purpose.

Sharded (dist/, `group` / `num_shards`): the SPMD learner (`spmd=True`)
gives the unsharded program's result; the shardmap learner samples
batch_size / num_shards rows per rank and all-reduces the mean of (loss,
gradient) once per update, the global-norm clip taken after it, or on the
kernel route all-gathers the K minibatches so that every rank runs B7 on
the union batch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..env import CartPole3D, EnvState
from ..models import NafNet, VisualNafNet, polyak
from ..models.nets import compute_dtype
from ..ops import learner_kernel as lk
from ..ops.naf_rollout import (naf_action, naf_fusable, naf_policy_rollout,
                               reference_naf_rollout)
from ..utils.prng import split_seed
from .common import (AdamState, adam_init, adam_update, bind_group,
                     bind_moments, check_block_batch, dist_presample,
                     dist_setup, evaluate_policy, gated_update_scan,
                     gather_batches, global_means, local_batch, lr_schedule,
                     pmean, resolve_learner, resolve_rollout, scheduled_lr)
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class NAFConfig:
    """The reference's NAFConfig, every field kept so that flags and
    configs carry over. `_SUPPORTED` below lists the values the port
    implements; any other value is rejected at construction."""

    hidden: tuple = (256, 256)
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    rollout_steps: int = 8
    updates_per_step: int = 8
    replay_capacity_per_env: int = 1024
    noise_sigma: float = 0.2
    noise_sigma_min: float = 0.02    # floor after decay
    noise_sigma_decay_env_steps: int = 30000  # linear horizon (0 = constant)
    max_grad_norm: float = 10.0      # global-norm gradient clip (0 = none)
    warmup_env_steps: int = 16
    dtype: str = "float32"
    sample: str = "column"           # column | block | uniform
    # "kernel": B7 (its plain twin on the CPU); "xla" (the default, as in
    # the reference; module docstring): the plain torch learner; "auto": B7
    # on a CUDA device when `kernel_learner_ok`, else the plain learner
    # (with one stderr line on a CUDA device).
    learner: str = "xla"
    learner_block: int = 512         # TPU kernel tiling; unused here
    # The kernel learner's product precision (ops.learner_kernel.mm_mode);
    # the plain learner ignores it.
    learner_precision: str | None = None
    lr_decay_env_steps: int = 40000  # linear lr decay horizon (0 = constant)
    lr_end_frac: float = 0.1
    encoder: str = "conv"            # pixel obs only: "conv" | "patch"
    conv_features: tuple = (16, 32, 32)  # the conv encoder's widths


# Fields whose other values select behaviour the port does not have yet.
_SUPPORTED = {
    "dtype": ("float32", "bfloat16"),
    "sample": ("column", "block", "uniform"),
    "learner": ("auto", "kernel", "xla"),
    "learner_precision": lk.PRECISIONS,
    "encoder": ("conv", "patch"),
}


class NAFState(NamedTuple):
    net: NafNet                # VisualNafNet on pixel obs
    target: NafNet
    opt: AdamState
    replay: ReplayState
    env_state: EnvState
    obs: torch.Tensor          # (B, *obs_shape) current observation
    generator: torch.Generator  # replay sampling (CPU)
    env_steps: int             # env-steps taken (per env)
    # Kernel mode: the 4 group buffers (net, target, then net's Adam moments
    # m, v) whose views are the modules' parameters and the AdamState's
    # moments (ops/learner_kernel.py documents the layout). None otherwise.
    groups: tuple | None = None


class NAF:
    """NAF agent over a batched continuous CartPole3D on one device."""

    def __init__(self, env: CartPole3D, config: NAFConfig = NAFConfig(),
                 group=None, num_shards: int = 1, spmd: bool = False):
        """group / num_shards: a dist.mesh.Mesh of num_shards ranks when
        the agent runs one rank's shard of the envs (env is then the
        per-rank env); spmd picks the SPMD learner, else the shardmap
        learner (the reference's dist_axis)."""
        if env.params.discrete_actions:
            raise ValueError("NAF needs the continuous env "
                             "(CartPoleParams(discrete_actions=False))")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"NAFConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        self.env = env
        self.cfg = config
        dist_setup(self, group, num_shards, spmd)
        check_block_batch(config.sample, self.local_batch_size,
                          env.num_envs * (self.num_shards if spmd else 1),
                          "naf")
        self.replay = ReplayBuffer(env.num_envs,
                                   config.replay_capacity_per_env,
                                   env.obs_size, env.action_dim, env.device,
                                   obs_shape=env.obs_shape,
                                   quantize_obs=env.obs_mode == "pixels")
        # Resolved once: the kernel learner keeps its state in the 4 group
        # buffers (state_from_tree), so the choice shapes init().
        self.kernel_mode = resolve_learner(
            config.learner, self.kernel_learner_ok(),
            env.device.type == "cuda", agent="naf", kernel="B7")
        self.kernel_rollout = resolve_rollout(
            "naf", "B6", self.fusable(), env.device.type == "cuda",
            "ops.naf_rollout.naf_fusable")

    @property
    def local_batch_size(self) -> int:
        """Rows this rank samples per update: batch_size / num_shards under
        the shardmap learner, else the whole batch."""
        return local_batch(self.cfg.batch_size,
                           1 if self.spmd else self.num_shards)

    def kernel_learner_ok(self) -> bool:
        """Whether kernel B7 covers this config: state observations, 2-D
        actions, at least one hidden layer (any depth and width), float32,
        at least one update, and under the shardmap learner a batch that
        splits evenly over the shards."""
        c = self.cfg
        return (self.env.obs_mode != "pixels"
                and (self.spmd or c.batch_size % self.num_shards == 0)
                and self.env.action_dim == 2
                and lk.naf_covers(self.env.obs_size, c.hidden)
                and c.updates_per_step >= 1
                and c.dtype == "float32")

    def fusable(self) -> bool:
        """Whether kernel B6 covers this env/config shape."""
        return naf_fusable(self.env, tuple(self.cfg.hidden))

    # --- init ---------------------------------------------------------------
    def init(self, seed: int) -> NAFState:
        """Fresh state: the NafNet (VisualNafNet on pixel obs) from a
        torch.Generator seeded with `seed`, envs reset as the reference's
        `init` resets them (its key split(PRNGKey(seed), 3)[1]), empty
        replay."""
        env, c = self.env, self.cfg
        g, dt = torch.Generator().manual_seed(seed), compute_dtype(c.dtype)
        if env.obs_mode == "pixels":
            net = VisualNafNet(env.obs_shape, env.action_dim,
                               tuple(c.hidden), tuple(c.conv_features),
                               c.encoder, generator=g, dtype=dt)
        else:
            net = NafNet(env.obs_size, env.action_dim, tuple(c.hidden),
                         generator=g, dtype=dt)
        net = net.to(env.device)
        env_state, obs = env.reset(split_seed(seed, 3, 1), self.index_offset)
        st = NAFState(net=net, target=copy.deepcopy(net), opt=adam_init(net),
                      replay=self.replay.init(), env_state=env_state,
                      obs=obs,
                      generator=torch.Generator().manual_seed(seed + 1),
                      env_steps=0)
        return self.state_from_tree(st)

    def state_from_tree(self, st: NAFState) -> NAFState:
        """A state whose modules own their parameters -> this agent's native
        layout. In kernel mode the parameters, the target and the Adam
        moments are copied into the 4 group buffers and rebound as views of
        them; otherwise, and for a state already bound, it is the
        identity."""
        if not self.kernel_mode or st.groups is not None:
            return st
        lay = lk.naf_layout(self.env.obs_size, tuple(self.cfg.hidden))
        nets = [bind_group(net, lay) for net in (st.net, st.target)]
        (m_buf, mu), (v_buf, nu) = (bind_moments(st.opt.mu, lay),
                                    bind_moments(st.opt.nu, lay))
        return st._replace(opt=st.opt._replace(mu=mu, nu=nu),
                           groups=(*nets, m_buf, v_buf))

    # --- acting -------------------------------------------------------------
    def _sigma(self, env_steps: int) -> float:
        """Exploration scale, decayed linearly in float32 as the reference
        does; a non-positive horizon holds it at noise_sigma."""
        c = self.cfg
        if c.noise_sigma_decay_env_steps <= 0:
            return float(np.float32(c.noise_sigma))
        frac = (np.float32(env_steps)
                / np.float32(c.noise_sigma_decay_env_steps))
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c.noise_sigma)
                     + frac * np.float32(c.noise_sigma_min - c.noise_sigma))

    @torch.no_grad()
    def act(self, net: NafNet, obs, env_seed=None, t: int | None = None,
            sigma: float | None = None):
        """mu(s), plus counter-PRNG Gaussian exploration clipped to [-1, 1]
        when (env_seed, t) are given."""
        mu = net(obs)[1]
        if env_seed is None:
            return mu
        return naf_action(mu, env_seed, t,
                          self.cfg.noise_sigma if sigma is None else sigma)

    def greedy_policy(self, st: NAFState):
        """mu policy fn(obs) -> action (no exploration)."""
        return lambda o: st.net(o)[1]

    @torch.no_grad()
    def evaluate(self, st: NAFState, num_steps: int = 200, seed: int = 0):
        """mu-policy evaluation (no exploration): episode stats."""
        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps, index_offset=self.index_offset,
                               mesh=self.group, spmd=self.spmd)

    # --- learning -----------------------------------------------------------
    def _loss(self, net, target, batch):
        """MSE of Q(s, a) against r + gamma (1 - done) V'(s')."""
        obs, action, reward, next_obs, done = batch
        with torch.no_grad():
            v_next = target(next_obs)[0]
            y = (reward + self.cfg.gamma * (1.0 - done.to(torch.float32))
                 * v_next)
        q = net(obs, action)[0]
        return torch.mean(torch.square(q - y))

    def _update_once(self, st: NAFState, batch):
        """One TD step: the gradient, optax's clip_by_global_norm ((g /
        norm) * max_norm unless norm < max_norm), Adam at the scheduled lr,
        then Polyak on the target."""
        c = self.cfg
        loss = self._loss(st.net, st.target, batch)
        grads = torch.autograd.grad(loss, list(st.net.parameters()))
        loss, grads = pmean(self, loss, grads)
        if c.max_grad_norm > 0.0:
            norm = lk.global_norm(grads)
            grads = [torch.where(norm < c.max_grad_norm, g,
                                 (g / norm) * c.max_grad_norm)
                     for g in grads]
        opt = adam_update(st.net, grads, st.opt,
                          scheduled_lr(c.lr, lr_schedule(c), st.opt.count))
        polyak(st.target, st.net, c.tau)
        return st._replace(opt=opt), {"loss": loss.detach()}

    def _kernel_update_phase(self, st: NAFState, batches):
        """The K-update phase through B7's wrapper: the 4 group buffers
        updated in place, the Adam count advanced by K (the lr schedule is
        keyed on it)."""
        c = self.cfg
        batches = gather_batches(self, batches)
        loss = lk.naf_update_phase(
            st.groups, tuple(x.contiguous() for x in batches), st.opt.count,
            c.hidden, lr=c.lr, gamma=c.gamma, tau=c.tau,
            max_grad_norm=c.max_grad_norm, lr_schedule=lr_schedule(c),
            mm_precision=c.learner_precision)
        st = st._replace(opt=st.opt._replace(
            count=st.opt.count + c.updates_per_step))
        return st, {"loss": loss.mean()}

    # --- the actor-learner step ---------------------------------------------
    def train_step(self, st: NAFState, indices=None, capture: bool = False):
        """rollout_steps env-steps + replay insert + updates_per_step
        gradient updates. Networks and the replay ring are updated in
        place; the returned state carries the new counters and tensors.

        The rollout runs through B6's wrapper where the agent resolved it
        at construction (a CUDA device and a config B6 covers), else
        through the plain rollout; `rollout_impl` says which ran. The updates run in the learner resolved at
        construction; `learner_impl` says which (1.0 B7's wrapper, 0.0 the
        plain learner). indices: optional presample draws ((slots, offs)
        for column and block sampling, (env_idx, slot) for uniform) in
        place of the state's generator.

        A quantized (pixel) ring takes the rollout after the update phase,
        as the reference's late insert does. capture=True adds the
        rollout's time-major trajectory (obs, action, reward, done) to the
        metrics as "traj", the event-log sink's input (the reference's
        `make_train_step(capture=True)`)."""
        c = self.cfg
        run = (naf_policy_rollout if self.kernel_rollout
               else reference_naf_rollout)
        env_state, obs, traj = run(
            self.env, st.net, st.env_state, st.obs, st.env_steps,
            self._sigma(st.env_steps), c.rollout_steps)
        late_insert = self.replay.quantize_obs
        if not late_insert:
            st = st._replace(replay=self.replay.add_trajectory(st.replay,
                                                               *traj))
        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(env_state=env_state, obs=obs, env_steps=env_steps)
        ready = c.warmup_env_steps <= 0 or env_steps >= c.warmup_env_steps
        losses = {"loss": torch.zeros((), dtype=torch.float32,
                                      device=self.env.device)}
        presample = dist_presample(self, c.batch_size, indices, c.sample)
        if ready and c.updates_per_step > 0:
            if self.kernel_mode:
                st, losses = self._kernel_update_phase(
                    st, presample(st, c.updates_per_step))
            else:
                st, losses = gated_update_scan(
                    st, self._update_once, c.updates_per_step, True, losses,
                    presample=presample)
        if late_insert:
            st = st._replace(replay=self.replay.add_trajectory(st.replay,
                                                               *traj))
        metrics = dict(losses)
        metrics["reward_mean"], metrics["done_frac"] = global_means(
            self, traj[2], traj[3])
        metrics["env_steps"] = env_steps
        # 1.0 = kernel B6 ran the rollout, 0.0 = the plain twin did.
        metrics["rollout_impl"] = float(self.kernel_rollout)
        # 1.0 = kernel B7's wrapper ran the learner (its twin on the CPU),
        # 0.0 = the plain learner did.
        metrics["learner_impl"] = float(self.kernel_mode)
        if capture:
            metrics["traj"] = traj
        return st, metrics
