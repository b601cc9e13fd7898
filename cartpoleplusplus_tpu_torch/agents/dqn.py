"""DQN on the discrete 5-action env (cartpoleplusplus_tpu/agents/dqn.py in
torch).

One `train_step` runs `rollout_steps` env-steps with the epsilon-greedy
Q-net in the loop (kernel B4 on a CUDA device where it covers the config,
else the plain rollout; its plain twin on the CPU), inserts the chunk into the
device replay with int32 actions, presamples the K minibatches (column,
block or uniform), and past the warmup runs `updates_per_step` double-DQN
updates: Huber TD toward r + gamma (1 - done) Q'(s', argmax_a Q(s', a)),
Adam, Polyak on the target.

Pixel observations (`env.obs_mode == "pixels"`) put a conv (or patch)
encoder in front of the Q-net (VisualQNet), keep the ring quantized to
uint8, and insert each rollout AFTER the update phase, as the reference
does: a learning step samples the ring as it was before this step's
rollout. No rollout kernel covers pixels (the env's render runs kernel
B10), and the learner is the plain one.

The updates run in one of two learners, resolved once at construction
(`learner`): kernel B5 (ops/learner_kernel.py, the whole K-update phase as
one launch; its plain twin on CPU tensors), or the plain learner, torch
autograd through optax's Huber loss with optax-exact Adam.

Sharded (dist/, `group` / `num_shards`): the SPMD learner (`spmd=True`)
gives the unsharded program's result; the shardmap learner samples
batch_size / num_shards rows per rank and all-reduces the mean of (loss,
gradient) once per update, or on the kernel route all-gathers the K
minibatches so that every rank runs B5 on the union batch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..env import CartPole3D, EnvState
from ..models import QNetMLP, VisualQNet, polyak
from ..models.nets import compute_dtype
from ..ops import learner_kernel as lk
from ..ops.q_rollout import (epsilon_greedy, q_fusable, q_policy_rollout,
                             reference_q_rollout)
from .common import (AdamState, adam_init, adam_update, bind_group,
                     bind_moments, check_block_batch, dist_presample,
                     dist_setup, evaluate_policy, gated_update_scan,
                     gather_batches, global_means, local_batch, pmean,
                     resolve_learner, resolve_rollout)
from ..utils.prng import split_seed
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """The reference's DQNConfig, every field kept so that flags and
    configs carry over. `_SUPPORTED` below lists the values the port
    implements; any other value is rejected at construction."""

    hidden: tuple = (256, 256)
    lr: float = 5e-5
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    rollout_steps: int = 8
    updates_per_step: int = 8
    replay_capacity_per_env: int = 1024
    eps_start: float = 1.0
    eps_end: float = 0.02
    eps_decay_env_steps: int = 10000  # linear decay horizon (per-env steps)
    warmup_env_steps: int = 16
    double_dqn: bool = True
    dtype: str = "float32"
    sample: str = "column"           # column | block | uniform
    # "kernel": B5 (its plain twin on the CPU); "xla": the plain torch
    # learner; "auto": B5 on a CUDA device when `kernel_learner_ok`, else
    # the plain learner (with one stderr line on a CUDA device).
    learner: str = "auto"
    learner_block: int = 512         # TPU kernel tiling; unused here
    # The kernel learner's product precision (ops.learner_kernel.mm_mode);
    # the plain learner ignores it.
    learner_precision: str | None = None
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


class DQNState(NamedTuple):
    q: QNetMLP                 # VisualQNet on pixel obs
    q_target: QNetMLP
    opt: AdamState
    replay: ReplayState
    env_state: EnvState
    obs: torch.Tensor          # (B, *obs_shape) current observation
    generator: torch.Generator  # replay sampling (CPU)
    env_steps: int             # env-steps taken (per env)
    # Kernel mode: the 4 group buffers (q, q_target, then q's Adam moments
    # m, v) whose views are the modules' parameters and the AdamState's
    # moments (ops/learner_kernel.py documents the layout). None otherwise.
    groups: tuple | None = None


def huber_loss(pred, target, delta: float = 1.0):
    """optax.huber_loss: 0.5 min(|e|, delta)^2 + delta (|e| - min(|e|,
    delta)) with e = pred - target."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


class DQN:
    """DQN agent over a batched discrete CartPole3D on one device."""

    def __init__(self, env: CartPole3D, config: DQNConfig = DQNConfig(),
                 group=None, num_shards: int = 1, spmd: bool = False):
        """group / num_shards: a dist.mesh.Mesh of num_shards ranks when
        the agent runs one rank's shard of the envs (env is then the
        per-rank env); spmd picks the SPMD learner, else the shardmap
        learner (the reference's dist_axis)."""
        if not env.params.discrete_actions:
            raise ValueError("DQN needs the discrete env "
                             "(CartPoleParams(discrete_actions=True))")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"DQNConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        self.env = env
        self.cfg = config
        dist_setup(self, group, num_shards, spmd)
        check_block_batch(config.sample, self.local_batch_size,
                          env.num_envs * (self.num_shards if spmd else 1),
                          "dqn")
        self.replay = ReplayBuffer(env.num_envs,
                                   config.replay_capacity_per_env,
                                   env.obs_size, 0, env.device,
                                   discrete=True, obs_shape=env.obs_shape,
                                   quantize_obs=env.obs_mode == "pixels")
        # Resolved once: the kernel learner keeps its state in the 4 group
        # buffers (state_from_tree), so the choice shapes init().
        self.kernel_mode = resolve_learner(
            config.learner, self.kernel_learner_ok(),
            env.device.type == "cuda", agent="dqn", kernel="B5")
        self.kernel_rollout = resolve_rollout(
            "dqn", "B4", self.fusable(), env.device.type == "cuda",
            "ops.q_rollout.q_fusable")

    @property
    def local_batch_size(self) -> int:
        """Rows this rank samples per update: batch_size / num_shards under
        the shardmap learner, else the whole batch."""
        return local_batch(self.cfg.batch_size,
                           1 if self.spmd else self.num_shards)

    def kernel_learner_ok(self) -> bool:
        """Whether kernel B5 covers this config: state observations, at
        least one hidden layer (any depth and width), float32, at least
        one update, and under the shardmap learner a batch that splits
        evenly over the shards."""
        c = self.cfg
        return (self.env.obs_mode != "pixels"
                and (self.spmd or c.batch_size % self.num_shards == 0)
                and lk.dqn_covers(self.env.obs_size, c.hidden)
                and c.updates_per_step >= 1
                and c.dtype == "float32")

    def fusable(self) -> bool:
        """Whether kernel B4 covers this env/config shape."""
        return q_fusable(self.env, tuple(self.cfg.hidden))

    # --- init ---------------------------------------------------------------
    def init(self, seed: int) -> DQNState:
        """Fresh state: the Q-net (VisualQNet on pixel obs) from a
        torch.Generator seeded with `seed`, envs reset as the reference's
        `init` resets them (its key split(PRNGKey(seed), 3)[1]), empty
        replay."""
        env, c = self.env, self.cfg
        g, dt = torch.Generator().manual_seed(seed), compute_dtype(c.dtype)
        if env.obs_mode == "pixels":
            q = VisualQNet(env.obs_shape, env.num_actions, tuple(c.hidden),
                           tuple(c.conv_features), c.encoder, generator=g,
                           dtype=dt)
        else:
            q = QNetMLP(env.obs_size, env.num_actions, tuple(c.hidden),
                        generator=g, dtype=dt)
        q = q.to(env.device)
        env_state, obs = env.reset(split_seed(seed, 3, 1), self.index_offset)
        st = DQNState(q=q, q_target=copy.deepcopy(q), opt=adam_init(q),
                      replay=self.replay.init(), env_state=env_state,
                      obs=obs,
                      generator=torch.Generator().manual_seed(seed + 1),
                      env_steps=0)
        return self.state_from_tree(st)

    def state_from_tree(self, st: DQNState) -> DQNState:
        """A state whose modules own their parameters -> this agent's native
        layout. In kernel mode the parameters, the target and the Adam
        moments are copied into the 4 group buffers and rebound as views of
        them; otherwise, and for a state already bound, it is the
        identity."""
        if not self.kernel_mode or st.groups is not None:
            return st
        lay = lk.qnet_layout(self.env.obs_size, tuple(self.cfg.hidden))
        nets = [bind_group(net, lay) for net in (st.q, st.q_target)]
        (m_buf, mu), (v_buf, nu) = (bind_moments(st.opt.mu, lay),
                                    bind_moments(st.opt.nu, lay))
        return st._replace(opt=st.opt._replace(mu=mu, nu=nu),
                           groups=(*nets, m_buf, v_buf))

    # --- acting -------------------------------------------------------------
    def epsilon(self, env_steps: int) -> float:
        """Exploration rate, decayed linearly in float32 as the reference
        does; a non-positive horizon holds it at eps_end."""
        c = self.cfg
        if c.eps_decay_env_steps <= 0:
            return float(np.float32(c.eps_end))
        frac = np.float32(env_steps) / np.float32(c.eps_decay_env_steps)
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c.eps_start)
                     + frac * np.float32(c.eps_end - c.eps_start))

    @torch.no_grad()
    def act(self, q: QNetMLP, obs, env_seed, t: int, eps: float):
        """Epsilon-greedy batched action (int32); exploration is a
        counter-PRNG function of (per-env seed, global step)."""
        return epsilon_greedy(q(obs), env_seed, t, eps)

    def greedy_policy(self, st: DQNState):
        """Greedy policy fn(obs) -> action (epsilon = 0)."""
        return lambda o: torch.argmax(st.q(o), dim=-1).to(torch.int32)

    @torch.no_grad()
    def evaluate(self, st: DQNState, num_steps: int = 200, seed: int = 0):
        """Greedy-policy evaluation (epsilon = 0): episode stats."""
        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps, index_offset=self.index_offset,
                               mesh=self.group, spmd=self.spmd)

    # --- learning -----------------------------------------------------------
    def _loss(self, q, q_target, batch):
        """Huber TD loss of Q(s, a) against the (double-)DQN target."""
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        with torch.no_grad():
            qn_t = q_target(next_obs)
            if c.double_dqn:
                a_star = torch.argmax(q(next_obs), dim=-1, keepdim=True)
                q_next = qn_t.gather(1, a_star)[:, 0]
            else:
                q_next = qn_t.max(dim=-1).values
            y = reward + c.gamma * (1.0 - done.to(torch.float32)) * q_next
        q_sa = q(obs).gather(1, action.long()[:, None])[:, 0]
        return torch.mean(huber_loss(q_sa, y))

    def _update_once(self, st: DQNState, batch):
        """One Huber TD step with Adam, then Polyak on the target."""
        loss = self._loss(st.q, st.q_target, batch)
        grads = torch.autograd.grad(loss, list(st.q.parameters()))
        loss, grads = pmean(self, loss, grads)
        opt = adam_update(st.q, grads, st.opt, self.cfg.lr)
        polyak(st.q_target, st.q, self.cfg.tau)
        return st._replace(opt=opt), {"loss": loss.detach()}

    def _kernel_update_phase(self, st: DQNState, batches):
        """The K-update phase through B5's wrapper: the 4 group buffers
        updated in place, the Adam count advanced by K."""
        c = self.cfg
        batches = gather_batches(self, batches)
        loss = lk.dqn_update_phase(
            st.groups, tuple(x.contiguous() for x in batches), st.opt.count,
            c.hidden, lr=c.lr, gamma=c.gamma, tau=c.tau,
            double_dqn=c.double_dqn, mm_precision=c.learner_precision)
        st = st._replace(opt=st.opt._replace(
            count=st.opt.count + c.updates_per_step))
        return st, {"loss": loss.mean()}

    # --- the actor-learner step ---------------------------------------------
    def train_step(self, st: DQNState, fused=None, indices=None,
                   capture: bool = False):
        """rollout_steps env-steps + replay insert + updates_per_step
        gradient updates. Networks and the replay ring are updated in
        place; the returned state carries the new counters and tensors.

        fused: None runs the rollout resolved at construction (B4 on a
        CUDA device where it covers the config, else the plain rollout);
        True runs it through B4's wrapper, which launches the kernel for
        CUDA tensors (and raises for a shape the kernel does not cover) and
        runs the plain twin for CPU tensors; False runs the plain rollout
        on any device. `rollout_impl` reports which ran. The updates run in the
        learner resolved at construction; `learner_impl` reports which
        (1.0 B5's wrapper, 0.0 the plain learner). indices: optional
        presample draws ((slots, offs) for column and block sampling,
        (env_idx, slot) for uniform) in place of the state's generator.

        A quantized (pixel) ring takes the rollout after the update phase,
        as the reference's late insert does. capture=True adds the
        rollout's time-major trajectory (obs, action, reward, done) to the
        metrics as "traj", the event-log sink's input (the reference's
        `make_train_step(capture=True)`)."""
        c = self.cfg
        eps = self.epsilon(st.env_steps)
        kernel = self.kernel_rollout if fused is None else fused
        run = q_policy_rollout if kernel else reference_q_rollout
        env_state, obs, traj = run(self.env, st.q, st.env_state, st.obs,
                                   st.env_steps, eps, c.rollout_steps)
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
        metrics["epsilon"] = eps
        metrics["reward_mean"], metrics["done_frac"] = global_means(
            self, traj[2], traj[3])
        metrics["env_steps"] = env_steps
        # 1.0 = kernel B4 ran the rollout, 0.0 = the plain twin did.
        metrics["rollout_impl"] = float(self.env.device.type == "cuda"
                                        and kernel)
        # 1.0 = kernel B5's wrapper ran the learner (its twin on the CPU),
        # 0.0 = the plain learner did.
        metrics["learner_impl"] = float(self.kernel_mode)
        if capture:
            metrics["traj"] = traj
        return st, metrics
