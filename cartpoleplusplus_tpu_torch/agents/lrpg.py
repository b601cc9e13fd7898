"""Likelihood-ratio policy gradient (REINFORCE) on the discrete env
(cartpoleplusplus_tpu/agents/lrpg.py in torch).

One `train_step` runs `rollout_steps` env-steps of the softmax policy,
sampled by Gumbel-max over counter draws (kernel B8 on a CUDA device
where it covers the config, else the plain rollout; its plain twin on the
CPU),
computes discounted returns-to-go that stop at the dones and bootstrap the
cut-off tail with an EMA baseline, centres and normalises them over the
window into advantages, and takes ONE Adam step of -mean(logp[a] adv) -
entropy_coef mean(H) over the whole (T x B)-row window.

The update runs in one of two learners, resolved once at construction
(`learner`): kernel B9 (ops/learner_kernel.py::lrpg_update_phase, the
closed-form softmax gradient and Adam as one kernel call; its plain twin
on CPU tensors), or the plain learner, torch autograd through `_loss` with
optax-exact Adam. The reference's rule that T x B be a multiple of 8
(agents/lrpg.py:138) is a TPU layout rule and does not carry over: B9
takes any window.

Pixel observations (`env.obs_mode == "pixels"`) put a conv (or patch)
encoder in front of the policy (VisualPolicy). On-policy, the window holds
the env's frames directly (uint8 where the env quantizes them), with no
replay ring. No rollout kernel covers pixels (the env's render runs kernel
B10), and the learner is the plain one, over the whole window in one
autograd pass.

Sharded (dist/, `group` / `num_shards`): under the SPMD learner
(`spmd=True`) every rank all-gathers the (T, B) window along the env axis
and takes the unsharded step on it; under the shardmap learner the window
statistics (the return mean, the advantages' second moment, the metrics)
are pmeans of the shard means and the plain gradient is all-reduced, or
on the kernel route the (T x B_local)-row windows are all-gathered in rank
order and every rank runs B9 on the union window (the reference's
agents/lrpg.py:254-328).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..env import CartPole3D, EnvState
from ..models import PolicyMLP, VisualPolicy
from ..models.nets import compute_dtype
from ..ops import learner_kernel as lk
from ..ops.pg_rollout import (gumbel_max, pg_fusable, pg_policy_rollout,
                              reference_pg_rollout)
from ..utils.prng import split_seed
from ..dist.mesh import all_gather_cat, all_reduce_sum
from .common import (AdamState, adam_init, adam_update, bind_group,
                     bind_moments, dist_setup, evaluate_policy, pmean,
                     resolve_learner, resolve_rollout)


@dataclasses.dataclass(frozen=True)
class LRPGConfig:
    """The reference's LRPGConfig, every field kept so that flags and
    configs carry over. `_SUPPORTED` below lists the values the port
    implements; any other value is rejected at construction."""

    hidden: tuple = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    rollout_steps: int = 32          # env-steps per update window
    baseline_rate: float = 0.05      # EMA rate for the scalar return baseline
    entropy_coef: float = 0.1        # strong: prevents softmax collapse
    dtype: str = "float32"
    # "kernel": B9 (its plain twin on the CPU); "xla": the plain torch
    # learner; "auto": B9 on a CUDA device when `kernel_learner_ok`, else
    # the plain learner (with one stderr line on a CUDA device).
    learner: str = "auto"
    learner_block: int = 1024        # TPU kernel tiling; unused here
    # The kernel learner's product precision (ops.learner_kernel.mm_mode);
    # the plain learner ignores it.
    learner_precision: str | None = None
    encoder: str = "conv"            # pixel obs only: "conv" | "patch"
    conv_features: tuple = (16, 32, 32)  # the conv encoder's widths


# Fields whose other values select behaviour the port does not have yet.
_SUPPORTED = {
    "dtype": ("float32", "bfloat16"),
    "learner": ("auto", "kernel", "xla"),
    "learner_precision": lk.PRECISIONS,
    "encoder": ("conv", "patch"),
}


class LRPGState(NamedTuple):
    policy: PolicyMLP          # VisualPolicy on pixel obs
    opt: AdamState
    baseline: torch.Tensor     # () float32, EMA of the window's returns
    env_state: EnvState
    obs: torch.Tensor          # (B, *obs_shape) current observation
    env_steps: int             # env-steps taken (per env)
    # Kernel mode: the 3 group buffers (the policy, then its Adam moments
    # m, v) whose views are the module's parameters and the AdamState's
    # moments (ops/learner_kernel.py documents the layout). None otherwise.
    groups: tuple | None = None


def returns_to_go(reward, done, gamma: float, bootstrap):
    """Discounted returns over a time-major (T, B) window; the recursion
    stops at done flags (masked auto-reset boundaries) and starts from
    `bootstrap` (B,) past the window's end."""
    g, out = bootstrap, []
    for r, d in zip(reward.flip(0), done.flip(0)):
        g = r + gamma * g * (1.0 - d.to(torch.float32))
        out.append(g)
    return torch.stack(out[::-1])


class LRPG:
    """LRPG agent over a batched discrete CartPole3D on one device."""

    def __init__(self, env: CartPole3D, config: LRPGConfig = LRPGConfig(),
                 group=None, num_shards: int = 1, spmd: bool = False):
        """group / num_shards: a dist.mesh.Mesh of num_shards ranks when
        the agent runs one rank's shard of the envs (env is then the
        per-rank env); spmd picks the SPMD learner, else the shardmap
        learner (the reference's dist_axis)."""
        if not env.params.discrete_actions:
            raise ValueError("LRPG needs the discrete env "
                             "(CartPoleParams(discrete_actions=True))")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"LRPGConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        self.env = env
        self.cfg = config
        dist_setup(self, group, num_shards, spmd)
        # Resolved once: the kernel learner keeps its state in the 3 group
        # buffers (state_from_tree), so the choice shapes init().
        self.kernel_mode = resolve_learner(
            config.learner, self.kernel_learner_ok(),
            env.device.type == "cuda", agent="lrpg", kernel="B9")
        self.kernel_rollout = resolve_rollout(
            "lrpg", "B8", self.fusable(), env.device.type == "cuda",
            "ops.pg_rollout.pg_fusable")

    def kernel_learner_ok(self) -> bool:
        """Whether kernel B9 covers this config: state observations, at
        least one hidden layer (any depth and width, `lk.lrpg_covers`), and
        float32."""
        c = self.cfg
        return (self.env.obs_mode != "pixels"
                and lk.lrpg_covers(self.env.obs_size, c.hidden)
                and c.dtype == "float32")

    def fusable(self) -> bool:
        """Whether kernel B8 covers this env/config shape."""
        return pg_fusable(self.env, tuple(self.cfg.hidden))

    # --- init ---------------------------------------------------------------
    def init(self, seed: int) -> LRPGState:
        """Fresh state: the policy (VisualPolicy on pixel obs) from a
        torch.Generator seeded with `seed`, envs reset as the reference's
        `init` resets them (its key split(PRNGKey(seed), 3)[1]), zero Adam
        moments and baseline."""
        env, c = self.env, self.cfg
        g, dt = torch.Generator().manual_seed(seed), compute_dtype(c.dtype)
        if env.obs_mode == "pixels":
            policy = VisualPolicy(env.obs_shape, env.num_actions,
                                  tuple(c.hidden), tuple(c.conv_features),
                                  c.encoder, generator=g, dtype=dt)
        else:
            policy = PolicyMLP(env.obs_size, env.num_actions,
                               tuple(c.hidden), generator=g, dtype=dt)
        policy = policy.to(env.device)
        env_state, obs = env.reset(split_seed(seed, 3, 1), self.index_offset)
        st = LRPGState(policy=policy, opt=adam_init(policy),
                       baseline=torch.zeros((), dtype=torch.float32,
                                            device=env.device),
                       env_state=env_state, obs=obs, env_steps=0)
        return self.state_from_tree(st)

    def state_from_tree(self, st: LRPGState) -> LRPGState:
        """A state whose module owns its parameters -> this agent's native
        layout. In kernel mode the parameters and the Adam moments are
        copied into the 3 group buffers and rebound as views of them;
        otherwise, and for a state already bound, it is the identity."""
        if not self.kernel_mode or st.groups is not None:
            return st
        lay = lk.policy_layout(self.env.obs_size, tuple(self.cfg.hidden))
        params = bind_group(st.policy, lay)
        (m_buf, mu), (v_buf, nu) = (bind_moments(st.opt.mu, lay),
                                    bind_moments(st.opt.nu, lay))
        return st._replace(opt=st.opt._replace(mu=mu, nu=nu),
                           groups=(params, m_buf, v_buf))

    # --- acting -------------------------------------------------------------
    @torch.no_grad()
    def act(self, policy: PolicyMLP, obs, env_seed, t: int):
        """Exact softmax sample (int32) by Gumbel-max over counter draws: a
        pure function of (per-env seed, global step)."""
        return gumbel_max(policy(obs), env_seed, t)

    def greedy_policy(self, st: LRPGState):
        """Argmax policy fn(obs) -> action."""
        return lambda o: torch.argmax(st.policy(o), dim=-1).to(torch.int32)

    @torch.no_grad()
    def evaluate(self, st: LRPGState, num_steps: int = 200, seed: int = 0):
        """Argmax-policy evaluation: episode stats."""
        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps, index_offset=self.index_offset,
                               mesh=self.group, spmd=self.spmd)

    # --- learning -----------------------------------------------------------
    def _loss(self, policy, obs, action, advantage):
        """-mean(logp[a] adv) - entropy_coef mean(H)."""
        logp = torch.log_softmax(policy(obs), dim=-1)
        lp_a = logp.gather(-1, action.long()[..., None])[..., 0]
        pg = -torch.mean(lp_a * advantage)
        entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
        return pg - self.cfg.entropy_coef * entropy

    def train_step(self, st: LRPGState, capture: bool = False):
        """rollout_steps env-steps, returns and advantages, one Adam step.
        The policy is updated in place; the returned state carries the new
        counters and tensors.

        The rollout runs through B8's wrapper where the agent resolved it
        at construction (a CUDA device and a config B8 covers), else
        through the plain rollout; `rollout_impl` says which ran. `learner_impl` says which learner took the update
        (1.0 B9's wrapper, 0.0 the plain learner). capture=True adds the rollout's time-major trajectory (obs, action,
        reward, done) to the metrics as "traj", the event-log sink's
        input (the reference's `make_train_step(capture=True)`)."""
        c = self.cfg
        run = (pg_policy_rollout if self.kernel_rollout
               else reference_pg_rollout)
        env_state, obs, traj = run(
            self.env, st.policy, st.env_state, st.obs, st.env_steps,
            c.rollout_steps)
        shardmap = self.group is not None and not self.spmd
        if self.group is not None and self.spmd:
            # The unsharded program: every rank takes the whole window.
            obs_t, act_t, rew_t, done_t = (
                all_gather_cat(x, self.group, dim=1) for x in traj)
        else:
            obs_t, act_t, rew_t, done_t = traj

        def gmean(*xs):
            """Window means, over every shard's window under shardmap
            (equal shards: the mean of the shard means)."""
            m = torch.stack([x.to(torch.float32).mean() for x in xs])
            if shardmap:
                m = all_reduce_sum(m, self.group) / self.num_shards
            return m[0] if len(xs) == 1 else list(m)

        # Bootstrap the cut-off tail with the baseline; window-centred,
        # normalised advantages (the reference's comments say why).
        g = returns_to_go(rew_t, done_t, c.gamma,
                          st.baseline.expand(rew_t.shape[1]))
        g_mean = gmean(g)
        baseline = ((1.0 - c.baseline_rate) * st.baseline
                    + c.baseline_rate * g_mean)
        adv = g - g_mean
        adv = adv / (torch.sqrt(gmean(adv * adv)) + 1e-6)

        if self.kernel_mode:
            n = obs_t.shape[0] * obs_t.shape[1]
            window = (obs_t.reshape(n, -1), act_t.reshape(n), adv.reshape(n))
            if shardmap:
                window = tuple(all_gather_cat(x, self.group)
                               for x in window)
            loss = lk.lrpg_update_phase(
                st.groups, window, st.opt.count, c.hidden,
                lr=c.lr, entropy_coef=c.entropy_coef,
                mm_precision=c.learner_precision)
            opt = st.opt._replace(count=st.opt.count + 1)
        else:
            loss = self._loss(st.policy, obs_t, act_t, adv)
            grads = torch.autograd.grad(loss, list(st.policy.parameters()))
            loss, grads = pmean(self, loss, grads)
            opt = adam_update(st.policy, grads, st.opt, c.lr)
            loss = loss.detach()

        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(opt=opt, baseline=baseline, env_state=env_state,
                         obs=obs, env_steps=env_steps)
        reward_mean, done_frac = gmean(rew_t, done_t)
        metrics = {
            "loss": loss,
            "return_mean": g_mean,
            "reward_mean": reward_mean,
            "done_frac": done_frac,
            "env_steps": env_steps,
            # 1.0 = kernel B8 ran the rollout, 0.0 = the plain twin did.
            "rollout_impl": float(self.kernel_rollout),
            # 1.0 = kernel B9's wrapper ran the update (its twin on the
            # CPU), 0.0 = the plain learner did.
            "learner_impl": float(self.kernel_mode),
        }
        if capture:
            metrics["traj"] = traj
        return st, metrics
