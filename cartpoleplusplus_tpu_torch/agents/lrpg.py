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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..env import CartPole3D, EnvState
from ..models import PolicyMLP
from ..ops import learner_kernel as lk
from ..ops.pg_rollout import (gumbel_max, pg_fusable, pg_policy_rollout,
                              reference_pg_rollout)
from ..utils.prng import split_seed
from .common import (AdamState, adam_init, adam_update, bind_group,
                     bind_moments, evaluate_policy, resolve_learner,
                     resolve_rollout)


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
    learner_precision: str | None = None
    encoder: str = "conv"            # pixel obs only; not ported yet
    conv_features: tuple = (16, 32, 32)


# Fields whose other values select behaviour the port does not have yet.
_SUPPORTED = {
    "dtype": ("float32",),
    "learner": ("auto", "kernel", "xla"),
    "learner_precision": (None,),
}


class LRPGState(NamedTuple):
    policy: PolicyMLP
    opt: AdamState
    baseline: torch.Tensor     # () float32, EMA of the window's returns
    env_state: EnvState
    obs: torch.Tensor          # (B, obs_dim) current observation
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

    def __init__(self, env: CartPole3D, config: LRPGConfig = LRPGConfig()):
        if not env.params.discrete_actions:
            raise ValueError("LRPG needs the discrete env "
                             "(CartPoleParams(discrete_actions=True))")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"LRPGConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        if env.obs_mode == "pixels":
            raise ValueError("pixel observations are not ported yet for "
                             "LRPG (VisualPolicy)")
        self.env = env
        self.cfg = config
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
        """Fresh state: the policy from a torch.Generator seeded with
        `seed`, envs reset as the reference's `init` resets them (its key
        split(PRNGKey(seed), 3)[1]), zero Adam moments and baseline."""
        env, c = self.env, self.cfg
        g = torch.Generator().manual_seed(seed)
        policy = PolicyMLP(env.obs_size, env.num_actions, tuple(c.hidden),
                           generator=g).to(env.device)
        env_state, obs = env.reset(split_seed(seed, 3, 1))
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
                               num_steps)

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
        env_state, obs, (obs_t, act_t, rew_t, done_t) = run(
            self.env, st.policy, st.env_state, st.obs, st.env_steps,
            c.rollout_steps)

        # Bootstrap the cut-off tail with the baseline; window-centred,
        # normalised advantages (the reference's comments say why).
        g = returns_to_go(rew_t, done_t, c.gamma,
                          st.baseline.expand(self.env.num_envs))
        g_mean = g.mean()
        baseline = ((1.0 - c.baseline_rate) * st.baseline
                    + c.baseline_rate * g_mean)
        adv = g - g_mean
        adv = adv / (torch.sqrt(torch.mean(adv * adv)) + 1e-6)

        if self.kernel_mode:
            n = obs_t.shape[0] * obs_t.shape[1]
            loss = lk.lrpg_update_phase(
                st.groups, (obs_t.reshape(n, -1), act_t.reshape(n),
                            adv.reshape(n)), st.opt.count, c.hidden,
                lr=c.lr, entropy_coef=c.entropy_coef)
            opt = st.opt._replace(count=st.opt.count + 1)
        else:
            loss = self._loss(st.policy, obs_t, act_t, adv)
            grads = torch.autograd.grad(loss, list(st.policy.parameters()))
            opt = adam_update(st.policy, grads, st.opt, c.lr)
            loss = loss.detach()

        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(opt=opt, baseline=baseline, env_state=env_state,
                         obs=obs, env_steps=env_steps)
        metrics = {
            "loss": loss,
            "return_mean": g_mean,
            "reward_mean": rew_t.mean(),
            "done_frac": done_t.to(torch.float32).mean(),
            "env_steps": env_steps,
            # 1.0 = kernel B8 ran the rollout, 0.0 = the plain twin did.
            "rollout_impl": float(self.kernel_rollout),
            # 1.0 = kernel B9's wrapper ran the update (its twin on the
            # CPU), 0.0 = the plain learner did.
            "learner_impl": float(self.kernel_mode),
        }
        if capture:
            metrics["traj"] = (obs_t, act_t, rew_t, done_t)
        return st, metrics
