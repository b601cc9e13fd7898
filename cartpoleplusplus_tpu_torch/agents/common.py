"""Shared actor-learner building blocks
(cartpoleplusplus_tpu/agents/common.py in torch): the exploration tags,
the learner resolution, optax-exact Adam and the flat group storage of the
kernel learners, the warmup-gated learner loop, the replay presample hook,
exact episode statistics for evaluation, and the hooks of the sharded
learners (dist/): the per-shard draws, the gradient all-reduce, the batch
all-gather and the global metrics.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..dist.mesh import all_gather_cat, all_reduce_sum
from ..ops import learner_kernel as lk
from ..ops.naf_rollout import TAG_NAF_X, TAG_NAF_Y
from ..ops.pg_rollout import TAG_PG_GUMBEL
from ..ops.policy_rollout import TAG_OU_X, TAG_OU_Y
from ..ops.q_rollout import TAG_EPS_ACT, TAG_EPS_GATE
from ..utils.prng import hash_words, split_seed

# Counter-PRNG stream tags for agent exploration (utils/prng.py; env-side
# tags live in env/compute.py). The DDPG OU tags, the DQN epsilon tags, the
# NAF Gaussian tags and the LRPG Gumbel tag are defined beside the kernels
# that draw them (B2, B4, B6, B8).
__all__ = ["TAG_OU_X", "TAG_OU_Y", "TAG_EPS_GATE", "TAG_EPS_ACT",
           "TAG_NAF_X", "TAG_NAF_Y", "TAG_PG_GUMBEL", "resolve_learner",
           "resolve_rollout", "check_block_batch",
           "lr_schedule", "scheduled_lr", "AdamState", "adam_init",
           "adam_update", "bind_group", "bind_moments", "gated_update_scan",
           "replay_presample", "episode_length_hist",
           "episode_stats_from_hist", "evaluate_policy", "local_batch",
           "dist_setup", "shard_generator", "dist_presample", "pmean",
           "gather_batches", "global_means"]

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def resolve_learner(learner: str, covered: bool, on_cuda: bool,
                    agent: str = "ddpg", kernel: str = "B3") -> bool:
    """Whether `agent` runs its fused update kernel (True) or the plain
    learner: "kernel" takes the kernel and raises where it does not cover
    the config, "xla" takes the plain learner, "auto" takes the kernel on
    a CUDA device when covered and otherwise the plain learner, saying so
    on stderr on a CUDA device (the reference's _notice_learner_fallback).
    Metrics carry the same fact as `learner_impl`."""
    if learner == "kernel":
        if not covered:
            raise ValueError(f"config shape not covered by the fused update "
                             f"kernel {kernel} (see "
                             f"{agent.upper()}.kernel_learner_ok)")
        return True
    if learner == "xla":
        return False
    if learner != "auto":
        raise ValueError(f"unknown learner {learner!r}")
    if on_cuda and not covered:
        print(f"{agent}: learner=auto resolved to the plain torch update "
              f"loop (config shape outside kernel {kernel} - see "
              f"kernel_learner_ok)", file=sys.stderr)
    return on_cuda and covered


def resolve_rollout(agent: str, kernel: str, covered: bool, on_cuda: bool,
                    check: str) -> bool:
    """Whether `agent`'s rollout runs its kernel: on a CUDA device where
    the kernel covers the config (`check` names the coverage predicate).
    Outside that coverage the plain torch rollout runs on the card, as the
    reference runs its XLA scan outside its kernel's window, and says so
    once on stderr. Metrics carry the same fact as `rollout_impl`; CPU
    tensors always run the plain rollout."""
    if on_cuda and not covered:
        print(f"{agent}: kernel {kernel} does not cover this env/network "
              f"shape ({check}); the plain torch rollout runs on the GPU",
              file=sys.stderr)
    return on_cuda and covered


def check_block_batch(sample: str, batch_size: int, num_envs: int,
                      agent: str) -> None:
    """The reference's gate on block sampling: each update's minibatch is
    one aligned block of consecutive envs, so the batch must divide
    num_envs."""
    if sample == "block" and (batch_size > num_envs
                              or num_envs % batch_size):
        raise ValueError(
            f"sample='block' needs the batch ({batch_size}) to divide "
            f"num_envs ({num_envs}) - lower --{agent}.batch-size or use "
            f"sample='column'")


def lr_schedule(cfg):
    """(end_frac, transition_steps) of an agent config's linear lr decay,
    or None (constant lr): the horizon `lr_decay_env_steps` in per-env
    env-steps converted to gradient steps."""
    if cfg.lr_decay_env_steps <= 0:
        return None
    return (cfg.lr_end_frac,
            max(cfg.lr_decay_env_steps * cfg.updates_per_step
                // max(cfg.rollout_steps, 1), 1))


def scheduled_lr(lr: float, sched, count: int) -> float:
    """The plain learners' lr at Adam count `count` (before the step):
    constant, or optax.linear_schedule(lr, lr * end_frac, T) in float32."""
    if sched is None:
        return lr
    end = lr * sched[0]
    frac = np.float32(1.0) - (np.float32(min(max(count, 0), sched[1]))
                              / np.float32(sched[1]))
    return float(np.float32(lr - end) * frac + np.float32(end))


class AdamState(NamedTuple):
    """optax ScaleByAdamState: step count and per-parameter moments, in
    `module.parameters()` order."""

    count: int
    mu: list
    nu: list


def adam_init(module: torch.nn.Module) -> AdamState:
    zeros = [torch.zeros_like(p) for p in module.parameters()]
    return AdamState(count=0, mu=zeros, nu=[z.clone() for z in zeros])


@torch.no_grad()
def adam_update(module: torch.nn.Module, grads, opt: AdamState,
                lr: float) -> AdamState:
    """One optax.adam step applied in place to `module`'s parameters and
    to the moments (so views of the kernel-mode group buffers stay views):
    m = (1-b1) g + b1 m;  v = (1-b2) g^2 + b2 v;
    p += -lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""
    count = opt.count + 1
    # Bias corrections in float32, as optax computes decay**count.
    bc1 = float(np.float32(1.0) - np.float32(_ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_ADAM_B2) ** np.float32(count))
    for p, g, m, v in zip(module.parameters(), grads, opt.mu, opt.nu):
        m.copy_((1 - _ADAM_B1) * g + _ADAM_B1 * m)
        v.copy_((1 - _ADAM_B2) * (g * g) + _ADAM_B2 * v)
        p.add_((m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS) * -lr)
    return opt._replace(count=count)


def bind_group(module: torch.nn.Module, layout) -> torch.Tensor:
    """Copy `module`'s parameters into one flat buffer in `layout` and
    rebind them as views of it; returns the buffer."""
    params = list(module.named_parameters())
    if [(n, tuple(p.shape)) for n, p in params] != [
            (n, tuple(sh)) for n, sh in layout]:
        raise ValueError("module parameters do not match the kernel layout")
    buf = torch.empty(lk.layout_size(layout), dtype=torch.float32,
                      device=params[0][1].device)
    with torch.no_grad():
        for (_, p), view in zip(params, lk.group_views(buf, layout)):
            view.copy_(p)
            p.data = view
    return buf


def bind_moments(tensors, layout):
    """(flat buffer, views) holding copies of Adam moments in `layout`."""
    buf = torch.cat([t.detach().reshape(-1).to(torch.float32)
                     for t in tensors])
    return buf, lk.group_views(buf, layout)


def gated_update_scan(st, upd_body, num_updates: int, ready: bool,
                      zero_metrics: dict, presample):
    """Warmup-gated learner phase: until `ready`, skip (returning
    `zero_metrics`); then draw all `num_updates` minibatches at once with
    `presample(st, num_updates)`, run `upd_body(state, batch)` over them
    in order, and average each metric."""
    if num_updates <= 0 or not ready:
        return st, zero_metrics
    batches = presample(st, num_updates)
    metrics = []
    for k in range(num_updates):
        st, m = upd_body(st, tuple(x[k] for x in batches))
        metrics.append(m)
    return st, {key: torch.stack([m[key] for m in metrics]).mean()
                for key in metrics[0]}


def replay_presample(replay, batch_size: int, indices=None,
                     sample: str = "column"):
    """The `presample` hook of gated_update_scan for column, block or
    uniform sampling: draws from the state's generator, or takes the given
    indices ((slots, offs) for column and block, (env_idx, slot) for
    uniform). A quantized (pixel) ring presamples in its storage dtype:
    the minibatch frames stay uint8 and the pixel encoders scale them."""
    draw = {"column": replay.presample_columns,
            "block": replay.presample_block,
            "uniform": replay.presample_uniform}[sample]

    def presample(st, num_updates):
        return draw(st.replay, batch_size, num_updates,
                    generator=st.generator, indices=indices)
    return presample


def local_batch(global_batch: int, num_shards: int) -> int:
    """Minibatch rows each shard samples under the shardmap learner."""
    return max(global_batch // max(num_shards, 1), 1)


def dist_setup(agent, group, num_shards: int, spmd: bool) -> None:
    """The sharding attributes of an agent built on this rank's envs:
    `group` (a dist.mesh.Mesh) of `num_shards` ranks, the learner (`spmd`:
    the unsharded program's result; else the shardmap learner's per-shard
    draws and all-reduced gradients), this rank and the global index of
    its first env. One shard (or no group) is the unsharded agent."""
    if num_shards > 1 and (group is None or group.size != num_shards):
        raise ValueError(f"num_shards={num_shards} needs a group of that "
                         f"many ranks")
    agent.group = group if num_shards > 1 else None
    agent.num_shards = num_shards if agent.group is not None else 1
    agent.spmd = bool(spmd)
    agent.rank = agent.group.rank if agent.group is not None else 0
    agent.index_offset = agent.rank * agent.env.num_envs


def _shardmap(agent) -> bool:
    return agent.group is not None and not agent.spmd


def shard_generator(generator: torch.Generator, rank: int):
    """A shard's sampling stream for one learner phase: one word drawn from
    the replicated generator (every rank draws the same) folded with the
    rank, the reference's fold_in(key, axis_index)."""
    base = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    return torch.Generator().manual_seed(int(hash_words(base, rank)))


def dist_presample(agent, batch_size: int, indices, sample: str):
    """The agent's `presample` hook: unsharded, the ring's own draw; under
    SPMD the global draw assembled from every rank's rows; under shardmap
    batch_size / num_shards rows of this rank's ring from its shard
    stream (or the given per-shard `indices`)."""
    replay = agent.replay
    if agent.group is None:
        return replay_presample(replay, batch_size, indices, sample)
    if agent.spmd:
        def presample(st, num_updates):
            return replay.presample_global(
                st.replay, sample, batch_size, num_updates, agent.group,
                generator=st.generator, indices=indices)
        return presample
    draw = replay_presample(replay, local_batch(batch_size, agent.num_shards),
                            indices, sample)

    def presample(st, num_updates):
        gen = (st.generator if indices is not None
               else shard_generator(st.generator, agent.rank))
        return draw(st._replace(generator=gen), num_updates)
    return presample


def pmean(agent, loss, grads):
    """The shardmap learner's pmean of (loss, gradients) over the ranks:
    one all-reduce of their concatenation, divided by the rank count.
    Identity for the unsharded and the SPMD learners."""
    if not _shardmap(agent):
        return loss, grads
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    flat = all_reduce_sum(flat, agent.group) / agent.num_shards
    out, i = [], 1
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[0], out


def gather_batches(agent, batches):
    """The shardmap kernel learner's batch replication: each (K, local Bm,
    ...) minibatch stack all-gathered along the batch axis in rank order,
    so every rank runs its learner kernel on the same (K, Bm) union batch
    (the reference's all_gather(axis=1, tiled=True)). Identity
    otherwise."""
    if not _shardmap(agent):
        return batches
    return tuple(all_gather_cat(x, agent.group, dim=1) for x in batches)


def global_means(agent, *xs):
    """Means of this rank's (T, B_local) rollout tensors over the GLOBAL
    batch: under SPMD from the gathered (T, B) tensors (the unsharded
    program's bits), under shardmap the pmean of the shard means (the
    reference's)."""
    xs = [x.to(torch.float32) for x in xs]
    if agent.group is None:
        return [x.mean() for x in xs]
    if agent.spmd:
        return [all_gather_cat(x, agent.group, dim=1).mean() for x in xs]
    return list(all_reduce_sum(torch.stack([x.mean() for x in xs]),
                               agent.group) / agent.num_shards)


def episode_length_hist(done: torch.Tensor, cap: int) -> torch.Tensor:
    """Histogram of COMPLETED-episode lengths from a time-major (T, B) done
    matrix: hist[L] = number of episodes that finished after exactly L
    env-steps (capped at `cap`). The trailing unfinished window of every
    env contributes nothing; episodes are aligned with t=0."""
    b = done.shape[1]
    c = torch.zeros((b,), dtype=torch.int64, device=done.device)
    hist = torch.zeros((cap + 1,), dtype=torch.int64, device=done.device)
    for done_t in done:
        c = c + 1
        hist.index_add_(0, torch.clamp(c, max=cap), done_t.to(torch.int64))
        c = torch.where(done_t, 0, c)
    return hist


def episode_stats_from_hist(hist: torch.Tensor) -> dict:
    """mean/median/max over completed episodes plus their count; an empty
    histogram yields zeros, not NaNs."""
    n = hist.sum()
    idx = torch.arange(hist.shape[0], device=hist.device)
    mean = (hist.to(torch.float32) * idx.to(torch.float32)).sum() \
        / torch.clamp(n.to(torch.float32), min=1.0)
    max_len = torch.where(hist > 0, idx, 0).max()
    cum = torch.cumsum(hist, 0)
    median = torch.argmax((2 * cum >= n).to(torch.int32))
    return {
        "episodes": n,
        "mean_episode_length": mean,
        "median_episode_length": median,
        "max_episode_length": max_len,
    }


@torch.no_grad()
def evaluate_policy(env, policy_fn, seed: int, num_steps: int,
                    generator: torch.Generator | None = None,
                    index_offset: int = 0, mesh=None,
                    spmd: bool = False) -> dict:
    """Policy evaluation over the batched env: `num_steps` steps from
    `env.reset(seed)` with masked auto-reset, reduced to exact statistics
    over completed episodes, plus mean reward and done fraction.
    policy_fn(obs) -> action is deterministic; with a `generator` (the
    reference's `needs_key`, for stochastic baselines) it is called as
    policy_fn(obs, generator) and draws from it. The envs reset with the
    seed the reference folds from split(PRNGKey(seed))[0], so both
    evaluate the same episodes.

    Sharded evaluation: `env` is this rank's shard, `index_offset` the
    global index of its first env (the same episodes as the unsharded
    eval), and over a `mesh` of several ranks the episode histogram, the
    reward and done totals and the env count are all-reduced, so every
    rank returns the global statistics: the integer ones exactly the
    unsharded eval's, reward_mean and done_frac to summation order. With
    `spmd` the (T, B_local) rewards and dones are all-gathered instead and
    reduced as the unsharded eval reduces them: its bits."""
    state, obs = env.reset(split_seed(seed, 2, 0), index_offset)
    sharded = mesh is not None and mesh.size > 1
    gather = sharded and spmd
    rew_total = torch.zeros((), dtype=torch.float32, device=env.device)
    dones, rewards = [], []
    for _ in range(num_steps):
        action = (policy_fn(obs) if generator is None
                  else policy_fn(obs, generator))
        state, obs, reward, done, _ = env.step(state, action)
        if gather:
            rewards.append(reward)
        else:
            rew_total = rew_total + reward.sum()
        dones.append(done)
    done = torch.stack(dones)
    if gather:
        done = all_gather_cat(done, mesh, dim=1)
        for reward in all_gather_cat(torch.stack(rewards), mesh, dim=1):
            rew_total = rew_total + reward.sum()
    hist = episode_length_hist(done, env.params.max_episode_steps)
    done_total = done.to(torch.float32).sum()
    n_envs = done.shape[1]
    if sharded and not gather:
        hist = all_reduce_sum(hist, mesh)
        rew_total, done_total = all_reduce_sum(
            torch.stack([rew_total, done_total]), mesh)
        n_envs *= mesh.size
    stats = episode_stats_from_hist(hist)
    denom = float(num_steps * n_envs)
    stats["reward_mean"] = rew_total / denom
    stats["done_frac"] = done_total / denom
    return stats
