"""Shared actor-learner building blocks
(cartpoleplusplus_tpu/agents/common.py in torch): the exploration tags,
the warmup-gated learner loop, the replay presample hook and exact
episode statistics for evaluation.
"""

from __future__ import annotations

import torch

from ..ops.policy_rollout import TAG_OU_X, TAG_OU_Y

# Counter-PRNG stream tags for agent exploration (utils/prng.py; env-side
# tags live in env/compute.py). The DDPG OU tags are defined beside the B2
# kernel that draws them.
__all__ = ["TAG_OU_X", "TAG_OU_Y", "gated_update_scan", "replay_presample",
           "episode_length_hist", "episode_stats_from_hist",
           "evaluate_policy"]


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


def replay_presample(replay, batch_size: int, indices=None):
    """The `presample` hook of gated_update_scan for column sampling:
    draws from the state's generator, or takes the given (slots, offs)."""
    def presample(st, num_updates):
        return replay.presample_columns(st.replay, batch_size, num_updates,
                                        generator=st.generator,
                                        indices=indices)
    return presample


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
def evaluate_policy(env, policy_fn, seed: int, num_steps: int) -> dict:
    """Policy evaluation over the batched env: `num_steps` steps from
    `env.reset(seed)` with masked auto-reset, reduced to exact statistics
    over completed episodes, plus mean reward and done fraction.
    policy_fn(obs) -> action is deterministic.

    The reference derives its reset seed from a split JAX key; here the
    integer seed resets the envs directly."""
    state, obs = env.reset(seed)
    rew_total = torch.zeros((), dtype=torch.float32, device=env.device)
    dones = []
    for _ in range(num_steps):
        state, obs, reward, done, _ = env.step(state, policy_fn(obs))
        rew_total = rew_total + reward.sum()
        dones.append(done)
    done = torch.stack(dones)
    stats = episode_stats_from_hist(
        episode_length_hist(done, env.params.max_episode_steps))
    denom = float(num_steps * env.num_envs)
    stats["reward_mean"] = rew_total / denom
    stats["done_frac"] = done.to(torch.float32).sum() / denom
    return stats
