"""Device-resident experience replay (cartpoleplusplus_tpu/agents/replay.py
in torch: the ring buffer with float (DDPG) or int32 (DQN) actions, the
aligned chunk insert, and the column and uniform presamples).

The ring is laid out (num_envs, capacity_per_env, ...). Next observations
are not stored: the transition at slot i reads its successor from slot
i+1, and the slot just before the cursor is never sampled (its successor
is stale); done transitions bootstrap with 0, so a stale successor across
an episode boundary is multiplied by zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ReplayState(NamedTuple):
    """Ring-buffer contents. Leading dims: (num_envs, capacity_per_env).
    The cursor and fill count are host integers (the host drives the
    inserts, so reading them never waits for the device)."""

    obs: torch.Tensor     # (B, C, obs_dim) float32
    action: torch.Tensor  # (B, C) int32 or (B, C, act_dim) float32
    reward: torch.Tensor  # (B, C) float32
    done: torch.Tensor    # (B, C) bool — episode ended at this transition
    cursor: int           # next slot to write
    filled: int           # number of valid slots (<= capacity)


class ReplayBuffer:
    """Static configuration + add/sample functions over a ReplayState."""

    def __init__(self, num_envs: int, capacity_per_env: int, obs_dim: int,
                 action_dim: int, device="cpu", discrete: bool = False):
        self.num_envs = num_envs
        self.capacity = capacity_per_env
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.discrete = discrete
        self.device = torch.device(device)

    def init(self) -> ReplayState:
        b, c, dev = self.num_envs, self.capacity, self.device
        if self.discrete:
            action = torch.zeros((b, c), dtype=torch.int32, device=dev)
        else:
            action = torch.zeros((b, c, self.action_dim),
                                 dtype=torch.float32, device=dev)
        return ReplayState(
            obs=torch.zeros((b, c, self.obs_dim), dtype=torch.float32,
                            device=dev),
            action=action,
            reward=torch.zeros((b, c), dtype=torch.float32, device=dev),
            done=torch.zeros((b, c), dtype=torch.bool, device=dev),
            cursor=0,
            filled=0)

    def add_trajectory(self, rs: ReplayState, obs, action, reward,
                       done) -> ReplayState:
        """Insert a time-major rollout chunk obs (T, B, obs_dim), action
        (T, B) or (T, B, act_dim), reward and done (T, B) at the cursor,
        in place. The chunk must land aligned: T divides the
        capacity and the cursor is a multiple of T, which holds whenever
        the ring is fed only by fixed-length rollouts from cursor 0."""
        t = obs.shape[0]
        i = rs.cursor
        if self.capacity % t or i % t:
            raise ValueError(f"unaligned insert: chunk {t}, cursor {i}, "
                             f"capacity {self.capacity}")
        for buf, rows in ((rs.obs, obs), (rs.action, action),
                          (rs.reward, reward), (rs.done, done)):
            buf[:, i:i + t] = rows.transpose(0, 1)
        return rs._replace(cursor=(i + t) % self.capacity,
                           filled=min(rs.filled + t, self.capacity))

    def draw_columns(self, rs: ReplayState, num_updates: int,
                     batch_size: int, generator: torch.Generator):
        """The random part of column sampling: per update, ceil(batch / B)
        valid slots `slots` (K, C) and a wrap-around row offset `offs`
        (K,). Drawn on the CPU from `generator`."""
        b = self.num_envs
        k_cols = -(-batch_size // b)
        n_valid = max(rs.filled - 1, 1)
        ages = torch.randint(1, n_valid + 1, (num_updates, k_cols),
                             generator=generator)
        offs = torch.randint(0, k_cols * b, (num_updates,),
                             generator=generator)
        return (rs.cursor - 1 - ages) % self.capacity, offs

    def presample_columns(self, rs: ReplayState, batch_size: int,
                          num_updates: int, generator=None, indices=None):
        """All K update minibatches (obs, action, reward, next_obs, done),
        each (K, batch_size, ...): whole ring COLUMNS (one slot x all envs)
        per update, concatenated and trimmed to batch_size rows from a
        random offset with wrap-around — the reference's column sampling.

        The slots and offsets come from `draw_columns(generator)`, or are
        given as `indices = (slots (K, C), offs (K,))` (tests inject the
        reference's draws through this)."""
        b = self.num_envs
        if indices is None:
            indices = self.draw_columns(rs, num_updates, batch_size,
                                        generator)
        slots, offs = (torch.as_tensor(x, dtype=torch.int64,
                                       device=self.device) for x in indices)
        kk, k_cols = slots.shape
        flat = slots.reshape(-1)
        row_idx = (offs[:, None]
                   + torch.arange(batch_size, device=self.device)[None, :]) \
            % (k_cols * b)                                     # (K, bs)

        def take(buf, idx):
            # (B, K*C, ...) -> (K, C*B, ...): column-major over envs within
            # each update, then the trimmed rows.
            out = buf[:, idx].transpose(0, 1)
            out = out.reshape((kk, k_cols * b) + buf.shape[2:])
            if batch_size == k_cols * b:  # whole columns: no trim
                return out
            ridx = row_idx.reshape(row_idx.shape + (1,) * (out.ndim - 2))
            return torch.take_along_dim(out, ridx.expand(
                (kk, batch_size) + out.shape[2:]), dim=1)

        nxt = (flat + 1) % self.capacity
        return (take(rs.obs, flat), take(rs.action, flat),
                take(rs.reward, flat), take(rs.obs, nxt),
                take(rs.done, flat))

    def presample_uniform(self, rs: ReplayState, batch_size: int,
                          num_updates: int, generator=None, indices=None):
        """All K uniform minibatches (each (K, batch_size, ...)): per row
        an env uniform over the batch and a slot uniform over the valid
        history, gathered from the env-major flattened ring.

        The draws come from `generator` (on the CPU), or are given as
        `indices = (env_idx (K, Bm), slot (K, Bm))` (tests inject the
        reference's draws through this)."""
        if indices is None:
            shape = (num_updates, batch_size)
            env_idx = torch.randint(0, self.num_envs, shape,
                                    generator=generator)
            n_valid = max(rs.filled - 1, 1)
            ages = torch.randint(1, n_valid + 1, shape, generator=generator)
            indices = (env_idx, (rs.cursor - 1 - ages) % self.capacity)
        env_idx, slot = (torch.as_tensor(x, dtype=torch.int64,
                                         device=self.device)
                         for x in indices)
        base = env_idx * self.capacity
        flat, flat_next = base + slot, base + (slot + 1) % self.capacity

        def take(buf, idx):
            rows = buf.reshape((-1,) + buf.shape[2:])
            return rows[idx]

        return (take(rs.obs, flat), take(rs.action, flat),
                take(rs.reward, flat), take(rs.obs, flat_next),
                take(rs.done, flat))
