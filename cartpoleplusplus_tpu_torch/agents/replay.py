"""Device-resident experience replay (cartpoleplusplus_tpu/agents/replay.py
in torch: the ring buffer with float (DDPG) or int32 (DQN) actions, flat
float32 or quantized uint8 observations, the chunk insert with its aligned
and wrapping forms, and the column, block and uniform presamples).

The ring is laid out (num_envs, capacity_per_env, ...). Next observations
are not stored: the transition at slot i reads its successor from slot
i+1, and the slot just before the cursor is never sampled (its successor
is stale); done transitions bootstrap with 0, so a stale successor across
an episode boundary is multiplied by zero.

`INDEX_COPIES` counts the presamples' copies of host draws to the ring's
device: `staged` to a CUDA ring, through page-locked memory and ordered on
the stream without a wait; `blocking` to a ring on any other device. A CPU
ring, or draws already on the device, count neither.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import spans

INDEX_COPIES = {"staged": 0, "blocking": 0}


class ReplayState(NamedTuple):
    """Ring-buffer contents. Leading dims: (num_envs, capacity_per_env).
    The cursor and fill count are host integers (the host drives the
    inserts, so neither reading them nor drawing from them waits for the
    device)."""

    obs: torch.Tensor     # (B, C, flat obs) float32, or uint8 when quantized
    action: torch.Tensor  # (B, C) int32 or (B, C, act_dim) float32
    reward: torch.Tensor  # (B, C) float32
    done: torch.Tensor    # (B, C) bool — episode ended at this transition
    cursor: int           # next slot to write
    filled: int           # number of valid slots (<= capacity)


class ReplayBuffer:
    """Static configuration + add/sample functions over a ReplayState.

    obs_shape: the per-env observation shape, (obs_dim,) for flat modes or
    (H, W, C) for pixels; observations are stored flat. quantize_obs=True
    stores them as uint8 ([0, 1] float <-> 0..255), the pixel ring."""

    def __init__(self, num_envs: int, capacity_per_env: int, obs_dim: int,
                 action_dim: int, device="cpu", discrete: bool = False,
                 obs_shape: tuple | None = None, quantize_obs: bool = False):
        self.num_envs = num_envs
        self.capacity = capacity_per_env
        self.obs_shape = tuple(obs_shape) if obs_shape else (obs_dim,)
        self.obs_dim = int(np.prod(self.obs_shape))
        self.action_dim = action_dim
        self.discrete = discrete
        self.quantize_obs = quantize_obs
        self.device = torch.device(device)

    def _encode_obs(self, obs):
        """(..., *obs_shape) -> (..., flat) in the storage dtype."""
        lead = obs.shape[:obs.ndim - len(self.obs_shape)]
        obs = obs.reshape(lead + (self.obs_dim,))
        if self.quantize_obs and obs.dtype != torch.uint8:
            return torch.clamp(obs * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return obs

    def _unflatten_obs(self, stored):
        """(..., flat) -> (..., *obs_shape) in the storage dtype: a quantized
        ring returns its uint8 frames, which the pixel encoders scale by
        1/255 themselves."""
        return stored.reshape(stored.shape[:-1] + self.obs_shape)

    def init(self) -> ReplayState:
        b, c, dev = self.num_envs, self.capacity, self.device
        if self.discrete:
            action = torch.zeros((b, c), dtype=torch.int32, device=dev)
        else:
            action = torch.zeros((b, c, self.action_dim),
                                 dtype=torch.float32, device=dev)
        obs_dtype = torch.uint8 if self.quantize_obs else torch.float32
        return ReplayState(
            obs=torch.zeros((b, c, self.obs_dim), dtype=obs_dtype,
                            device=dev),
            action=action,
            reward=torch.zeros((b, c), dtype=torch.float32, device=dev),
            done=torch.zeros((b, c), dtype=torch.bool, device=dev),
            cursor=0,
            filled=0)

    def add_trajectory(self, rs: ReplayState, obs, action, reward,
                       done) -> ReplayState:
        """Insert a time-major rollout chunk obs (T, B, *obs_shape), action
        (T, B) or (T, B, act_dim), reward and done (T, B) at the cursor,
        in place. An aligned chunk (T divides the capacity, the cursor is a
        multiple of T: always so when fixed-length rollouts feed the ring
        from cursor 0) lands as one slice per buffer; otherwise the rows
        go to the wrapped slot indices, and when T exceeds the capacity
        only the last `capacity` rows are written, as a sequential ring
        pass would leave them."""
        t = obs.shape[0]
        i = rs.cursor
        rows = ((rs.obs, self._encode_obs(obs)), (rs.action, action),
                (rs.reward, reward), (rs.done, done))
        if self.capacity % t == 0 and i % t == 0:
            for buf, x in rows:
                buf[:, i:i + t] = x.transpose(0, 1)
        else:
            off = max(t - self.capacity, 0)
            idx = (i + off + torch.arange(t - off, device=self.device)) \
                % self.capacity
            for buf, x in rows:
                buf[:, idx] = x[off:].transpose(0, 1).to(buf.dtype)
        return rs._replace(cursor=(i + t) % self.capacity,
                           filled=min(rs.filled + t, self.capacity))

    def draw_columns(self, rs: ReplayState, num_updates: int,
                     batch_size: int, generator: torch.Generator,
                     num_envs: int | None = None):
        """The random part of column sampling: per update, ceil(batch / B)
        valid slots `slots` (K, C) and a wrap-around row offset `offs`
        (K,). Drawn on the CPU from `generator`; B is the ring's env count
        unless `num_envs` gives the global one (the SPMD learner's draw)."""
        b = num_envs or self.num_envs
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
        if indices is None:
            indices = self.draw_columns(rs, num_updates, batch_size,
                                        generator)
        return self.take_rows(rs, *self.row_indices(
            "column", indices, batch_size, self.num_envs))

    def presample_block(self, rs: ReplayState, batch_size: int,
                        num_updates: int, generator=None, indices=None):
        """All K block minibatches (each (K, batch_size, ...)): per update
        one valid slot and one aligned block of batch_size consecutive
        envs (batch_size must divide num_envs).

        The draws come from `generator` (on the CPU), or are given as
        `indices = (slots (K,), offs (K,))` with offs the block's first env
        (tests inject the reference's draws through this)."""
        b = self.num_envs
        if batch_size > b or b % batch_size:
            raise ValueError("block sampling needs batch_size | num_envs")
        if indices is None:
            indices = self.draw_block(rs, num_updates, batch_size, generator)
        return self.take_rows(rs, *self.row_indices(
            "block", indices, batch_size, b))

    def presample_uniform(self, rs: ReplayState, batch_size: int,
                          num_updates: int, generator=None, indices=None):
        """All K uniform minibatches (each (K, batch_size, ...)): per row
        an env uniform over the batch and a slot uniform over the valid
        history.

        The draws come from `generator` (on the CPU), or are given as
        `indices = (env_idx (K, Bm), slot (K, Bm))` (tests inject the
        reference's draws through this)."""
        if indices is None:
            indices = self.draw_uniform(rs, num_updates, batch_size,
                                        generator)
        return self.take_rows(rs, *self.row_indices(
            "uniform", indices, batch_size, self.num_envs))

    def draw_block(self, rs: ReplayState, num_updates: int, batch_size: int,
                   generator: torch.Generator, num_envs: int | None = None):
        """The random part of block sampling: per update one valid slot and
        the first env of an aligned block of batch_size envs, (slots (K,),
        offs (K,)), over `num_envs` envs (default: the ring's)."""
        b = num_envs or self.num_envs
        n_valid = max(rs.filled - 1, 1)
        ages = torch.randint(1, n_valid + 1, (num_updates,),
                             generator=generator)
        blk = torch.randint(0, b // batch_size, (num_updates,),
                            generator=generator)
        return (rs.cursor - 1 - ages) % self.capacity, blk * batch_size

    def draw_uniform(self, rs: ReplayState, num_updates: int,
                     batch_size: int, generator: torch.Generator,
                     num_envs: int | None = None):
        """The random part of uniform sampling: per row an env and a valid
        slot, (env_idx (K, Bm), slot (K, Bm)), over `num_envs` envs
        (default: the ring's)."""
        shape = (num_updates, batch_size)
        env_idx = torch.randint(0, num_envs or self.num_envs, shape,
                                generator=generator)
        n_valid = max(rs.filled - 1, 1)
        ages = torch.randint(1, n_valid + 1, shape, generator=generator)
        return env_idx, (rs.cursor - 1 - ages) % self.capacity

    def row_indices(self, sample: str, indices, batch_size: int,
                    num_envs: int):
        """(env (K, Bm), slot) int64 on the ring's device, slot (K, Bm) or
        (K, 1) for a block's one slot per update: every minibatch row of a
        column, block or uniform draw over `num_envs` envs, the rows the
        presamples read with take_rows. Draws made on the host reach the
        device in one copy (_to_ring): to a CUDA ring from page-locked
        memory, queued on the current stream without waiting for it."""
        a, b = self._to_ring(*(torch.as_tensor(x, dtype=torch.int64)
                               for x in indices))
        if sample == "uniform":
            return a, b
        rows = torch.arange(batch_size, device=self.device)[None, :]
        if sample == "block":
            return b[:, None] + rows, a[:, None]
        # column: row j of the concatenated columns is env j % B of column
        # j // B, the rows trimmed from offset offs with wrap-around (whole
        # columns are taken untrimmed, from row 0).
        k_cols = a.shape[1]
        j = rows.expand(a.shape[0], -1)
        if batch_size != k_cols * num_envs:
            j = (b[:, None] + j) % (k_cols * num_envs)
        return j % num_envs, torch.gather(a, 1, j // num_envs)

    def _to_ring(self, a, b):
        """(a, b) on the ring's device, handed over at the wait site
        `indices`. Host draws bound for a CUDA ring go in one copy from a
        page-locked buffer of torch's caching host allocator with
        non_blocking=True: the copy is ordered on the current stream and
        the host goes on at once. The allocator hands the buffer out again
        only after the event that the copy recorded has passed, so no copy
        still queued reads a buffer written over."""
        if (self.device.type == "cpu"
                or not a.device.type == b.device.type == "cpu"):
            with spans.wait("indices"):
                return a.to(self.device), b.to(self.device)
        n = (a.numel(), b.numel())
        staged = self.device.type == "cuda"
        flat = torch.empty(sum(n), dtype=torch.int64, pin_memory=staged)
        torch.cat([a.reshape(-1), b.reshape(-1)], out=flat)
        with spans.wait("indices"):
            flat = flat.to(self.device, non_blocking=staged)
        INDEX_COPIES["staged" if staged else "blocking"] += 1
        return (x.view(y.shape) for x, y in zip(flat.split(n), (a, b)))

    def take_rows(self, rs: ReplayState, env, slot):
        """The transitions (obs, action, reward, next_obs, done) at ring
        rows (env, slot), each (K, Bm, ...): one index per buffer that
        reads only the rows it returns."""
        nxt = (slot + 1) % self.capacity
        return (self._unflatten_obs(rs.obs[env, slot]),
                rs.action[env, slot], rs.reward[env, slot],
                self._unflatten_obs(rs.obs[env, nxt]), rs.done[env, slot])

    def presample_global(self, rs: ReplayState, sample: str,
                         batch_size: int, num_updates: int, mesh,
                         generator=None, indices=None):
        """The SPMD learner's presample: the K minibatches of the
        unsharded ring of mesh.size * num_envs envs, drawn over GLOBAL env
        indices (the generator is replicated, so every rank draws the
        same), each rank reading the rows of the envs it owns and the
        minibatch assembled by `owned_rows` (one all-reduce of the rows,
        zero where not owned: exact). Equal, bit for bit, to the
        unsharded ring's presample of the same draws."""
        from ..dist.mesh import owned_rows

        b_glob = self.num_envs * mesh.size
        if indices is None:
            draw = {"column": self.draw_columns, "block": self.draw_block,
                    "uniform": self.draw_uniform}[sample]
            if sample == "block" and (batch_size > b_glob
                                      or b_glob % batch_size):
                raise ValueError("block sampling needs batch_size | "
                                 "num_envs")
            indices = draw(rs, num_updates, batch_size, generator,
                           num_envs=b_glob)
        env, slot = self.row_indices(sample, indices, batch_size, b_glob)
        local = env - mesh.rank * self.num_envs
        mine = (local >= 0) & (local < self.num_envs)
        rows = self.take_rows(rs, torch.where(mine, local, 0), slot)
        return owned_rows(rows, mine, mesh)
