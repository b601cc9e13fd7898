"""The replay ring and its column draws, in plain PyTorch.

Slot i holds (obs, action, reward, done) of one env-step per env; its
successor observation is slot i + 1 (slot 0 after the last), and the
slot just before the cursor is never drawn. A column draw takes, per
update, ceil(batch / B) slots of all B envs each, concatenated, and the
batch's rows from a random offset with wrap-around; the slots and
offsets come from a CPU torch.Generator, ages first.
"""

from __future__ import annotations

import torch


class Ring:
    """A ring of `capacity` slots per env, written in order: a chunk
    that runs past the last slot goes on at slot 0."""

    def __init__(self, num_envs: int, capacity: int):
        self.b, self.capacity = num_envs, capacity
        self.data = None
        self.cursor = self.filled = 0

    def add(self, *traj) -> None:
        """Insert a time-major chunk (T, B, ...) of each buffer at the
        cursor; of a chunk longer than the ring only the last `capacity`
        rows stay, as a pass in order would leave them."""
        t = traj[0].shape[0]
        if self.data is None:
            self.data = [torch.zeros((self.b, self.capacity) + x.shape[2:],
                                     dtype=x.dtype, device=x.device)
                         for x in traj]
        off = max(t - self.capacity, 0)
        slots = (self.cursor + off + torch.arange(
            t - off, device=self.data[0].device)) % self.capacity
        for buf, x in zip(self.data, traj):
            buf[:, slots] = x[off:].transpose(0, 1)
        self.cursor = (self.cursor + t) % self.capacity
        self.filled = min(self.filled + t, self.capacity)

    def columns(self, num_updates: int, batch: int, gen: torch.Generator):
        """(obs, action, reward, next_obs, done), each (K, batch, ...)."""
        b = self.b
        k_cols = -(-batch // b)
        ages = torch.randint(1, max(self.filled - 1, 1) + 1,
                             (num_updates, k_cols), generator=gen)
        offs = torch.randint(0, k_cols * b, (num_updates,), generator=gen)
        dev = self.data[0].device
        slots = ((self.cursor - 1 - ages) % self.capacity).to(dev)
        j = torch.arange(batch, device=dev)[None, :].expand(num_updates, -1)
        if batch != k_cols * b:
            j = (offs.to(dev)[:, None] + j) % (k_cols * b)
        env, slot = j % b, torch.gather(slots, 1, j // b)
        obs, action, reward, done = (x[env, slot] for x in self.data)
        nxt = (slot + 1) % self.capacity
        return obs, action, reward, self.data[0][env, nxt], done


def ring_schedule(cfg: dict) -> tuple:
    """(the first train step that learns, the train steps until the ring
    has wrapped once) of an agent that learns from a ring past
    `warmup_env_steps`."""
    t = cfg["rollout_steps"]
    return (max(-(-cfg["warmup_env_steps"] // t), 1),
            -(-cfg["replay_capacity_per_env"] // t))
