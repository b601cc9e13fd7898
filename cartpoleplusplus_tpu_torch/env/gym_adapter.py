"""Single-env gym-style adapter (cartpoleplusplus_tpu/env/gym_adapter.py
in torch): the reference's env API shape.

`reset() -> obs`, `step(a) -> (obs, reward, done, info)`, `render()`,
gym spaces, and the static `add_opts(parser)` hook that trainers compose
flags with: numpy in and out, one env, the same call shapes. Underneath
runs the batched `CartPole3D` as a 1-env batch without auto-reset, on the
card unless the caller asks for the CPU; `render()` draws camera 0
through kernel B10 there. For throughput use CartPole3D directly.
gym/gymnasium are not dependencies: `Discrete` and `Box` are duck-typed
stand-ins with the same attributes (n / low, high, shape) and `sample()`.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import add_dataclass_args, from_args
from ..physics import CartPoleParams
from .cartpole import CartPole3D
from .pixels import RenderConfig


class Discrete:
    """gym.spaces.Discrete stand-in."""

    def __init__(self, n: int):
        self.n = n
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        if rng is None:
            rng = np.random
        if hasattr(rng, "integers"):  # numpy Generator API
            return int(rng.integers(self.n))
        return int(rng.randint(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n


class Box:
    """gym.spaces.Box stand-in."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = np.full(shape, low, dtype)
        self.high = np.full(shape, high, dtype)
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, rng=None):
        if rng is None:
            rng = np.random
        # Unbounded dims sample a standard normal (gym.Box's convention),
        # bounded dims a uniform.
        bounded = np.isfinite(self.low) & np.isfinite(self.high)
        lo = np.where(bounded, self.low, 0.0)
        hi = np.where(bounded, self.high, 1.0)
        u = rng.uniform(lo, hi)
        g = rng.standard_normal(self.shape) if hasattr(
            rng, "standard_normal") else rng.randn(*self.shape)
        return np.where(bounded, u, g).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low)
                and np.all(x <= self.high))


class GymCartPole3D:
    """The reference's env class shape over the batched env."""

    metadata = {"render.modes": ["rgb_array"]}

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 obs_mode: str = "pose_stack", seed: int = 0,
                 render_config: RenderConfig | None = None,
                 device="cuda"):
        # auto_reset=False: gym semantics, the caller sees the terminal
        # observation and resets explicitly.
        self._env = CartPole3D(params, num_envs=1, obs_mode=obs_mode,
                               auto_reset=False, device=device,
                               render_config=render_config)
        self._seed = seed
        self._episode = 0
        self._state = None
        if params.discrete_actions:
            self.action_space = Discrete(self._env.num_actions)
        else:
            self.action_space = Box(-1.0, 1.0, (self._env.action_dim,))
        if obs_mode == "pixels":
            self.observation_space = Box(0.0, 1.0, self._env.obs_shape)
        else:
            self.observation_space = Box(-np.inf, np.inf,
                                         (self._env.obs_size,))

    @staticmethod
    def add_opts(parser: argparse.ArgumentParser) -> None:
        """Contribute this env's flags (--env.*) to a composed parser."""
        add_dataclass_args(parser, CartPoleParams, prefix="env.")

    @staticmethod
    def from_opts(args: argparse.Namespace, **kw) -> "GymCartPole3D":
        return GymCartPole3D(from_args(CartPoleParams, args, prefix="env."),
                             **kw)

    def seed(self, seed: int):
        """Restart the reproducible episode sequence from `seed`: the next
        reset() matches a fresh env constructed with this seed."""
        self._seed = seed
        self._episode = 0

    def reset(self) -> np.ndarray:
        # A fresh episode: a new derived seed per (seed, episode), so
        # repeated resets draw other initial pushes, reproducibly.
        self._state, obs = self._env.reset(
            self._seed * 1_000_003 + self._episode)
        self._episode += 1
        return obs[0].cpu().numpy()

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        dev = self._env.device
        if self._env.params.discrete_actions:
            a = torch.tensor([int(action)], dtype=torch.int32, device=dev)
        else:
            a = torch.as_tensor(np.asarray(action, np.float32)[None],
                                device=dev)
        self._state, obs, reward, done, info = self._env.step(self._state,
                                                              a)
        info_out = {k: v.cpu().numpy()[0] for k, v in info.items()
                    if k != "terminal_obs"}
        return (obs[0].cpu().numpy(), float(reward[0]), bool(done[0]),
                info_out)

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        """Camera 0's RGB frame of the current state, uint8 (x * 255 +
        0.5): kernel B10 on the card, its twin on the CPU."""
        from ..ops.render_kernel import render

        if self._state is None:
            raise RuntimeError("call reset() before render()")
        cfg = self._env.render_config
        cam0 = dataclasses.replace(cfg, cameras=cfg.cameras[:1],
                                   grayscale=False)
        img = render(self._env.params, cam0, self._state.phys)
        return (img[0].cpu().numpy() * 255.0 + 0.5).astype(np.uint8)

    def close(self):
        pass
