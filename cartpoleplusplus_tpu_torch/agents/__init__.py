"""Agents of the port (DDPG so far) and their replay and learner plumbing."""

from .ddpg import DDPG, DDPGConfig, DDPGState
from .replay import ReplayBuffer, ReplayState

__all__ = ["DDPG", "DDPGConfig", "DDPGState", "ReplayBuffer", "ReplayState"]
