"""Agents of the port (DDPG and DQN so far) and their replay and learner
plumbing."""

from .ddpg import DDPG, DDPGConfig, DDPGState
from .dqn import DQN, DQNConfig, DQNState
from .replay import ReplayBuffer, ReplayState

__all__ = ["DDPG", "DDPGConfig", "DDPGState", "DQN", "DQNConfig", "DQNState",
           "ReplayBuffer", "ReplayState"]
