"""Agents of the port (DDPG, DQN, NAF, LRPG and the random baseline) and
their replay and learner plumbing."""

from .ddpg import DDPG, DDPGConfig, DDPGState
from .dqn import DQN, DQNConfig, DQNState
from .lrpg import LRPG, LRPGConfig, LRPGState
from .naf import NAF, NAFConfig, NAFState
from .random_agent import RandomAgent
from .replay import ReplayBuffer, ReplayState

__all__ = ["DDPG", "DDPGConfig", "DDPGState", "DQN", "DQNConfig", "DQNState",
           "LRPG", "LRPGConfig", "LRPGState", "NAF", "NAFConfig", "NAFState",
           "RandomAgent", "ReplayBuffer", "ReplayState"]
