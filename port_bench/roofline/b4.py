"""B4, DQN's epsilon-greedy Q-net in the env loop (csrc/q_rollout.cu on the
shared body `tile_rollout_kernel` of csrc/q_tile.cuh): 5 Q values, int32
actions, and the epsilon gate's one uniform and its scale per env-step."""

from . import rollout

KERNEL = "tile_rollout_kernel"
EPS_FLOP = 2


def counts(cell) -> tuple:
    return rollout.counts(cell, 5, 4, EPS_FLOP, 0)


def net_flop(cell) -> int:
    return rollout.net_flop(cell, 5)
