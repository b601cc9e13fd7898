"""B2, DDPG's actor in the env loop (csrc/policy_rollout.cu on the shared
body `tile_rollout_kernel` of csrc/q_tile.cuh): the actor's 2 outputs,
float actions, and the OU update (two counter normals of 7 operations and
5 more per component) with its (B, 2) noise carried in and out."""

from . import rollout

KERNEL = "tile_rollout_kernel"
OU_FLOP = 2 * 7 + 2 * 5


def counts(cell) -> tuple:
    return rollout.counts(cell, 2, 2 * 4, OU_FLOP, 2 * 4)


def net_flop(cell) -> int:
    return rollout.net_flop(cell, 2)
