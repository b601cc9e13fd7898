"""B6, NAF's mu head in the env loop (`cp_naf_rollout` of
csrc/policy_rollout.cu on the shared body `tile_rollout_kernel` of
csrc/q_tile.cuh, mode kModeNaf): the head's 2 mu rows, float actions, and
per env-step two counter normals of 7 operations each, each scaled by
sigma; no noise carried between steps."""

from . import rollout

KERNEL = "tile_rollout_kernel"
NOISE_FLOP = 2 * 7 + 2 * 1


def counts(cell) -> tuple:
    return rollout.counts(cell, 2, 2 * 4, NOISE_FLOP, 0)


def net_flop(cell) -> int:
    return rollout.net_flop(cell, 2)
