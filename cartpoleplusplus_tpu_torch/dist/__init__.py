"""Distribution over ranks (cartpoleplusplus_tpu/dist in torch): process
groups, the env-batch placement rule, the collectives, the SPMD learner,
the shardmap learner and the sharded eval.

The only axis is the env batch: pure data parallelism. Each rank of a
`torch.distributed` group owns a contiguous slice of the envs (their
seeds key on the global env index, so trajectories do not depend on the
layout); parameters and optimizer state are replicated. Launch with
`torchrun --nproc-per-node N -m cartpoleplusplus_tpu_torch.train ...`.
"""

from .mesh import (DATA_AXIS, STATS, Mesh, all_gather_cat, all_reduce_sum,
                   barrier, gather_batch_tree, initialize_multihost,
                   make_mesh, reset_stats, shard_batch_tree)
from .shardmap import (make_shardmap_evaluate, make_shardmap_train_scan,
                       make_shardmap_train_step, state_partition_specs)
from .train import (make_distributed_train_scan, make_distributed_train_step,
                    measure_rollout_rate, scaling_report, shard_agent_state,
                    stitch_traj)

__all__ = [
    "DATA_AXIS",
    "STATS",
    "Mesh",
    "all_gather_cat",
    "all_reduce_sum",
    "barrier",
    "gather_batch_tree",
    "initialize_multihost",
    "make_mesh",
    "reset_stats",
    "shard_batch_tree",
    "make_distributed_train_scan",
    "make_distributed_train_step",
    "make_shardmap_evaluate",
    "make_shardmap_train_scan",
    "make_shardmap_train_step",
    "measure_rollout_rate",
    "scaling_report",
    "shard_agent_state",
    "state_partition_specs",
    "stitch_traj",
]
