"""The shardmap learner: shard-local replay sampling and explicit
collectives (cartpoleplusplus_tpu/dist/shardmap.py in torch).

The agent is built on this rank's envs with `group=mesh,
num_shards=mesh.size` (spmd=False):

  * each rank rolls out ITS envs and inserts into ITS replay rows (no
    communication);
  * each rank samples batch_size / num_shards transitions locally, from a
    stream folded from the replicated generator and the rank
    (agents/common.py::shard_generator);
  * the plain learner all-reduces the mean of (loss, gradient): twice per
    update for DDPG (critic, actor), once for DQN and NAF (the clip after
    it), once per train step for LRPG beside its window statistics;
  * the kernel learners all-gather the K minibatches (LRPG: the window)
    along the batch axis, so every rank runs B3/B5/B7/B9 on the union
    batch and the parameters stay bit-identical on every rank.
"""

from __future__ import annotations

from .mesh import DATA_AXIS, Mesh, shards
from .train import _BATCH_FIELDS, _check_agent, _scan, _stepper


def state_partition_specs(state, mesh: Mesh):
    """The placement of every leaf of an agent state: DATA_AXIS for the
    batch fields' tensors the rule shards, None (replicated) for the
    rest, in the state's own structure (NamedTuples and lists)."""

    def spec(x, batch):
        if batch and hasattr(x, "ndim") and shards(x, mesh.size):
            return DATA_AXIS
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(spec(v, batch) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(spec(v, batch) for v in x)
        return None

    return type(state)(*(spec(getattr(state, f), f in _BATCH_FIELDS)
                         for f in state._fields))


def make_shardmap_evaluate(local_agent, mesh: Mesh, state_template,
                           num_steps: int, seed: int = 0):
    """Sharded deterministic-policy evaluation: each rank resets its envs
    at their global indices (index_offset = rank * local envs) and runs
    the greedy policy; the episode histogram and the reward and done
    totals are all-reduced, so every rank returns the global statistics:
    the integer ones exactly the unsharded eval's, reward_mean and
    done_frac to summation order (agents/common.py::evaluate_policy)."""
    _check_agent(local_agent, mesh, spmd=False)
    return lambda state: local_agent.evaluate(state, num_steps, seed)


def make_shardmap_train_step(local_agent, mesh: Mesh, state_template=None,
                             capture: bool = False):
    """The shardmap train step: fn(state) -> (state, metrics).
    capture=True adds the rollout chunk as metrics["traj"], each rank's
    envs stitched along the env axis in rank order (the global layout the
    SPMD path gives)."""
    return _stepper(local_agent, mesh, capture, spmd=False)


def make_shardmap_train_scan(local_agent, mesh: Mesh, num_calls: int,
                             state_template=None, capture: bool = False):
    """`num_calls` shardmap train steps as one call, with stacked metrics
    (metrics["traj"][k] = rollout chunk k when capture=True)."""
    return _scan(_stepper(local_agent, mesh, capture, spmd=False),
                 num_calls)
