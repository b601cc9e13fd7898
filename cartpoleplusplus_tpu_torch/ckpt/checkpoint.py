"""Checkpoints of full agent training states
(cartpoleplusplus_tpu/ckpt/checkpoint.py in torch).

A checkpoint is one directory per step, `<dir>/<step>/state.pt`: the
`torch.save` of a plain dict in the reference's canonical, unflattened
field set, keyed by the reference's field names:

- each module's `state_dict()` (NAF's `net` and LRPG's `policy` under the
  reference's `params`);
- each `AdamState` as {"count", "mu", "nu"}, the moments in
  `module.parameters()` order;
- the replay ring and its cursor and fill count, the env state, `obs`,
  DDPG's OU `noise`, LRPG's `baseline` and `env_steps`;
- the replay-sampling `torch.Generator`'s `get_state()` under the
  reference's `rng`.

Every tensor is saved from the CPU (a copy of the view, never the storage
behind it) and restored onto the target's device. No field of the port
differs in layout between the learners: in kernel mode the modules'
parameters and the Adam moments are views of the learner's group buffers
(`groups`, which is storage and never saved), so a save reads the
canonical values directly and a restore `copy_`s into those same views,
never rebinding them: the kernels keep reading the buffers they were
given, and a checkpoint of either learner restores into the other.

`CheckpointManager` keeps the reference manager's bookkeeping (its
interval policy, the retention of the newest `max_to_keep`, atomic saves
through a temporary directory and `os.replace`) and the reference's
restore rules: fields missing on disk keep the target's values, with the
reference's stderr note, and a full save restores weights-only.

Sharded runs (a `mesh` of several ranks, dist/) save the GLOBAL state:
every rank's env-shaped fields are gathered in rank order to rank 0 alone,
rank 0 writes, and the other ranks wait at a barrier. A restore maps the
global file and each rank reads only its own envs' rows, so a checkpoint
moves between runs of any rank count that divides its env count. The
ranks share the checkpoint directory, as the reference's multi-host
saves do.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch

_FILE = "state.pt"
# The port's field names that differ from the reference's.
_NAMES = {"net": "params", "policy": "params", "generator": "rng"}
# The kernel learners' flat group buffers: storage behind the modules'
# parameters and the Adam moments, never saved.
_DERIVED = ("groups",)
# Checkpoint keys whose tensors lead with the env axis (sharded by rank).
_BATCH_KEYS = ("replay", "env_state", "obs", "noise")


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_asdict")


def state_fields(state) -> list:
    """[(field, checkpoint key)] of a state's saved fields, in order."""
    return [(f, _NAMES.get(f, f)) for f in state._fields
            if f not in _DERIVED]


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _to_tree(x):
    if isinstance(x, torch.nn.Module):
        return {k: _cpu(v) for k, v in x.state_dict().items()}
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return _cpu(x)
    if _is_record(x):
        return {k: _to_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_to_tree(v) for v in x]
    return x


def to_tree(state, exclude=(), mesh=None) -> dict:
    """An agent state -> the plain dict a checkpoint holds, without the
    `exclude`d keys (reference names: e.g. "replay" for weights-only
    saves). Over a `mesh` of several ranks the env-shaped fields are
    gathered into the global layout on rank 0 (None on the other ranks;
    a collective: every rank calls it)."""
    tree = {key: _to_tree(getattr(state, f))
            for f, key in state_fields(state) if key not in exclude}
    if mesh is not None and mesh.size > 1:
        from ..dist.mesh import gather_batch_tree
        for key in _BATCH_KEYS:
            if key in tree:
                tree[key] = gather_batch_tree(tree[key], mesh)
    return tree


@torch.no_grad()
def _merge(target, saved):
    """`saved` restored into `target`'s objects: modules, tensors and
    generators in place, counters and ints replaced."""
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Generator):
        target.set_state(saved)
        return target
    if isinstance(target, torch.Tensor):
        if tuple(target.shape) != tuple(saved.shape) \
                or target.dtype != saved.dtype:
            raise ValueError(f"checkpoint tensor {tuple(saved.shape)} "
                             f"{saved.dtype} does not fit the target's "
                             f"{tuple(target.shape)} {target.dtype}")
        target.copy_(saved)
        return target
    if _is_record(target):
        return type(target)(**{k: (_merge(v, saved[k]) if k in saved else v)
                               for k, v in target._asdict().items()})
    if isinstance(target, (list, tuple)):
        if len(target) != len(saved):
            raise ValueError("checkpoint list length differs from the "
                             "target's")
        return type(target)(_merge(a, b) for a, b in zip(target, saved))
    return saved


def merge_restored(target, tree: dict, exclude=(), mesh=None):
    """The reference's `_reconcile` + `_merge_restored`: `tree`'s fields
    restored into `target` (a fresh state of the agent, in its native
    layout); fields not on disk (a weights-only save) keep the target's
    values with one stderr note, and `exclude`d or extra fields on disk
    are not read. Over a `mesh` of several ranks `tree` is the global
    state and this rank's env rows are restored (sliced before they are
    copied: of a mapped file only these rows are read)."""
    if mesh is not None and mesh.size > 1:
        from ..dist.mesh import shard_batch_tree
        tree = {k: (shard_batch_tree(v, mesh) if k in _BATCH_KEYS
                    and k not in exclude else v) for k, v in tree.items()}
    request = [(f, key) for f, key in state_fields(target)
               if key not in exclude]
    dropped = sorted(key for _, key in request if key not in tree)
    if dropped:
        print(f"ckpt: {', '.join(dropped)} not in checkpoint (weights-only "
              "save?); keeping fresh values", file=sys.stderr)
    return target._replace(**{f: _merge(getattr(target, f), tree[key])
                              for f, key in request if key in tree})


def _load(path: str) -> dict:
    # mmap: fields not requested (a full save restored weights-only, the
    # replay ring) are never read from disk.
    return torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True, mmap=True)


def _write(path: str, tree: dict) -> None:
    """Atomic: a temporary directory beside `path`, renamed into place."""
    parent, name = os.path.split(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, exclude: tuple = (),
                    mesh=None) -> None:
    """Write one checkpoint to `path` (a directory); over a `mesh`, the
    global state, written by rank 0."""
    tree = to_tree(state, exclude, mesh)
    if mesh is None or mesh.rank == 0:
        _write(path, tree)
    if mesh is not None:
        from ..dist.mesh import barrier
        barrier(mesh)


def restore_checkpoint(path: str, target, exclude: tuple = (), mesh=None):
    """Restore into `target` (a fresh agent state); tensors land on the
    target's devices. Fields absent on disk keep target's values;
    `exclude` drops further fields from the request; over a `mesh`, this
    rank's rows of the global state."""
    return merge_restored(target, _load(path), exclude, mesh)


class CheckpointManager:
    """Periodic save / latest-resume over a checkpoint directory, with
    the reference's manager's policy: `should_save(step)` is true when
    step is past the latest saved step and either a multiple of
    `save_interval_steps` or the first save of the directory; the last
    `max_to_keep` saves (in save order, the directory's own steps first,
    sorted) are kept, and the latest step is the one saved last.
    tests/test_torch_ckpt.py holds it to the reference's manager call
    for call. Over a `mesh` of several ranks, every rank keeps the same
    bookkeeping, saves are collective (rank 0 writes the global state)
    and restores give each rank its rows."""

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: int = 3, exclude: tuple = (), mesh=None):
        self.directory = os.path.abspath(directory)
        self._mesh = mesh
        self._interval = save_interval_steps
        self._keep = max_to_keep
        self._exclude = tuple(exclude)
        os.makedirs(self.directory, exist_ok=True)
        self._steps = sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.exists(
                os.path.join(self.directory, n, _FILE)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list:
        """The saved steps in save order (the directory's own, sorted,
        first), as the reference's manager lists them."""
        return list(self._steps)

    def latest_step(self):
        """The step saved last (the reference manager's latest: by save
        order)."""
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        """Whether the interval policy would save at `step`."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self._interval == 0 or not self._steps

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save if the interval policy says so (or `force`); returns
        whether it saved. force=True skips the policy, as the chunked
        train loop needs (its windows end on steps like 511 that are no
        multiple of the interval), but never overwrites a saved step."""
        if not force and not self.should_save(step):
            return False
        if step in self._steps:
            raise ValueError(f"Checkpoint for step {step} already exists.")
        save_checkpoint(self._path(step), state, self._exclude, self._mesh)
        self._steps.append(step)
        writer = self._mesh is None or self._mesh.rank == 0
        while len(self._steps) > self._keep:
            old = self._path(self._steps.pop(0))
            if writer:
                shutil.rmtree(old, ignore_errors=True)
        return True

    def restore(self, target, step: int | None = None):
        """Restore `step` (default: the latest) into `target`, with the
        reference's rules: fields missing on disk keep `target`'s values,
        and the manager's `exclude`d fields are not read."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        return merge_restored(target, _load(self._path(step)),
                              self._exclude, self._mesh)

    def saved_keys(self, step: int | None = None) -> list:
        """The field keys on disk at `step` (default: the latest)."""
        step = self.latest_step() if step is None else step
        return sorted(_load(self._path(step)))

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
