"""Process groups, the env-batch placement rule and the collectives
(cartpoleplusplus_tpu/dist/mesh.py in torch).

The reference lays one named axis, 'data', over every chip and lets XLA
insert the collectives. Here every rank is one process of a
`torch.distributed` group and owns the envs `rank * b_local ...
(rank + 1) * b_local - 1`: env state, observations, replay rows and OU
noise are sliced on their leading (env) axis, network parameters and
optimizer state are replicated. A `Mesh` names the group, this rank and
its device; the collectives below are the only communication.

Backends follow the device with no silent switching: gloo on the CPU,
NCCL on CUDA when each local rank has a card of its own. Ranks that share
a card (NCCL refuses two ranks on one GPU) need `backend="gloo"` passed
explicitly; gloo takes the CUDA tensors itself (it stages them through
the host inside each call).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"

# Per-process counters of the collectives: calls, bytes sent per rank and,
# while `STATS["timed"]` is set, seconds (the device synchronised before
# and after each call).
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}

_DEVICE = None      # the rank's device, set by initialize_multihost


class Mesh(NamedTuple):
    """One process group over the env batch: `size` ranks, this `rank`,
    its `device`, the group handle (None: the default group) and its
    backend."""

    size: int
    rank: int
    device: torch.device
    group: object = None
    backend: str = "gloo"


def reset_stats(timed: bool = False) -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, timed=timed)


def _local_layout(num_processes: int, process_id: int) -> tuple:
    """(local rank, local world size): torchrun's environment, else every
    process on this host."""
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return local_rank, local_world


def resolve_backend(device: str, backend: str | None, local_world: int,
                    num_cards: int) -> str:
    """gloo on the CPU; on CUDA NCCL when every local rank has a card of
    its own, and for ranks that share a card only an explicit gloo."""
    if backend not in (None, "auto", "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if torch.device(device).type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices")
        return "gloo"
    shared = local_world > num_cards
    if backend in (None, "auto"):
        if shared:
            raise ValueError(
                f"{local_world} local ranks share {num_cards} CUDA "
                f"card(s): NCCL takes one rank per card; pass "
                f"backend='gloo' (--dist-backend gloo) to run them anyway")
        return "nccl"
    if backend == "nccl" and shared:
        raise ValueError(f"{local_world} local ranks share {num_cards} CUDA "
                         f"card(s): NCCL takes one rank per card")
    return backend


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None, device: str = "cuda",
                         timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    coordinator_address: "host:port", "tcp://host:port" or "file://path";
    None takes torchrun's MASTER_ADDR/MASTER_PORT. Missing num_processes
    and process_id come from WORLD_SIZE and RANK. device "cuda" (the
    default) gives local rank r the card r (modulo the card count when
    ranks share cards) and raises when no card is visible; "cpu" runs the
    rank on the host. `backend` follows `resolve_backend`."""
    global _DEVICE
    n = int(num_processes if num_processes is not None
            else os.environ["WORLD_SIZE"])
    r = int(process_id if process_id is not None else os.environ["RANK"])
    local_rank, local_world = _local_layout(n, r)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError("initialize_multihost(device='cuda'): no CUDA "
                           "device is visible (pass device='cpu' to run "
                           "the rank on the host)")
    cards = torch.cuda.device_count() if on_cuda else 0
    backend = resolve_backend(device, backend, local_world, cards)
    if on_cuda:
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=init, world_size=n, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def make_mesh(group=None) -> Mesh:
    """The mesh of an initialised process group (the default group unless
    given); a 1-rank CPU mesh when none is initialised."""
    if not dist.is_initialized():
        return Mesh(1, 0, torch.device("cpu"))
    return Mesh(size=dist.get_world_size(group), rank=dist.get_rank(group),
                device=_DEVICE or torch.device("cpu"), group=group,
                backend=dist.get_backend(group))


# --- the collectives --------------------------------------------------------

def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the backend takes: CPU tensors go onto the card for
    NCCL (checkpoint trees are gathered from the host)."""
    if mesh.backend == "nccl" and not x.is_cuda:
        return x.to(mesh.device)
    return x.contiguous()


def _sync(x: torch.Tensor) -> None:
    if STATS["timed"] and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _count(x: torch.Tensor, seconds: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    STATS["seconds"] += seconds


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; every rank gets the
    same bits)."""
    if mesh.size == 1:
        return x.clone()
    _sync(x)
    t0 = time.perf_counter()
    w = _wire(x, mesh).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
    out = w.to(x.device)
    _sync(out)
    _count(x, time.perf_counter() - t0)
    return out


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (same shape on every rank) concatenated along
    `dim` in rank order (the reference's `all_gather(..., tiled=True)`)."""
    if mesh.size == 1:
        return x.clone()
    _sync(x)
    t0 = time.perf_counter()
    w = _wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _sync(out)
    _count(x, time.perf_counter() - t0)
    return out


def owned_rows(xs, mine: torch.Tensor, mesh: Mesh) -> tuple:
    """Tensors of rows (the leading dims, `mine`'s shape) that each rank
    holds where `mine` is true: every rank gets each row from its owner.
    One all-reduce sum over the bytes of every tensor, zero in the rows a
    rank does not own, taken as int64 words: every byte of a word has one
    rank that may set it, so the words add without a carry and each byte
    is its owner's: exact. The wire carries the rows once, whatever the
    rank count."""
    if mesh.size == 1:
        return tuple(xs)
    parts = []
    for x in xs:
        m = mine.reshape(mine.shape + (1,) * (x.ndim - mine.ndim))
        z = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        parts.append(z.reshape(-1).view(torch.uint8))
    pad = -sum(p.numel() for p in parts) % 8
    parts.append(torch.zeros(pad, dtype=torch.uint8, device=mine.device))
    flat = all_reduce_sum(torch.cat(parts).view(torch.int64), mesh)
    flat = flat.view(torch.uint8)
    out, i = [], 0
    for x, p in zip(xs, parts):
        # A copy: a view at a byte offset may not align to the dtype.
        out.append(flat[i:i + p.numel()].clone().view(x.dtype)
                   .reshape(x.shape))
        i += p.numel()
    return tuple(out)


def gather_to_root(x: torch.Tensor, mesh: Mesh):
    """Every rank's `x` (same shape on every rank) concatenated along dim
    0 in rank order, on rank 0's host; None on the other ranks. Only rank
    0 receives: gloo gathers host copies, NCCL gathers on the card one
    tensor at a time."""
    _sync(x)
    t0 = time.perf_counter()
    w = x.detach().cpu().contiguous() if mesh.backend == "gloo" \
        else _wire(x, mesh)
    parts = ([torch.empty_like(w) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(w, parts, dst=0, group=mesh.group)
    _count(x, time.perf_counter() - t0)
    return torch.cat([p.cpu() for p in parts]) if mesh.rank == 0 else None


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


# --- the placement rule -----------------------------------------------------

def _map_tree(fn, tree):
    """`fn` on every tensor leaf of nested NamedTuples, dicts, lists and
    tuples; other leaves (ints, generators, modules) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree


def shards(x: torch.Tensor, size: int) -> bool:
    """The placement rule: a leading axis longer than 1 that divides by
    the number of ranks is sharded; everything else is replicated."""
    return x.ndim >= 1 and x.shape[0] > 1 and x.shape[0] % size == 0


def shard_batch_tree(tree, mesh: Mesh):
    """This rank's rows of every tensor leaf the placement rule shards (a
    copy, so the global tensor can be freed); other leaves kept whole."""
    if mesh.size == 1:
        return tree

    def place(x):
        if not shards(x, mesh.size):
            return x
        n = x.shape[0] // mesh.size
        return x.narrow(0, mesh.rank * n, n).clone()

    return _map_tree(place, tree)


def gather_batch_tree(tree, mesh: Mesh):
    """The inverse of shard_batch_tree, to rank 0: every tensor leaf with
    a leading axis gathered along it in rank order (the global layout, on
    rank 0's host; None on the other ranks); scalars kept. A collective:
    every rank calls it."""
    if mesh.size == 1:
        return tree
    return _map_tree(lambda x: gather_to_root(x, mesh) if x.ndim >= 1
                     else x, tree)
