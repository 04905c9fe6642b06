"""The cohort's device group (port of ``repro.launch.mesh``'s
``make_cohort_mesh``).

The reference's ``stream(devices=D)`` is a ``shard_map`` over a 1-D
``clients`` mesh of D devices in one process. The port runs one process
(rank) per device in a ``torch.distributed`` group instead:

    python -m torch.distributed.run --standalone --nproc-per-node D \\
        -m repro_torch.launch.train ... --cohort "stream(shard=K,devices=D)"

Rank r computes on ``cuda:{LOCAL_RANK % device_count}``, so two ranks on a
one-card machine share ``cuda:0``. The backend follows from the cards, not
from a flag: ``nccl`` when every rank has a card of its own, ``gloo``
otherwise (ranks sharing a card, since NCCL refuses two ranks on one
device, or ranks on the CPU). Under gloo the compute stays on the card and
only the reduce's bytes pass through pinned host memory
(``core.wire.reduce_accumulator``). The production TPU meshes
(``make_production_mesh``) have no counterpart: the port runs no model
sharding.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: how long a rank waits at init and in every collective before the run
#: fails (a dead rank fails the run; it never hangs it)
TIMEOUT = datetime.timedelta(seconds=600)


def backend_for(world: int, device_type: str) -> str:
    """``nccl`` when each rank on this host (``LOCAL_WORLD_SIZE``, else all
    ``world``) has a card of its own, else ``gloo``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` (made the
    current card), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_cohort_group(devices: int = 0, *, device_type: str = "cuda",
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout: datetime.timedelta = TIMEOUT,
                      verbose: bool = True):
    """The initialized process group of the cohort's D ranks: the default
    group, joined here from the environment ``torch.distributed.run``
    sets (``env://``), or from ``init_method``, ``rank`` and ``world_size``
    (e.g. ``file://...`` for spawned ranks), unless it is up already.
    ``devices=0`` takes the world size; any other count must equal it (a
    rank holds the rows of its slice, so an idle rank has nothing to do).
    Prints the backend and the cards once, on rank 0."""
    if not dist.is_initialized():
        world = (world_size if world_size is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        backend = backend_for(world, device_type)
        kw = {} if rank is None else {"rank": rank, "world_size": world}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=timeout, **kw)
    world = dist.get_world_size()
    n = devices or world
    if n > world:
        raise ValueError(f"cohort mesh wants {n} devices but only {world} "
                         f"are visible (start {n} ranks: python -m "
                         f"torch.distributed.run --nproc-per-node {n})")
    if n < world:
        raise ValueError(f"cohort mesh wants {n} devices but the group has "
                         f"{world} ranks (start {n} ranks: python -m "
                         f"torch.distributed.run --nproc-per-node {n})")
    dev = rank_device(device_type)
    if verbose and dist.get_rank() == 0:
        cards = ("cpu" if dev.type != "cuda" else
                 f"{torch.cuda.device_count()} visible, "
                 f"{torch.cuda.get_device_name(dev)}")
        print(f"# cohort group: {world} ranks, backend "
              f"{dist.get_backend()}, cards: {cards}")
    return dist.group.WORLD


def axis_size(mesh, axes) -> int:
    """Product of the named axes' sizes of a mesh-like object (``shape``
    maps axis names to sizes)."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
