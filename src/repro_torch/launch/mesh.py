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
(``core.wire.reduce_accumulator``).

The model-sharded client replica runs on a ``ReplicaGrid``: the ranks of
the default group laid out row-major over named axes, with one subgroup for
every set of axes (``make_replica_grid``). ``make_production_mesh`` is the
reference's production mesh as such a grid: (data, model) 16 x 16, or (pod,
data, model) 2 x 16 x 16, over a 256- or 512-rank group (a fake one for the
dry run, ``launch/dryrun.py``). Chip runs use a small grid, such as 2 x 2
ranks sharing one card under gloo.
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

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


class ReplicaGrid:
    """The ranks of the default group as a row-major grid over named axes
    (the port's counterpart of a ``jax.sharding.Mesh``). ``shape`` maps each
    axis name to its size (``launch/sharding.make_plan`` reads it and
    ``axis_names``); ``coords`` is this rank's coordinate on each axis.
    ``group(axes)`` is the subgroup of the ranks that share this rank's
    coordinates off ``axes`` (None where the axes hold one rank), with its
    ranks in row-major order over ``axes``, so the index of a rank in the
    subgroup is ``index(axes)``."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 rank: int, groups: Dict[Tuple[str, ...], object]):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               _unravel(rank, tuple(self.shape.values()))))
        self._groups = groups

    @property
    def size(self) -> int:
        return axis_size(self, self.axis_names)

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` in the grid's order (a set of axes has one group)."""
        return tuple(a for a in self.axis_names if a in tuple(axes))

    def group(self, axes):
        axes = self.axes(axes)
        return self._groups.get(axes) if axis_size(self, axes) > 1 else None

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its rank in
        ``group(axes)``)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def index_of(self, coords: Dict[str, int], axes) -> int:
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def __repr__(self) -> str:
        dims = " x ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ReplicaGrid({dims}, rank {self.rank})"


def _unravel(i: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def make_replica_grid(shape: Sequence[int], names: Sequence[str], *,
                      device_type: str = "cuda",
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      timeout: datetime.timedelta = TIMEOUT) -> ReplicaGrid:
    """A ``ReplicaGrid`` of ``shape`` over the default group, joined here
    (``env://``, or ``init_method`` and ``rank``) unless it is up already;
    its size must equal the group's. The backend follows ``backend_for``:
    gloo where ranks share a card (the 2 x 2 grid on one H100), nccl where
    each rank has its own. Every rank makes every subgroup, in the same
    order, as ``torch.distributed.new_group`` asks."""
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"grid shape {shape} and axis names {names} do not "
                         f"match")
    world = 1
    for s in shape:
        world *= s
    if not dist.is_initialized():
        backend = backend_for(world, device_type)
        kw = {} if rank is None else {"rank": rank, "world_size": world}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=timeout, **kw)
    if dist.get_world_size() != world:
        raise ValueError(f"a {' x '.join(map(str, shape))} grid needs "
                         f"{world} ranks, but the group has "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    groups = {}
    all_coords = [_unravel(r, shape) for r in range(world)]
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            if all(shape[a] == 1 for a in axes):
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            buckets: Dict[tuple, list] = {}
            for r, c in enumerate(all_coords):
                buckets.setdefault(tuple(c[a] for a in rest), []).append(r)
            for key in sorted(buckets):
                g = dist.new_group(buckets[key])
                if me in buckets[key]:
                    groups[tuple(names[a] for a in axes)] = g
    if device_type == "cuda":
        rank_device(device_type)
    return ReplicaGrid(shape, names, me, groups)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> ReplicaGrid:
    """The reference's production mesh as a grid of ranks: (data, model)
    16 x 16, or (pod, data, model) 2 x 16 x 16, over a default group of 256
    or 512 ranks (``make_replica_grid``'s keywords pass through)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_replica_grid(shape, axes, **kw)


def axis_size(mesh, axes) -> int:
    """Product of the named axes' sizes of a mesh-like object (``shape``
    maps axis names to sizes)."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
