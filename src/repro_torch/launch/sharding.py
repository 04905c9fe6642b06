"""Parallel plans (port of the arithmetic of ``repro.launch.sharding``).

``ParallelPlan`` and ``make_plan`` say, per (arch x shape x mesh), how
many clients run side by side, in how many sequential groups, and at what
per-client micro-batch; the analytic roofline (``launch/roofline.py``)
reads them. ``make_plan`` takes any mesh-like object with ``axis_names``
and a ``shape`` mapping (the reference's production meshes, or a stub).
``cohort_plan`` is the plan of ``stream(devices=D)``, whose ranks
(``launch/mesh.py``) split the clients, and ``round_context`` the
launchers' RoundContext.

The reference's GSPMD ``PartitionSpec`` rules (parameter, batch, KV-cache
and wire-state specs over the production TPU meshes) have no counterpart:
the port shards no parameter. Each rank holds the whole model, and only
the client-state rows are split across ranks (``core.fedavg.owned_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.context import RoundContext
from repro_torch.launch.mesh import axis_size


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    client_axes: Tuple[str, ...]
    micro_axes: Tuple[str, ...]   # within-client batch axes
    seq_axes: Tuple[str, ...]
    replica_axes: Tuple[str, ...]
    n_clients: int
    client_groups: int
    micro: int                    # per-client per-local-step batch
    local_steps: int


def make_plan(arch, shape, mesh) -> ParallelPlan:
    """The reference's plan rules: a regular arch runs one client per
    ``data`` (and ``pod``) slot, replicas over ``model``; a big arch runs
    sequential client groups on one pod (one client per pod on several),
    replicas over (``data``, ``model``). The global batch splits over
    groups x clients x local steps."""
    multi = "pod" in mesh.axis_names
    E = arch.local_steps if shape.kind == "train" else 1
    if arch.big:
        client_axes = ("pod",) if multi else ()
        micro_axes, seq_axes = ("data",), ("model",)
        replica_axes = ("data", "model")
        n_clients = axis_size(mesh, client_axes) if client_axes else 1
        groups = 1 if multi else arch.seq_client_groups
    else:
        client_axes = ("pod", "data") if multi else ("data",)
        micro_axes, seq_axes = (), ("model",)
        replica_axes = ("model",)
        n_clients = axis_size(mesh, client_axes)
        groups = 1
    denom = max(1, groups * n_clients * E)
    micro = max(1, shape.global_batch // denom)
    return ParallelPlan(client_axes, micro_axes, seq_axes, replica_axes,
                        n_clients, groups, micro, E)


def cohort_plan(n_clients: int, *, client_groups: int = 1, micro: int = 1,
                local_steps: int = 1) -> ParallelPlan:
    """The plan of ``stream(devices=D)``: clients split over the ranks of
    the ``clients`` group; params, activations and the reduced wire
    accumulator stay replicated on every rank, client-scope state rows
    stay with the rank that walks them, server-scope state is
    replicated."""
    return ParallelPlan(client_axes=("clients",), micro_axes=(),
                        seq_axes=(), replica_axes=(),
                        n_clients=n_clients, client_groups=client_groups,
                        micro=micro, local_steps=local_steps)


def round_context(plan: ParallelPlan, *, agg_backend: str = "auto",
                  encode_backend: str = "auto",
                  dynamic_sigma: bool = False, cohort: str = "auto",
                  adversary: str = "none") -> RoundContext:
    """The launchers' RoundContext for a plan: the backend selectors and
    ``weights_are_mask=True`` (their samplers emit exact 0/1 masks, so
    every robust ``agg=`` law is available). ``plan`` is accepted for
    per-plan policy later, as in the reference; the reference's
    ``donate_state`` has no counterpart (the port updates its state in
    place)."""
    del plan
    return RoundContext(agg_backend=agg_backend,
                        encode_backend=encode_backend,
                        weights_are_mask=True, dynamic_sigma=dynamic_sigma,
                        cohort=cohort, adversary=adversary)
