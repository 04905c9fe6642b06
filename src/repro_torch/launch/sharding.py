"""Parallel plans (port of the arithmetic of ``repro.launch.sharding``).

``ParallelPlan`` and ``make_plan`` say, per (arch x shape x mesh), how
many clients run side by side, in how many sequential groups, and at what
per-client micro-batch; the analytic roofline (``launch/roofline.py``)
reads them. ``make_plan`` takes any mesh-like object with ``axis_names``
and a ``shape`` mapping (the reference's production meshes, or a stub).
``cohort_plan`` is the plan of ``stream(devices=D)``, whose ranks
(``launch/mesh.py``) split the clients, and ``round_context`` the
launchers' RoundContext.

The spec rules of the reference's GSPMD plans are ported rule for rule:
``param_specs``, ``batch_specs``, ``wire_state_specs``,
``server_state_specs`` and ``cache_specs``; ``range_state_specs`` and
``range_server_specs`` are the model-sharded replica's own state layout.
A spec is a plain tuple, one entry per dimension: None, an axis name, or
a tuple of names (the reference's ``PartitionSpec``, which is a tuple
too). The rules are pure functions of names and shapes, over the port's
trees (``meta`` tensors, shape tuples or ``BatchLeaf``s) and any
mesh-like object with ``shape`` and ``axis_names`` (a
``launch/mesh.ReplicaGrid`` or a stub). The
model-sharded client replica (``core/fedavg.build_sharded_round_step``)
stores each parameter as this rank's shard of its spec
(``models/api.shard_params``); every family's train cell runs on a grid
(the enc-dec's frames, (G, N, E, micro, S_src, D), cut along their
sequence as the tokens are).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.core.context import RoundContext
from repro_torch.core.tree import tree_map
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


# ---------------------------------------------------------------------------
# parameter specs (the reference's rules, launch/sharding.py:107-297)
# ---------------------------------------------------------------------------

_COL_KEYS = ("wq", "wk", "wv", "w1", "w3", "wqkv", "wx", "in_proj", "wif",
             "dt_proj")
_ROW_KEYS = ("wo", "w2", "out_proj", "x_proj")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _divides(n: int, mesh, axes) -> bool:
    return n % axis_size(mesh, axes) == 0


def _param_spec(path_keys, shape, mesh, replica_axes,
                moe_experts: int) -> tuple:
    name = path_keys[-1]
    ndim = len(shape)
    spec = [None] * ndim

    def set_dim(d, axes):
        spec[d] = axes[0] if len(axes) == 1 else tuple(axes)

    if name == "router" or ndim == 1:
        return ()
    if name == "embed":
        for axes in (replica_axes, ("model",), ("data",)):
            if set(axes) <= set(replica_axes) and _divides(shape[0], mesh,
                                                           axes):
                set_dim(0, axes)
                break
        return tuple(spec)
    if name == "lm_head":
        for axes in (replica_axes, ("model",), ("data",)):
            if set(axes) <= set(replica_axes) and _divides(shape[-1], mesh,
                                                           axes):
                set_dim(ndim - 1, axes)
                break
        return tuple(spec)
    # MoE expert tensors (..., E, D, F): the expert dim over `model`, the
    # other replica axes over the ff dim
    if moe_experts > 0 and ndim >= 3 and shape[-3] == moe_experts and \
            name in ("w1", "w2", "w3"):
        rest = [a for a in replica_axes if a != "model"]
        if _divides(moe_experts, mesh, ("model",)):
            spec[ndim - 3] = "model"
            if rest and _divides(shape[-1], mesh, tuple(rest)):
                set_dim(ndim - 1, rest)
        elif _divides(shape[-1], mesh, replica_axes):
            set_dim(ndim - 1, replica_axes)
        return tuple(spec)
    if ndim >= 2 and name in _COL_KEYS and _divides(shape[-1], mesh,
                                                    replica_axes):
        set_dim(ndim - 1, replica_axes)
        return tuple(spec)
    if ndim >= 2 and name in _ROW_KEYS and _divides(shape[-2], mesh,
                                                    replica_axes):
        set_dim(ndim - 2, replica_axes)
        return tuple(spec)
    # fallback: the biggest trailing dim that divides
    for d in (ndim - 1, ndim - 2):
        if d >= 0 and shape[d] >= 1024 and _divides(shape[d], mesh,
                                                    replica_axes):
            set_dim(d, replica_axes)
            return tuple(spec)
    return ()


def param_specs(param_shapes, mesh, plan: ParallelPlan,
                moe_experts: int = 0):
    """The spec of every leaf of a parameter tree (``meta`` tensors or
    shape tuples, e.g. ``family_module(cfg).param_shapes(cfg)``), as a tree
    of the same structure."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return _param_spec(path, _shape(tree), mesh, plan.replica_axes,
                           moe_experts)
    return walk(param_shapes, ())


def spec_dims(spec) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """-> every sharded dimension of a parameter spec with its axes as a
    tuple, in dimension order: () for a replicated leaf, one pair for a
    dense leaf, two for an MoE expert tensor of the big plan (E over
    `model`, the last dimension over the other replica axes)."""
    return tuple((d, (e,) if isinstance(e, str) else tuple(e))
                 for d, e in enumerate(spec) if e is not None)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's shape ``shape`` cut along every dimension ``spec``
    shards."""
    out = list(shape)
    for d, axes in spec_dims(spec):
        out[d] //= axis_size(mesh, axes)
    return tuple(out)


# ---------------------------------------------------------------------------
# batch / state / cache specs
# ---------------------------------------------------------------------------

def _axes_entry(axes):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_specs(batch_shapes, plan: ParallelPlan):
    """Round-batch leaves have layout (groups, n_clients, E, micro, S,
    ...)."""
    def spec(leaf):
        ndim = len(_shape(leaf))
        s = [None] * ndim
        if ndim >= 2:
            s[1] = _axes_entry(plan.client_axes)
        if ndim >= 4:
            s[3] = _axes_entry(plan.micro_axes)
        if ndim >= 5:
            s[4] = _axes_entry(plan.seq_axes)
        return tuple(s)

    return tree_map(spec, batch_shapes)


def wire_state_specs(cstate_shapes, plan: ParallelPlan):
    """Per-client state slots (G, N, n_coords): clients over the plan's
    client axes, the coordinate axis replicated (each client reads and
    writes only its own rows). The reference's layout, kept as its rule;
    the model-sharded replica (``core/fedavg.build_sharded_round_step``)
    keeps ``range_state_specs``' instead."""
    def spec(leaf):
        shape = _shape(leaf)
        s = [None] * len(shape)
        if len(shape) >= 2:
            s[1] = _axes_entry(plan.client_axes)
        return tuple(s)

    return tree_map(spec, cstate_shapes)


def server_state_specs(server_shapes, plan: ParallelPlan):
    """Server-scope slots (one flat (n_coords,) row each): replicated, as
    the params they correct. The reference's layout; the model-sharded
    replica keeps ``range_server_specs``' instead."""
    del plan
    return tree_map(lambda leaf: (), server_shapes)


def range_state_specs(cstate_shapes, plan: ParallelPlan):
    """The model-sharded replica's per-client state slots, (G, N, d_pad)
    over the whole cohort: clients over the plan's client axes and the
    flat coordinates over its replica axes, so a rank holds (G, 1, hi -
    lo), the range [lo, hi) of its payload bytes (``wire.RangeLayout``;
    ``fedavg.init_server_state(layout=)``). The state bytes a rank are
    those of ``wire_state_specs`` over the replica's size; the dry run
    counts both layouts' from these rules (``dryrun.state_bytes``)."""
    def spec(leaf):
        s = [None] * len(_shape(leaf))
        if len(s) >= 3:
            s[1] = _axes_entry(plan.client_axes)
            s[2] = _axes_entry(plan.replica_axes)
        return tuple(s)

    return tree_map(spec, cstate_shapes)


def range_server_specs(server_shapes, plan: ParallelPlan):
    """The model-sharded replica's server-scope slots, one flat (d_pad,)
    row each: the coordinates over the replica axes (a rank holds the
    range of its payload bytes), replicated over the client axes, where
    every rank decodes the same range."""
    return tree_map(lambda leaf: (_axes_entry(plan.replica_axes),),
                    server_shapes)


def cache_specs(cache_shapes, plan: ParallelPlan, *, batch: int,
                seq_lens: Tuple[int, ...]):
    """Decode KV/state cache: seq dims over seq(+micro when batch == 1)
    axes, batch dims over client+micro axes, large feature dims over
    `model`."""
    big_seq_axes = plan.seq_axes if batch > 1 else tuple(
        list(plan.client_axes) + list(plan.micro_axes) + list(plan.seq_axes))
    batch_axes = tuple(list(plan.client_axes) + list(plan.micro_axes))

    def spec(leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        s = [None] * ndim
        got_seq = False
        for d, size in enumerate(shape):
            if size in seq_lens and not got_seq:
                s[d] = _axes_entry(big_seq_axes)
                got_seq = True
            elif size == batch and batch > 1 and s[d] is None and \
                    d < ndim - 1:
                if batch % axis_size_tuple(batch_axes) == 0:
                    s[d] = _axes_entry(batch_axes)
        if not got_seq:
            # recurrent state: shard the largest model-divisible feature dim
            for d in range(ndim - 1, -1, -1):
                if s[d] is None and shape[d] >= 1024 and shape[d] % 16 == 0:
                    s[d] = "model"
                    break
        return tuple(s)

    return tree_map(spec, cache_shapes)


#: the production mesh's axis sizes (the reference's ``_MESH_SIZES``)
_MESH_SIZES = {"pod": 2, "data": 16, "model": 16}


def axis_size_tuple(axes) -> int:
    n = 1
    for a in axes:
        n *= _MESH_SIZES[a]
    return n
