"""Sharding hints (port of ``repro.launch.hints``): the collectives that
make one client's replica run over a grid of ranks, written as
``torch.autograd.Function``s, behind a context the launcher sets so model
code calls them without threading the grid through every layer.

The reference pins layouts and lets GSPMD insert the collectives; here
each hint IS its collective, over a subgroup of a ``launch/mesh.ReplicaGrid``:

  ``seq_shard(x, seq_dim)``  this rank's slice of a full (B, S, ...) tensor:
                       the sequence over the seq axes and, on the big
                       plan's ``micro_axes``, the batch (no communication;
                       the identity on a tensor that is a slice already)
  ``gather_seq(x)``    all-gather along the sequence over the seq axes (the
                       GQA K/V at kv-head width, in their stored dtype);
                       its backward is a reduce-scatter
  ``fsdp_gather(lp)``  one layer's weight shards gathered along the
                       dimensions their spec names (the reference's
                       ``fsdp_params``; an expert tensor's E dimension may
                       stay expert-parallel, the reference's ``_egather``);
                       its backward reduce-scatters the weight gradients
                       onto the shards. A leaf replicated over replica axes
                       has its gradient all-reduced over them instead
  ``expert_swap(buf)`` the MoE dispatch buffer between this rank's
                       sequence shard and the experts it holds: one
                       all-to-all over the seq axes each way (the
                       reference's ``shard_dim`` reshards of ``moe_apply``'s
                       ``ep`` branch); its backward is the other direction
  ``reduce_sum(x, axes)``  a forward all-reduce with no gradient (the
                       loss's token sums, the MoE aux's expert counts)
  ``scatter_seq(x)``   a full-length (B, S, ...) partial summed over the
                       seq axes, this rank's sequence slice kept (the
                       channel-parallel mamba block's output projection);
                       its backward is the all-gather
  ``sum_partials(x)``  the sum over the seq axes of partials whose
                       consumers differ per rank (the mamba block's
                       ``x_proj`` over a channel slice); its backward is
                       the all-reduce of the gradients

Serving (the prefill and decode cells) runs under ``serving_hints``: the
batch rows split over the plan's client and micro axes (a decode's over the
axes its cache's batch dimension takes, ``launch/sharding.cache_specs``),
no layer rematerialized. A decode reads its cache's layout from the whole
spec tree: each slot layout (the self-attention's K/V and the enc-dec's
cross-attention memory, each of its own length) over the axes of its slot
dimension (over every axis at batch 1), and a recurrent state's feature
dimension over the axes its spec names. There

  ``cache_bounds(n, leaf)``  [lo, hi) of this rank's n slots of a slot
                       layout and its length: the rank whose slots hold a
                       position owns it (the only one that writes its K/V)
  ``softmax_stats(m, l, leaf)``  a decode softmax's row max and sum of
                       exponentials over every rank's slots, from each
                       rank's (f32), all-gathered over the layout's slot
                       axes and folded in rank order: every rank of the
                       group gets the same bits
  ``sum_slots(y, leaf)``  the sum over those ranks of each rank's
                       probability-weighted V, added in rank order
  ``state_bounds(n)``  [lo, hi) of this rank's channels of a recurrent
                       state's cut feature dimension
  ``gather_state(x, dim, use)``  all-gather of a channel slice over the
                       state's axes (the sLSTM's state, the mamba step's
                       activations), so every sum over channels is whole
  ``gather_rows(x)``   all-gather of this rank's batch rows (the logits)
  ``last_position(x)`` the hidden state of the sequence's last position,
                       which the last sequence rank holds, on every rank
                       of its sequence group

Every hint is the identity when no grid is set, so the single-device path is
unchanged. ``seq_shard_view(n)`` sets, in one process and without a grid,
the sequence shard count the MoE layer counts its capacity over, as the
reference's ``sharding_hints(mesh, seq_axes)`` does on one device: a
one-process row then routes as a grid of n sequence shards does. Under gloo
a CUDA tensor is staged through pinned host memory (the bytes cross the
host, as ``core/wire.reduce_accumulator``'s do). The
all-reduces are that rank-order chain, so every rank gets the same bits.
Every collective adds to ``COLLECTIVES``, under its kind and use (weight
and K/V gathers, their gradients' reduce-scatters, the wire's re-layout,
the loss, the replicated gradients), the bytes of its result a rank (the
quantity the reference's dry run sums from the HLO: an all-gather's
gathered tensor, a reduce-scatter's shard, an all-reduce's tensor, an
all-to-all's received buffer), one call and the seconds inside it (staging
included); ``collective_totals`` sums them by kind. ``launch/dryrun.py``
and ``chip_smoke.py`` read them.

Remat, on a grid and off it, as the reference's ``jax.checkpoint`` does,
whenever autograd records (``remat_on``; ``remat_mode(False)`` and the
grid's ``sharding_hints(remat=False)`` are the one off switch, which
changes no bit): ``remat(fn, save_weights, *args)`` runs one layer (a
transformer or enc-dec layer, an xLSTM group, a hybrid super-block) in a
``remat_slot``, which marks its forward, and keeps only its arguments (the
layer's input and weights) for the backward pass, which runs it again and
differentiates it. On its first run the gathered K/V and sequence gathers
(and, with ``save_weights``, the gathered weights) are kept; on the
recompute the same hints return the kept tensors instead of gathering
again (the reference's ``save_only_these_names("kv_gathered",
"fsdp_gathered")`` policy). Off a grid only the input is kept: the
recompute runs the whole layer, so keeping the roped K/V, which the
reference names there too, would save no work. ``remat_chunk(fn, *args)``
does the same for one mamba or sLSTM scan chunk or one cross-entropy
chunk, in a region of its own nested in its layer's: only its arguments
(the carry and the chunk's input slices) are kept, and it makes no
collective, so a layer's recompute replays its gathers from the slot in
their order. Off a grid a region is ``_Recomputed``: its first forward
records no graph, where ``torch.utils.checkpoint``'s hooks pack and unpack
every tensor it saves (the one-process local step is bound by the host's
dispatch); on a grid it is that checkpoint (``_recomputed``).

The reference's ``opt_barrier`` and its grad/vmap rules for
``optimization_barrier`` (``hints.py:28-72``) are jax-only: torch neither
hoists a cast across a collective nor needs the rules.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_paths, tree_set

_CTX = {"grid": None, "seq_axes": None, "batch_axes": None,
        "replica_axes": None, "specs": None, "seq_len": None,
        "batch": None, "remat": None, "remat_on": True, "view": 1,
        "cache": None}

KINDS = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce")
#: "<kind>:<use>" (e.g. "all_gather:weight", "reduce_scatter:kv",
#: "all_to_all:to_range") -> [bytes, calls, seconds] since the last reset
COLLECTIVES: dict = {}


def reset_collective_stats() -> None:
    COLLECTIVES.clear()


def record(kind: str, nbytes: int, t0: float, use: str = "") -> None:
    """Count one collective of ``kind`` for ``use`` whose result has
    ``nbytes`` bytes, begun at ``time.perf_counter()`` = ``t0``."""
    row = COLLECTIVES.setdefault(f"{kind}:{use}", [0, 0, 0.0])
    row[0] += int(nbytes)
    row[1] += 1
    row[2] += time.perf_counter() - t0


def collective_totals(field: int = 0) -> dict:
    """Per kind, the sum over uses of ``COLLECTIVES``' bytes (``field``
    0), calls (1) or seconds (2)."""
    out = {k: 0.0 if field == 2 else 0 for k in KINDS}
    for key, row in COLLECTIVES.items():
        out[key.split(":")[0]] += row[field]
    return out


@contextmanager
def sharding_hints(grid, seq_axes, batch_axes=None, *, replica_axes=(),
                   specs=None, remat: bool = True):
    """Set the grid for the hints: ``seq_axes`` split the sequence,
    ``batch_axes`` the batch (the big plan's ``micro_axes``),
    ``replica_axes`` share one client's replica, ``specs`` is the
    parameter spec tree (``launch/sharding.param_specs``) that says how
    each stored leaf is sharded; ``remat`` rematerializes each layer (the
    model reads ``remat_on``)."""
    old = dict(_CTX)
    _CTX.update(grid=grid, seq_axes=tuple(seq_axes or ()),
                batch_axes=tuple(batch_axes or ()),
                replica_axes=tuple(replica_axes or ()), specs=specs,
                seq_len=None, batch=None, remat=None, remat_on=remat,
                cache=None)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


@contextmanager
def seq_shard_view(n: int):
    """Off a grid, count the MoE capacity over ``n`` sequence shards (the
    reference's ``moe_apply`` under ``sharding_hints`` with n sequence
    devices): ``seq_shard_count()`` is n. A grid's own count wins."""
    old = _CTX["view"]
    _CTX["view"] = int(n)
    try:
        yield
    finally:
        _CTX["view"] = old


def active() -> bool:
    return _CTX["grid"] is not None


def remat_on() -> bool:
    """Whether layers and scan chunks are rematerialized: whenever autograd
    records, on a grid or off it, unless ``remat_mode(False)`` (or the
    grid's ``sharding_hints(remat=False)``) turned it off."""
    return _CTX["remat_on"] and torch.is_grad_enabled()


@contextmanager
def remat_mode(on: bool):
    """Rematerialize (the default) or keep every activation: the one
    switch ``build_round_step(remat=)`` and ``build_sharded_round_step(
    remat=)`` set, which changes no bit of a result."""
    old = _CTX["remat_on"]
    _CTX["remat_on"] = bool(on)
    try:
        yield
    finally:
        _CTX["remat_on"] = old


def _size(axes) -> int:
    grid = _CTX["grid"]
    n = 1
    for a in axes or ():
        n *= grid.shape[a]
    return n


def seq_shard_count() -> int:
    """Number of sequence shards under the current hints (off a grid, 1 or
    the count ``seq_shard_view`` sets)."""
    return _size(_CTX["seq_axes"]) if active() else _CTX["view"]


def seq_axes() -> Tuple[str, ...]:
    return _CTX["seq_axes"] if active() else ()


def seq_len(local: int) -> int:
    """The full sequence length of the running forward: its recorded
    length on a grid (``local_positions``), ``local`` off it."""
    if active() and _CTX["seq_len"] is not None:
        return _CTX["seq_len"]
    return local


# ---------------------------------------------------------------------------
# raw collectives (staged through pinned host memory under gloo)
# ---------------------------------------------------------------------------

#: the single-tensor collectives under their current names (torch 2.13
#: renames them; older versions have only the old names)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


def _empty_like_host(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, pin_memory=True)


def all_gather_dim(x: torch.Tensor, group, dim: int,
                   use: str = "") -> torch.Tensor:
    """Concatenation along ``dim`` of every rank's ``x`` in group-rank
    order."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    shape = (n * xt.shape[0],) + tuple(xt.shape[1:])
    if _staged(x, group):
        out = _empty_like_host(shape, xt)
        _ALL_GATHER(out, _host(xt), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, xt, group=group)
    out = out.movedim(0, dim).contiguous()
    record("all_gather", out.numel() * out.element_size(), t0, use)
    return out


def reduce_scatter_dim(x: torch.Tensor, group, dim: int,
                       use: str = "") -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum over the group's ``x``."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    shape = (xt.shape[0] // n,) + tuple(xt.shape[1:])
    if _staged(x, group):
        out = _empty_like_host(shape, xt)
        _REDUCE_SCATTER(out, _host(xt), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, xt, group=group)
    out = out.movedim(0, dim).contiguous()
    record("reduce_scatter", out.numel() * out.element_size(), t0, use)
    return out


def all_reduce_sum(x: torch.Tensor, group, use: str = "") -> torch.Tensor:
    """The sum of the group's ``x`` (a new tensor), the same bits on every
    rank: the rank-order chain of ``core/wire.reduce_accumulator`` (gloo's
    all-reduce promises no order), so a replicated leaf's gradient and the
    loss's token sums stay identical across a replica's ranks."""
    from repro_torch.core import wire
    t0 = time.perf_counter()
    out = wire.reduce_accumulator(x.contiguous(), group)
    record("all_reduce", out.numel() * out.element_size(), t0, use)
    return out


def all_to_all(out: torch.Tensor, inp: torch.Tensor, out_splits,
               in_splits, group, use: str = "") -> None:
    """``all_to_all_single`` of flat 1-D buffers (staged under gloo); the
    result is written into ``out``. A buffer of another dtype than f32 (the
    MoE dispatch's bf16) moves as its raw bytes, which every backend
    takes (gloo refuses int16, for one)."""
    t0 = time.perf_counter()
    nbytes = out.numel() * out.element_size()
    if inp.dtype != torch.float32:
        b = inp.element_size()
        out, inp = out.view(torch.uint8), inp.view(torch.uint8)
        out_splits = [b * n for n in out_splits]
        in_splits = [b * n for n in in_splits]
    if _staged(inp, group):
        h_out = _empty_like_host(out.shape, out)
        dist.all_to_all_single(h_out, _host(inp), list(out_splits),
                               list(in_splits), group=group)
        out.copy_(h_out)
    else:
        dist.all_to_all_single(out, inp, list(out_splits), list(in_splits),
                               group=group)
    record("all_to_all", nbytes, t0, use)


# ---------------------------------------------------------------------------
# autograd-aware hints
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: reduce-scatter
    along ``dim`` over ``group``, then an all-reduce over ``rest`` (the
    replica axes the value is replicated over). ``cached`` (a one-element
    list) hands in the gathered value kept from the first forward of a
    rematerialized layer."""

    @staticmethod
    def forward(ctx, x, group, dim, rest, cached, use):
        ctx.group, ctx.dim, ctx.rest, ctx.use = group, dim, rest, use
        if cached:
            return cached[0]
        return all_gather_dim(x, group, dim, use)

    @staticmethod
    def backward(ctx, g):
        g = reduce_scatter_dim(g, ctx.group, ctx.dim, ctx.use)
        if ctx.rest is not None:
            g = all_reduce_sum(g, ctx.rest, ctx.use)
        return g, None, None, None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward: all-reduce of the gradient over
    ``group`` (a leaf replicated over replica ranks that each see a slice
    of the data)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group, "replicated_grad"), None


def _swap(x: torch.Tensor, group, to_experts: bool,
          use: str) -> torch.Tensor:
    """``expert_swap``'s exchange. To the experts: this rank's (B, E, C, D)
    buffer -> (n, B, E/n, C, D), group rank i's cells of this rank's E/n
    experts at [i]. Back: that layout -> (B, E, C, D), this rank's cells of
    every expert."""
    n = dist.get_world_size(group)
    if to_experts:
        B, E = x.shape[:2]
        send = x.reshape((B, n, E // n) + tuple(x.shape[2:])).movedim(
            1, 0).contiguous()
    else:
        send = x.contiguous()
    out = torch.empty_like(send)
    per = [send.numel() // n] * n
    all_to_all(out.reshape(-1), send.reshape(-1), per, per, group, use)
    if to_experts:
        return out
    return out.movedim(0, 1).reshape((out.shape[1], -1)
                                     + tuple(out.shape[3:]))


class _ExpertSwap(torch.autograd.Function):
    """``_swap`` in one direction; backward: the other direction."""

    @staticmethod
    def forward(ctx, x, group, to_experts, use):
        ctx.group, ctx.to_experts, ctx.use = group, to_experts, use
        return _swap(x, group, to_experts, use)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, not ctx.to_experts, ctx.use), None, \
            None, None


def expert_swap(buf: torch.Tensor, to_experts: bool) -> torch.Tensor:
    """The MoE dispatch buffer between the sequence-shard layout and the
    expert layout over the seq axes, whose n ranks hold E/n experts each
    (rank i experts [i*E/n, (i+1)*E/n)): ``to_experts`` takes this rank's
    (B, E, C, D) buffer of its sequence shard to (n, B, E/n, C, D), every
    shard's cells of this rank's experts in shard order; the other
    direction takes the experts' outputs back to (B, E, C, D). One
    all-to-all a direction, data movement only: every rank's bits are
    kept."""
    group = _CTX["grid"].group(_CTX["seq_axes"])
    return _ExpertSwap.apply(buf, group, to_experts,
                             "moe_dispatch" if to_experts else "moe_combine")


class RematSlot:
    """What one checkpointed layer keeps across its recompute: the
    gathered tensors of its first forward, handed back in the same order
    on the recompute."""

    def __init__(self, save_weights: bool):
        self.save_weights = save_weights
        self.kept = []
        self.pos = 0
        self.first = True


@contextmanager
def remat_slot(slot: Optional[RematSlot]):
    old = _CTX["remat"]
    _CTX["remat"] = slot
    try:
        yield
    finally:
        _CTX["remat"] = old
        if slot is not None:
            slot.first = False
            slot.pos = 0


def remat(fn, save_weights: bool, *args):
    """``fn(*args)``, one layer, rematerialized in the backward pass
    (``_recomputed``) in a ``RematSlot``: the gathered K/V and sequence
    gathers (and, with ``save_weights``, the gathered weights) of the first
    forward are handed back on the recompute (the reference's
    ``save_only_these_names("kv_gathered", "fsdp_gathered")``); nothing
    else of the layer is kept but ``args``. ``args`` are tensors, nested
    dicts of them, or constants. Without remat ``_plain``."""
    if not remat_on():
        return _plain(fn, args)
    slot = RematSlot(save_weights)

    def run(*args):
        with remat_slot(slot):
            return fn(*args)

    return _recomputed(run, args)


def remat_chunk(fn, *args):
    """``fn(*args)``, one scan or cross-entropy chunk, rematerialized in the
    backward pass in a region of its own (nested in its layer's): only
    ``args`` are kept, the reference's per-chunk ``jax.checkpoint``. ``fn``
    makes no collective. Without remat ``_plain``."""
    if not remat_on():
        return _plain(fn, args)
    return _recomputed(fn, args)


def _plain(fn, args):
    """``fn(*args)`` without remat. Where autograd records off a grid,
    ``fn`` gets a view of each tensor of ``args``: the view sums the
    region's uses of the tensor before they join its other uses, as
    ``_Recomputed``'s backward does, so that a gradient summed over regions
    (the enc-dec memory's over the decoder layers, the sLSTM's ``wr`` over
    the scan chunks) is added in the same order, and to the same bits,
    with remat and without. On a grid the checkpoint's recompute joins the
    backward's graph, which sums them as the plain call does."""
    if not torch.is_grad_enabled() or active():
        return fn(*args)
    leaves = []
    rebuild = _flat(args, leaves)
    return fn(*rebuild([t.view_as(t) for t in leaves]))


def _recomputed(fn, args):
    """``fn(*args)`` rematerialized: off a grid by ``_Recomputed``; on a
    grid by ``torch.utils.checkpoint`` (non-reentrant), whose recompute
    stops after the last tensor the backward needs, so that a layer's tail
    is not run again (``_Recomputed`` raised the dry run's rank peak by
    11,472 bytes on the reduced model's big-plan cell). The ranks are
    bound by their collectives, not by the hooks' host time. The models
    draw no random numbers, so neither keeps an RNG state."""
    fn = _replayed(fn)
    if active():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    leaves = []
    rebuild = _flat(args, leaves)
    return _Recomputed.apply(fn, rebuild, *leaves)


def _flat(tree, leaves: list):
    """Append the tensors of ``tree`` (nested dicts, lists and tuples) to
    ``leaves``; -> a function of such a list that rebuilds ``tree`` with
    its tensors."""
    if isinstance(tree, torch.Tensor):
        i = len(leaves)
        leaves.append(tree)
        return lambda ts: ts[i]
    if isinstance(tree, dict):
        parts = {k: _flat(v, leaves) for k, v in tree.items()}
        return lambda ts: {k: f(ts) for k, f in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flat(v, leaves) for v in tree]
        return lambda ts: type(tree)(f(ts) for f in parts)
    return lambda ts: tree


class _Recomputed(torch.autograd.Function):
    """``fn(*rebuild(leaves))`` computed without autograd, keeping only
    ``leaves``; the backward pass computes it again with autograd from
    them and differentiates it. The same ops in the same order as without
    remat, so the same bits."""

    @staticmethod
    def forward(ctx, fn, rebuild, *leaves):
        ctx.fn, ctx.rebuild = fn, rebuild
        ctx.save_for_backward(*leaves)
        ctx.set_materialize_grads(False)
        return fn(*rebuild(leaves))

    @staticmethod
    def backward(ctx, *grads):
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fn(*ctx.rebuild(leaves))
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and isinstance(o, torch.Tensor)
                 and o.requires_grad]
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else [None] * len(wanted))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in leaves)


def _replayed(fn):
    """``fn`` run under the hints as they are now, also when the backward
    pass recomputes it later, outside the caller's contexts (a
    ``seq_shard_view`` the MoE capacity reads, the remat switch the nested
    chunk regions read)."""
    snap = dict(_CTX)

    def run(*args):
        old = dict(_CTX)
        _CTX.update(snap)
        try:
            return fn(*args)
        finally:
            _CTX.clear()
            _CTX.update(old)

    return run


def _gather(x, group, dim, rest, keep: bool, use: str):
    slot = _CTX["remat"]
    if slot is None or not keep:
        return _Gather.apply(x, group, dim, rest, [], use)
    if slot.first:
        out = _Gather.apply(x, group, dim, rest, [], use)
        slot.kept.append(out.detach())
        return out
    cached = slot.kept[slot.pos]
    slot.pos += 1
    return _Gather.apply(x, group, dim, rest, [cached.detach()], use)


def local_positions(batch: int, seq_len: int, device) -> torch.Tensor:
    """Record the full batch and sequence length of the forward that
    starts and return this rank's GLOBAL positions (its sequence slice;
    every position off a grid)."""
    if not active():
        return torch.arange(seq_len, device=device)
    _CTX["seq_len"], _CTX["batch"] = seq_len, batch
    lo, hi = seq_bounds(seq_len)
    return torch.arange(lo, hi, device=device)


def seq_bounds(seq_len: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's sequence slice of a length ``seq_len``."""
    if not active():
        return 0, seq_len
    n = _size(_CTX["seq_axes"])
    if seq_len % n:
        raise ValueError(f"sequence {seq_len} does not split over {n} "
                         f"ranks")
    i = _CTX["grid"].index(_CTX["seq_axes"])
    per = seq_len // n
    return i * per, (i + 1) * per


def batch_bounds(batch: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's batch slice (the big plan's micro axes)."""
    if not active() or not _CTX["batch_axes"]:
        return 0, batch
    n = _size(_CTX["batch_axes"])
    if batch % n:
        raise ValueError(f"micro-batch {batch} does not split over {n} "
                         f"ranks")
    i = _CTX["grid"].index(_CTX["batch_axes"])
    per = batch // n
    return i * per, (i + 1) * per


def seq_shard(x, seq_dim: int = 1):
    """This rank's (batch-, sequence-) slice of ``x`` when ``x`` is the
    full tensor of the running forward; a slice already passes through."""
    if not active() or _CTX["seq_len"] is None:
        return x
    if x.shape[seq_dim] == _CTX["seq_len"] and seq_shard_count() > 1:
        lo, hi = seq_bounds(_CTX["seq_len"])
        x = x.narrow(seq_dim, lo, hi - lo)
    if seq_dim != 0 and x.shape[0] == _CTX["batch"] and \
            _size(_CTX["batch_axes"]) > 1:
        lo, hi = batch_bounds(_CTX["batch"])
        x = x.narrow(0, lo, hi - lo)
    return x


def gather_seq(x, seq_dim: int = 1, *, keep: bool = True, use: str = "kv"):
    """All-gather of a (B, S_local, ...) tensor along the sequence over the
    seq axes, the batch dim kept sharded (the GQA K/V in the stored dtype,
    before any upcast). Kept across a layer's recompute when ``keep``."""
    if not active() or seq_shard_count() == 1:
        return x
    grid = _CTX["grid"]
    return _gather(x, grid.group(_CTX["seq_axes"]), seq_dim, None, keep,
                   use)


def seq_index() -> int:
    """This rank's index over the seq axes (0 off a grid): its sequence
    slice, and its channel slice in the channel-parallel mamba block."""
    return _CTX["grid"].index(_CTX["seq_axes"]) if active() else 0


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` over ``group``; backward: the
    all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim, use):
        ctx.group, ctx.dim, ctx.use = group, dim, use
        return reduce_scatter_dim(x, group, dim, use)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim, ctx.use), None, None, \
            None


class _SumPartials(torch.autograd.Function):
    """All-reduce (sum) over ``group``; backward: the all-reduce of the
    gradients (each rank's consumers of the sum differ)."""

    @staticmethod
    def forward(ctx, x, group, use):
        ctx.group, ctx.use = group, use
        return all_reduce_sum(x, group, use)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group, ctx.use), None, None


def scatter_seq(x, seq_dim: int = 1, *, use: str):
    """This rank's sequence slice of the sum over the seq axes of a
    full-length partial (B, S, ...): one reduce-scatter, whose backward
    all-gathers the slice's gradient. The identity where the sequence is
    not split."""
    if not active() or seq_shard_count() == 1:
        return x
    return _ScatterSeq.apply(x, _CTX["grid"].group(_CTX["seq_axes"]),
                             seq_dim, use)


def sum_partials(x, *, use: str):
    """The sum over the seq axes of each rank's partial ``x`` (the same
    bits on every rank, ``all_reduce_sum``'s rank-order chain); its
    backward all-reduces the gradients, since each rank's consumers of the
    sum differ. The identity where the sequence is not split."""
    if not active() or seq_shard_count() == 1:
        return x
    return _SumPartials.apply(x, _CTX["grid"].group(_CTX["seq_axes"]), use)


def key_positions(positions, n_keys: int):
    """The global positions of the keys a gathered K/V holds."""
    if not active() or seq_shard_count() == 1:
        return positions
    return torch.arange(n_keys, device=positions.device)


def _leaf_spec(path):
    specs = _CTX["specs"]
    for k in path:
        if not isinstance(specs, dict) or k not in specs:
            return ()
        specs = specs[k]
    return specs


def fsdp_gather(lp, prefix: Tuple[str, ...] = (), *, stacked: int = 1,
                skip=(), keep_axes=()):
    """FSDP just-in-time gather of parameter shards: every leaf of ``lp``
    (the tree at ``prefix`` of the stored params; one layer's slice of the
    stored leaves, which drops their ``stacked`` leading dimensions: 1 for
    a depth stack, 2 for the hybrid's (nb, 7, ...) mamba and (nb, 4, ...)
    MoE and MLP stacks or the xLSTM's (ng, 3, ...) mLSTM stack, 0 for a
    leaf outside a stack) is all-gathered along each
    dimension its spec shards, except a dimension sharded over
    ``keep_axes`` (the E dimension of expert-parallel experts, which stays
    this rank's: the reference's ``_egather``); its backward reduce-scatters
    the gradient onto the shards (and all-reduces it over the replica axes
    the leaf is not sharded over). A replicated leaf passes through with its
    gradient all-reduced over the replica axes. Leaves under a key named in
    ``skip`` stay as they are. The gathered weights are kept across the
    layer's recompute when its remat slot says ``save_weights``."""
    if not active():
        return lp
    from repro_torch.launch.sharding import spec_dims
    grid = _CTX["grid"]
    replica = _CTX["replica_axes"]
    slot = _CTX["remat"]
    keep = slot is not None and slot.save_weights
    out: dict = {}
    for path, x in tree_paths(lp):
        if any(k in skip for k in path):
            tree_set(out, path, x)
            continue
        dims = spec_dims(_leaf_spec(prefix + path))
        if any(d < int(stacked) for d, _ in dims):
            raise ValueError(f"{prefix + path}: its spec {dims} cuts one of "
                             f"the {int(stacked)} stacked dimensions a slice "
                             f"drops: gather the stack first")
        held = {a for _, axes in dims for a in axes}
        rest = tuple(a for a in replica if a not in held)
        rest_group = grid.group(rest) if _size(rest) > 1 else None
        # a dimension cut over axes of size 1 (the big plan's `data` on a
        # 1 x n grid) is whole already
        cut = [(d, axes) for d, axes in dims
               if not set(axes) & set(keep_axes) and _size(axes) > 1]
        if not cut:
            y = x if rest_group is None else _SumGrad.apply(x, rest_group)
        else:
            # the inner dimension first; the replica all-reduce of the
            # gradient once, in the outermost gather's backward
            y = x
            for i, (dim, axes) in enumerate(reversed(cut)):
                d = dim - int(stacked)
                y = _gather(y, grid.group(axes), d,
                            rest_group if i == len(cut) - 1 else None, keep,
                            "weight")
        tree_set(out, path, y)
    return out


def cuts_dim(prefix: Tuple[str, ...], dim: int) -> bool:
    """Whether the spec of a stored leaf under ``prefix`` shards its
    dimension ``dim`` (False off a grid)."""
    if not active():
        return False
    from repro_torch.launch.sharding import spec_dims
    tree = _leaf_spec(prefix)
    specs = [s for _, s in tree_paths(tree)] if isinstance(tree, dict) \
        else [tree]
    return any(d == dim for s in specs for d, _ in spec_dims(s))


def reduce_sum(x: torch.Tensor, axes, use: str = "loss") -> torch.Tensor:
    """Forward all-reduce (sum) of a detached tensor over ``axes``."""
    if not active() or _size(axes) == 1:
        return x
    return all_reduce_sum(x.detach(), _CTX["grid"].group(axes), use)


def token_axes() -> Tuple[str, ...]:
    """The axes that split one client's tokens: the sequence's and, on the
    big plan, the micro-batch's."""
    if not active():
        return ()
    return tuple(_CTX["seq_axes"]) + tuple(_CTX["batch_axes"])


def sharded_over(path, dim: int, axes) -> bool:
    """Whether the stored leaf at ``path`` has dimension ``dim`` sharded
    over exactly ``axes`` under the current grid."""
    if not active() or not axes:
        return False
    from repro_torch.launch.sharding import spec_dims
    grid = _CTX["grid"]
    return any(d == dim and grid.axes(a) == grid.axes(axes)
               for d, a in spec_dims(_leaf_spec(path)))


def replica_axes() -> Tuple[str, ...]:
    return _CTX["replica_axes"] or ()


# ---------------------------------------------------------------------------
# serving: the prefill and decode cells on a grid
# ---------------------------------------------------------------------------

def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


#: the slot leaves of a serving cache (top-level keys of the family's
#: ``init_cache`` tree, shaped (L, B, S, K, hd)) and the slot layout each
#: shares: the self-attention's K/V ("k") and the enc-dec's cross-attention
#: memory ("mem_k"), each with a length of its own. Every other leaf is a
#: recurrent state
SLOT_LEAVES = {"k": "k", "v": "k", "mem_k": "mem_k", "mem_v": "mem_k"}
#: the uses of a slot layout's softmax fold: (statistics, V products)
_FOLD_USES = {"k": ("decode_softmax", "decode_attn"),
              "mem_k": ("mem_softmax", "mem_attn")}


def _same_axes(grid, a, b) -> bool:
    return grid.axes(a) == grid.axes(b)


def same_axes(a, b) -> bool:
    """Whether two sets of axes are the same axes of the current grid (in
    any order); off a grid, whether both are empty."""
    if not active():
        return not a and not b
    return _same_axes(_CTX["grid"], a, b)


def _cache_layout(grid, plan, cache_specs, cache_shapes, batch: int,
                  seq_lens) -> dict:
    """The layout of a decode cache from its spec tree (``launch/sharding.
    cache_specs``' output over ``cache_shapes``, the whole cache's shapes,
    at ``batch`` rows and the sequence lengths ``seq_lens`` it matched):
    {"rows": the axes of every leaf's batch dimension, "slots": slot
    layout -> (its slot dimension's axes, its length), "state": the axes
    of the recurrent states' cut feature dimension}. Each cut must be one
    of the three rules: a leaf's batch dimension over the plan's client and
    micro axes; a slot leaf's (``SLOT_LEAVES``) slot dimension, 2; one
    feature dimension of a state leaf, whose size is neither the batch's
    (once the batch's dimension is cut) nor a sequence length (those are
    the sequence rule's), over the same axes in every state leaf. Any other
    cut raises ``ValueError``."""
    from repro_torch.launch.sharding import spec_dims
    shapes = {p: tuple(getattr(v, "shape", v))
              for p, v in tree_paths(cache_shapes)}
    row_axes = tuple(plan.client_axes) + tuple(plan.micro_axes)
    rows, state, slots = [], [], {}

    def unexplained(path, d, shape, axes):
        return ValueError(
            f"cache spec of {'.'.join(path)} {shape}: dimension {d} over "
            f"{axes} is none of a batch, slot or state feature dimension (a "
            f"cache dimension of the batch's or a sequence's size is cut as "
            f"one)")

    for path, spec in tree_paths(cache_specs):
        shape = shapes[path]
        slot = SLOT_LEAVES.get(path[-1]) if len(path) == 1 else None
        got_batch = got_feature = False
        for d, axes in spec_dims(spec):
            is_batch = shape[d] == batch and _same_axes(grid, axes, row_axes)
            if is_batch and not got_batch and (slot is None or d == 1):
                rows.append(axes)
                got_batch = True
            elif slot is not None and d == 2 and shape[d] in seq_lens:
                slots.setdefault(slot, []).append((axes, shape[d]))
            elif slot is None and not got_feature and not is_batch and \
                    shape[d] not in seq_lens:
                state.append(axes)
                got_feature = True
            else:
                raise unexplained(path, d, shape, axes)
    out = {"rows": rows[0] if rows else (), "slots": {}, "state": ()}
    for name, kind in (("rows", rows), ("state", state)):
        if any(not _same_axes(grid, a, kind[0]) for a in kind):
            raise ValueError(f"cache leaves cut their {name} dimension over "
                             f"different axes: {kind}")
        if kind:
            out[name] = grid.axes(kind[0])
    for slot, cuts in slots.items():
        if any(not _same_axes(grid, a, cuts[0][0]) or n != cuts[0][1]
               for a, n in cuts):
            raise ValueError(f"the {slot} slot leaves differ in layout: "
                             f"{cuts}")
        out["slots"][slot] = (grid.axes(cuts[0][0]), int(cuts[0][1]))
    return out


@contextmanager
def serving_hints(grid, plan, specs, *, cache_specs=None, cache_shapes=None,
                  batch: Optional[int] = None, seq_lens=()):
    """The grid for one serving call of the model-sharded replica: the
    parameter shards of ``specs`` gathered a layer over the plan's replica
    axes, no layer rematerialized. A prefill (no ``cache_specs``) splits
    the sequence over the plan's seq axes and the batch rows over its
    client and micro axes (the reference's prefill cell's token spec). A
    decode takes the layout of its cache from ``cache_specs``, the whole
    spec tree ``launch/sharding.cache_specs`` gives the family's cache
    (whose whole shapes are ``cache_shapes``, at ``batch`` rows, the slot
    lengths ``seq_lens`` matched): the batch rows over the axes of the
    leaves' batch dimension; each slot layout (``SLOT_LEAVES``: the
    self-attention's K/V, the enc-dec's memory) over the axes of its slot
    dimension, with its own length (every axis at batch 1); a recurrent
    state's cut feature dimension over the axes its spec names (``model``
    at any batch: at batch 1 the data ranks hold the same state and step it
    alike). A spec that cuts a dimension none of these rules explains (a
    cache dimension of the batch's or a sequence's size) raises
    ``ValueError``. The lengths of the call are its own: nothing a training
    forward recorded under an earlier context is read."""
    if cache_specs is None:
        rows = tuple(plan.client_axes) + tuple(plan.micro_axes)
        cache = None
    else:
        cache = _cache_layout(grid, plan, cache_specs, cache_shapes,
                              int(batch), tuple(seq_lens))
        rows = cache["rows"]
    with sharding_hints(grid, plan.seq_axes, rows,
                        replica_axes=plan.replica_axes, specs=specs,
                        remat=False):
        _CTX["cache"] = cache
        yield


def serving() -> bool:
    """Whether a decode's cache layout is set (``serving_hints``)."""
    return active() and _CTX["cache"] is not None


def _slots(leaf: str):
    """(axes, length) of the slot layout of ``leaf`` ("k" or "mem_k", or a
    leaf sharing one), None where no cache layout is set."""
    if not serving():
        return None
    return _CTX["cache"]["slots"].get(SLOT_LEAVES[leaf])


def slot_axes(leaf: str = "k") -> Tuple[str, ...]:
    """The axes of the slot dimension of ``leaf``'s layout (() off a
    grid)."""
    slots = _slots(leaf)
    return () if slots is None else slots[0]


def cache_bounds(n_slots: int, leaf: str = "k") -> Tuple[int, int, int]:
    """(lo, hi, length): this rank's ``n_slots`` slots [lo, hi) of the
    length of ``leaf``'s slot layout (the self-attention's, "k", or the
    enc-dec memory's, "mem_k"); (0, n_slots, n_slots) where no cache layout
    is set. Raises ``ValueError`` when the length does not split over the
    layout's axes or ``n_slots`` is not this rank's share."""
    slots = _slots(leaf)
    if slots is None:
        return 0, n_slots, n_slots
    axes, length = slots
    n = _size(axes)
    if length % n:
        raise ValueError(f"a {length}-slot cache does not split over {n} "
                         f"ranks")
    per = length // n
    if n_slots != per:
        raise ValueError(f"cache slice of {n_slots} slots, the grid's is "
                         f"{per} of {length}")
    i = _CTX["grid"].index(axes)
    return i * per, (i + 1) * per, length


def _slot_group(leaf: str):
    """The group of ``leaf``'s slot axes, None where the slots are not
    split."""
    slots = _slots(leaf)
    if slots is None:
        return None
    return _CTX["grid"].group(slots[0])


def softmax_stats(m: torch.Tensor, l: torch.Tensor,
                  leaf: str = "k") -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, L), a decode softmax's row max and sum of exp(score - M) over
    every rank's slots of ``leaf``'s layout, from each rank's f32 ``m``
    (the max of its scores) and ``l`` (the sum of exp(score - m) over its
    slots): the two all-gathered over the layout's slot axes in one tensor
    (``all_gather:decode_softmax``, the memory's ``:mem_softmax``) and
    folded in rank order, so every rank of the group gets the same bits.
    ``(m, l)`` where the slots are not split."""
    group = _slot_group(leaf)
    if group is None:
        return m, l
    parts = all_gather_dim(torch.stack([m, l]).unsqueeze(0), group, 0,
                           _FOLD_USES[SLOT_LEAVES[leaf]][0])
    top = parts[:, 0].amax(dim=0)
    total = torch.zeros_like(l)
    for part in parts:
        total = total + torch.exp(part[0] - top) * part[1]
    return top, total


def sum_slots(y: torch.Tensor, leaf: str = "k") -> torch.Tensor:
    """The sum over the ranks of ``leaf``'s slot axes of each rank's f32
    ``y`` (the probability-weighted V over its slots): all-gathered
    (``all_gather:decode_attn``, the memory's ``:mem_attn``) and added in
    rank order, the same bits on every rank; ``y`` where the slots are not
    split."""
    group = _slot_group(leaf)
    if group is None:
        return y
    parts = all_gather_dim(y.unsqueeze(0), group, 0,
                           _FOLD_USES[SLOT_LEAVES[leaf]][1])
    total = torch.zeros_like(y)
    for part in parts:
        total = total + part
    return total


def _state_axes() -> Tuple[str, ...]:
    return _CTX["cache"]["state"] if serving() else ()


def state_bounds(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's channels of a recurrent state's feature
    dimension of ``n`` channels, cut over the axes the cache's spec names
    for it (``serving_hints``); (0, n) where the state is not cut."""
    axes = _state_axes()
    k = _size(axes) if axes else 1
    if n % k:
        raise ValueError(f"a state of {n} channels does not split over {k} "
                         f"ranks")
    if k == 1:
        return 0, n
    i = _CTX["grid"].index(axes)
    return i * (n // k), (i + 1) * (n // k)


def gather_state(x: torch.Tensor, dim: int, use: str) -> torch.Tensor:
    """All-gather along ``dim`` of this rank's channel slice over the axes
    of the recurrent state's cut feature dimension, in their rank order
    (every channel on every rank), laid out in memory in ``x``'s order of
    dimensions: the whole tensor one process holds there has that layout
    (the mamba step's activations come out of an einsum with the batch
    innermost), and the card's matmul picks its kernel, so its bits, by
    the layout (an H100 rounded ``x_proj`` otherwise for a row-major copy).
    The identity where the state is not cut."""
    axes = _state_axes()
    if not axes or _size(axes) == 1:
        return x
    out = all_gather_dim(x, _CTX["grid"].group(axes), dim, use)
    order = sorted(range(x.dim()), key=lambda i: (-x.stride(i), i))
    back = sorted(range(x.dim()), key=order.__getitem__)
    return out.permute(order).contiguous().permute(back)


def gather_rows(x: torch.Tensor, use: str = "logits") -> torch.Tensor:
    """All-gather along dim 0 of this rank's batch rows over the serving
    call's batch axes (every row on every rank); the identity where the
    rows are not split."""
    if not active() or _size(_CTX["batch_axes"]) == 1:
        return x
    return all_gather_dim(x, _CTX["grid"].group(_CTX["batch_axes"]), 0, use)


def last_position(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, D): the last position of a (B, S_loc, D) sequence slice, the
    last sequence rank's, on every rank of the sequence group (the ranks'
    last positions all-gathered, ``all_gather:prefill_last``)."""
    last = x[:, -1:]
    if not active() or seq_shard_count() == 1:
        return last
    group = _CTX["grid"].group(_CTX["seq_axes"])
    return all_gather_dim(last, group, 1, "prefill_last")[:, -1:]
