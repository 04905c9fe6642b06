"""z-SignFedAvg round engine (port of ``repro.core.fedavg``).

One round step:

    for each client c of a group or shard (a Python loop; the reference
    vmaps it):
        E local SGD steps from the server params -> pseudo-gradient
        (x0 - xE)/gamma in f32 (or the batch gradient when E == 1),
        written into row c of ONE preallocated (K, d_pad) f32 buffer
    -> ONE batched encode over the K rows and their pipeline state (on a
       card: kernel E1 for the counter-noise sign encode, C1 for the
       dense-noise one, F1 for the fused EF-SignSGD step; 1 bit/coord)
    -> the weighted sign-reduce over the packed payloads (R1)
    -> decode_sum (/ n_live, * eta_z * sigma) -> unflatten once -> server
       optimizer step.

Per-client PRNG keys are derived by GLOBAL client index exactly like the
reference (``rng, sub = split(state.rng)``; client j's key is ``fold_in(sub,
j)``), so every plan below draws the reference's counter-stream bits.
``RoundContext.cohort`` picks the plan (``resolve_cohort``):

  vmap, one group   all n clients in one buffer, one encode, one reduce.
  vmap, G groups    the sequential group scan: the groups run one after
                    another through the same (N, d_pad) buffer. Compressed
                    wires keep each group's payload stack and reduce ONCE
                    over the (G*N, n_bytes) stack; the dense f32 wire
                    folds each group into one carried sum. N == 1 is the
                    sequential-client mode (E1 with n = 1).
  stream(shard=K)   the flat cohort of G*N clients in K-client shards
                    through one (K, d_pad) buffer; each shard's payloads
                    fold into ONE running accumulator (``Pipeline.zero_acc``:
                    a flat sum, the int32 vote pair of the robust sign laws
                    or top-k's scatter sums; or the ``wire.SignFoldAcc`` of
                    ``Pipeline.fold_init`` on the f32-weighted routes),
                    closed by ``fold_finalize`` before decode. The last
                    shard wraps to the cohort's first rows under a zero
                    mask; their state rows are never written back.
                    Bit-identical to the vmap plan at any K.
  stream(feed=host) the same shards, with batch, mask and state rows in
                    pinned host memory: shard s+1 is copied to the card on
                    a side stream while shard s computes, and finished
                    state rows return to the host.
  stream(devices=D) one rank of a torch.distributed group (launch/mesh.py)
                    per device: the shard sequence, padded to a multiple of
                    D with all-padding shards under a zero mask, splits
                    into D contiguous slices, and rank r walks slice r with
                    GLOBAL shard and client indices (keys, adversary,
                    rows). Each rank finalizes its accumulator, and the
                    ranks meet in ONE O(d) rank-order reduce
                    (``Pipeline.reduce_across_devices``) plus one scalar
                    (the loss); every rank then takes the same server step,
                    so params and server state stay replicated bit for bit.
                    Client-state rows stay with the rank whose slice holds
                    them (``owned_rows``; ``init_server_state(ctx=)``).

A ``RoundContext.adversary`` (``fed.adversary``) drops scheduled clients
from the round's host mask before anything reads it, and corrupts each
group's or shard's encoded payload stack after the encode (so EF residuals
stay honest) and before the aggregate, by global client index and round
counter: every plan sees the same attack. ``RoundContext.debug_wire`` checks
once a round that the host mask is exactly 0/1. ``RoundContext.round_mode
= "async(...)"`` hands the round to ``fed.async_server``, which runs the
stream pass below with a fold-weight vector apart from the compute mask and
queues late payload rows for a later round.

Stateful pipelines (``ef``, ``cv``) keep ``ServerState.comp_state`` =
``{slot: (G, N, d)}``; a dead client keeps its rows bit-exactly. The
pipeline updates those rows in place, and the group scan and the stream
plans write each group's or shard's new rows back into them in place: at
qwen2-0.5B width a second state of 16 clients would cost another 31.6 GB.
Server-scope state (the ``cv`` server variate) is ``ServerState.comp_server``,
on the card under every plan, read by every encode and updated once a round
after the decode. Under ``RoundContext(dynamic_sigma=True)`` every encode and
the decode take ``ServerState.sigma`` (the Plateau controller's); pipelines
with a ``sigma_sched`` stage get the round's TreeSpec at both ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import noise as znoise
from repro_torch.core import wire
from repro_torch.core.context import (COHORT_DEVICES_AUTO,
                                      STREAM_AUTO_MIN_ELEMS,
                                      STREAM_DEFAULT_SHARD, STREAM_SHARD_AUTO,
                                      STREAM_SHARD_BUDGET_BYTES,
                                      STREAM_SHARD_MAX, STREAM_SHARD_MIN,
                                      CohortPolicy, RoundContext,
                                      RoundModePolicy)
from repro_torch.core.tree import (tree_leaves, tree_map, tree_paths,
                                   tree_set)
from repro_torch.fed.adversary import parse_adversary
from repro_torch.optim.optimizers import Optimizer, make_optimizer


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 8            # parallel clients of one group
    client_groups: int = 1        # sequential groups; total = n * groups
    local_steps: int = 1          # E
    client_lr: float = 0.01       # gamma
    server_lr: float = 1.0        # eta (decode already applies eta_z * sigma)
    server_opt: str = "sgd"       # sgd | momentum | adam
    server_opt_kw: tuple = ()     # e.g. (("beta", 0.9),)


class ServerState(NamedTuple):
    params: Any
    opt_state: Any
    #: stacked per-client pipeline state {slot: (G, N, ...)} or None
    comp_state: Any
    rng: torch.Tensor             # (2,) int64 key words
    round: int
    sigma: torch.Tensor           # f32 scalar, the codec's noise scale
    #: shared server-scope pipeline state {slot: (d,)} (the cv server
    #: variate), on the card, or None
    comp_server: Any = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor
    grad_est_norm: torch.Tensor
    participation: torch.Tensor
    uplink_bits: torch.Tensor
    #: clients per stream shard this round (0 on the vmap plan), an int32
    #: scalar as in the reference
    shard_clients: torch.Tensor = torch.zeros((), dtype=torch.int32)


class RoundInputs(NamedTuple):
    """What every driver of a round reads once from the state and the mask
    (``build_round_step``'s ``round_inputs``)."""
    spec: Any                     # the params' wire.TreeSpec
    params: Any
    device: torch.device
    rng: torch.Tensor             # the next round's key
    sub: torch.Tensor             # this round's client key root
    plan: "CohortPlan"
    #: the (G, N) f32 mask after the adversary's dropout, where the caller
    #: gave it (the sampler's, on the host)
    mask: torch.Tensor
    gamma_t: torch.Tensor         # client lr, f32 on the device
    #: what the encodes read besides their rows (dynamic sigma, server
    #: state, the TreeSpec), passed only where a stage takes it
    extra: dict


class CohortPlan(NamedTuple):
    """Resolved execution plan of the round driver (see resolve_cohort)."""
    mode: str          # "vmap" | "stream"
    shard: int         # clients per stream shard (0 on the vmap plan)
    unroll: int        # recorded only: the shard loop is a Python loop
    devices: int       # ranks of the torch.distributed group (1 = none)
    feed: str          # "device" | "host" shard feeding


#: the vmap plan: the whole cohort (or each group) in one batch
VMAP_PLAN = CohortPlan("vmap", 0, 1, 1, "device")


def _server_optimizer(cfg: FedConfig) -> Optimizer:
    return make_optimizer(cfg.server_opt, lr=cfg.server_lr,
                          **dict(cfg.server_opt_kw))


def init_server_state(params, cfg: FedConfig, compressor, rng: torch.Tensor,
                      sigma0: float = 0.0, host_state: bool = False,
                      ctx: Optional[RoundContext] = None,
                      group=None, layout=None) -> ServerState:
    """Fresh server state. ``host_state`` puts the per-client state rows in
    host memory (pinned when the params lie on a card), where the
    ``stream(feed=host)`` plan keeps them; the server-scope state stays
    with the params. Given the round's ``ctx`` (and the cohort ``group``,
    the default torch.distributed group when None), a rank of a
    ``stream(devices=D)`` round holds only its own rows, flat: ``{slot:
    (hi - lo, n_coords)}`` for its ``owned_rows`` (lo, hi).

    On the model-sharded replica ``params`` are this rank's shards and
    ``layout`` is the round step's ``wire.RangeLayout``
    (``build_sharded_round_step(...).layout(params)``): the rank then
    holds its flat range [lo, hi) of every slot, ``{slot: (G, 1, hi -
    lo)}`` for its client of each group and ``{slot: (hi - lo,)}`` of the
    server slots, with the params (``launch/sharding.range_state_specs``);
    no rank holds a (d,) row."""
    device = tree_leaves(params)[0].device
    if layout is not None:
        lo, hi = layout.bounds
        return ServerState(
            params=params, opt_state=_server_optimizer(cfg).init(params),
            comp_state=compressor.init_state(
                hi - lo, lead=(cfg.client_groups, 1), device=device),
            rng=rng, round=0,
            sigma=torch.tensor(sigma0, dtype=torch.float32, device=device),
            comp_server=compressor.init_server_state(hi - lo, device=device))
    n_coords = wire.tree_spec(params).n_coords
    rows = None if ctx is None else state_rows(cfg, ctx, n_coords, group)
    # one zero state row per client per slot: (groups, n_clients, ...), or
    # the rank's own rows
    cstate = compressor.init_state(
        n_coords, lead=((cfg.client_groups, cfg.n_clients) if rows is None
                        else (rows[1] - rows[0],)),
        device="cpu" if host_state else device,
        pin_memory=host_state and device.type == "cuda")
    cserver = compressor.init_server_state(n_coords, device=device)
    return ServerState(params=params,
                       opt_state=_server_optimizer(cfg).init(params),
                       comp_state=cstate, rng=rng, round=0,
                       sigma=torch.tensor(sigma0, dtype=torch.float32,
                                          device=device),
                       comp_server=cserver)


def auto_shard_size(n_coords: int) -> int:
    """The reference's streaming shard size from the memory budget: about
    one f32 gradient row plus its packed wire row per client (4*d + d/8
    bytes), K = budget // that, rounded down to a multiple of
    SIGN_REDUCE_CLIENT_BLK and clamped to [STREAM_SHARD_MIN,
    STREAM_SHARD_MAX]."""
    if n_coords <= 0:
        return STREAM_DEFAULT_SHARD
    k = STREAM_SHARD_BUDGET_BYTES // (4 * n_coords + n_coords // 8)
    k = (k // wire.SIGN_REDUCE_CLIENT_BLK) * wire.SIGN_REDUCE_CLIENT_BLK
    return int(min(max(k, STREAM_SHARD_MIN), STREAM_SHARD_MAX))


def resolve_cohort(policy, total_clients: int, n_coords: int,
                   group=None, spmd_axes=None) -> CohortPlan:
    """CohortPolicy (or its spec string) + the round's shapes -> the plan,
    as the reference resolves it: ``vmap`` is the vmap plan; ``auto`` and a
    bare ``stream`` keep it below STREAM_AUTO_MIN_ELEMS client-coordinate
    elements and while one auto-sized shard covers the cohort; an explicit
    ``shard=K``, ``shard=auto`` or ``feed=host`` always streams. The shard
    is clamped to the cohort; ``devices=auto`` is the size of the cohort's
    torch.distributed ``group`` (the default group when None; 1 without
    one), more devices than the group has ranks raise, and the device
    count is clamped to the shard count.

    ``spmd_axes`` is a grid plan's client axes (the model-sharded
    replica's clients side by side, ``build_sharded_round_step``): the
    grid already runs the clients in parallel, so ``auto`` and a bare
    ``stream`` are the vmap plan and a forced stream policy raises the
    reference's ``ValueError``."""
    pol = CohortPolicy.parse(policy)
    if pol.mode == "vmap":
        return VMAP_PLAN
    forced = pol.mode == "stream" and (pol.shard != 0 or pol.devices != 1
                                       or pol.feed == "host")
    if spmd_axes is not None:
        if forced:
            raise ValueError(
                f"cohort policy {policy!r} forces the streaming plan, "
                f"but the launcher plan shards the client axis over mesh "
                f"axes {spmd_axes!r} — the shard scan would serialize the "
                "axis the mesh parallelizes. Drop the stream(...) policy "
                "(the mesh already provides client parallelism) or use a "
                "launcher plan without client_axes.")
        return VMAP_PLAN
    if not forced and total_clients * n_coords < STREAM_AUTO_MIN_ELEMS:
        return VMAP_PLAN
    want = (auto_shard_size(n_coords)
            if pol.shard in (0, STREAM_SHARD_AUTO) else pol.shard)
    shard = min(want, total_clients)
    if shard >= total_clients and not forced:
        return VMAP_PLAN   # one shard IS the vmap plan
    _, world = wire.rank_world(group)
    devices = world if pol.devices == COHORT_DEVICES_AUTO else pol.devices
    if devices > world:
        raise ValueError(
            f"cohort plan wants devices={devices} but only {world} are "
            f"visible (start D ranks, one per device: python -m "
            f"torch.distributed.run --nproc-per-node D, which "
            f"launch/mesh.py's make_cohort_group joins)")
    devices = max(1, min(devices, -(-total_clients // shard)))
    return CohortPlan("stream", shard, pol.unroll, devices, pol.feed)


def rank_shards(plan: CohortPlan, total: int, rank: int) -> range:
    """The global shard indices rank ``rank`` walks under ``plan``: all of
    them on one device; under ``devices=D`` the shard count is padded to a
    multiple of D (all-padding shards under a zero mask) and rank r takes
    the contiguous slice [r * per, (r + 1) * per), the reference's
    shard_map partition (and ``CohortSampler.device_partitions``)."""
    n_shards = -(-total // plan.shard)
    if plan.devices <= 1:
        return range(n_shards)
    per = -(-n_shards // plan.devices)
    return range(rank * per, (rank + 1) * per)


def owned_rows(plan: CohortPlan, total: int, rank: int) -> Tuple[int, int]:
    """The cohort rows (lo, hi) whose client state rank ``rank`` holds: the
    real clients of its shard slice (``rank_shards``); the padding slots of
    the last slices own none. O(ceil(total / D) * d) state bytes a rank."""
    shards = rank_shards(plan, total, rank)
    return (min(shards.start * plan.shard, total),
            min(shards.stop * plan.shard, total))


def state_rows(cfg: FedConfig, ctx: RoundContext, n_coords: int,
               group=None) -> Optional[Tuple[int, int]]:
    """This rank's ``owned_rows`` when ``ctx`` runs the synchronous
    ``stream(devices=D > 1)`` plan, else None (every row, in the (G, N)
    layout). Async rounds walk every shard on each rank whatever
    ``devices=`` says, as the reference's async rounds do."""
    if RoundModePolicy.parse(ctx.round_mode).mode != "sync":
        return None
    total = cfg.client_groups * cfg.n_clients
    plan = resolve_cohort(ctx.cohort, total, n_coords, group)
    if plan.devices <= 1:
        return None
    return owned_rows(plan, total, wire.rank_world(group)[0])


def _gather_rows(x: torch.Tensor, rows: torch.Tensor,
                 pin: bool) -> torch.Tensor:
    out = torch.empty((rows.numel(),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device, pin_memory=pin)
    return torch.index_select(x, 0, rows.to(x.device), out=out)


def _gather_state(x: torch.Tensor, rows: torch.Tensor, row_lo: int,
                  pin: bool) -> torch.Tensor:
    """State rows ``rows`` (cohort indices) of a rank that holds rows
    row_lo .. row_lo + len(x) - 1 in ``x``; a row another rank holds (a
    padding slot's wrap) reads as zeros, since its weight is 0."""
    local = rows - row_lo
    own = (local >= 0) & (local < x.shape[0])
    if bool(own.all()):
        return _gather_rows(x, local, pin)
    out = torch.zeros((rows.numel(),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device, pin_memory=pin)
    if bool(own.any()):
        out[own.to(x.device)] = x[local[own].to(x.device)]
    return out


def iter_shards(batch, mask, cstate, *, shard: int, total: int,
                pin: bool = False, before_gather: Optional[Callable] = None,
                shards: Optional[range] = None, row_lo: int = 0):
    """The shard feeder of the streaming plan (port of the reference's
    ``iter_shards``): yields ``(s, batch_s, cstate_s, mask_s)`` per shard in
    global shard order, over ``shards`` (every shard of the cohort by
    default; a rank's slice under ``stream(devices=D)``). A shard inside
    the cohort is a view of the flat rows; a shard past its end wraps to
    the cohort's first rows (a gathered copy, in pinned memory with
    ``pin``) under a zero participation mask. ``cstate`` holds the flat
    state rows from cohort row ``row_lo`` on (all rows, from 0, on one
    device); the state rows of a view are the caller's own rows.
    ``before_gather`` runs just before wrapped rows are read (the host feed
    waits there for the copies that write earlier shards' rows back)."""
    shards = range(-(-total // shard)) if shards is None else shards

    def flat(x):
        return x.reshape((total,) + tuple(x.shape[2:]))

    b = tree_map(flat, batch)
    m = flat(mask).to(torch.float32)
    c = (None if cstate is None else
         {k: v.reshape((-1, v.shape[-1])) for k, v in cstate.items()})
    for s in shards:
        lo = s * shard
        if lo + shard <= total:
            def take(x):
                return x[lo:lo + shard]

            def take_state(x):
                return x[lo - row_lo:lo - row_lo + shard]
            mask_s = m[lo:lo + shard]
        else:
            slots = torch.arange(lo, lo + shard)
            rows = slots % total
            if before_gather is not None:
                before_gather()

            def take(x):
                return _gather_rows(x, rows, pin)

            def take_state(x):
                return _gather_state(x, rows, row_lo, pin)
            mask_s = m[rows.to(m.device)] * (slots < total).to(m.device)
        yield (s, tree_map(take, b),
               None if c is None else {k: take_state(v)
                                       for k, v in c.items()},
               mask_s)


def _prefetch(shards, device: torch.device):
    """Copy each host shard to ``device`` on a side stream, one shard ahead
    of the compute: the copy of shard s+1 is issued after everything the
    compute stream holds up to shard s-1 (so it never reads host rows that
    a write-back still owns) and runs while shard s computes."""
    if device.type != "cuda":
        yield from shards
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def upload(item):
        s, batch_s, cstate_s, mask_s = item
        side.wait_stream(main)
        with torch.cuda.stream(side):
            moved = [tree_map(lambda x: x.to(device, non_blocking=True), t)
                     if t is not None else None
                     for t in (batch_s, cstate_s, mask_s)]
        done = torch.cuda.Event()
        done.record(side)
        return (s, *moved), done

    def use(up):
        item, done = up
        main.wait_event(done)
        # the side stream allocated these; the compute stream uses them
        for t in item[1:]:
            for x in ([] if t is None else tree_leaves(t)):
                x.record_stream(main)
        return item

    cur = upload(next(shards))
    for item in shards:
        nxt = upload(item)
        yield use(cur)
        cur = nxt
    yield use(cur)


def _write_rows(dst, src, n: int) -> None:
    """State rows back into the caller's rows: the first ``n`` rows of each
    ``src`` buffer into ``dst`` (no copy where they are the same memory)."""
    for k, d in dst.items():
        s = src[k][:n]
        if s.data_ptr() != d.data_ptr() or s.device != d.device:
            d.copy_(s, non_blocking=True)


def build_round_step(loss_fn: Callable, compressor, cfg: FedConfig,
                     ctx: Optional[RoundContext] = None, group=None, *,
                     remat: bool = True):
    """-> round_step(state, batch, mask) -> (state, RoundMetrics).

    ``loss_fn(params, batch_slice)`` is a scalar loss; ``batch`` is a tree
    whose leaves have leading dims (client_groups, n_clients, E, ...);
    ``mask`` is the (client_groups, n_clients) 0/1 (or weight) mask.
    ``group``: the ranks of ``stream(devices=D)`` (the default
    torch.distributed group when None); every rank calls the step with the
    same batch and mask. The launcher always takes the default group; a
    subgroup exists for tests that run D = 2 on pairs of a 4-rank group
    (``tests/torch_multidevice_ranks.py``), as do the ``group`` arguments
    of ``init_server_state`` and ``resolve_cohort``. ``remat``
    rematerializes each layer and scan chunk of the client's local SGD (on
    by default, as in the reference; off only to show that it changes no
    bit), as ``build_sharded_round_step``'s does on a grid."""
    from repro_torch.launch import hints
    ctx = ctx or RoundContext()
    compressor = compressor.with_context(ctx)
    policy = CohortPolicy.parse(ctx.cohort)
    opt = _server_optimizer(cfg)
    gamma = cfg.client_lr
    G, N = cfg.client_groups, cfg.n_clients
    total = G * N
    adversary = parse_adversary(ctx.adversary)
    if adversary is not None:
        adversary = adversary.bind(total)
    debug_wire = ctx.debug_wire or getattr(compressor.codec, "debug_wire",
                                           False)

    def client_update(spec, params0, client_batch, row, gamma_t):
        """One client: local SGD, then its pseudo-gradient written into
        ``row`` (its f32 row of the cohort buffer). -> mean local loss."""
        with hints.remat_mode(remat):
            return local_sgd(spec, params0, client_batch, row, gamma_t)

    def local_sgd(spec, params0, client_batch, row, gamma_t):
        paths = [p for p, _ in tree_paths(params0)]
        if cfg.local_steps == 1:
            # E == 1: the pseudo-gradient (x0 - x1)/gamma IS the batch
            # gradient, so the updated weights never need to exist
            p = tree_map(lambda w: w.detach().requires_grad_(True), params0)
            loss = loss_fn(p, tree_map(lambda x: x[0], client_batch))
            grads = torch.autograd.grad(loss, tree_leaves(p))
            for g, off in zip(grads, spec.offsets):
                row[off:off + g.numel()].copy_(g.reshape(-1))
            return loss.detach().to(torch.float32)
        p = params0
        losses = []
        for e in range(cfg.local_steps):
            pg = tree_map(lambda w: w.detach().requires_grad_(True), p)
            loss = loss_fn(pg, tree_map(lambda x: x[e], client_batch))
            leaves = tree_leaves(pg)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = {}
                for path, w, g in zip(paths, leaves, grads):
                    tree_set(p, path, w.detach() - gamma * g.to(w.dtype))
            losses.append(loss.detach().to(torch.float32))
        with torch.no_grad():
            for (_, a), b, off in zip(tree_paths(params0), tree_leaves(p),
                                      spec.offsets):
                seg = row[off:off + a.numel()].view(a.shape)
                torch.sub(a.to(torch.float32), b.to(torch.float32), out=seg)
                seg.div_(gamma_t)
        return torch.stack(losses).mean()

    def new_buffer(rows: int, d: int, device) -> torch.Tensor:
        """The (rows, d_pad) f32 client buffer, reused by every group or
        shard of the round: row c receives client c's pseudo-gradient IN
        PLACE (the reference stacks the vmapped rows functionally); the
        tile padding past d stays zero, as the reference's pad does."""
        mult = compressor.pad_multiple()
        d_pad = -(-d // mult) * mult
        buf = torch.empty((rows, d_pad), dtype=torch.float32, device=device)
        if d_pad > d:
            buf[:, d:].zero_()
        return buf

    def encode_clients(spec, params, batch_rows, keys, cstate_rows, mask_s,
                       live_rows, buf, gamma_t, extra, lo, round_idx):
        """One group or shard of k = len(mask_s) clients (the reference's
        ``group_encode``): local SGD of each into ``buf[:k]``, then ONE
        batched encode, then the adversary's payload attack on clients lo
        .. lo+k-1 (global indices). -> (payload stack, new state rows,
        masked loss sum). Dead (and padding) clients keep their state rows
        and add no loss; ``live_rows`` lists the others as host
        indices."""
        k = mask_s.shape[0]
        losses = torch.stack([
            client_update(spec, params, tree_map(lambda x: x[c], batch_rows),
                          buf[c], gamma_t)
            for c in range(k)])
        with torch.no_grad():
            enc, new_rows = compressor.encode_batch(keys, buf[:k],
                                                    spec.n_coords,
                                                    cstate_rows, mask_s,
                                                    live_rows=live_rows,
                                                    **extra)
            if adversary is not None:
                enc = adversary.corrupt(enc, torch.arange(lo, lo + k),
                                        round_idx)
            loss_sum = torch.sum(torch.where(mask_s > 0, losses * mask_s,
                                             0.0))
        return enc, new_rows, loss_sum

    def live_among(live, lo: int, k: int):
        """The live rows among cohort slots lo .. lo+k-1, as indices from 0
        (a slot past the cohort is the stream's wrapped padding)."""
        return [c for c in range(k) if lo + c < total and live[lo + c]]

    def vmap_groups(inp: RoundInputs, batch, mask, live, cstate, round_idx):
        """The vmap plan: one group (all clients in one batch), or the
        sequential group scan over G groups of N."""
        spec, params, sub = inp.spec, inp.params, inp.sub
        gamma_t, extra = inp.gamma_t, inp.extra
        d = spec.n_coords
        device = gamma_t.device
        keys = znoise.client_keys(sub, 0, total)
        buf = new_buffer(N, d, device)
        if G == 1:
            rows = (None if cstate is None else
                    {k: v[0] for k, v in cstate.items()})
            enc, rows, loss_sum = encode_clients(
                spec, params, tree_map(lambda x: x[0], batch), keys, rows,
                mask[0], live_among(live, 0, N), buf, gamma_t, extra, 0,
                round_idx)
            del buf
            if rows is not None:
                cstate = {k: v.unsqueeze(0) for k, v in rows.items()}
            with torch.no_grad():
                return compressor.aggregate(enc, mask[0], d), cstate, loss_sum
        stacked = compressor.stacks_group_payloads()
        encs, acc = [], None
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for g in range(G):
            rows = (None if cstate is None else
                    {k: v[g] for k, v in cstate.items()})
            enc, new_rows, ls = encode_clients(
                spec, params, tree_map(lambda x: x[g], batch),
                keys[g * N:(g + 1) * N], rows, mask[g],
                live_among(live, g * N, N), buf, gamma_t, extra, g * N,
                round_idx)
            with torch.no_grad():
                if rows is not None:
                    _write_rows(rows, new_rows, N)
                loss_sum = loss_sum + ls
                if stacked:
                    # compressed wire: keep the payload stack, reduce once
                    encs.append(enc)
                else:
                    # dense f32 wire: fold each group into the carried sum
                    # (the client-order fold of one call over all groups)
                    acc = compressor.aggregate(enc, mask[g], d, acc=acc)
        del buf
        with torch.no_grad():
            if stacked:
                enc_all = (torch.cat(encs) if isinstance(encs[0],
                                                         torch.Tensor)
                           else {k: torch.cat([e[k] for e in encs])
                                 for k in encs[0]})
                del encs
                acc = compressor.aggregate(enc_all, mask.reshape(-1), d)
        return acc, cstate, loss_sum

    def stream_cohort(inp: RoundInputs, batch, mask, live, cstate, round_idx,
                      shard: int, host: bool, fold_w=None, on_shard=None,
                      shards: Optional[range] = None, row_lo: int = 0):
        """The streaming plan: K = ``shard`` clients at a time through one
        (K, d_pad) buffer, each shard's payloads folded into one running
        accumulator, returned open (``fold_finalize`` closes it).
        ``host``: batch, mask and state rows stay in (pinned) host memory
        and each shard is copied to the card one shard ahead; the state
        returned lives on the host. ``mask`` gates local SGD, the loss and
        the state rows; ``fold_w`` (padded to whole shards, on the device)
        weighs the fold instead of it where given, and ``on_shard(lo,
        enc)`` sees each shard's payload stack before the next shard runs
        (the two hooks of async rounds). ``shards`` and ``row_lo``: a rank's
        slice of ``stream(devices=D)`` and the first cohort row of its
        flat state rows (``iter_shards``)."""
        spec, params, sub = inp.spec, inp.params, inp.sub
        gamma_t, extra = inp.gamma_t, inp.extra
        d = spec.n_coords
        device = gamma_t.device
        cuda = device.type == "cuda"
        if host:
            def to_host(x):
                x = x if x.device.type == "cpu" else x.cpu()
                return x.pin_memory() if cuda and not x.is_pinned() else x
            batch, mask = tree_map(to_host, batch), to_host(mask)
            if cstate is not None:
                cstate = {k: to_host(v) for k, v in cstate.items()}
        feed = iter_shards(
            batch, mask, cstate, shard=shard, total=total, pin=host and cuda,
            before_gather=(torch.cuda.current_stream(device).synchronize
                           if host and cuda else None),
            shards=shards, row_lo=row_lo)
        if host:
            feed = _prefetch(feed, device)
        flat_state = (None if cstate is None else
                      {k: v.reshape((-1, v.shape[-1]))
                       for k, v in cstate.items()})
        buf = new_buffer(shard, d, device)
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for s, batch_s, rows, mask_s in feed:
            lo = s * shard
            keys = znoise.client_keys(sub, lo, shard)
            enc, new_rows, ls = encode_clients(spec, params, batch_s, keys,
                                               rows, mask_s,
                                               live_among(live, lo, shard),
                                               buf, gamma_t, extra, lo,
                                               round_idx)
            with torch.no_grad():
                real = min(shard, total - lo)
                if flat_state is not None and real > 0:
                    # real rows only: the wrapped padding is never written
                    _write_rows({k: v[lo - row_lo:lo - row_lo + real]
                                 for k, v in flat_state.items()},
                                new_rows, real)
                if acc is None:
                    acc = compressor.fold_init(enc)
                if acc is None:
                    acc = compressor.zero_acc(enc, d)
                acc = compressor.aggregate(
                    enc, mask_s if fold_w is None
                    else fold_w[lo:lo + shard], d, acc=acc)
                loss_sum = loss_sum + ls
                if on_shard is not None:
                    on_shard(lo, enc)
            del enc, new_rows, rows, batch_s
        del buf
        if host and cuda:
            # the state rows' copies back to the host are complete
            torch.cuda.current_stream(device).synchronize()
        return acc, cstate, loss_sum

    def rank_part(plan: CohortPlan, cstate) -> dict:
        """This rank's shard slice and first state row under
        ``stream(devices=D)``, after checking that the group has D ranks
        and that ``cstate`` holds this rank's rows."""
        rank, world = wire.rank_world(group)
        if world != plan.devices:
            raise ValueError(
                f"stream(devices={plan.devices}) runs one rank per device, "
                f"but the torch.distributed group has {world} ranks (the "
                f"cohort of {total} clients in shards of {plan.shard} keeps "
                f"{plan.devices} busy): start {plan.devices} ranks")
        lo, hi = owned_rows(plan, total, rank)
        for k, v in (cstate or {}).items():
            if v.dim() != 2 or v.shape[0] != hi - lo:
                raise ValueError(
                    f"state slot {k!r} has shape {tuple(v.shape)}, but rank "
                    f"{rank} of stream(devices={plan.devices}) holds its "
                    f"{hi - lo} rows ({lo}..{hi - 1}) flat: build the state "
                    f"with init_server_state(..., ctx=ctx)")
        return {"shards": rank_shards(plan, total, rank), "row_lo": lo}

    def round_inputs(state: ServerState, mask) -> RoundInputs:
        params = state.params
        spec = wire.tree_spec(params)
        device = tree_leaves(params)[0].device
        rng, sub = znoise.split(state.rng)
        mask_all = torch.as_tensor(mask, dtype=torch.float32).reshape(G, N)
        if adversary is not None:
            # mid-round dropout fires on the full mask before anything
            # reads it, so n_live, the loss and the state masking agree
            mask_all = adversary.drop_mask(mask_all, state.round)
        if debug_wire:
            wire.check_mask_membership(mask_all)
        gamma_t = torch.tensor(gamma, dtype=torch.float32, device=device)
        # what the encodes of the round read besides their rows, passed
        # only where a stage takes it (as the reference gates them): the
        # dynamic sigma, the server-scope state and the round's TreeSpec
        extra = {}
        if ctx.dynamic_sigma:
            extra["sigma"] = state.sigma
        if state.comp_server is not None:
            extra["server"] = state.comp_server
        if compressor.needs_tree_spec:
            extra["spec"] = spec
        return RoundInputs(spec, params, device, rng, sub,
                           resolve_cohort(policy, total, spec.n_coords,
                                          group),
                           mask_all, gamma_t, extra)

    def round_step(state: ServerState, batch, mask):
        inp = round_inputs(state, mask)
        plan = inp.plan
        host = plan.mode == "stream" and plan.feed == "host"
        # the live clients, read once a round from the mask as the caller
        # gave it (the sampler's, on the host): a stateful stage updates
        # only their rows, and no group or shard waits on the card for them
        live = (inp.mask.reshape(-1) > 0).tolist()
        mask_all = inp.mask if host else inp.mask.to(inp.device)
        if plan.mode == "stream":
            part = {}
            if plan.devices > 1:
                part = rank_part(plan, state.comp_state)
            acc, cstate, loss_sum = stream_cohort(
                inp, batch, mask_all, live, state.comp_state, state.round,
                plan.shard, host, **part)
            with torch.no_grad():
                enc_sum = compressor.fold_finalize(acc)
                if plan.devices > 1:
                    # THE cross-rank step of the round: one O(d) reduce of
                    # the finalized accumulators, and the loss
                    enc_sum = compressor.reduce_across_devices(enc_sum,
                                                               group)
                    loss_sum = wire.reduce_accumulator(
                        loss_sum.reshape(1), group).reshape(())
        else:
            enc_sum, cstate, loss_sum = vmap_groups(
                inp, batch, mask_all, live, state.comp_state, state.round)
        with torch.no_grad():
            return _finish(state, inp.spec, inp.rng, enc_sum, loss_sum,
                           mask_all.to(inp.device), cstate, plan.shard)

    def _finish(state, spec, rng, enc_sum, loss_sum, mask_g, cstate,
                shard_used):
        n_live = torch.clamp_min(torch.sum(mask_g), 1.0)
        g_flat = compressor.decode_sum(
            enc_sum, n_live, sigma=state.sigma if ctx.dynamic_sigma else None,
            **({"spec": spec} if compressor.needs_tree_spec else {}))
        # the ONE unflatten: decoded flat estimate -> params-shaped tree
        g_hat = spec.unflatten(g_flat)
        # Algorithm 1 line 15: x_t = x_{t-1} - eta * gamma * mean(Delta)
        scaled = tree_map(lambda g: gamma * g, g_hat)
        new_params, new_opt = opt.update(scaled, state.opt_state,
                                         state.params)
        # server-scope state (the cv server variate) folds the decoded mean
        comp_server = compressor.update_server(state.comp_server, g_flat,
                                               n_live, float(total))
        metrics = RoundMetrics(
            loss=loss_sum / n_live,
            grad_est_norm=torch.linalg.vector_norm(g_flat[:spec.n_coords]),
            participation=n_live,
            uplink_bits=n_live * float(spec.n_coords
                                       * compressor.wire_bits_per_coord),
            shard_clients=torch.tensor(shard_used, dtype=torch.int32))
        new_state = ServerState(params=new_params, opt_state=new_opt,
                                comp_state=cstate, rng=rng,
                                round=state.round + 1, sigma=state.sigma,
                                comp_server=comp_server)
        return new_state, metrics

    mode = RoundModePolicy.parse(ctx.round_mode)
    if mode.mode == "async":
        # the async driver runs this builder's own stream pass, decode and
        # server step, so zero latency is the sync host-fed round
        from repro_torch.fed.async_server import build_async_round_step
        return build_async_round_step(
            policy=mode, latency_spec=ctx.latency, compressor=compressor,
            round_inputs=round_inputs, stream=stream_cohort, finish=_finish,
            total=total)
    return round_step



# ---------------------------------------------------------------------------
# the model-sharded client replica
# ---------------------------------------------------------------------------

def _axes_size(grid, axes) -> int:
    n = 1
    for a in axes:
        n *= grid.shape[a]
    return n


def build_sharded_round_step(loss_fn: Callable, compressor, cfg: FedConfig,
                             ctx: Optional[RoundContext], *, grid, plan,
                             specs, remat: bool = True):
    """-> round_step(state, batch, mask) -> (state, RoundMetrics) of the
    model-sharded client replica on a ``launch/mesh.ReplicaGrid`` (the
    counterpart of the reference's ``build_round_step`` with its launcher's
    ``spmd_axes`` and ``param_constraint``, ``launch/dryrun.py:84-100``).

    ``plan`` (``launch/sharding.make_plan``) says which axes run clients
    side by side (``client_axes``: one client per data row), which split a
    client's micro-batch (``micro_axes``) and sequence (``seq_axes``), and
    which share its replica (``replica_axes``); ``specs`` is the params'
    spec tree (``param_specs``). ``state.params`` holds this rank's shards
    (``models/api.shard_params``). Every rank is called with the same
    (G, N, E, micro, S) batch and (G, N) mask.

    A round: for each of the G sequential groups, this rank's data row
    runs its client's local SGD on the sharded replica (``loss_fn`` under
    ``launch/hints.sharding_hints``: FSDP gathers, sequence-parallel
    attention, remat); the per-leaf pseudo-gradient shards move to this
    rank's flat range in one exchange (``wire.RangeLayout.to_range``); the
    pipeline encodes the range (``Pipeline.encode_range``: the transform
    stages on the range's state rows, E1 with the range's first tile id,
    F1 on the fused EF route, C1 on the dense draw's range slice, the QSGD
    bits at the range's coordinates, top-k's share of the whole row's
    selection), its whole-vector statistics (the EF scale, sto-sign's
    sigma, the DP clip norm, the QSGD norm, top-k's threshold counts) summed
    from per-range partials over the replica's ranks in rank order
    (``hints.all_reduce_sum``). A ``RoundContext.adversary`` drops its
    clients from the (G, N) mask before anything reads it and attacks each
    range payload after its encode, by global client index and the range's
    first byte, the byte slice of the one-process attack. After the groups,
    the ranks that own the same range on the other data rows meet over the
    client axes in the one-process round's client order:

      * the bitpacked sign wire (the 0/1-mask sum, the scale-weighted EF
        wire, the robust laws' vote pair): the payload rows (and scales)
        all-gathered, 1 bit a coordinate a client, and R1 reduces the
        (G * N, n_bytes) stack in global client order. At the most
        clients side by side that a plan holds (32, the regular plan on
        2 x 16 x 16) that is 4 bytes a coordinate, what one walk of an
        f32 rank-order chain moves, and the chain walks twice;
      * the dense f32 wire (QSGD, dpgauss): the fold of
        ``wire.fold_rows_over_ranks`` in global client order;
      * top-k's COO pairs: all-gathered and scattered in global client
        order (``wire.scatter_sum_coo``).

    The range is decoded (and the cv server variate's range updated from
    it), moved back onto the shards (``from_range``) and the server
    optimizer steps each shard. So no rank holds a (d,) vector, a (G, N,
    d) state or the whole tree; each keeps its range of every state slot
    (``init_server_state(layout=)``), and a range's payload is the slice of
    the unsharded round's. The cohort policy is resolved as the reference's
    launcher does, with the plan's client axes as ``spmd_axes``: ``auto``
    and ``stream`` run this round, a forced ``stream(shard=K)`` raises
    ``ValueError``. On a plan without client axes (the big plan's
    sequential groups, one client a group) the policy resolves as the
    reference's does with no ``spmd_axes``, and a stream plan runs the
    reference's ``stream_cohort`` on this rank's range: the G * N clients
    in K-client shards (the last wrapped to the cohort's first rows under
    a zero mask), each shard's K clients' local SGD written into one (K,
    hi - lo) range buffer and encoded at once (E1 with n = K from the
    range's first tile, or F1 under EF), folded into ONE running range
    accumulator (R1 add mode, or fold mode into a ``wire.SignFoldAcc`` on
    the f32-weighted routes), their state rows written back for the real
    clients only; so a rank holds K payload rows, not G.
    ``stream(feed=host)`` keeps the batch in (pinned) host memory and
    copies each client's slice to the card as it runs, the same
    computation; ``stream(devices=D)`` pads the shard count to a multiple
    of D and finalizes each of the D contiguous slices' accumulators
    apart, adding them in slice order, the reference's shard_map and psum
    on the grid's own ranks (D at most the group's size, as
    ``resolve_cohort`` checks). ``RoundMetrics.shard_clients`` is K, as
    the reference sets it. Async rounds raise ``NotImplementedError``.
    ``remat`` rematerializes each layer (on by default, as in the
    reference; off only to show that it changes no bit)."""
    from repro_torch.core.compression import ENCODE_TILE
    from repro_torch.launch import hints
    from repro_torch.launch.sharding import spec_dims
    ctx = ctx or RoundContext()
    compressor = compressor.with_context(ctx)
    compressor.check_range_encode()
    if RoundModePolicy.parse(ctx.round_mode).mode != "sync":
        raise NotImplementedError("async rounds on a grid wait (ROADMAP)")
    G, N = cfg.client_groups, cfg.n_clients
    adversary = parse_adversary(ctx.adversary)
    if adversary is not None:
        adversary = adversary.bind(G * N)
    wire_layout = compressor.wire_format().layout
    if plan.client_axes:
        resolve_cohort(ctx.cohort, G * N, 0, spmd_axes=plan.client_axes)
    if _axes_size(grid, plan.client_axes) != N:
        raise ValueError(f"{N} clients side by side, but the client axes "
                         f"{plan.client_axes} hold "
                         f"{_axes_size(grid, plan.client_axes)} rows")
    opt = _server_optimizer(cfg)
    gamma = cfg.client_lr
    c = grid.index(plan.client_axes)
    client_group = grid.group(plan.client_axes)
    paths = [p for p, _ in tree_paths(specs)]
    leaf_specs = [spec_dims(s) for _, s in tree_paths(specs)]
    cache = {}

    def layout_for(params) -> wire.RangeLayout:
        if "layout" not in cache:
            shapes = []
            for (_, leaf), dims in zip(tree_paths(params), leaf_specs):
                shape = list(leaf.shape)
                for dim, axes in dims:
                    shape[dim] *= _axes_size(grid, axes)
                shapes.append(tuple(shape))
            offsets, off = [], 0
            for s in shapes:
                offsets.append(off)
                n = 1
                for x in s:
                    n *= x
                off += n
            spec = wire.TreeSpec(tuple(paths), tuple(shapes),
                                 tuple(offsets), off)
            cache["cohort"] = (VMAP_PLAN if plan.client_axes else
                               resolve_cohort(ctx.cohort, G * N, off))
            cache["layout"] = wire.RangeLayout(spec, leaf_specs, grid,
                                               plan.replica_axes)
        return cache["layout"]

    def client_update(params0, client_batch):
        """One client's local SGD on the shards -> (pseudo-gradient shards
        in TreeSpec order, the mean local loss)."""
        if cfg.local_steps == 1:
            p = tree_map(lambda w: w.detach().requires_grad_(True), params0)
            loss = loss_fn(p, tree_map(lambda x: x[0], client_batch))
            grads = torch.autograd.grad(loss, tree_leaves(p))
            return list(grads), loss.detach().to(torch.float32)
        p, losses = params0, []
        for e in range(cfg.local_steps):
            pg = tree_map(lambda w: w.detach().requires_grad_(True), p)
            loss = loss_fn(pg, tree_map(lambda x: x[e], client_batch))
            leaves = tree_leaves(pg)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = {}
                for path, w, g in zip(paths, leaves, grads):
                    tree_set(p, path, w.detach() - gamma * g.to(w.dtype))
            losses.append(loss.detach().to(torch.float32))
        with torch.no_grad():
            pseudo = [(a.to(torch.float32) - b.to(torch.float32)) / gamma
                      for a, b in zip(tree_leaves(params0), tree_leaves(p))]
        return pseudo, torch.stack(losses).mean()

    def check_state(state: ServerState, layout) -> None:
        lo, hi = layout.bounds
        for k, v in (state.comp_state or {}).items():
            if tuple(v.shape) != (G, 1, hi - lo):
                raise ValueError(
                    f"state slot {k!r} has shape {tuple(v.shape)}, but this "
                    f"rank holds its range {lo}..{hi} of its client's rows: "
                    f"({G}, 1, {hi - lo}); build the state with "
                    f"init_server_state(..., layout=step.layout(params))")
        for k, v in (state.comp_server or {}).items():
            if tuple(v.shape) != (hi - lo,):
                raise ValueError(
                    f"server slot {k!r} has shape {tuple(v.shape)}, not this "
                    f"rank's range ({hi - lo},)")

    def all_sum(group):
        """The partial-sum hook of ``Pipeline.encode_range``: a per-row
        partial over this range, summed over the replica's ranks."""
        if group is None:
            return lambda t, use: t
        return lambda t, use: hints.all_reduce_sum(t, group, use)

    def rank_prefix(layout):
        """The ``rank_prefix`` hook of ``Pipeline.encode_range``: the sum
        of a small tensor over the replica's ranks before this one."""
        if layout.group is None:
            return lambda t, use: torch.zeros_like(t)
        return lambda t, use: hints.all_gather_dim(
            t.reshape(1, -1), layout.group, 0, use)[:layout.me].sum(
                0).reshape(t.shape)

    def client_order(x):
        """(N * G, ...) rows gathered in client-rank order -> (G * N, ...)
        in global client order g * N + c."""
        rest = tuple(x.shape[1:])
        return x.reshape((N, G) + rest).transpose(0, 1).reshape(
            (G * N,) + rest)

    def gather_clients(enc):
        """The bitpacked payloads of every client of the range, in global
        client order: this rank's (G, n_bytes) rows (and (G,) scales)
        all-gathered over the client axes."""
        if not isinstance(enc, dict):
            return client_order(hints.all_gather_dim(enc, client_group, 0,
                                                     "wire_bytes"))
        return {k: client_order(hints.all_gather_dim(
                    v, client_group, 0,
                    "wire_bytes" if k == "packed" else "wire_scale"))
                for k, v in enc.items()}

    def gather_coo(payloads, device):
        """Top-k's kept (values, range-local indices) of every client of
        the range, in global client order: each rank's G rows (their
        lengths differ) padded to the longest and all-gathered over the
        client axes, then cut back to their lengths."""
        rows = [(p["values"][0], p["indices"][0]) for p in payloads]
        if client_group is None:
            return rows
        counts = client_order(hints.all_gather_dim(
            torch.tensor([v.shape[0] for v, _ in rows], dtype=torch.int64,
                         device=device), client_group, 0, "topk_counts"))
        # a trace on meta tensors (the dry run) has no counts to read: this
        # rank's widest row stands in for every client's
        counts = ([max(v.shape[0] for v, _ in rows)] * (G * N)
                  if counts.is_meta else counts.tolist())
        width = max(counts)
        vals = torch.zeros((G, width), dtype=torch.float32, device=device)
        idx = torch.zeros((G, width), dtype=torch.int32, device=device)
        for g, (v, i) in enumerate(rows):
            vals[g, :v.shape[0]], idx[g, :i.shape[0]] = v, i
        vals = client_order(hints.all_gather_dim(vals, client_group, 0,
                                                 "wire_values"))
        idx = client_order(hints.all_gather_dim(idx, client_group, 0,
                                                "wire_indices"))
        return [(vals[j, :n], idx[j, :n]) for j, n in enumerate(counts)]

    def client_sum(payloads, mask_all, L: int, device):
        """The aggregate of the range over every client of the round, from
        this rank's G payloads (one a group): the ranks that own this range
        on the other data rows meet over the client axes by one of the
        three routes of ``build_sharded_round_step``, each in the
        one-process round's client order."""
        if wire_layout == "sparse_coo":
            mask_flat = mask_all.reshape(-1).to(device)
            acc = compressor.zero_acc(payloads[0], L)
            for j, (v, i) in enumerate(gather_coo(payloads, device)):
                acc = compressor.aggregate(
                    {"values": v[None], "indices": i[None]},
                    mask_flat[j:j + 1], L, acc=acc)
            return acc
        enc = (torch.cat(payloads) if isinstance(payloads[0], torch.Tensor)
               else {k: torch.cat([p[k] for p in payloads])
                     for k in payloads[0]})
        del payloads[:]
        if client_group is None:
            return compressor.aggregate(enc, mask_all[:, c].to(device), L)
        if wire_layout != "dense":
            return compressor.aggregate(gather_clients(enc),
                                        mask_all.reshape(-1).to(device), L)
        t0 = time.perf_counter()
        out = wire.fold_rows_over_ranks(enc, mask_all[:, c].to(device),
                                        client_group)
        # one (L,) f32 running sum a lap, a lap a group
        hints.record("all_reduce", G * out.numel() * 4, t0, "client_sum")
        return out

    def encode_rows(rnd, buf, rows, keys, mask_k, live_rows, gidx):
        """One group's or shard's k = ``buf.shape[0]`` clients: the range
        rows already in ``buf``, encoded at once with the range's state
        ``rows`` ``{slot: (k, hi - lo)}`` (updated in place for the live
        ones), then the adversary's attack by global client index ``gidx``
        and the range's first byte -> the payload stack."""
        extra = dict(rnd["extra"])
        if rows is not None:
            extra.update(state=rows, live=mask_k, live_rows=live_rows)
        enc = compressor.encode_range(keys, buf, rnd["tile0"],
                                      sigma=rnd["sigma"], **extra)
        if adversary is not None:
            adversary.corrupt(enc, gidx, rnd["round"], b0=rnd["lo"] // 8)
        return enc

    def group_rounds(rnd, params, batch, mask_all, cstate):
        """The vmap plan: this rank's client of each of the G groups ->
        (its G payloads, the masked loss sum)."""
        layout, device = rnd["layout"], rnd["device"]
        lo, hi = layout.bounds
        buf = torch.empty((1, hi - lo), dtype=torch.float32, device=device)
        payloads = []
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for g in range(G):
            j = g * N + c
            pseudo, loss = client_update(
                params, tree_map(lambda x: x[g, c], batch))
            with torch.no_grad():
                layout.to_range(pseudo, out=buf[0])
                del pseudo
                w = mask_all[g, c].to(device)
                # this client's rows, updated in place; a dead client
                # keeps its own
                rows = (None if cstate is None else
                        {k: v[g] for k, v in cstate.items()})
                payloads.append(encode_rows(
                    rnd, buf, rows, rnd["keys"][j:j + 1], w.reshape(1),
                    [0] if mask_all[g, c] > 0 else [], torch.tensor([j])))
                if payloads[-1] is buf:
                    # the dense wire's payload is the buffer itself
                    buf = torch.empty_like(buf)
                loss_sum = loss_sum + torch.where(w > 0, loss * w, 0.0)
        return payloads, loss_sum

    def stream_rounds(rnd, cplan, params, batch, mask_all, cstate):
        """The stream plan on this rank's range (``stream_cohort`` of the
        reference): K-client shards through one (K, hi - lo) buffer, each
        folded into one running accumulator, finalized per device slice and
        the slices added in order -> (the range's client sum, the masked
        loss sum)."""
        layout, device = rnd["layout"], rnd["device"]
        lo, hi = layout.bounds
        L, total, K = hi - lo, G * N, cplan.shard
        n_shards = -(-total // K)
        per = n_shards
        if cplan.devices > 1:
            per = -(-n_shards // cplan.devices)
            n_shards = per * cplan.devices
        if cplan.feed == "host":
            batch = tree_map(lambda x: x.cpu().pin_memory()
                             if device.type == "cuda" else x.cpu(), batch)
        flat = (None if cstate is None else
                {k: v.reshape((total, v.shape[-1]))
                 for k, v in cstate.items()})
        mask_flat = mask_all.reshape(-1).cpu()
        buf = torch.empty((K, L), dtype=torch.float32, device=device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        acc, enc_sum = None, None
        for s in range(n_shards):
            s0 = s * K
            slots = range(s0, s0 + K)
            # a slot past the cohort wraps to its first rows, weight 0
            mask_k = torch.stack([mask_flat[j] if j < total
                                  else torch.zeros(()) for j in slots])
            losses = []
            for i, j in enumerate(slots):
                r = j % total
                pseudo, loss = client_update(params, tree_map(
                    lambda x: x[r // N, r % N].to(device, non_blocking=True),
                    batch))
                with torch.no_grad():
                    layout.to_range(pseudo, out=buf[i])
                del pseudo
                losses.append(loss)
            with torch.no_grad():
                real = max(0, min(K, total - s0))
                rows = None
                if flat is not None:
                    rows = ({k: v[s0:s0 + K] for k, v in flat.items()}
                            if real == K else
                            {k: v[torch.tensor(slots, device=v.device)
                                  % total] for k, v in flat.items()})
                mask_d = mask_k.to(device)
                live = [i for i, j in enumerate(slots)
                        if j < total and mask_flat[j] > 0]
                enc = encode_rows(rnd, buf, rows,
                                  znoise.client_keys(rnd["sub"], s0, K),
                                  mask_d, live, torch.arange(s0, s0 + K))
                if rows is not None and 0 < real < K:
                    # the real rows of a wrapped shard's copies; the
                    # padding's are never written back
                    for k, v in flat.items():
                        v[s0:s0 + real].copy_(rows[k][:real])
                if acc is None:
                    acc = compressor.fold_init(enc)
                if acc is None:
                    acc = compressor.zero_acc(enc, L)
                acc = compressor.aggregate(enc, mask_d, L, acc=acc)
                loss_sum = loss_sum + torch.sum(torch.where(
                    mask_d > 0, torch.stack(losses) * mask_d, 0.0))
                del enc, rows
                if (s + 1) % per == 0:
                    # a device slice's accumulator, finalized; the slices
                    # add in order (the reference's psum)
                    part = compressor.fold_finalize(acc)
                    enc_sum = part if enc_sum is None else enc_sum + part
                    acc = None
        return enc_sum, loss_sum

    def round_step(state: ServerState, batch, mask):
        params = state.params
        device = tree_leaves(params)[0].device
        layout = layout_for(params)
        cplan = cache["cohort"]
        check_state(state, layout)
        lo, hi = layout.bounds
        d = layout.spec.n_coords
        rng, sub = znoise.split(state.rng)
        mask_all = torch.as_tensor(mask, dtype=torch.float32).reshape(G, N)
        if adversary is not None:
            mask_all = adversary.drop_mask(mask_all, state.round)
        if ctx.debug_wire:
            wire.check_mask_membership(mask_all)
        sigma = state.sigma if ctx.dynamic_sigma else None
        rnd = {"layout": layout, "device": device, "lo": lo, "sub": sub,
               "keys": znoise.client_keys(sub, 0, G * N),
               # ranges start on an encode tile (``wire.flat_ranges``),
               # whatever the codec's own pad multiple
               "tile0": lo // ENCODE_TILE, "sigma": sigma,
               "round": state.round,
               # what the encodes read besides their rows
               "extra": {"n_coords": d, "all_sum": all_sum(layout.group),
                         "rank_prefix": rank_prefix(layout),
                         "server": state.comp_server, "spec": layout.spec}}
        with hints.sharding_hints(grid, plan.seq_axes, plan.micro_axes,
                                  replica_axes=plan.replica_axes,
                                  specs=specs, remat=remat):
            if cplan.mode == "stream":
                enc_sum, loss_sum = stream_rounds(rnd, cplan, params, batch,
                                                  mask_all, state.comp_state)
            else:
                payloads, loss_sum = group_rounds(rnd, params, batch,
                                                  mask_all, state.comp_state)
        with torch.no_grad():
            if cplan.mode != "stream":
                enc_sum = client_sum(payloads, mask_all, hi - lo, device)
                del payloads
            if client_group is not None:
                t0 = time.perf_counter()
                loss_sum = wire.reduce_accumulator(loss_sum.reshape(1),
                                                   client_group).reshape(())
                hints.record("all_reduce", 4, t0, "loss")
            n_live = torch.clamp_min(mask_all.sum(), 1.0).to(device)
            g_range = compressor.decode_sum(enc_sum, n_live, sigma=sigma,
                                            spec=layout.spec, lo=lo)
            real = max(0, min(hi, d) - lo)
            if state.comp_server is not None:
                # the server slots' range (the cv server variate) folds the
                # decoded range in place, as the one-process round's
                # _finish folds the decoded vector
                compressor.update_server(
                    {k: v[:real] for k, v in state.comp_server.items()},
                    g_range, n_live, float(G * N))
            sq = torch.sum(torch.square(g_range[:real])).reshape(1)
            if layout.group is not None:
                sq = hints.all_reduce_sum(sq, layout.group, "norm")
            upd = layout.from_range(g_range, [tuple(v.shape) for v in
                                              tree_leaves(params)])
            del g_range
            g_hat: dict = {}
            for path, u in zip(paths, upd):
                tree_set(g_hat, path, u)
            scaled = tree_map(lambda u: gamma * u, g_hat)
            new_params, new_opt = opt.update(scaled, state.opt_state, params)
            metrics = RoundMetrics(
                loss=loss_sum / n_live,
                grad_est_norm=torch.sqrt(sq[0]),
                participation=n_live,
                uplink_bits=n_live * float(d
                                           * compressor.wire_bits_per_coord),
                shard_clients=torch.tensor(cplan.shard, dtype=torch.int32))
            return ServerState(params=new_params, opt_state=new_opt,
                               comp_state=state.comp_state, rng=rng,
                               round=state.round + 1, sigma=state.sigma,
                               comp_server=state.comp_server), metrics

    round_step.layout = layout_for
    return round_step
