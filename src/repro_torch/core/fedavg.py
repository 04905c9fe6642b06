"""z-SignFedAvg round engine, vmap plan (port of ``repro.core.fedavg``).

One round step:

    for each client c (a Python loop; the reference vmaps it):
        E local SGD steps from the server params -> pseudo-gradient
        (x0 - xE)/gamma in f32 (or the batch gradient when E == 1),
        written into row c of ONE preallocated (n, d_pad) f32 buffer
    -> ONE batched encode over the n rows and their pipeline state (on a
       card: kernel E1 for the counter-noise sign encode, C1 for the
       dense-noise one, F1 for the fused EF-SignSGD step; 1 bit/coord)
    -> ONE weighted sign-reduce over the (n, d_pad/8) uint8 stack (R1)
    -> decode_sum (/ n_live, * eta_z * sigma) -> unflatten once -> server
       optimizer step.

That is what the reference runs on a TPU for a cohort of 2 or more clients:
the batched encode kernel (K2, K5 or K4 under vmap) and then the sign-reduce
kernel (K3). Per-client PRNG keys are derived by GLOBAL client index exactly
like the reference (``rng, sub = split(state.rng)``; client j's key is
``fold_in(sub, j)``), so the port draws the reference's counter-stream bits.

Stateful pipelines (``ef``) keep ``ServerState.comp_state`` = ``{slot:
(1, n_clients, d)}``; a dead client keeps its rows bit-exactly. The fused EF
path updates those rows in place (see ``Pipeline.encode_batch``).

Ported plan: ``cohort`` auto/vmap with ``client_groups == 1``. A round that
resolves to the streaming plan, or ``client_groups > 1``, raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import noise as znoise
from repro_torch.core import wire
from repro_torch.core.context import (STREAM_AUTO_MIN_ELEMS,
                                      STREAM_DEFAULT_SHARD,
                                      STREAM_SHARD_BUDGET_BYTES,
                                      STREAM_SHARD_MAX, STREAM_SHARD_MIN,
                                      CohortPolicy, RoundContext)
from repro_torch.core.tree import (tree_leaves, tree_map, tree_paths,
                                   tree_set)
from repro_torch.optim.optimizers import Optimizer, make_optimizer


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 8            # parallel clients of one round
    client_groups: int = 1        # sequential groups (only 1 is ported)
    local_steps: int = 1          # E
    client_lr: float = 0.01       # gamma
    server_lr: float = 1.0        # eta (decode already applies eta_z * sigma)
    server_opt: str = "sgd"       # sgd | momentum | adam
    server_opt_kw: tuple = ()     # e.g. (("beta", 0.9),)


class ServerState(NamedTuple):
    params: Any
    opt_state: Any
    #: stacked per-client pipeline state {slot: (1, n_clients, ...)} or None
    comp_state: Any
    rng: torch.Tensor             # (2,) int64 key words
    round: int
    sigma: torch.Tensor           # f32 scalar, the codec's noise scale
    #: shared server-scope pipeline state (no ported stage declares one)
    comp_server: Any = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor
    grad_est_norm: torch.Tensor
    participation: torch.Tensor
    uplink_bits: torch.Tensor


def _server_optimizer(cfg: FedConfig) -> Optimizer:
    return make_optimizer(cfg.server_opt, lr=cfg.server_lr,
                          **dict(cfg.server_opt_kw))


def _check_supported(cfg: FedConfig) -> None:
    if cfg.client_groups != 1:
        raise NotImplementedError(
            "client_groups > 1 (the sequential group scan) is not yet "
            "ported (ROADMAP queue 1 item 6)")


def init_server_state(params, cfg: FedConfig, compressor, rng: torch.Tensor,
                      sigma0: float = 0.0) -> ServerState:
    _check_supported(cfg)
    device = tree_leaves(params)[0].device
    # one zero state row per client per slot: (groups, n_clients, ...)
    cstate = compressor.init_state(wire.tree_spec(params).n_coords,
                                   lead=(cfg.client_groups, cfg.n_clients),
                                   device=device)
    return ServerState(params=params,
                       opt_state=_server_optimizer(cfg).init(params),
                       comp_state=cstate, rng=rng, round=0,
                       sigma=torch.tensor(sigma0, dtype=torch.float32,
                                          device=device))


def auto_shard_size(n_coords: int) -> int:
    """The reference's streaming shard size from the memory budget."""
    if n_coords <= 0:
        return STREAM_DEFAULT_SHARD
    k = STREAM_SHARD_BUDGET_BYTES // (4 * n_coords + n_coords // 8)
    k = (k // wire.SIGN_REDUCE_CLIENT_BLK) * wire.SIGN_REDUCE_CLIENT_BLK
    return int(min(max(k, STREAM_SHARD_MIN), STREAM_SHARD_MAX))


def resolve_cohort(policy, total_clients: int, n_coords: int) -> str:
    """The reference's plan choice: ``auto`` keeps the vmap plan below the
    streaming gate, and also above it while one auto-sized shard covers the
    whole cohort. Anything else would stream, which is not yet ported."""
    pol = CohortPolicy.parse(policy)
    if pol.mode == "vmap" or total_clients * n_coords < STREAM_AUTO_MIN_ELEMS:
        return "vmap"
    if min(auto_shard_size(n_coords), total_clients) >= total_clients:
        return "vmap"
    raise NotImplementedError(
        f"{total_clients} clients x {n_coords} coords resolve to the "
        "streaming cohort plan, not yet ported (ROADMAP queue 1 item 10)")


def build_round_step(loss_fn: Callable, compressor, cfg: FedConfig,
                     ctx: Optional[RoundContext] = None):
    """-> round_step(state, batch, mask) -> (state, RoundMetrics).

    ``loss_fn(params, batch_slice)`` is a scalar loss; ``batch`` is a tree
    whose leaves have leading dims (client_groups, n_clients, E, ...);
    ``mask`` is the (client_groups, n_clients) 0/1 (or weight) mask."""
    ctx = ctx or RoundContext()
    _check_supported(cfg)
    compressor = compressor.with_context(ctx)
    opt = _server_optimizer(cfg)
    gamma = cfg.client_lr
    n = cfg.n_clients

    def client_update(spec, params0, client_batch, row, gamma_t):
        """One client: local SGD, then its pseudo-gradient written into
        ``row`` (its f32 row of the cohort buffer). -> mean local loss."""
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

    def round_step(state: ServerState, batch, mask):
        params = state.params
        spec = wire.tree_spec(params)
        device = tree_leaves(params)[0].device
        rng, sub = znoise.split(state.rng)
        resolve_cohort(ctx.cohort, n, spec.n_coords)
        keys = znoise.client_keys(sub, 0, n)
        mask_g = torch.as_tensor(mask, dtype=torch.float32,
                                 device=device).reshape(n)
        d = spec.n_coords
        mult = compressor.pad_multiple()
        d_pad = -(-d // mult) * mult
        # The cohort buffer: row c receives client c's pseudo-gradient IN
        # PLACE (the reference stacks the vmapped rows functionally); the
        # tile padding past d stays zero, as the reference's pad does.
        buf = torch.empty((n, d_pad), dtype=torch.float32, device=device)
        if d_pad > d:
            buf[:, d:].zero_()
        gamma_t = torch.tensor(gamma, dtype=torch.float32, device=device)
        losses = torch.stack([
            client_update(spec, params, tree_map(lambda x: x[0, c], batch),
                          buf[c], gamma_t)
            for c in range(n)])
        with torch.no_grad():
            # client group 0 of the stacked state: views of its rows
            cstate = (None if state.comp_state is None else
                      {k: v[0] for k, v in state.comp_state.items()})
            enc, cstate = compressor.encode_batch(keys, buf, d, cstate,
                                                  mask_g)
            del buf
            if cstate is not None:
                cstate = {k: v.unsqueeze(0) for k, v in cstate.items()}
            enc_sum = compressor.aggregate(enc, mask_g, d)
            loss_sum = torch.sum(torch.where(mask_g > 0, losses * mask_g,
                                             0.0))
            return _finish(state, spec, rng, enc_sum, loss_sum, mask_g,
                           cstate)

    def _finish(state, spec, rng, enc_sum, loss_sum, mask_g, cstate):
        n_live = torch.clamp_min(torch.sum(mask_g), 1.0)
        g_flat = compressor.decode_sum(enc_sum, n_live)
        # the ONE unflatten: decoded flat estimate -> params-shaped tree
        g_hat = spec.unflatten(g_flat)
        # Algorithm 1 line 15: x_t = x_{t-1} - eta * gamma * mean(Delta)
        scaled = tree_map(lambda g: gamma * g, g_hat)
        new_params, new_opt = opt.update(scaled, state.opt_state,
                                         state.params)
        metrics = RoundMetrics(
            loss=loss_sum / n_live,
            grad_est_norm=torch.linalg.vector_norm(g_flat[:spec.n_coords]),
            participation=n_live,
            uplink_bits=n_live * float(spec.n_coords
                                       * compressor.wire_bits_per_coord))
        new_state = ServerState(params=new_params, opt_state=new_opt,
                                comp_state=cstate, rng=rng,
                                round=state.round + 1, sigma=state.sigma,
                                comp_server=state.comp_server)
        return new_state, metrics

    return round_step

