"""Async deadline rounds: straggler tolerance (port of
``repro.fed.async_server``).

``RoundContext(round_mode="async(deadline=T[,min_clients=M]
[,staleness=none|poly(a)|cutoff(s)])")`` replaces the sync round's barrier
with a deadline: the driver walks the cohort in shards, folds each on-time
payload into the round's wire accumulator, and closes the round at the
deadline. Client latency comes from a deterministic ``LatencyModel`` (the
``RoundContext.latency`` spec), one draw per (seed, round, client) in units
of one round's compute window. A round's cohort splits three ways:

  * on time (latency <= the effective deadline): the payload folds into
    this round at its mask weight, as in the sync round;
  * late (finite latency past the deadline): the client computes against
    this round's params; its payload row is copied to host memory and
    folds into round r + s (s = ceil(latency / deadline) - 1, at least 1)
    at weight ``RoundModePolicy.stale_weight(s)``. A zero stale weight
    drops the client instead: it does not compute;
  * dead (mask 0, adversary dropout, or a failure draw): the dead-client
    mask semantics, state rows kept as they are.

The shard pass is the sync ``stream_cohort`` of ``core.fedavg`` itself, run
with a fold-weight vector apart from the compute mask and a hook that queues
the late rows, so zero latency gives a round bit-identical to the sync
``stream(feed=host)`` round: params, client state and metrics.

The late-payload queue lives in the built step: drive one training run per
built step. ``fedavg.build_round_step`` dispatches here when the context's
round mode is async.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import RoundModePolicy
from repro_torch.core.tree import tree_leaves, tree_map

#: latency model kinds (the heads of RoundContext.latency specs)
LATENCY_KINDS = ("zero", "const", "linear", "lognormal", "pareto")


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Deterministic simulated client latency and failure draw; the time
    unit is one round's compute window.

      zero                          every client reports at once
      const(t=T)                    every client takes T
      linear(base=B,step=S)         client i takes B + S*i
      lognormal(median=M,sigma=S)   M * exp(S * N(0,1))
      pareto(xm=X,alpha=A)          X * (1 + Pareto(A))

    ``fail=P`` makes each client fail a round with probability P (latency
    +inf: a dead client). Every draw comes from one numpy ``RandomState``
    seeded by (seed, round), so the draws equal the reference's.
    """
    kind: str = "zero"
    t: float = 0.0
    base: float = 0.0
    step: float = 0.0
    median: float = 1.0
    sigma: float = 1.0
    xm: float = 1.0
    alpha: float = 1.5
    fail: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in LATENCY_KINDS:
            raise ValueError(f"unknown latency kind {self.kind!r}; expected "
                             f"one of {LATENCY_KINDS}")
        if not 0.0 <= self.fail < 1.0:
            raise ValueError(f"latency fail= must be in [0, 1), got "
                             f"{self.fail!r}")
        if self.kind == "pareto" and self.alpha <= 0.0:
            raise ValueError("pareto latency needs alpha > 0")

    def sample(self, round_idx: int, n: int) -> np.ndarray:
        """(n,) float64 latencies of this round; failed clients get +inf."""
        rs = np.random.RandomState(
            (self.seed * 1000003 + int(round_idx) * 7919 + 17) % (1 << 32))
        if self.kind == "zero":
            lat = np.zeros(n)
        elif self.kind == "const":
            lat = np.full(n, float(self.t))
        elif self.kind == "linear":
            lat = self.base + self.step * np.arange(n, dtype=np.float64)
        elif self.kind == "lognormal":
            lat = self.median * np.exp(self.sigma * rs.randn(n))
        else:  # pareto
            lat = self.xm * (1.0 + rs.pareto(self.alpha, n))
        if self.fail > 0.0:
            lat = np.where(rs.rand(n) < self.fail, np.inf, lat)
        return lat


def parse_latency(spec) -> LatencyModel:
    """``zero | const(t=T) | linear(base=B,step=S) |
    lognormal(median=M,sigma=S) | pareto(xm=X,alpha=A)``, each with optional
    ``fail=P`` / ``seed=N`` -> LatencyModel."""
    if isinstance(spec, LatencyModel):
        return spec
    s = spec.strip()
    if "(" not in s:
        return LatencyModel(kind=s)
    if not s.endswith(")"):
        raise ValueError(f"malformed latency spec {spec!r}")
    kind, args = s[:-1].split("(", 1)
    kw = {}
    for part in filter(None, (p.strip() for p in args.split(","))):
        if "=" not in part:
            raise ValueError(f"latency argument {part!r} in {spec!r} must "
                             f"be key=value")
        k, v = (t.strip() for t in part.split("=", 1))
        if k == "seed":
            kw[k] = int(v)
        elif k in ("t", "base", "step", "median", "sigma", "xm", "alpha",
                   "fail"):
            kw[k] = float(v)
        else:
            raise ValueError(f"unknown latency argument {k!r} in {spec!r}")
    return LatencyModel(kind=kind.strip(), **kw)


def staleness_rounds(lat: np.ndarray, deadline: float) -> np.ndarray:
    """Arrival lag of a payload with latency ``lat``: it arrives in round r
    + s, s = ceil(lat / deadline) - 1, at least 1; +inf stays +inf."""
    with np.errstate(invalid="ignore"):
        s = np.ceil(np.asarray(lat, np.float64) / float(deadline)) - 1.0
    return np.maximum(s, 1.0)


def partition_round(policy: RoundModePolicy, lat: np.ndarray,
                    live: np.ndarray):
    """Split one round's cohort by the deadline law -> ``(on_time, stale_s,
    stale_w, close_time)``: the on-time selector, each client's arrival lag
    (0 where it does not fold late), its stale fold weight (0 where
    dropped), and the simulated close time (the last on-time arrival, or
    the effective deadline when a client is late; ``min_clients`` may have
    extended it)."""
    lat = np.asarray(lat, np.float64)
    live = np.asarray(live, bool)
    finite = live & np.isfinite(lat)
    eff_t = float(policy.deadline)
    if policy.min_clients > 0 and np.any(finite):
        have = int(np.sum(finite & (lat <= eff_t)))
        if have < policy.min_clients:
            cand = np.sort(lat[finite])
            kth = cand[min(policy.min_clients, cand.size) - 1]
            eff_t = max(eff_t, float(kth))
    on_time = finite & (lat <= eff_t)
    late = finite & ~on_time
    s = np.zeros(lat.shape, np.int64)
    w = np.zeros(lat.shape, np.float64)
    if np.any(late):
        s_late = staleness_rounds(lat[late], policy.deadline).astype(np.int64)
        w_late = np.array([policy.stale_weight(int(si)) for si in s_late])
        s[late] = np.where(w_late > 0.0, s_late, 0)
        w[late] = w_late
    if np.any(late) or not np.any(on_time):
        close = eff_t
    else:
        close = float(np.max(lat[on_time]))
    return on_time, s, w, close


def simulate_close_times(policy: RoundModePolicy, model: LatencyModel,
                         rounds: int, total: int) -> np.ndarray:
    """(rounds, 2) simulated close times: column 0 the async close
    (``partition_round``), column 1 the sync barrier, the slowest finite
    latency (a failed client would never let a sync round close)."""
    out = np.empty((rounds, 2))
    live = np.ones(total, bool)
    for r in range(rounds):
        lat = model.sample(r, total)
        out[r, 0] = partition_round(policy, lat, live)[3]
        finite = np.isfinite(lat)
        out[r, 1] = float(np.max(lat[finite])) if np.any(finite) else 0.0
    return out


def _host_row(x: torch.Tensor) -> torch.Tensor:
    """A copy of one payload row in host memory (pinned, copied on the
    compute stream, when it lies on a card), so the queue never holds a
    view of a shard's payload stack."""
    if x.device.type != "cuda":
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def queue_bytes(pending: dict) -> int:
    """Host bytes held by a late-payload queue."""
    return sum(x.numel() * x.element_size()
               for rows in pending.values() for *_, row in rows
               for x in tree_leaves(row))


def build_async_round_step(*, policy: RoundModePolicy, latency_spec,
                           compressor, round_inputs, stream, finish,
                           total: int):
    """The async round driver. Called only from ``fedavg.build_round_step``,
    whose internals the arguments after ``latency_spec`` are:
    ``round_inputs(state, mask)`` the round's shared inputs (the mask after
    the adversary's dropout), ``stream`` its ``stream_cohort`` and
    ``finish`` its decode and server step. ->
    ``async_round_step(state, batch, mask) -> (state, metrics)``, with
    ``async_round_step.pending`` the late-payload queue (arrival round ->
    ``[(compute_round, client_id, fold_weight, payload_row), ...]``)."""
    latency = parse_latency(latency_spec)
    if policy.staleness == "poly" and getattr(compressor.codec,
                                              "weights_are_mask", False):
        raise ValueError(
            "staleness=poly(...) folds FRACTIONAL stale weights, which "
            "breaks the static weights_are_mask 0/1 contract (and the "
            "vote/popcount aggregation laws built on it). Use "
            "staleness=cutoff(s) with this pipeline, or drop "
            "weights_are_mask.")
    pending = {}

    def async_round_step(state, batch, mask):
        # the adversary's dropout has hit the mask before the partition
        inp = round_inputs(state, mask)
        device, d = inp.device, inp.spec.n_coords
        # the vmap plan is one shard of the whole cohort
        shard = inp.plan.shard if inp.plan.mode == "stream" else total
        host = inp.plan.mode == "stream" and inp.plan.feed == "host"
        r = int(state.round)
        shape = inp.mask.shape
        flat_mask = inp.mask.cpu().numpy().reshape(total)

        lat = latency.sample(r, total)
        on_time, stale_s, stale_w, _ = partition_round(
            policy, lat, flat_mask > 0.0)
        # the compute mask gates local SGD, the loss and the state rows
        # (late clients compute against this round's params); the fold
        # weights keep only the on-time payloads in this round's sum. Zero
        # latency makes the two equal, and the pass the sync one.
        computes = on_time | (stale_w > 0.0)
        compute_mask = (flat_mask * computes).astype(np.float32)
        fold_w = (flat_mask * on_time).astype(np.float32)
        late_ids = np.nonzero((stale_w > 0.0) & ~on_time
                              & (flat_mask > 0.0))[0]
        fold_pad = np.zeros(-(-total // shard) * shard, np.float32)
        fold_pad[:total] = fold_w

        def queue_late(lo, enc):
            # each late client's payload row to the host, before the next
            # shard's encode; every leaf of a structured (EF) payload
            for cid in late_ids[(late_ids >= lo) & (late_ids < lo + shard)]:
                row = tree_map(lambda x: _host_row(x[int(cid) - lo]), enc)
                pending.setdefault(r + int(stale_s[cid]), []).append(
                    (r, int(cid), float(flat_mask[cid] * stale_w[cid]),
                     row))

        compute_t = torch.from_numpy(compute_mask.reshape(shape))
        acc, cstate, loss_sum = stream(
            inp, batch, compute_t if host else compute_t.to(device),
            (compute_mask > 0).tolist(), state.comp_state, state.round,
            shard, host, fold_w=torch.from_numpy(fold_pad).to(device),
            on_shard=queue_late)

        # the payloads arriving this round, in (compute_round, client_id)
        # order, each a one-row stack at its stale weight
        stale_weight_sum = 0.0
        with torch.no_grad():
            for _, _, w, row in sorted(pending.pop(r, []),
                                       key=lambda e: (e[0], e[1])):
                one = tree_map(lambda x: x.to(device, non_blocking=True)[None],
                               row)
                acc = compressor.aggregate(
                    one, torch.tensor([w], dtype=torch.float32,
                                      device=device), d, acc=acc)
                stale_weight_sum += w
            enc_sum = compressor.fold_finalize(acc)
        # the round's effective participation: the on-time fold weights
        # plus the stale weights folded in, added onto slot 0 in f32 as the
        # reference does; the decode divides by its sum
        eff_w = fold_w.copy()
        eff_w[0] += np.float32(stale_weight_sum)
        eff_mask = torch.from_numpy(eff_w.reshape(shape)).to(device)
        with torch.no_grad():
            return finish(state, inp.spec, inp.rng, enc_sum, loss_sum,
                          eff_mask, cstate, inp.plan.shard)

    async_round_step.pending = pending
    return async_round_step
