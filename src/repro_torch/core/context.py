"""RoundContext: the typed policy a federated round runs under (port of
``repro.core.context``, the fields the training launcher sets).

``resolve_backend`` is the one place an ``auto`` backend becomes a concrete
one: the CUDA kernel for tensors on a card, the plain PyTorch path anywhere
else. Backend names of the port: ``auto``, ``torch`` (plain PyTorch ops on
the tensor's device) and ``cuda`` (the hand-written kernel; on a CPU tensor
its wrapper runs the kernel's plain version); the encode also has
``reference``, the dense-noise draw (``SignCodec._encode_dense``), and the
aggregate ``dense``, the dense sign-matrix oracle (``wire.unpack_sum_dense``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

#: server sign-reduce backends
AGG_BACKENDS = ("auto", "torch", "cuda", "dense")
#: client encode backends
ENCODE_BACKENDS = ("auto", "torch", "cuda", "reference")
_VALID = {"agg": AGG_BACKENDS, "encode": ENCODE_BACKENDS}
#: cohort execution modes (see CohortPolicy)
COHORT_MODES = ("auto", "vmap", "stream")
#: shard feeding of the streaming plan: "device" keeps the whole cohort's
#: batch, mask and state rows on the card; "host" keeps them in pinned host
#: memory and copies one shard ahead on a side stream
COHORT_FEEDS = ("device", "host")
#: streaming auto-gate, in client-coordinate elements (reference value)
STREAM_AUTO_MIN_ELEMS = 1 << 24
#: clients per shard when a stream policy pins none and n_coords == 0
STREAM_DEFAULT_SHARD = 64
#: sentinel of ``stream(shard=auto)``: the memory-budget shard size
STREAM_SHARD_AUTO = -1
#: sentinel of ``stream(devices=auto)``: every rank of the torch.distributed
#: group (one without a group)
COHORT_DEVICES_AUTO = 0
#: per-device budget for one in-flight stream shard, and its clamp bounds
STREAM_SHARD_BUDGET_BYTES = 256 << 20
STREAM_SHARD_MIN = 8
STREAM_SHARD_MAX = 512
#: round execution modes: the synchronous barrier or the async deadline
#: round (see RoundModePolicy)
ROUND_MODES = ("sync", "async")
#: buffered-staleness laws of async rounds: "none" drops late payloads,
#: "poly" weighs a payload arriving s rounds late by (1+s)^-a, "cutoff"
#: keeps full weight up to s_max rounds late, then drops
STALENESS_LAWS = ("none", "poly", "cutoff")


def split_top(args: str, what: Optional[str] = None) -> list:
    """Split a spec argument list on top-level commas only, so nested
    values such as ``staleness=poly(0.5)`` or ``agg=trimmed(f=2)`` stay
    whole; -> the stripped, non-empty parts. ``what`` is the text an
    unbalanced-parentheses error names (``args`` itself by default)."""
    what = args if what is None else what
    parts, cur, depth = [], [], 0
    for ch in args:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        depth += (ch == "(") - (ch == ")")
        if depth < 0:
            raise ValueError(f"unbalanced parentheses in {what!r}")
        cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced parentheses in {what!r}")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def resolve_backend(kind: str, backend: str, device_type: str = "cpu") -> str:
    """``auto`` -> ``cuda`` when the tensors lie on a card, else ``torch``;
    any other name must be one of the kind's backends."""
    valid = _VALID[kind]
    if backend not in valid:
        raise ValueError(f"unknown {kind} backend {backend!r}; "
                         f"expected one of {valid}")
    if backend == "auto":
        return "cuda" if device_type == "cuda" else "torch"
    return backend


@dataclasses.dataclass(frozen=True)
class CohortPolicy:
    """Parsed ``RoundContext.cohort``: how the round driver walks the
    cohort (the reference's grammar and validation errors).

      mode="vmap"    every client of a group in one batched encode and one
                     reduce (client groups run one after another).
      mode="stream"  the flat cohort in ``shard``-client slices, each
                     slice's payloads folded into ONE running wire
                     accumulator; memory O(shard * d), any cohort size.
      mode="auto"    stream iff total_clients * n_coords >=
                     STREAM_AUTO_MIN_ELEMS and one auto-sized shard does
                     not cover the cohort.

    ``shard=0`` leaves the size to ``fedavg.auto_shard_size`` (a bare
    ``stream`` still auto-gates); ``shard=K`` or ``shard=auto`` force
    streaming. ``unroll`` is parsed and recorded only: the reference hands
    it to ``lax.scan``, and eager PyTorch has no scan to unroll (the shard
    loop is a Python loop). ``devices=D`` splits the shard sequence into
    D contiguous slices, one for each rank of a ``torch.distributed`` group
    (``launch/mesh.py``), whose accumulators meet in one O(d) reduce;
    ``devices=auto`` takes the group's world size (1 without a group).
    ``feed=host`` keeps batch, mask and state rows in pinned host memory
    (single device only).
    """
    mode: str = "auto"
    shard: int = 0
    unroll: int = 1
    devices: int = 1
    feed: str = "device"

    def __post_init__(self):
        if self.mode not in COHORT_MODES:
            raise ValueError(f"unknown cohort mode {self.mode!r}; expected "
                             f"one of {COHORT_MODES}")
        if self.shard < STREAM_SHARD_AUTO or self.unroll < 1:
            raise ValueError(f"cohort policy needs shard >= 0 (or 'auto') "
                             f"and unroll >= 1, got shard={self.shard} "
                             f"unroll={self.unroll}")
        if self.devices < COHORT_DEVICES_AUTO:
            raise ValueError(f"cohort policy needs devices >= 1 (or 'auto'),"
                             f" got devices={self.devices}")
        if self.feed not in COHORT_FEEDS:
            raise ValueError(f"unknown cohort feed {self.feed!r}; expected "
                             f"one of {COHORT_FEEDS}")
        if self.mode != "stream":
            for name, val, default in (("shard", self.shard, 0),
                                       ("devices", self.devices, 1),
                                       ("feed", self.feed, "device")):
                if val != default:
                    raise ValueError(f"{name}={val!r} only applies to cohort "
                                     f"mode 'stream', not {self.mode!r}")
        if self.feed == "host" and self.devices != 1:
            raise ValueError("feed='host' is a single-device driver; it "
                             "cannot be combined with devices="
                             f"{self.devices!r}")

    @classmethod
    def parse(cls, spec: "str | CohortPolicy") -> "CohortPolicy":
        """``auto | vmap | stream |
        stream(shard=K|auto[,unroll=U][,devices=D|auto][,feed=device|host])``
        -> policy."""
        if isinstance(spec, cls):
            return spec
        s = spec.strip()
        if "(" not in s:
            return cls(mode=s)
        if not s.endswith(")"):
            raise ValueError(f"malformed cohort spec {spec!r}")
        mode, args = s[:-1].split("(", 1)
        kw = {}
        for part in filter(None, (p.strip() for p in args.split(","))):
            if "=" not in part:
                raise ValueError(f"cohort argument {part!r} in {spec!r} "
                                 f"must be key=value")
            k, v = part.split("=", 1)
            k, v = k.strip(), v.strip()
            if k not in ("shard", "unroll", "devices", "feed"):
                raise ValueError(f"unknown cohort argument {k!r} in "
                                 f"{spec!r}; expected shard=, unroll=, "
                                 f"devices= or feed=")
            if k == "feed":
                kw[k] = v
            elif k == "shard" and v == "auto":
                kw[k] = STREAM_SHARD_AUTO
            elif k == "devices" and v == "auto":
                kw[k] = COHORT_DEVICES_AUTO
            else:
                try:
                    iv = int(v)
                except ValueError:
                    raise ValueError(
                        f"cohort argument {part!r} in {spec!r} must be an "
                        f"integer" + (" or 'auto'"
                                      if k in ("shard", "devices") else "")
                    ) from None
                if iv < 0:
                    raise ValueError(f"cohort argument {part!r} in {spec!r} "
                                     f"must be non-negative")
                kw[k] = iv
        return cls(mode=mode.strip(), **kw)


@dataclasses.dataclass(frozen=True)
class RoundModePolicy:
    """Parsed ``RoundContext.round_mode``: when a round closes (the
    reference's grammar and errors).

      mode="sync"    the barrier: the round folds every live client's
                     payload.
      mode="async"   the deadline round (``fed/async_server.py``): payloads
                     fold as they arrive and the round closes at
                     ``deadline`` simulated time units; a late payload
                     folds s rounds later at weight ``stale_weight(s)``,
                     a client that never reports is dead.

    ``min_clients`` extends the close past the deadline until that many
    live payloads have arrived (0: never). ``staleness``: ``none`` drops a
    late payload, ``poly(a)`` folds it at (1 + s)^-a, ``cutoff(s)`` at full
    weight while s <= s_max and drops it beyond.

    Zero latency and a deadline covering every client make the async round
    bit-identical to the sync ``stream(feed=host)`` round.
    """
    mode: str = "sync"
    deadline: float = 0.0
    min_clients: int = 0
    staleness: str = "none"
    staleness_arg: float = 0.0

    def __post_init__(self):
        if self.mode not in ROUND_MODES:
            raise ValueError(f"unknown round mode {self.mode!r}; expected "
                             f"one of {ROUND_MODES}")
        if self.staleness not in STALENESS_LAWS:
            raise ValueError(f"unknown staleness law {self.staleness!r}; "
                             f"expected one of {STALENESS_LAWS}")
        if self.mode == "sync":
            if (self.deadline, self.min_clients, self.staleness) != \
                    (0.0, 0, "none"):
                raise ValueError("deadline=/min_clients=/staleness= only "
                                 "apply to round mode 'async'")
        else:
            if not self.deadline > 0.0:
                raise ValueError("async round mode needs deadline > 0, got "
                                 f"deadline={self.deadline!r}")
        if self.min_clients < 0 or self.staleness_arg < 0.0:
            raise ValueError("min_clients and the staleness argument must "
                             "be non-negative")

    def stale_weight(self, s: int) -> float:
        """Fold weight of a payload arriving ``s`` rounds after it was
        computed (s == 0 is on time)."""
        if s <= 0:
            return 1.0
        if self.staleness == "poly":
            return float((1.0 + s) ** (-self.staleness_arg))
        if self.staleness == "cutoff":
            return 1.0 if s <= self.staleness_arg else 0.0
        return 0.0

    @classmethod
    def parse(cls, spec: "str | RoundModePolicy") -> "RoundModePolicy":
        """``sync | async(deadline=T[,min_clients=M]
        [,staleness=none|poly(a)|cutoff(s)])`` -> policy."""
        if isinstance(spec, cls):
            return spec
        s = spec.strip()
        if "(" not in s:
            return cls(mode=s)
        if not s.endswith(")"):
            raise ValueError(f"malformed round_mode spec {spec!r}")
        mode, args = s[:-1].split("(", 1)
        kw = {}
        for part in split_top(args):
            if "=" not in part:
                raise ValueError(f"round_mode argument {part!r} in {spec!r} "
                                 f"must be key=value")
            k, v = (t.strip() for t in part.split("=", 1))
            if k == "deadline":
                kw["deadline"] = float(v)
            elif k == "min_clients":
                kw["min_clients"] = int(v)
            elif k == "staleness":
                if "(" in v:
                    if not v.endswith(")"):
                        raise ValueError(f"malformed staleness law {v!r} in "
                                         f"{spec!r}")
                    law, arg = v[:-1].split("(", 1)
                    kw["staleness"] = law.strip()
                    kw["staleness_arg"] = float(arg)
                else:
                    kw["staleness"] = v
            else:
                raise ValueError(f"unknown round_mode argument {k!r} in "
                                 f"{spec!r}; expected deadline=, "
                                 f"min_clients= or staleness=")
        return cls(mode=mode.strip(), **kw)


@dataclasses.dataclass(frozen=True)
class RoundContext:
    """Frozen per-deployment policy for one round step. ``None`` backends
    keep the pipeline stage's own setting. ``dynamic_sigma`` hands
    ``ServerState.sigma`` (the Plateau controller's sigma) to the
    pipeline's one sigma consumer at encode and at decode. ``debug_wire``
    (default from ``REPRO_DEBUG_WIRE`` = 1/true/yes) checks once a round
    that the host mask is exactly 0/1 (``wire.check_mask_membership``). ``adversary`` is a ``fed.adversary``
    spec string, ``round_mode`` a ``RoundModePolicy`` spec and ``latency``
    a ``fed.async_server`` latency spec (async rounds only), each
    validated here."""
    agg_backend: Optional[str] = None
    encode_backend: Optional[str] = None
    weights_are_mask: bool = False
    dynamic_sigma: bool = False
    cohort: str = "auto"
    debug_wire: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "REPRO_DEBUG_WIRE", "").lower() in ("1", "true", "yes"))
    #: "none" | "sign_flip(f=4)" | "byte_corrupt(f=2,p=0.1)" |
    #: "collude(f=4)" | "dropout(f=8)" (+ every=/start=/rotate=/seed=)
    adversary: str = "none"
    #: "sync" | "async(deadline=T[,min_clients=M][,staleness=none|poly(a)|
    #: cutoff(s)])": async rounds are driven by fed/async_server.py
    round_mode: str = "sync"
    #: simulated client latency of async rounds: "zero" | "const(t=T)" |
    #: "linear(base=B,step=S)" | "lognormal(median=M,sigma=S)" |
    #: "pareto(xm=X,alpha=A)" (+ fail=P, seed=N)
    latency: str = "zero"

    def __post_init__(self):
        for kind, backend in (("agg", self.agg_backend),
                              ("encode", self.encode_backend)):
            if backend is not None:
                resolve_backend(kind, backend)
        CohortPolicy.parse(self.cohort)
        mode = RoundModePolicy.parse(self.round_mode)
        if self.latency != "zero":
            if mode.mode != "async":
                raise ValueError("latency= is a simulation knob of async "
                                 "rounds; set round_mode='async(...)' or "
                                 "leave latency='zero'")
            # imported here: the fed layer is not a load-time dependency
            from repro_torch.fed.async_server import parse_latency
            parse_latency(self.latency)
        if self.adversary != "none":
            from repro_torch.fed.adversary import parse_adversary
            parse_adversary(self.adversary)
