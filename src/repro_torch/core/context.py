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
#: sentinel of ``stream(devices=auto)``: every process-local device (one)
COHORT_DEVICES_AUTO = 0
#: per-device budget for one in-flight stream shard, and its clamp bounds
STREAM_SHARD_BUDGET_BYTES = 256 << 20
STREAM_SHARD_MIN = 8
STREAM_SHARD_MAX = 512


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
    loop is a Python loop). ``devices=auto`` is the one process-local
    device; ``devices > 1`` (a ``torch.distributed`` group) is not yet
    ported. ``feed=host`` keeps batch, mask and state rows in pinned host
    memory (single device only).
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
        if self.devices > 1:
            raise NotImplementedError(
                f"stream(devices={self.devices}) (a torch.distributed group "
                "of cards) is not yet ported (ROADMAP queue 1 item 14)")

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
class RoundContext:
    """Frozen per-deployment policy for one round step. ``None`` backends
    keep the pipeline stage's own setting. ``dynamic_sigma`` hands
    ``ServerState.sigma`` (the Plateau controller's sigma) to the
    pipeline's one sigma consumer at encode and at decode. ``debug_wire``
    (default from ``REPRO_DEBUG_WIRE`` = 1/true/yes) checks once a round
    that the host mask is exactly 0/1 (``wire.check_mask_membership``).
    ``adversary`` is a ``fed.adversary`` spec string, validated here."""
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

    def __post_init__(self):
        for kind, backend in (("agg", self.agg_backend),
                              ("encode", self.encode_backend)):
            if backend is not None:
                resolve_backend(kind, backend)
        CohortPolicy.parse(self.cohort)
        if self.adversary != "none":
            # imported here: the fed layer is not a load-time dependency
            from repro_torch.fed.adversary import parse_adversary
            parse_adversary(self.adversary)
