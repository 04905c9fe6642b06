"""RoundContext: the typed policy a federated round runs under (port of
``repro.core.context``, the fields the training launcher sets).

``resolve_backend`` is the one place an ``auto`` backend becomes a concrete
one: the CUDA kernel for tensors on a card, the plain PyTorch path anywhere
else. Backend names of the port: ``auto``, ``torch`` (plain PyTorch ops on
the tensor's device) and ``cuda`` (the hand-written kernel; on a CPU tensor
its wrapper runs the kernel's plain version); the encode also has
``reference``, the dense-noise draw (``SignCodec._encode_dense``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: server sign-reduce backends
AGG_BACKENDS = ("auto", "torch", "cuda")
#: client encode backends
ENCODE_BACKENDS = ("auto", "torch", "cuda", "reference")
_VALID = {"agg": AGG_BACKENDS, "encode": ENCODE_BACKENDS}
#: reference backends with no port yet, and the ROADMAP item that ports them
_UNPORTED = {
    ("agg", "dense"): "the dense-matrix oracle (ROADMAP queue 1 item 2)",
}

#: cohort execution modes (see CohortPolicy)
COHORT_MODES = ("auto", "vmap", "stream")
#: streaming auto-gate, in client-coordinate elements (reference value)
STREAM_AUTO_MIN_ELEMS = 1 << 24
#: per-device budget for one in-flight stream shard, and its clamp bounds
STREAM_SHARD_BUDGET_BYTES = 256 << 20
STREAM_SHARD_MIN = 8
STREAM_SHARD_MAX = 512
STREAM_DEFAULT_SHARD = 64


def resolve_backend(kind: str, backend: str, device_type: str = "cpu") -> str:
    """``auto`` -> ``cuda`` when the tensors lie on a card, else ``torch``;
    any other name must be one of the kind's backends."""
    if (kind, backend) in _UNPORTED:
        raise NotImplementedError(
            f"{kind} backend {backend!r} is not yet ported: "
            f"{_UNPORTED[(kind, backend)]}")
    valid = _VALID[kind]
    if backend not in valid:
        raise ValueError(f"unknown {kind} backend {backend!r}; "
                         f"expected one of {valid}")
    if backend == "auto":
        return "cuda" if device_type == "cuda" else "torch"
    return backend


@dataclasses.dataclass(frozen=True)
class CohortPolicy:
    """Parsed ``RoundContext.cohort``. The port runs the vmap plan (all
    clients of the round in one batched encode and one reduce); ``auto``
    resolves to it below the streaming gate, and ``stream`` is refused."""
    mode: str = "auto"

    def __post_init__(self):
        if self.mode not in COHORT_MODES:
            raise ValueError(f"unknown cohort mode {self.mode!r}; expected "
                             f"one of {COHORT_MODES}")
        if self.mode == "stream":
            raise NotImplementedError(
                "the streaming cohort plan is not yet ported (ROADMAP "
                "queue 1 item 10)")

    @classmethod
    def parse(cls, spec: "str | CohortPolicy") -> "CohortPolicy":
        if isinstance(spec, cls):
            return spec
        s = spec.strip()
        if "(" in s:
            mode = s.split("(", 1)[0].strip()
            if mode == "stream":
                return cls(mode="stream")
            raise ValueError(f"cohort mode {mode!r} takes no arguments")
        return cls(mode=s)


@dataclasses.dataclass(frozen=True)
class RoundContext:
    """Frozen per-deployment policy for one round step. ``None`` backends
    keep the pipeline stage's own setting."""
    agg_backend: Optional[str] = None
    encode_backend: Optional[str] = None
    weights_are_mask: bool = False
    cohort: str = "auto"

    def __post_init__(self):
        for kind, backend in (("agg", self.agg_backend),
                              ("encode", self.encode_backend)):
            if backend is not None:
                resolve_backend(kind, backend)
        CohortPolicy.parse(self.cohort)
