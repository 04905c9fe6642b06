"""Wire-level Byzantine fault injection for the round engine (port of
``repro.fed.adversary``).

An :class:`Adversary` is a deterministic corruption policy applied where a
real attacker acts:

  * the participation mask (``drop_mask``): mid-round dropout, scheduled
    clients go dark, so their votes, loss and state updates all vanish;
  * the encoded payload stack (``corrupt``): sign flips, random byte
    corruption, or a colluding cohort that sends one shared pattern.

Corruption hits the ENCODED wire, after the client encode and before
aggregation, so an EF client's residual stays what it meant to send.

Which clients are corrupt depends only on (global client index, round,
seed), never on the cohort plan; the byte randomness is counter-derived
(``fold_in(fold_in(key, round), client)``), so every plan sees the same
attack. Stream-padding slots (index >= total clients) are never selected.
The draws are the reference's bits: ``jax.random.bernoulli(k, p, (n,))`` is
``uniform(k) < p`` and ``jax.random.randint(k, (n,), 0, 256, uint8)`` is
the low byte of ``bits(split(k)[1])`` (``noise.random_bits``).

Spec grammar (``--adversary`` / ``RoundContext.adversary``)::

    none
    sign_flip(f=4)                      # clients 0..3 send -sign(x)
    byte_corrupt(f=2,p=0.1)             # 2 clients, each byte hit w.p. 0.1
    collude(f=4)                        # 4 clients send ONE shared pattern
    dropout(f=8)                        # 8 would-be participants go dark
    sign_flip(f=4,every=2,start=10)     # rounds 10, 12, 14, ...
    sign_flip(f=4,rotate=true,seed=7)   # membership rotates each round
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import noise as znoise

__all__ = ["Adversary", "parse_adversary", "ADVERSARY_KINDS"]

#: recognised attack kinds: "dropout" acts on the mask, the others on the
#: encoded payload stack
ADVERSARY_KINDS = ("sign_flip", "byte_corrupt", "collude", "dropout")


@dataclasses.dataclass(frozen=True)
class Adversary:
    """One deterministic fault-injection policy (see the module
    docstring). ``total`` is bound by the engine (:meth:`bind`)."""
    kind: str
    #: corrupt-cohort size (clients per active round)
    f: int = 1
    #: per-byte corruption probability (byte_corrupt only)
    p: float = 0.05
    #: the attack fires every this many rounds ...
    every: int = 1
    #: ... starting at this round
    start: int = 0
    #: slide the corrupt set by f slots per round (else clients 0..f-1)
    rotate: bool = False
    #: PRNG seed of the byte and collude randomness
    seed: int = 0
    #: total client slots: the rotation modulus and the pad-slot guard
    total: int = 0

    def __post_init__(self):
        if self.kind not in ADVERSARY_KINDS:
            raise ValueError(f"unknown adversary kind {self.kind!r}; "
                             f"expected one of {ADVERSARY_KINDS} or 'none'")
        if self.f < 1:
            raise ValueError(f"adversary needs f >= 1 corrupt clients, got "
                             f"f={self.f} (use 'none' for no attack)")
        if self.every < 1 or self.start < 0:
            raise ValueError(f"bad schedule: every={self.every} (>= 1), "
                             f"start={self.start} (>= 0)")
        if self.kind == "byte_corrupt" and not 0.0 < self.p <= 1.0:
            raise ValueError(f"byte_corrupt needs 0 < p <= 1, got {self.p}")

    def bind(self, total: int) -> "Adversary":
        """Bind the deployment's total client-slot count (called once by
        ``fedavg.build_round_step``)."""
        if total < 1:
            raise ValueError(f"total client slots must be >= 1, got {total}")
        if self.f >= max(total, 1) and self.kind != "dropout":
            raise ValueError(f"adversary f={self.f} corrupts every one of "
                             f"{total} client slots; robust aggregation "
                             f"requires f < n/2")
        return dataclasses.replace(self, total=total)

    def _selected(self, idx, round_idx: int) -> torch.Tensor:
        """Bool per slot: is this GLOBAL client index corrupt this round?
        ``idx`` is an integer tensor (or array) on the host."""
        if self.total < 1:
            raise ValueError("adversary is unbound — the engine must call "
                             "bind(total_clients) before tracing")
        idx = torch.as_tensor(idx).to(torch.int64)
        r = int(round_idx)
        active = r >= self.start and (r - self.start) % self.every == 0
        if self.rotate:
            sel = (idx - r * self.f) % self.total < self.f
        else:
            sel = idx < self.f
        return sel & (idx < self.total) & active

    def drop_mask(self, mask: torch.Tensor, round_idx: int) -> torch.Tensor:
        """Mid-round dropout: zero the scheduled slots of the engine's full
        (groups, n_clients) mask (slot (g, i) is client g * n_clients + i).
        Identity for the payload kinds."""
        if self.kind != "dropout":
            return mask
        idx = torch.arange(mask.numel()).reshape(mask.shape)
        sel = self._selected(idx, round_idx).to(mask.device)
        return torch.where(sel, torch.zeros_like(mask), mask)

    def corrupt(self, payload, idx, round_idx: int, b0: int = 0):
        """Attack one group's or shard's encoded payload stack IN PLACE
        (the engine's own, consumed by the aggregate) and return it.
        ``payload`` has a leading client axis matching ``idx`` (the clients'
        GLOBAL indices): a bitpacked (n, n_bytes) uint8 stack, a
        {"packed", "scale"} dict (its bytes attacked, the scale sent as
        it is), a COO {"values", "indices"} dict or a dense (n, d) f32
        stack. ``b0``: the first byte of the whole payload that the rows
        hold (a flat range's bytes on the model-sharded replica): the
        byte draws are those of bytes [b0, b0 + n_bytes), the slice of the
        whole payload's attack. Identity for the dropout kind."""
        if self.kind == "dropout":
            return payload
        rows = torch.nonzero(self._selected(idx, round_idx)).reshape(-1)
        idx = torch.as_tensor(idx).to(torch.int64)
        if isinstance(payload, dict):
            if "packed" in payload:
                self._corrupt_packed(payload["packed"], rows, idx, round_idx,
                                     b0)
                return payload
            if "values" in payload:
                if self.kind != "sign_flip":
                    raise ValueError(
                        f"adversary kind {self.kind!r} targets the bitpacked "
                        f"uint8 wire; the sparse COO payload only supports "
                        f"sign_flip (value negation)")
                for c in rows.tolist():
                    payload["values"][c].neg_()
                return payload
            raise ValueError(f"unrecognized payload dict keys "
                             f"{sorted(payload)} for adversary injection")
        if payload.dtype == torch.uint8:
            self._corrupt_packed(payload, rows, idx, round_idx, b0)
            return payload
        if self.kind != "sign_flip":
            raise ValueError(
                f"adversary kind {self.kind!r} targets the bitpacked uint8 "
                f"wire; dense f32 payloads only support sign_flip")
        for c in rows.tolist():
            payload[c].neg_()
        return payload

    def _corrupt_packed(self, packed: torch.Tensor, rows: torch.Tensor,
                        idx: torch.Tensor, round_idx: int,
                        b0: int = 0) -> None:
        rows = rows.tolist()
        if not rows:
            return
        if self.kind == "sign_flip":
            # every sign inverted: XOR the whole bitfield
            for c in rows:
                packed[c].bitwise_xor_(0xFF)
            return
        n_bytes, dev = packed.shape[-1], packed.device
        rkey = znoise.fold_in(znoise.prng_key(self.seed), int(round_idx))
        if self.kind == "collude":
            # every colluder sends the SAME pattern, drawn fresh each round
            patt = _randint_u8(rkey, b0, b0 + n_bytes, dev)
            for c in rows:
                packed[c].copy_(patt)
            return
        # byte_corrupt: per-client counter-derived randomness
        p = torch.tensor(self.p, dtype=torch.float32, device=dev)
        for c in rows:
            kb, kv = znoise.split(znoise.fold_in(rkey, int(idx[c])))
            for lo in range(0, n_bytes, znoise.BITS_CHUNK):
                hi = min(lo + znoise.BITS_CHUNK, n_bytes)
                hit = znoise.bits_to_uniform(
                    znoise.random_bits(kb, b0 + lo, b0 + hi, dev)) < p
                rnd = _randint_u8(kv, b0 + lo, b0 + hi, dev)
                seg = packed[c, lo:hi]
                seg.copy_(torch.where(hit, rnd, seg))


def _randint_u8(key: torch.Tensor, lo: int, hi: int,
                device) -> torch.Tensor:
    """Entries lo .. hi-1 of ``jax.random.randint(key, (n,), 0, 256,
    uint8)``: the low bytes of ``bits(split(key)[1])``, drawn in slices of
    ``noise.BITS_CHUNK``."""
    sub = znoise.split(key)[1]
    out = torch.empty((hi - lo,), dtype=torch.uint8, device=device)
    for a in range(lo, hi, znoise.BITS_CHUNK):
        b = min(a + znoise.BITS_CHUNK, hi)
        out[a - lo:b - lo] = znoise.random_bits(sub, a, b, device) & 0xFF
    return out


def parse_adversary(spec: str):
    """Adversary spec string -> :class:`Adversary`, or None for "none":
    ``kind`` or ``kind(k=v,...)`` with kinds sign_flip | byte_corrupt |
    collude | dropout and args f=, p=, every=, start=, rotate=, seed=."""
    s = spec.strip()
    if s in ("", "none"):
        return None
    if "(" not in s:
        return Adversary(kind=s)
    if not s.endswith(")"):
        raise ValueError(f"malformed adversary spec {spec!r}")
    kind, args = s[:-1].split("(", 1)
    kw = {}
    for part in filter(None, (p.strip() for p in args.split(","))):
        if "=" not in part:
            raise ValueError(f"adversary argument {part!r} in {spec!r} must "
                             f"be key=value")
        k, v = (x.strip() for x in part.split("=", 1))
        if k not in ("f", "p", "every", "start", "rotate", "seed"):
            raise ValueError(f"unknown adversary argument {k!r} in {spec!r}; "
                             f"expected f=, p=, every=, start=, rotate= or "
                             f"seed=")
        if k == "rotate":
            if v.lower() not in ("true", "false", "1", "0"):
                raise ValueError(f"rotate must be true/false, got {v!r}")
            kw[k] = v.lower() in ("true", "1")
        elif k == "p":
            kw[k] = float(v)
        else:
            try:
                kw[k] = int(v)
            except ValueError:
                raise ValueError(f"adversary argument {part!r} in {spec!r} "
                                 f"must be an integer") from None
    return Adversary(kind=kind.strip(), **kw)
