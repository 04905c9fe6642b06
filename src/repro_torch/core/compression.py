"""Compression pipelines over the flat wire buffer (port of
``repro.core.compression``).

The codecs: the ``SignCodec`` (``zsign`` / ``zsign_packed`` / ``stosign``:
sigma_mode fixed or norm, any z, scale none or mean_abs, the counter-noise
and the dense-noise encodes, and the server laws agg=mean and the robust
agg=vote|trimmed|median over the integer vote pair), the ``QSGDCodec``
(``qsgd``, the unbiased stochastic quantizer on a dense f32 wire), the
``TopKCodec`` (``topk``, global top-k on a sparse COO wire, agg=mean or
coord) and the uncompressed ``DenseCodec``; every transform stage (``ef``
error feedback, ``dp`` clip + Gaussian noise, ``cv`` control variates,
``sigma_sched`` per-layer sigma schedule); a ``Pipeline`` with its client
and server state slots, the engine's dynamic (Plateau) sigma, the round's
TreeSpec and the fused EF kernel path; the spec parser and the legacy
factories.

The round engine hands the pipeline a STACK of client buffers at once —
``encode_batch(keys, flat2d, n_coords, state, live)`` is the reference's
vmap of ``encode`` over clients, written out as a batch dimension: one
encode launch over all rows (kernel E1, C1 or F1 on a card) instead of n.
``aggregate`` is one sign-reduce over the (n, n_bytes) payload stack
(kernel R1 on a card; on the vote routes R1 gives the pair's signed
count). The plain work around the kernels (per-client norms, the clip, the
sigma_sched multiply, the cv rows, the QSGD levels, the top-k selection)
runs one row at a time or in place, so no (n, d) temporary exists beside
the cohort buffer.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dp as dplib
from repro_torch.core import noise as znoise
from repro_torch.core import wire
from repro_torch.core.context import (AGG_BACKENDS, ENCODE_BACKENDS,
                                      RoundContext, resolve_backend,
                                      split_top)
from repro_torch.core.tree import tree_leaves
from repro_torch.core.wire import WireFormat, pack_signs, unpack_signs
from repro_torch.fed import client_state as cstate_lib
from repro_torch.fed.client_state import StateSlot
from repro_torch.kernels.efsign import ops as EK
from repro_torch.kernels.zsign import ops as K

__all__ = [
    "Pipeline", "SignCodec", "QSGDCodec", "TopKCodec", "DenseCodec",
    "ErrorFeedback", "DPTransform", "ControlVariate", "SigmaSchedule",
    "RoundContext", "StateSlot", "Compressor", "ZSignCompressor",
    "PackedZSignCompressor", "StoSignCompressor", "EFSignCompressor",
    "QSGDCompressor", "TopKCompressor", "DPGaussianCompressor",
    "available", "global_norm", "pack_signs", "unpack_signs", "sign_reduce",
    "vote_pair", "parse_spec", "AGG_BACKENDS", "ENCODE_BACKENDS",
]

#: encode tile, in elements (the kernels' tile; payloads are padded to
#: ceil(d/8192)*1024 bytes)
ENCODE_TILE = K.TILE

def sign_reduce(packed: torch.Tensor, weights: torch.Tensor,
                backend: str = "auto", *, weights_are_mask: bool = False,
                acc=None):
    """Weighted sign-reduce over stacked bitpacked payloads: (n, n_bytes)
    u8 + (n,) f32 -> (8*n_bytes,) f32. ``backend``: ``auto`` (the CUDA
    kernel R1 for tensors on a card, the plain path elsewhere), ``cuda`` (the
    kernel's wrapper), ``torch`` (``wire.unpack_sum``, or its popcount
    form ``wire.unpack_sum_mask`` under the static 0/1 ``weights_are_mask``
    guarantee) or ``dense`` (the sign-matrix oracle). The kernel route adds
    a flat ``acc`` after the blocked sum, as the reference's Pallas route
    does. A ``wire.SignFoldAcc`` ``acc`` takes the partition-invariant fold
    and returns the updated carry: R1 in fold mode on a card, the LUT fold
    (``wire.unpack_sum``) elsewhere."""
    backend = resolve_backend("agg", backend, packed.device.type)
    if isinstance(acc, wire.SignFoldAcc):
        if backend == "cuda":
            return K.sign_fold_step(packed, weights, acc)
        return wire.unpack_sum(packed, weights, acc)
    if backend == "cuda":
        return K.sign_reduce(packed, weights, acc)
    if backend == "dense":
        return wire.unpack_sum_dense(packed, weights, acc)
    if weights_are_mask:
        return wire.unpack_sum_mask(packed, weights, acc)
    return wire.unpack_sum(packed, weights, acc)


def vote_pair(packed: torch.Tensor, mask: torch.Tensor,
              backend: str = "auto", acc: Optional[torch.Tensor] = None):
    """The robust laws' (2, 8*n_bytes) int32 vote pair (signed count,
    n_live) of stacked payloads under a 0/1 ``mask``, plus the carried pair
    ``acc``. On the kernel route (``cuda``; ``auto`` on a card) the signed
    count is R1's weighted sign sum under the mask: an integer below 2^24,
    exact in f32 in any order, so its int32 cast is ``2*count - n_live``
    bit for bit. Elsewhere it is the popcount route,
    ``wire.vote_accumulator``."""
    if resolve_backend("agg", backend, packed.device.type) != "cuda":
        return wire.vote_accumulator(packed, mask, acc)
    s = K.sign_reduce(packed, mask).to(torch.int32)
    n_live = mask.to(device=s.device, dtype=torch.float32).sum().to(
        torch.int32)
    pair = torch.stack([s, n_live.expand_as(s)])
    return pair if acc is None else acc + pair


def sign_fold_finalize(acc: wire.SignFoldAcc,
                       backend: str = "auto") -> torch.Tensor:
    """Close a fold carry (``backend`` as in ``sign_reduce``): R1 in fold
    mode on the kernel route, the LUT fold elsewhere."""
    if resolve_backend("agg", backend, acc.sums.device.type) == "cuda":
        return K.sign_fold_finalize(acc)
    return wire.sign_fold_finalize(acc)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of a whole tree, leaf sums of squares added in leaf
    order (the reference's expression)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _norm_z(z) -> int:
    """Spec-level z values: "inf" (or any z <= 0 / float inf) -> Z_INF."""
    if isinstance(z, str):
        if z.lower() == "inf":
            return znoise.Z_INF
        raise ValueError(f"z must be an int or 'inf', got {z!r}")
    if isinstance(z, float):
        if math.isinf(z):
            return znoise.Z_INF
        if z != int(z):
            raise ValueError(f"z must be an integer or 'inf', got {z!r}")
        z = int(z)
    return znoise.Z_INF if z <= znoise.Z_INF else z


def _decode_row(packed: torch.Tensor, d: int, f) -> torch.Tensor:
    """One client's local decode from its packed bytes: (nb,) uint8 ->
    (d,) f32, f32(f) where the bit is set and -f32(f) elsewhere, which is
    f * (+/-1) exactly, with no int8 or unscaled f32 row in between. ``f``
    is a Python float (kept off the card: no copy, no wait) or an f32
    scalar tensor on the row's device."""
    return torch.where(wire.unpack_bits(packed)[:d], f, -f)


def _mean_abs_rows(p2d: torch.Tensor, d: int,
                   e2d: Optional[torch.Tensor] = None,
                   all_sum: Optional[Callable] = None,
                   n_total: Optional[int] = None) -> torch.Tensor:
    """(n,) f32: mean(|p[c, :d] (+ e[c])|) over the TRUE d coordinates of
    each row, one client at a time (no (n, d) temporary).

    With ``all_sum`` the rows are flat ranges holding d of the ``n_total``
    true coordinates of longer vectors (the model-sharded replica): each
    row's sum of |p| over its range is the partial, ``all_sum(partials,
    use)`` adds every range's in rank order, and the mean divides by
    ``n_total``."""
    out = []
    for c in range(p2d.shape[0]):
        row = p2d[c, :d] if e2d is None else p2d[c, :d] + e2d[c]
        out.append(torch.mean(torch.abs(row)) if all_sum is None
                   else torch.sum(torch.abs(row)))
    if all_sum is None:
        return torch.stack(out)
    return all_sum(torch.stack(out), "abs_sum") / float(n_total)


def _live_rows(n: int, live: Optional[torch.Tensor]):
    """Indices of the rows whose participation weight is > 0 (all rows
    without a mask): the rows a stateful stage updates. Reading a mask on
    the card waits for it; the engine passes the rows from its host mask
    instead (``encode_batch(live_rows=)``)."""
    if live is None:
        return range(n)
    return [c for c, w in enumerate(live.tolist()) if w > 0]


# ---------------------------------------------------------------------------
# transform stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Per-client error-feedback residual (slot ``"ef"``).

    Pre-codec: the buffer becomes ``p = flat + e``. Post-codec: the new
    residual is ``codec_input - local_decode(payload)`` — exactly what the
    server will NOT see of this client's update. Dead clients keep their
    residual bit-exactly. With the sign codec the spec parser defaults the
    codec to ``scale="mean_abs"``, so ``ef|zsign`` IS EF-SignSGD.
    """
    spec_name = "ef"
    stateful = True

    def state_spec(self, n_coords: int):
        return (StateSlot("ef", (n_coords,), torch.float32, "client"),)

    def pre_encode(self, p2d: torch.Tensor, state, server=None) -> torch.Tensor:
        """p + e on the (n, d_pad) rows, added IN PLACE over the consumed
        buffer (the residual is (n, d); the tile padding stays zero)."""
        del server
        e = state["ef"]
        p2d[:, :e.shape[-1]].add_(e)
        return p2d

    def post_encode(self, state, codec_input: torch.Tensor, local, rows):
        """The live ``rows``' residuals, written IN PLACE over the state
        rows, one row at a time; the other rows keep theirs."""
        e = state["ef"]
        d = e.shape[-1]
        for c in rows:
            torch.sub(codec_input[c, :d], local(c), out=e[c])
        return {"ef": e}


@dataclasses.dataclass(frozen=True)
class ControlVariate:
    """Compressed SCAFFOLD control variates (SCALLION-style; slots ``"cv"``
    per client and ``"cv_server"`` shared):

      pre-codec    q_i = p_i - eta * (c_i - c)          (drift correction)
      client       c_i <- c_i + beta * m_i,   m_i = local_decode(payload_i)
      server       c   <- c + beta * (n_live / N) * g_dec     (round tail)

    Nothing extra goes on the wire. For a decode linear in the per-client
    local decodes (g_dec = mean of the m_i) the server law is SCAFFOLD's
    bookkeeping c_{t+1} - c_t = (1/N) * sum_i (c_i' - c_i) exactly, which is
    why the pipeline refuses count-law decodes under ``cv`` (the robust sign
    ``agg=`` modes and top-k's ``agg=coord``). The corrections and the row
    updates run one client row at a time, IN PLACE over the buffer and the
    state rows; the server variate is updated in place too.
    """
    eta: float = 1.0
    beta: float = 1.0
    spec_name = "cv"
    stateful = True
    randomized = False
    #: the server-variate law is exact only for codecs whose decode_sum is
    #: linear in the per-client local decodes (checked at build time)
    needs_linear_decode = True

    def state_spec(self, n_coords: int):
        return (StateSlot("cv", (n_coords,), torch.float32, "client"),
                StateSlot("cv_server", (n_coords,), torch.float32, "server"))

    def pre_encode(self, p2d: torch.Tensor, state, server) -> torch.Tensor:
        """q = p - eta * (c_i - c) on each row's first d entries, in the
        reference's f32 order (a unit eta multiplies exactly, so it is
        skipped)."""
        cv, c_srv = state["cv"], server["cv_server"]
        d = cv.shape[-1]
        for c in range(p2d.shape[0]):
            t = cv[c] - c_srv
            if self.eta != 1.0:
                t.mul_(self.eta)
            p2d[c, :d].sub_(t)
        return p2d

    def post_encode(self, state, codec_input, local, rows):
        del codec_input
        cv = state["cv"]
        for c in rows:
            m = local(c)
            cv[c].add_(m if self.beta == 1.0 else m * self.beta)
        return {"cv": cv}

    def update_server(self, server, g_dec, n_live, n_total):
        """Round-tail server variate update from the decoded aggregate
        ``g_dec`` (possibly padded past d), ``n_live`` the live weight sum
        (an f32 scalar tensor) and ``n_total`` the cohort size N; IN PLACE,
        with the reference's f32 order."""
        c = server["cv_server"]
        coef = self.beta * n_live / n_total
        c.add_(coef * g_dec[:c.shape[0]])
        return {"cv_server": c}


@dataclasses.dataclass(frozen=True)
class DPTransform:
    """DP clip + Gaussian noise (paper Algorithm 2, the client mechanism).

    ``clip`` > 0 clips each client's buffer to that L2 norm; ``noise`` is the
    Gaussian std added afterwards. Instead of ``noise`` a target ``eps``
    (with ``delta``/``steps``/``q``) may be given: the noise multiplier is
    then calibrated by the RDP accountant (``core/dp.py``) and multiplied by
    the clip norm, so ``dp(clip=1.0,eps=2.0,steps=200,q=0.3)`` is a
    complete client-side DP spec.

    Over a :class:`SignCodec` the ``Pipeline`` FUSES the noise into the
    codec's sigma at build time (z=1 only): Sign(clip(x) + sigma*xi) is
    sampled from its Bernoulli law by the counter encode (E1 on a card), so
    the dense noise buffer never exists and the wire stays 1 bit/coord.
    Over a dense codec the noise is added here, drawn from the
    ``torch.Generator`` of each client's stage key (classic DP-FedAvg, 32
    bits/coord; it matches the reference's draw in law, not in bits).
    """
    clip: float = 0.0
    noise: float = 0.0
    eps: float = 0.0
    delta: float = 1e-5
    steps: int = 500
    q: float = 1.0
    #: True iff ``noise`` came from an (eps, delta) calibration: a dynamic
    #: (Plateau) sigma may not override it
    calibrated: bool = False
    spec_name = "dp"
    stateful = False

    def __post_init__(self):
        if self.eps > 0.0:
            if self.noise > 0.0:
                raise ValueError("give dp(eps=...) OR dp(noise=...), not "
                                 "both — one target, one mechanism")
            if self.clip <= 0.0:
                raise ValueError("dp(eps=...) needs clip > 0 — the clip norm "
                                 "is the mechanism's sensitivity")
            nm = dplib.calibrate_noise(q=self.q, steps=self.steps,
                                       target_eps=self.eps, delta=self.delta,
                                       hi=200.0)
            # eps is consumed into the noise std, so dataclasses.replace of
            # this instance is idempotent
            object.__setattr__(self, "noise", nm * self.clip)
            object.__setattr__(self, "eps", 0.0)
            object.__setattr__(self, "calibrated", True)

    def apply(self, keys: torch.Tensor, p2d: torch.Tensor, n_coords: int,
              sigma=None, all_sum: Optional[Callable] = None,
              lo: Optional[int] = None) -> torch.Tensor:
        """Clip, then add ``sig * N(0, 1)``, on each row's first n_coords
        entries IN PLACE (``sigma`` is the engine's dynamic override). With
        ``all_sum`` the rows are flat ranges from coordinate ``lo`` on: the
        clip norm is the whole vectors' (``dp.row_norms``) and the noise
        the range's slice of each whole row's draw."""
        if self.clip > 0.0:
            dplib.clip_rows_(p2d, n_coords, self.clip,
                             None if all_sum is None else
                             dplib.row_norms(p2d, n_coords, all_sum))
        if sigma is not None or self.noise > 0.0:
            sig = self.noise if sigma is None else sigma
            at = {} if lo is None else {"lo": lo}
            for c in range(p2d.shape[0]):
                xi = znoise.sample_z_noise(keys[c], (n_coords,), 1,
                                           device=p2d.device, **at)
                p2d[c, :n_coords].add_(xi.mul_(sig))
        return p2d

    @property
    def randomized(self) -> bool:
        return self.noise > 0.0


@dataclasses.dataclass(frozen=True)
class SigmaSchedule:
    """Per-layer sigma schedule as a STATIC geometric leaf rescaling: leaf
    ``j`` of the ``L``-leaf parameter tree is multiplied by ``m_j = head *
    (tail / head)^(j / (L - 1))`` before the codec. Since ``Sign(m_j * p +
    sigma * xi) == Sign(p + (sigma / m_j) * xi)`` the wire carries what a
    per-layer noise scale ``sigma / m_j`` would give, at no wire cost and no
    state; the server decode divides by the same multipliers. It needs the
    round's ``wire.TreeSpec`` (``needs_tree_spec``).

    Build rules: at most one, the FIRST stage, never with ``cv``. The
    multiply runs once per leaf over a strided column block of the rows,
    IN PLACE: the (d,) multiplier vector is never built on the round path.
    """
    head: float = 1.0
    tail: float = 1.0
    spec_name = "sigma_sched"
    stateful = False
    randomized = False
    needs_tree_spec = True

    def __post_init__(self):
        if self.head <= 0.0 or self.tail <= 0.0:
            raise ValueError(f"sigma_sched multipliers must be positive, "
                             f"got head={self.head}, tail={self.tail}")

    def leaf_multipliers(self, spec) -> np.ndarray:
        """(L,) f32: m_j, geometric from head (leaf 0) to tail (last)."""
        L = len(spec.shapes)
        if L == 1:
            return np.asarray([self.head], np.float32)
        j = np.arange(L, dtype=np.float64) / (L - 1)
        return (self.head * (self.tail / self.head) ** j).astype(np.float32)

    @staticmethod
    def _sizes(spec):
        return [int(np.prod(s)) if s else 1 for s in spec.shapes]

    def multipliers(self, spec) -> torch.Tensor:
        """(n_coords,) f32 per-coordinate multiplier, constant per leaf."""
        return torch.from_numpy(np.repeat(self.leaf_multipliers(spec),
                                          self._sizes(spec)))

    def _mul_leaves(self, x: torch.Tensor, spec, factors,
                    lo: int = 0) -> torch.Tensor:
        # column j of x is coordinate lo + j of the TreeSpec's flat order;
        # a leaf may straddle either end of the columns
        hi = lo + x.shape[-1]
        for off, size, f in zip(spec.offsets, self._sizes(spec), factors):
            a, b = max(off, lo), min(off + size, hi)
            if b > a:
                x[..., a - lo:b - lo].mul_(float(f))
        return x

    def scale(self, p: torch.Tensor, spec, lo: int = 0) -> torch.Tensor:
        """p * m over the last axis, IN PLACE (the padding is untouched);
        ``lo``: the flat coordinate of p's first column (a range of the
        model-sharded replica)."""
        return self._mul_leaves(p, spec, self.leaf_multipliers(spec), lo)

    def unscale(self, g: torch.Tensor, spec, lo: int = 0) -> torch.Tensor:
        """g * f32(1 / m) over the last axis, IN PLACE (``lo`` as in
        ``scale``)."""
        return self._mul_leaves(g, spec,
                                np.float32(1.0) / self.leaf_multipliers(spec),
                                lo)


# ---------------------------------------------------------------------------
# wire codec stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseCodec:
    """Uncompressed f32 wire (identity / FedAvg baseline)."""
    spec_name = "dense"
    randomized = False

    def wire_format(self) -> WireFormat:
        return WireFormat("float32", 32.0, "dense")

    def pad_multiple(self) -> int:
        return 1

    def encode_with_decode_batch(self, keys, p2d, n_coords: int,
                                 need_decode: bool = False, sigma=None,
                                 **span):
        del keys, sigma, span
        return p2d, ((lambda c: p2d[c, :n_coords]) if need_decode else None)

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        return wire.dense_masked_sum(payload, mask, acc)

    def zero_acc(self, payload, n_coords: int) -> torch.Tensor:
        del n_coords
        return torch.zeros((payload.shape[-1],), dtype=torch.float32,
                           device=payload.device)

    def decode_sum(self, enc_sum, n_live, sigma=None):
        del sigma
        return enc_sum / n_live


@dataclasses.dataclass(frozen=True)
class SignCodec:
    """The stochastic-sign wire codec: bitpacked Sign(p + sigma * xi_z) at
    1 bit/coord, reduced on the packed bytes.

      sigma > 0          z-sign, decoded as ``(sum / n_live) * f32(eta_z *
                         sigma)`` (Lemma 1). z in {inf, 1} samples the bit
                         from the counter stream (E1); finite z > 1 draws a
                         dense noise buffer (``_encode_dense``). sigma == 0.0
                         is vanilla SignSGD with no random stream at all.
      sigma_mode="norm"  sto-sign: client i's sigma is its own ||p_i||_2
                         over its true d coordinates; the (n,) sigma vector
                         goes into ONE E1 launch, and the decode is the
                         plain sign mean (no debias).
      scale="mean_abs"   the EF-SignSGD wire: the payload carries ONE f32
                         magnitude (mean |p|) next to the bits, and the
                         aggregation weights become mask * scale.

    ``agg`` is the server law over the +/-1 votes: ``mean`` (every route
    above), ``vote`` (coordinate majority, 0 at a tie), ``trimmed`` (drop
    ``trim_f`` votes at each end; ``agg=trimmed(f=2)`` is the spec sugar)
    and ``median``. The robust laws aggregate the integer vote pair
    (``vote_pair``: R1 gives its signed count on a card), fold additively
    across stream shards, and need the static 0/1 ``weights_are_mask``
    guarantee and ``scale="none"``. ``debug_wire`` asks the engine to
    check the 0/1 mask once a round (``wire.check_mask_membership``).

    The engine's dynamic (Plateau) sigma arrives as the ``sigma=`` override
    of the encode and the decode (an f32 scalar tensor); ``_noise_gate`` is
    the one place the gate is decided.

    ``encode_backend`` picks the client path (auto | torch | cuda |
    reference, see ``context.resolve_backend``); ``reference`` is the dense
    draw. ``dense_kernel`` routes the dense draw through the kernel C1
    (``zsign_compress_rows``, the ``zsign_packed`` spec); ``use_kernel``
    enables the fused EF kernel F1 under an ``ef`` transform.
    ``weights_are_mask`` is the static 0/1-mask guarantee from the
    RoundContext (never set on scale-weighted aggregation).
    """
    z: int = 1
    sigma: float = 0.0
    sigma_mode: str = "fixed"
    scale: str = "none"
    agg_backend: str = "auto"
    encode_backend: str = "auto"
    weights_are_mask: bool = False
    dense_kernel: bool = False
    use_kernel: bool = False
    agg: str = "mean"
    trim_f: int = 0
    debug_wire: bool = False
    spec_name = "zsign"
    randomized = True

    def __post_init__(self):
        object.__setattr__(self, "z", _norm_z(self.z))
        if self.sigma_mode not in ("fixed", "norm"):
            raise ValueError(f"sigma_mode must be 'fixed' or 'norm', "
                             f"got {self.sigma_mode!r}")
        if self.scale not in ("none", "mean_abs"):
            raise ValueError(f"scale must be 'none' or 'mean_abs', "
                             f"got {self.scale!r}")
        # "trimmed(f=2)" spec sugar -> agg="trimmed", trim_f=2
        agg = self.agg
        if isinstance(agg, str) and agg.startswith("trimmed("):
            m = re.fullmatch(r"trimmed\(\s*f\s*=\s*(\d+)\s*\)", agg)
            if not m:
                raise ValueError(f"malformed trimmed agg spec {agg!r}; "
                                 f"expected trimmed(f=<int>)")
            f = int(m.group(1))
            if self.trim_f not in (0, f):
                raise ValueError(f"conflicting trim levels: agg={agg!r} vs "
                                 f"trim_f={self.trim_f}")
            object.__setattr__(self, "agg", "trimmed")
            object.__setattr__(self, "trim_f", f)
        if self.agg not in wire.VOTE_AGG_MODES:
            raise ValueError(f"unknown agg mode {self.agg!r}; expected one "
                             f"of {wire.VOTE_AGG_MODES} (trimmed also as "
                             f"'trimmed(f=<int>)')")
        if self.agg == "trimmed" and self.trim_f < 1:
            raise ValueError("agg=trimmed needs trim_f >= 1 — say "
                             "agg=trimmed(f=2) or trim_f=2; trimmed(f=0) is "
                             "exactly agg=mean")
        if self.agg != "trimmed" and self.trim_f != 0:
            raise ValueError(f"trim_f={self.trim_f} only applies to "
                             f"agg=trimmed, not agg={self.agg!r}")
        if self.agg != "mean" and self.scale != "none":
            raise ValueError(
                f"agg={self.agg!r} requires scale='none': scale="
                f"{self.scale!r} aggregation weights clients by fractional "
                f"magnitudes, which have no integer vote-count semantics "
                f"(robust modes count +/-1 votes under a 0/1 mask)")
        for kind, b in (("agg", self.agg_backend),
                        ("encode", self.encode_backend)):
            resolve_backend(kind, b)

    def wire_format(self) -> WireFormat:
        layout = "bitpacked+scale" if self.scale == "mean_abs" else "bitpacked"
        return WireFormat("uint8", 1.0, layout)

    def pad_multiple(self) -> int:
        """The cohort buffer's row length is a multiple of the encode tile,
        so the batched encode reads it without a padded copy."""
        return ENCODE_TILE

    # -- client side --------------------------------------------------------

    def _encode_dense(self, keys, x2d, n_coords: int, sig, add_noise: bool,
                      lo: Optional[int] = None):
        """The dense-noise draw (``reference`` backend, and every finite
        z > 1): client c's noise is ``sample_z_noise(keys[c], (d,), z)``,
        zero in the tile padding, as the reference pads it; over a flat
        range from coordinate ``lo`` on, the range's slice of that row."""
        n, d_pad = x2d.shape
        noise = None
        if add_noise:
            noise = torch.empty_like(x2d)
            noise[:, n_coords:].zero_()
            at = {} if lo is None else {"lo": lo}
            for c in range(n):
                noise[c, :n_coords] = znoise.sample_z_noise(
                    keys[c], (n_coords,), self.z, device=x2d.device, **at)
        if self.dense_kernel:
            if not add_noise:
                # vanilla SignSGD: no noise is drawn (x doubles as a dummy
                # operand; sigma == 0 makes it a no-op in the kernel)
                return K.zsign_compress_rows(x2d, x2d, torch.zeros_like(sig))
            return K.zsign_compress_rows(x2d, noise, sig)
        if add_noise:
            x2d = x2d + sig.reshape(n, 1) * noise
        return self._pack_rows(keys, x2d, sig)

    def _pack_rows(self, keys, x2d, sig):
        """The noise-free pack ``x >= 0`` (the reference's ``pack_flat``):
        E1 with z=None (bit-identical) on a card unless the encode backend
        is ``torch``, the plain pack elsewhere."""
        backend = resolve_backend("encode", self.encode_backend,
                                  x2d.device.type)
        if backend == "torch":
            return K.zsign_encode_plain(x2d, keys, sig, None)
        return K.zsign_encode(x2d, keys, sig, None)

    def _encode_bits(self, keys, x2d, n_coords: int, sig, add_noise: bool,
                     tile0: Optional[int] = None):
        backend = resolve_backend("encode", self.encode_backend,
                                  x2d.device.type)
        if backend == "reference" or (
                add_noise and not znoise.counter_supported(self.z)):
            return self._encode_dense(
                keys, x2d, n_coords, sig, add_noise,
                None if tile0 is None else tile0 * ENCODE_TILE)
        z = self.z if add_noise else None
        if backend == "cuda":
            return K.zsign_encode(x2d, keys, sig, z, tile0)
        return K.zsign_encode_plain(x2d, keys, sig, z, tile0)

    def _noise_gate(self, sigma):
        """-> (sigma, add_noise); the ONE place the noise gate is decided. A
        static sigma of 0.0 (vanilla SignSGD) disables the draw on every
        backend; a dynamic sigma always flows through (a runtime 0 degrades
        exactly inside the threshold, to x >= 0); norm mode computes its
        sigma from the rows (None here)."""
        if self.sigma_mode == "norm":
            return None, True
        add_noise = (sigma is not None) or self.sigma > 0.0
        return (self.sigma if sigma is None else sigma), add_noise

    def encode_with_decode_batch(self, keys: torch.Tensor, p2d: torch.Tensor,
                                 n_coords: int, need_decode: bool = False,
                                 sigma=None, tile0: Optional[int] = None,
                                 all_sum: Optional[Callable] = None,
                                 n_total: Optional[int] = None,
                                 rank_prefix: Optional[Callable] = None):
        """(n, 2) client keys + (n, d_pad) f32 rows (d_pad a multiple of
        8192, zero past n_coords) -> (payload, local decode or None). The
        payload is the (n, d_pad/8) uint8 stack, with ``{"packed",
        "scale"}`` on the mean_abs wire. The local decode is a function of
        the client index c giving the exact (n_coords,) value the server
        attributes to client c's payload (what an ``ef`` residual subtracts
        and a ``cv`` row adds), made one row at a time so the (n, d) decode
        of a cohort never exists. ``sigma`` is the dynamic override (an f32
        scalar tensor).

        The model-sharded replica encodes flat RANGES: the rows hold
        coordinates [tile0 * 8192, tile0 * 8192 + d_pad) of longer vectors,
        n_coords of them true ones, and the payload is the byte slice of
        the whole vectors' (E1 with ``tile0``; C1 or the plain pack on the
        dense draw's slice of the range). The two statistics that span a
        whole vector, sto-sign's sigma = ||p|| and the mean_abs scale over
        the ``n_total`` true coordinates, then come from per-row partials
        summed over the ranks by ``all_sum(partials, use)``."""
        del rank_prefix
        n = p2d.shape[0]
        sig0, add_noise = self._noise_gate(sigma)
        # the range keywords only over a range: the one-process calls keep
        # their plain forms
        span = {} if all_sum is None else {"all_sum": all_sum}
        if sig0 is None:
            sig = dplib.row_norms(p2d, n_coords, **span)
        elif isinstance(sig0, torch.Tensor):
            sig = sig0.to(device=p2d.device, dtype=torch.float32).reshape(
                1).expand(n).contiguous()
        else:
            sig = torch.full((n,), sig0, dtype=torch.float32,
                             device=p2d.device)
        if self.scale == "mean_abs":
            s = _mean_abs_rows(p2d, n_coords, **span,
                               **({"n_total": n_total} if span else {}))
            if not add_noise:
                # EF-SignSGD proper: noise-free signs, p >= 0 -> +1 as on
                # the wire, so the residual accounts exactly for what the
                # server decodes
                packed = self._pack_rows(keys, p2d, sig)
                def local(c):
                    return torch.where(p2d[c, :n_coords] >= 0, s[c], -s[c])
            else:
                packed = self._encode_bits(keys, p2d, n_coords, sig, True,
                                           tile0)
                def local(c):
                    return _decode_row(packed[c], n_coords, s[c])
            return ({"packed": packed, "scale": s},
                    local if need_decode else None)
        packed = self._encode_bits(keys, p2d, n_coords, sig, add_noise, tile0)
        if not need_decode:
            return packed, None
        if self.sigma_mode == "norm" or not add_noise:
            factor = 1.0
        else:
            # static: f32(eta_z * sigma), the product in Python double;
            # dynamic: f32(eta_z) * f32(sigma), rounded in f32
            factor = znoise.eta_z(self.z) * sig0
        return packed, lambda c: _decode_row(packed[c], n_coords, factor)

    # -- server side --------------------------------------------------------

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        if self.scale == "mean_abs":
            # weights = mask * per-client scale: the weighted reduce takes
            # the scale-weighted sum straight from the packed bytes
            return sign_reduce(payload["packed"], mask * payload["scale"],
                               self.agg_backend, acc=acc)
        if self.agg != "mean":
            if not self.weights_are_mask:
                raise ValueError(
                    f"agg={self.agg!r} requires the static weights_are_mask "
                    f"guarantee (0/1 participation masks): robust sign "
                    f"aggregation counts +/-1 votes, and fractional weights "
                    f"(importance/arrival sampler tiers, data-size weights) "
                    f"have no vote-count semantics. Run under "
                    f"RoundContext(weights_are_mask=True) with a uniform "
                    f"0/1 sampler, or use agg=mean.")
            return vote_pair(payload, mask, self.agg_backend, acc)
        return sign_reduce(payload, mask, self.agg_backend,
                           weights_are_mask=self.weights_are_mask, acc=acc)

    def zero_acc(self, payload, n_coords: int) -> torch.Tensor:
        """The zero accumulator of ``aggregate`` for one shard's payload
        stack: the (2, 8*n_bytes) int32 vote pair on the robust laws, the
        flat (8*n_bytes,) f32 sum otherwise."""
        del n_coords
        p = payload["packed"] if isinstance(payload, dict) else payload
        n = 8 * p.shape[-1]
        if self.agg != "mean":
            return torch.zeros((2, n), dtype=torch.int32, device=p.device)
        return torch.zeros((n,), dtype=torch.float32, device=p.device)

    def fold_init(self, payload):
        """The streaming fold's carry for this codec, or None where the
        zero accumulator is exact already. The f32-weighted routes
        (``scale="mean_abs"``, and agg=mean without the 0/1-mask guarantee)
        are order-sensitive, so they get a ``wire.SignFoldAcc`` sized from
        one shard's payload; 0/1-mask sums and vote pairs are integers,
        exact under any association."""
        weighted = (self.scale == "mean_abs"
                    or (self.agg == "mean" and not self.weights_are_mask))
        if not weighted:
            return None
        packed = payload["packed"] if isinstance(payload, dict) else payload
        return wire.sign_fold_init(packed.shape[-1], packed.device)

    def decode_mean(self, flat_mean, sigma=None):
        """mean_abs and sto-sign: the magnitudes are in the aggregation
        weights / the plain sign mean; otherwise the Lemma 1 debias, by
        f32(eta_z * sigma) for the static sigma and by f32(eta_z) *
        f32(sigma) for a dynamic one."""
        if self.scale == "mean_abs" or self.sigma_mode == "norm":
            return flat_mean
        if sigma is None:
            scale = (znoise.eta_z(self.z) * self.sigma
                     if self.sigma > 0.0 else 1.0)
        else:
            scale = znoise.eta_z(self.z) * sigma
        return flat_mean * scale

    def decode_sum(self, enc_sum, n_live, sigma=None):
        """Server estimate from ``aggregate``'s output and the live count:
        agg=mean is ``decode_mean(sum / n_live)``; the robust laws decode
        the vote pair (``wire.vote_decode``), trimmed then debiased by
        eta_z * sigma as the mean is, vote and median returned raw in
        {-1, 0, +1}."""
        if self.agg == "mean":
            return self.decode_mean(enc_sum / n_live, sigma=sigma)
        est = wire.vote_decode(enc_sum, self.agg, self.trim_f)
        if self.agg == "trimmed":
            return self.decode_mean(est, sigma=sigma)
        return est


@dataclasses.dataclass(frozen=True)
class QSGDCodec:
    """The unbiased stochastic quantizer of Alistarh et al. (paper
    Definition 2; FedPAQ with local steps), ``s`` levels: each coordinate
    becomes ``||p|| * sign(p) * (floor(r) + b) / s`` with ``r = |p| / ||p||
    * s`` and ``b ~ Bernoulli(r - floor(r))``. The wire counts
    ceil(log2(2s+1)) bits a coordinate and carries the dense f32 values.

    ``b`` is the reference's draw bit for bit: ``jax.random.bernoulli(key,
    q, (d,))`` is ``u < q`` with ``u = f32((bits >> 9) | 0x3F800000) - 1``
    and ``bits[i] = y0 ^ y1`` of threefry2x32 (20 rounds) on the counter
    (0, i). The port draws them in slices of ``noise.BITS_CHUNK`` and
    writes q over the consumed rows in place. The norm comes from
    ``dp.row_norms``, whose summation order differs from the reference's:
    given the reference's norm, q is bit-identical."""
    s: int = 1
    spec_name = "qsgd"
    randomized = True

    def wire_format(self) -> WireFormat:
        return WireFormat("float32",
                          float(math.ceil(math.log2(2 * self.s + 1))),
                          "dense")

    def pad_multiple(self) -> int:
        return 1

    def _quantize_row(self, key, row: torch.Tensor, nrm: torch.Tensor,
                      lo: int = 0):
        """q over ``row`` in place (``nrm`` already has the 1e-12 floor);
        ``lo``: the flat coordinate of the row's first entry (a range's on
        a grid), whose draws are the whole row's at the same
        coordinates."""
        for a in range(0, row.shape[0], znoise.BITS_CHUNK):
            x = row[a:a + znoise.BITS_CHUNK]
            u = znoise.bits_to_uniform(znoise.random_bits(
                key, lo + a, lo + a + x.shape[0], row.device))
            r = torch.abs(x) / nrm * self.s
            low = torch.floor(r)
            up = u < torch.clip(r - low, 0.0, 1.0)
            lvl = (low + up.to(torch.float32)) / self.s
            # jnp.sign keeps the sign of a zero; torch.sign gives +0
            sgn = torch.copysign((x != 0).to(torch.float32), x)
            x.copy_(nrm * sgn * lvl)

    def encode_with_decode_batch(self, keys, p2d, n_coords: int,
                                 need_decode: bool = False, sigma=None,
                                 tile0: Optional[int] = None,
                                 all_sum: Optional[Callable] = None,
                                 n_total: Optional[int] = None,
                                 rank_prefix: Optional[Callable] = None):
        """(n, d) rows -> the (n, d) f32 q stack, written over the rows;
        the local decode of client c is its q row. Over flat ranges
        (``tile0``, ``all_sum`` as in ``SignCodec``) the norm is the whole
        vectors' and the draws those of the range's coordinates."""
        del sigma, n_total, rank_prefix
        span = {} if all_sum is None else {"all_sum": all_sum}
        nrms = dplib.row_norms(p2d, n_coords, **span) + 1e-12
        lo = 0 if tile0 is None else tile0 * ENCODE_TILE
        for c in range(p2d.shape[0]):
            self._quantize_row(keys[c], p2d[c, :n_coords], nrms[c], lo)
        local = (lambda c: p2d[c, :n_coords]) if need_decode else None
        return p2d, local

    aggregate = DenseCodec.aggregate
    zero_acc = DenseCodec.zero_acc
    decode_sum = DenseCodec.decode_sum


def topk_select(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a non-negative f32 ``score``,
    as ``lax.top_k`` gives them: ties at the k-th value keep the LOWEST
    indices, and the result is ordered by (score descending, index
    ascending). ``torch.topk`` fixes neither on a card, but the VALUE of
    its smallest kept entry is the k-th largest score t whichever tied
    entries it kept; ``_keep_at`` then selects. -> (k,) int64."""
    t = torch.topk(score, k, sorted=False).values.min()
    return _keep_at(score, t, lambda above, ties: k - above)


#: entries a slice of the selection's passes (bounds temporaries)
TOPK_CHUNK = 1 << 24


def _keep_at(row: torch.Tensor, t: torch.Tensor, need: Callable
             ) -> torch.Tensor:
    """The selection of the k largest |entries| of ``row`` ((L,) f32) given
    the k-th largest magnitude t: every entry above t, the first
    ``need(n_above, n_ties)`` entries at t in index order (this row's
    counts), and a stable descending sort of the kept magnitudes (taken in
    index order). The passes walk TOPK_CHUNK entries at a time: beside the
    row, only the (L,) keep mask and the ties' indices are whole-row
    temporaries. -> the int64 indices, ordered by (|entry| descending,
    index ascending)."""
    L = row.shape[0]
    keep = torch.empty((L,), dtype=torch.bool, device=row.device)
    ties = []
    for a in range(0, L, TOPK_CHUNK):
        m = torch.abs(row[a:a + TOPK_CHUNK])
        keep[a:a + m.shape[0]] = m > t
        ties.append(torch.nonzero(m == t).reshape(-1) + a)
    ties = torch.cat(ties) if ties else torch.zeros((0,), dtype=torch.int64,
                                                    device=row.device)
    n = need(int(keep.sum()), ties.numel())
    keep[ties[:max(n, 0)]] = True
    del ties
    idx = torch.nonzero(keep).reshape(-1)
    del keep
    order = torch.sort(torch.abs(row[idx]), descending=True,
                       stable=True).indices
    return idx[order]


def range_topk_select(row: torch.Tensor, k: int, all_sum: Callable,
                      rank_prefix: Callable) -> torch.Tensor:
    """``topk_select`` of a whole row's magnitudes, where the row's flat
    ranges lie on the ranks of a replica, taken on this rank's range
    ``row`` ((L,) f32). -> the range-local int64 indices of the whole
    row's k largest |entries| that lie in the range, ordered by (|entry|
    descending, index ascending): the one-process selection's entries in
    the range, ties at the k-th magnitude to the lowest global indices.

    Only the threshold differs from ``topk_select``: the k-th largest
    magnitude t is a radix select over the bit patterns of |row| (the
    int32 view with the sign bit cleared orders as the magnitude): four
    passes of 8 bits, each a 256-bin count of the entries that share the
    digits found so far, summed over the ranks by ``all_sum(counts,
    use)``, an exact integer sum. ``_keep_at`` keeps the entries above t,
    and of the ties at t the first ``need - ties before this range`` in
    index order, where ``rank_prefix(t, use)`` sums ``t`` over the ranks
    before this one (the ranks hold the ranges in coordinate order)."""
    bits = row.view(torch.int32)
    L = bits.shape[0]
    prefix, need = 0, k
    for shift in (24, 16, 8, 0):
        hist = torch.zeros((257,), dtype=torch.int64, device=row.device)
        for a in range(0, L, TOPK_CHUNK):
            b = bits[a:a + TOPK_CHUNK] & 0x7FFFFFFF
            dig = (b >> shift) & 0xFF
            if shift < 24:
                # only the entries whose higher digits are t's so far
                same = (b >> (shift + 8)) == (prefix >> (shift + 8))
                dig = torch.where(same, dig, 256)
            hist += torch.bincount(dig, minlength=257)
        h = all_sum(hist[:256], "topk_hist").tolist()
        above, digit = 0, 0
        for digit in range(255, -1, -1):
            if above + h[digit] >= need:
                break
            above += h[digit]
        need -= above
        prefix |= digit << shift
    t = torch.tensor([prefix], dtype=torch.int32).view(torch.float32).to(
        row.device)[0]

    def ties_here(above, ties):
        before = rank_prefix(torch.tensor([ties], dtype=torch.int64,
                                          device=row.device), "topk_ties")
        return need - int(before[0])
    return _keep_at(row, t, ties_here)


@dataclasses.dataclass(frozen=True)
class TopKCodec:
    """Global top-k sparsifier: keep the ``frac`` largest-magnitude
    coordinates of the flat buffer, k = max(1, int(n_coords * frac)), on a
    COO wire of (f32 value, int32 index) pairs, 64 * frac bits a
    coordinate. Stateless: ``ef|topk`` is the error-corrected form (the
    legacy ``topk`` compressor).

    The selection is ``topk_select`` over the first n_coords entries of
    each row: exactly ``lax.top_k``'s set and order, ties at the k-th
    magnitude to the lowest index. ``chunk`` is the reference's two-stage
    candidate width (0: ``_resolve_chunk``); its selection is the same for
    every chunk, so the port parses and keeps it and selects in one stage.

    ``agg="coord"`` scatter-adds a per-coordinate reporter count beside
    the values, a (2, n_coords) accumulator, and decodes each coordinate
    by its own count (0 where nobody reported it); ``agg="mean"`` divides
    the scatter-sum by n_live."""
    frac: float = 0.01
    chunk: int = 0
    agg: str = "mean"
    spec_name = "topk"
    randomized = False

    def __post_init__(self):
        if self.agg not in ("mean", "coord"):
            raise ValueError(f"topk agg must be 'mean' or 'coord', "
                             f"got {self.agg!r}")
        if self.chunk < 0:
            raise ValueError(f"topk chunk must be 0 (auto) or positive, "
                             f"got {self.chunk}")

    def wire_format(self) -> WireFormat:
        return WireFormat("float32", 64.0 * self.frac, "sparse_coo")

    def pad_multiple(self) -> int:
        return 1

    @staticmethod
    def _resolve_chunk(d: int, k: int) -> int:
        """The reference's auto chunk: sqrt(d * k) rounded up to a power of
        two, clamped to [4096, 2^20]."""
        c = max(1, int(math.sqrt(d * max(1, k))))
        return min(1 << 20, max(4096, 1 << (c - 1).bit_length()))

    def encode_with_decode_batch(self, keys, p2d, n_coords: int,
                                 need_decode: bool = False, sigma=None,
                                 tile0: Optional[int] = None,
                                 all_sum: Optional[Callable] = None,
                                 n_total: Optional[int] = None,
                                 rank_prefix: Optional[Callable] = None):
        """(n, d) rows -> ({"values": (n, k) f32, "indices": (n, k)
        int32}, local decode). The local decode of client c is its row with
        only the kept values, so an ``ef`` residual is the row with the
        kept coordinates zeroed.

        Over a flat range (``all_sum``; one row a call, since the ranges'
        shares of k differ) k counts the ``n_total`` coordinates of the
        whole vector, and the payload holds the whole row's selection in
        the range (``range_topk_select``) with RANGE-LOCAL indices: the
        one-process wire's (f32, int32) pairs, whose global indices would
        pass int32 past 2^31 coordinates."""
        del keys, sigma, tile0
        n = p2d.shape[0]
        if all_sum is None:
            k = max(1, int(n_coords * self.frac))
            idx = torch.empty((n, k), dtype=torch.int64, device=p2d.device)
            for c in range(n):
                idx[c] = topk_select(torch.abs(p2d[c, :n_coords]), k)
        elif n != 1:
            raise ValueError(f"top-k encodes one range row a call, got {n}")
        else:
            idx = range_topk_select(
                p2d[0, :n_coords], max(1, int(n_total * self.frac)),
                all_sum, rank_prefix).reshape(1, -1)
        vals = torch.gather(p2d, 1, idx)
        payload = {"values": vals, "indices": idx.to(torch.int32)}
        if not need_decode:
            return payload, None

        def local(c):
            out = torch.zeros((n_coords,), dtype=torch.float32,
                              device=p2d.device)
            return out.index_put_((idx[c],), vals[c])
        return payload, local

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        vals, idx = payload["values"], payload["indices"]
        if self.agg == "coord":
            if acc is None:
                acc = self.zero_acc(payload, n_coords)
            wire.scatter_sum_coo(vals, idx, mask, n_coords, acc[0])
            wire.scatter_sum_coo(torch.ones_like(vals), idx, mask, n_coords,
                                 acc[1])
            return acc
        return wire.scatter_sum_coo(vals, idx, mask, n_coords, acc)

    def zero_acc(self, payload, n_coords: int) -> torch.Tensor:
        shape = (2, n_coords) if self.agg == "coord" else (n_coords,)
        return torch.zeros(shape, dtype=torch.float32,
                           device=payload["values"].device)

    def decode_sum(self, enc_sum, n_live, sigma=None):
        del sigma
        if self.agg == "coord":
            # the value row is exactly 0 wherever the count row is 0
            return enc_sum[0] / torch.clamp_min(enc_sum[1], 1.0)
        return enc_sum / n_live


# ---------------------------------------------------------------------------
# spec strings and the pipeline
# ---------------------------------------------------------------------------

_TRANSFORM_SPECS = {"ef": ErrorFeedback, "dp": DPTransform,
                    "cv": ControlVariate, "sigma_sched": SigmaSchedule}


def _sign_spec(**defaults):
    def build(**kw):
        return SignCodec(**{**defaults, **kw})
    return build


_CODEC_SPECS = {
    "zsign": _sign_spec(),
    # the reference pins zsign_packed to its Pallas kernels; the port pins
    # it to its CUDA kernels (whose wrappers run the plain versions on CPU
    # tensors)
    "zsign_packed": _sign_spec(encode_backend="cuda", dense_kernel=True),
    "stosign": _sign_spec(z=znoise.Z_INF, sigma_mode="norm"),
    "qsgd": QSGDCodec,
    "topk": TopKCodec,
    "dense": DenseCodec,
    "identity": DenseCodec,
}


def _parse_value(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _parse_stage(tok: str) -> Tuple[str, dict]:
    tok = tok.strip()
    if "(" not in tok:
        return tok, {}
    if not tok.endswith(")"):
        raise ValueError(f"malformed stage spec {tok!r}")
    name, args = tok[:-1].split("(", 1)
    kw = {}
    for part in split_top(args, tok):
        if "=" not in part:
            raise ValueError(f"stage argument {part!r} in {tok!r} must be "
                             f"key=value")
        k, v = part.split("=", 1)
        kw[k.strip()] = _parse_value(v.strip())
    return name.strip(), kw


def parse_spec(spec: str):
    """Spec string -> (transforms tuple, codec). Grammar:
    ``stage ("|" stage)*``, ``stage := name | name(k=v, ...)``; every stage
    but the last is a transform (``ef``, ``dp``, ``cv``, ``sigma_sched``),
    the last is the codec (``zsign``, ``zsign_packed``, ``stosign``,
    ``qsgd``, ``topk``, ``dense``/``identity``). An ``ef`` transform in
    front of a noise-free fixed-sigma mean sign codec sets
    ``scale="mean_abs"`` unless given explicitly: ``"ef|zsign"`` IS
    EF-SignSGD (noisy z-sign and sto-sign keep their own decode laws, and
    the robust agg= laws need scale="none": ``"ef|zsign(agg=vote)"`` is EF
    over the raw-sign wire with the majority-vote decode)."""
    toks = [t for t in (p.strip() for p in spec.split("|")) if t]
    if not toks:
        raise ValueError("empty pipeline spec")
    transforms = []
    for tok in toks[:-1]:
        name, kw = _parse_stage(tok)
        if name not in _TRANSFORM_SPECS:
            raise ValueError(
                f"unknown transform stage {name!r} in {spec!r}; transforms: "
                f"{sorted(_TRANSFORM_SPECS)} (codecs must come last)")
        transforms.append(_TRANSFORM_SPECS[name](**kw))
    name, kw = _parse_stage(toks[-1])
    if name not in _CODEC_SPECS:
        raise ValueError(f"unknown codec stage {name!r} in {spec!r}; "
                         f"codecs: {sorted(_CODEC_SPECS)}")
    codec = _CODEC_SPECS[name](**kw)
    if (isinstance(codec, SignCodec) and "scale" not in kw
            and codec.sigma == 0.0 and codec.sigma_mode == "fixed"
            and codec.agg == "mean"
            and any(isinstance(t, ErrorFeedback) for t in transforms)):
        codec = dataclasses.replace(codec, scale="mean_abs")
    return tuple(transforms), codec


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Transforms + one wire codec; the engine-facing compressor. Build it
    from a spec string (``Pipeline("ef|zsign")``) or from stages
    (``Pipeline((ErrorFeedback(),), SignCodec(scale="mean_abs"))``).

    Build rules (``__post_init__``, the reference's): slot names are unique
    across stages; at most one ``ef``; a ``dp`` stage's noise is FUSED into
    a downstream sign codec's sigma (z=1, sigma_mode="fixed" only, and the
    codec must not carry a sigma of its own); at most one ``sigma_sched``,
    first, never with ``cv``; ``cv`` needs a decode linear in the local
    decodes. The engine's dynamic sigma goes to ONE consumer: the sign codec
    (none for the noise-free EF wire), else the last noise-bearing ``dp``
    stage."""
    transforms: object = ()
    codec: object = None
    name: str = ""

    def __post_init__(self):
        transforms, codec, name = self.transforms, self.codec, self.name
        if isinstance(transforms, str):
            if codec is not None:
                raise ValueError("give either a spec string or stages, "
                                 "not both")
            spec = transforms
            transforms, codec = parse_spec(spec)
            name = name or spec
        transforms = tuple(transforms)
        if codec is None:
            raise ValueError("pipeline needs a wire codec as its last stage")
        if sum(isinstance(t, ErrorFeedback) for t in transforms) > 1:
            raise ValueError("at most one ef transform per pipeline")
        # dp noise fused into the sign codec (see DPTransform)
        if isinstance(codec, SignCodec):
            fused = []
            for t in transforms:
                if isinstance(t, DPTransform) and t.noise > 0.0:
                    if codec.z != 1 or codec.sigma_mode != "fixed":
                        # the accountant assumes the GAUSSIAN mechanism
                        raise ValueError(
                            "dp noise is Gaussian: the sign codec must be "
                            "z=1 with sigma_mode='fixed' to carry it "
                            f"(got z={codec.z}, sigma_mode="
                            f"{codec.sigma_mode!r})")
                    if codec.sigma > 0.0:
                        raise ValueError(
                            "ambiguous noise: both the dp stage and the sign "
                            "codec carry a sigma — set it on one stage only")
                    codec = dataclasses.replace(codec, sigma=t.noise)
                    t = dataclasses.replace(t, noise=0.0, eps=0.0)
                fused.append(t)
            transforms = tuple(fused)
        object.__setattr__(self, "transforms", transforms)
        object.__setattr__(self, "codec", codec)
        object.__setattr__(self, "name", name or self.spec)
        n_random = sum(bool(getattr(t, "randomized", False))
                       for t in transforms + (codec,))
        object.__setattr__(self, "_n_random", n_random)
        stateful = tuple(i for i, t in enumerate(transforms)
                         if getattr(t, "stateful", False))
        object.__setattr__(self, "_stateful_idx", stateful)
        scheds = [i for i, t in enumerate(transforms)
                  if isinstance(t, SigmaSchedule)]
        if len(scheds) > 1:
            raise ValueError("at most one sigma_sched stage per pipeline")
        if scheds:
            if any(isinstance(t, ControlVariate) for t in transforms):
                raise ValueError(
                    "sigma_sched cannot compose with cv: the server "
                    "variate update folds the UNSCALED decoded aggregate "
                    "while client variates would track scaled local "
                    "decodes — the SCAFFOLD bookkeeping identity breaks")
            if scheds[0] != 0:
                raise ValueError(
                    "sigma_sched must be the first stage (e.g. "
                    "'sigma_sched(...)|ef|zsign'): it rescales the raw "
                    "pseudo-gradient, so residuals and clipping must "
                    "happen in the scaled domain")
        object.__setattr__(self, "_needs_spec", any(
            getattr(t, "needs_tree_spec", False) for t in transforms))
        # slot-name collisions fail here, not deep in the engine
        slots0 = cstate_lib.collect_slots(
            [transforms[i] for i in stateful], 0)
        object.__setattr__(self, "_has_server_state",
                           any(s.scope == "server" for s in slots0))
        # control variates need a decode linear in the per-client local
        # decodes: the count laws (robust sign agg=, top-k agg=coord) are
        # refused at build
        linear_needers = [t for t in transforms
                          if getattr(t, "needs_linear_decode", False)]
        if linear_needers:
            bad = None
            if isinstance(codec, SignCodec) and codec.agg != "mean":
                bad = f"the sign codec's agg={codec.agg!r} vote law"
            elif isinstance(codec, TopKCodec) and codec.agg != "mean":
                bad = "topk's agg='coord' per-coordinate count law"
            if bad is not None:
                raise ValueError(
                    f"{linear_needers[0].spec_name} control variates "
                    f"require a server decode LINEAR in the per-client "
                    f"local decodes (the variate update is exact only for "
                    f"mean-law codecs), but {bad} decodes through a "
                    f"nonlinear count — use agg=mean or drop the cv stage")
        # the dynamic (Plateau) sigma's one consumer: the sign codec (none on
        # the noise-free EF-SignSGD wire), else the last noise-bearing dp
        if isinstance(codec, SignCodec):
            consumer = (None if codec.scale == "mean_abs"
                        and codec.sigma == 0.0 else "codec")
        else:
            dps = [i for i, t in enumerate(transforms)
                   if isinstance(t, DPTransform) and t.noise > 0.0]
            consumer = dps[-1] if dps else "codec"
        object.__setattr__(self, "_sigma_stage", consumer)

    @property
    def spec(self) -> str:
        """Canonical spec string (non-default stage fields spelled out)."""
        def stage_str(s):
            kw = [f"{f.name}={getattr(s, f.name)}"
                  for f in dataclasses.fields(s)
                  if getattr(s, f.name) != f.default]
            return s.spec_name + (f"({','.join(kw)})" if kw else "")
        return "|".join([stage_str(t) for t in self.transforms]
                        + [stage_str(self.codec)])

    def with_context(self, ctx: RoundContext) -> "Pipeline":
        """Rebind the deployment's backend policy onto the sign codec.
        ``weights_are_mask`` applies to pure-mask aggregation only: the
        scale-weighted (EF) reduce keeps the general LUT path;
        ``debug_wire`` is switched on, never off. A dynamic
        sigma is refused over an (eps, delta)-CALIBRATED ``dp`` stage: the
        Plateau override would void the guarantee (a hand-set
        ``dp(noise=...)`` promises none, and the dynamic sigma overrides
        it)."""
        if ctx.dynamic_sigma and any(
                isinstance(t, DPTransform) and t.calibrated
                for t in self.transforms):
            raise ValueError(
                "dynamic (Plateau) sigma cannot run over an eps-calibrated "
                "dp stage: the loss-adaptive override would replace the "
                "privacy-calibrated noise and void the (eps, delta) "
                "guarantee")
        codec = self.codec
        if isinstance(codec, SignCodec):
            kw = {}
            if ctx.agg_backend is not None:
                kw["agg_backend"] = ctx.agg_backend
            if ctx.encode_backend is not None:
                kw["encode_backend"] = ctx.encode_backend
            if ctx.weights_are_mask and codec.scale == "none":
                kw["weights_are_mask"] = True
            if ctx.debug_wire and not codec.debug_wire:
                kw["debug_wire"] = True
            if kw:
                codec = dataclasses.replace(codec, **kw)
        if codec is self.codec:
            return self
        return dataclasses.replace(self, codec=codec)

    def wire_format(self) -> WireFormat:
        return self.codec.wire_format()

    @property
    def wire_bits_per_coord(self) -> float:
        return self.wire_format().bits_per_coord

    @property
    def needs_tree_spec(self) -> bool:
        """True when a stage (sigma_sched) needs the round's
        ``wire.TreeSpec`` at encode and at decode (``spec=``)."""
        return self._needs_spec

    def pad_multiple(self) -> int:
        return self.codec.pad_multiple()

    def state_slots(self, n_coords: int):
        """The StateSlot declarations of the stateful stages, in order
        (client- and server-scope)."""
        return cstate_lib.collect_slots(
            [self.transforms[i] for i in self._stateful_idx], n_coords)

    def init_state(self, n_coords: int, lead: Tuple[int, ...] = (),
                   device=None, pin_memory: bool = False):
        """Zero per-client state ``{slot: lead + (n_coords,)}`` over the
        client-scope slots (in pinned host memory with ``pin_memory``), or
        None for stateless pipelines."""
        return cstate_lib.init_tree(self.state_slots(n_coords), "client",
                                    lead, device, pin_memory)

    def init_server_state(self, n_coords: int, device=None):
        """Zero SHARED server-scope state ``{slot: (n_coords,)}`` (the
        ``cv`` server variate), or None: one tree per deployment, threaded
        into every client encode (``server=``)."""
        return cstate_lib.init_tree(self.state_slots(n_coords), "server",
                                    (), device)

    def update_server(self, server, g_dec, n_live, n_total):
        """Round-tail update of the server-scope state from the DECODED
        aggregate, once per round after ``decode_sum``; stages without an
        ``update_server`` hook keep their slots."""
        if server is None:
            return None
        new = dict(server)
        for i in self._stateful_idx:
            hook = getattr(self.transforms[i], "update_server", None)
            if hook is not None:
                new.update(hook(server, g_dec, n_live, n_total))
        return new

    def _stage_key(self, keys: torch.Tensor, i: int) -> torch.Tensor:
        # a single random stage consumes the raw client keys; several
        # random stages get fold_in-derived subkeys
        if self._n_random <= 1:
            return keys
        return znoise.fold_in(keys, i)

    @property
    def _ef_kernel_path(self) -> bool:
        return (len(self.transforms) == 1
                and isinstance(self.transforms[0], ErrorFeedback)
                and isinstance(self.codec, SignCodec)
                and self.codec.use_kernel
                and self.codec.scale == "mean_abs"
                and self.codec.sigma_mode == "fixed"
                and self.codec.sigma == 0.0)

    def _use_ef_kernel(self, sigma) -> bool:
        """The fused F1 path, unless a dynamic sigma has a consumer."""
        return self._ef_kernel_path and (sigma is None
                                         or self._sigma_stage is None)

    def encode_batch(self, keys: torch.Tensor, flat2d: torch.Tensor,
                     n_coords: Optional[int] = None, state=None,
                     live: Optional[torch.Tensor] = None, sigma=None,
                     server=None, spec=None,
                     live_rows: Optional[Sequence[int]] = None, *,
                     tile0: Optional[int] = None,
                     all_sum: Optional[Callable] = None,
                     n_total: Optional[int] = None,
                     rank_prefix: Optional[Callable] = None):
        """Encode a cohort: (n, 2) client keys, (n, d_pad) f32 rows (zero
        past ``n_coords``, which defaults to d_pad), the per-client state
        ``{slot: (n, n_coords)}`` and the (n,) participation mask ``live``
        -> (payload stack, new state). ``live_rows`` lists the rows with
        ``live > 0`` as host indices (read from ``live`` when not given,
        which waits for a mask on the card). ``sigma`` is the engine's
        dynamic override, routed to the pipeline's one sigma consumer;
        ``server``
        the shared server-scope state (required with ``cv``); ``spec`` the
        round's ``wire.TreeSpec`` (required with ``sigma_sched``).

        The rows are consumed: the transforms work on them in place. State
        rows are updated IN PLACE for live clients (the returned state holds
        the same tensors); dead clients (``live <= 0``) keep theirs
        bit-exactly. The fused EF path (``ef|zsign(use_kernel=true)``) is
        one launch of F1 over the cohort: at qwen2-0.5B width a second (n,
        d) residual would cost another 15.8 GB.

        With ``tile0`` the rows are flat RANGES of longer vectors (the
        model-sharded replica, ``encode_range``): coordinates [lo, lo +
        d_pad), lo = tile0 * 8192, and the payload is the byte slice of the
        whole vectors' (E1 with ``tile0``). ``all_sum(partials, use)`` then
        adds the per-row partials of the statistics that span a whole
        vector (the EF scale over its ``n_total`` true coordinates,
        sto-sign's sigma, the clip norm, the QSGD norm, top-k's threshold
        counts) over the ranks holding the other ranges, and
        ``rank_prefix(t, use)`` sums ``t`` over the ranks before this one
        (top-k's ties)."""
        if self._has_server_state and server is None:
            raise ValueError(
                "pipeline declares server-scope state slots (control "
                "variates): encode needs the shared server tree — pass "
                "server=init_server_state(n_coords) (the engine threads "
                "ServerState.comp_server here)")
        if self._needs_spec and spec is None:
            raise ValueError(
                "pipeline declares a tree-structured stage (sigma_sched): "
                "encode needs the flat buffer's wire.TreeSpec — pass "
                "spec=wire.tree_spec(params) (the engine threads its "
                "round TreeSpec here)")
        d = flat2d.shape[1] if n_coords is None else n_coords
        # the range keywords only over ranges: the one-process calls keep
        # their plain forms
        span = ({} if all_sum is None
                else {"all_sum": all_sum, "n_total": n_total})
        if self._use_ef_kernel(sigma):
            e = state["ef"]
            # mean(|g + e|) over the true d, outside the kernel as in the
            # reference
            scale = _mean_abs_rows(flat2d, d, e, **span)
            packed, e, _ = EK.ef_sign_rows(flat2d, e, scale, live=live,
                                           in_place=True)
            return {"packed": packed, "scale": scale}, {**state, "ef": e}
        lo = 0 if tile0 is None else tile0 * ENCODE_TILE
        p = flat2d
        for i, t in enumerate(self.transforms):
            if getattr(t, "needs_tree_spec", False):
                p = t.scale(p, spec, lo)
            elif getattr(t, "stateful", False):
                p = t.pre_encode(p, state, server)
            else:
                p = t.apply(self._stage_key(keys, i), p, d,
                            sigma=sigma if self._sigma_stage == i else None,
                            **({} if all_sum is None
                               else {"all_sum": all_sum, "lo": lo}))
        payload, local = self.codec.encode_with_decode_batch(
            self._stage_key(keys, len(self.transforms)), p, d,
            need_decode=bool(self._stateful_idx),
            sigma=sigma if self._sigma_stage == "codec" else None,
            **({} if tile0 is None else {"tile0": tile0, **span,
                                         "rank_prefix": rank_prefix}))
        if not self._stateful_idx:
            return payload, state
        rows = (_live_rows(p.shape[0], live) if live_rows is None
                else live_rows)
        new_state = dict(state)
        for i in self._stateful_idx:
            new_state.update(self.transforms[i].post_encode(state, p, local,
                                                            rows))
        return payload, new_state

    def check_range_encode(self) -> None:
        """Raise before a grid round's local SGD where its aggregate would
        refuse the pipeline: the robust sign laws (``agg=vote|trimmed|
        median``) count votes under the static 0/1-mask guarantee
        (``RoundContext(weights_are_mask=True)``, which
        ``launch/sharding.round_context`` sets). Every other spec string
        encodes flat ranges (``encode_range``)."""
        c = self.codec
        if isinstance(c, SignCodec) and c.agg != "mean" \
                and not c.weights_are_mask:
            raise ValueError(
                f"agg={c.agg!r} on a grid requires the static "
                f"weights_are_mask guarantee (0/1 participation masks): run "
                f"under RoundContext(weights_are_mask=True)")

    @property
    def scale_weighted(self) -> bool:
        """True when the payload carries a per-client f32 scale that
        weighs the aggregate (the mean_abs wire of EF-SignSGD)."""
        return getattr(self.codec, "scale", "none") == "mean_abs"

    def encode_range(self, keys: torch.Tensor, x2d: torch.Tensor,
                     tile0: int, sigma=None, *,
                     n_coords: Optional[int] = None, state=None,
                     server=None, spec=None,
                     live: Optional[torch.Tensor] = None,
                     live_rows: Optional[Sequence[int]] = None,
                     all_sum: Optional[Callable] = None,
                     rank_prefix: Optional[Callable] = None):
        """``encode_batch`` over flat RANGES:
        (n, 2) client keys and (n, L) f32 rows holding coordinates [lo, lo +
        L), lo = tile0 * 8192, of the clients' whole pseudo-gradients of
        ``n_coords`` true coordinates (lo + L by default); zero past them.
        ``state`` holds the rows' state slots over the same range, ``{slot:
        (n, L)}``, and ``server`` the server slots' range ``{slot: (L,)}``;
        the stages see only the range's true coordinates, so the padding of
        the last range stays zero and feeds no residual. ``spec`` is the
        whole vectors' ``wire.TreeSpec``; ``all_sum`` and ``rank_prefix``
        as in ``encode_batch`` (None: the range is the whole vector). ->
        the payload stack: the byte slice of the whole vectors' on the
        sign wire, the range's entries of the dense f32 wire, or top-k's
        kept pairs in the range with range-local indices."""
        L = x2d.shape[1]
        lo = tile0 * ENCODE_TILE
        d = lo + L if n_coords is None else n_coords
        real = max(0, min(lo + L, d) - lo)
        st = (None if state is None else
              {k: v[:, :real] for k, v in state.items()})
        srv = (None if server is None else
               {k: v[:real] for k, v in server.items()})
        return self.encode_batch(keys, x2d, real, st, live, sigma, srv, spec,
                                 live_rows, tile0=tile0, all_sum=all_sum,
                                 n_total=d, rank_prefix=rank_prefix)[0]

    def stacks_group_payloads(self) -> bool:
        """Whether the sequential group scan stacks the raw payloads and
        reduces them once over all groups x clients (compressed wires), or
        carries the decoded group sums (the dense f32 wire)."""
        return self.wire_format().layout != "dense"

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        return self.codec.aggregate(payload, mask, n_coords, acc)

    def zero_acc(self, payload, n_coords: int) -> torch.Tensor:
        """The zero accumulator of ``aggregate``'s output for one shard's
        payload stack (the reference takes it from ``eval_shape`` of
        ``aggregate``): the flat f32 sum, the (2, d_pad) int32 vote pair,
        or top-k's (n_coords,) or (2, n_coords) f32 scatter sums."""
        return self.codec.zero_acc(payload, n_coords)

    def fold_init(self, payload):
        """The codec's structured streaming carry (a ``wire.SignFoldAcc`` on
        the f32-weighted sign routes), or None: the driver then starts from
        ``zero_acc``."""
        init = getattr(self.codec, "fold_init", None)
        return None if init is None else init(payload)

    def fold_finalize(self, acc):
        """Close a streaming accumulator into what ``decode_sum`` takes: a
        ``SignFoldAcc`` flushes its pending block; a flat sum passes
        through."""
        if isinstance(acc, wire.SignFoldAcc):
            return sign_fold_finalize(acc, self.codec.agg_backend)
        return acc

    def reduce_across_devices(self, acc, group=None):
        """The round's one cross-rank reduce under ``stream(devices=D)``:
        the rank-order sum of every rank's FINALIZED accumulator
        (``wire.reduce_accumulator``; a ``SignFoldAcc``'s pending rows are
        positional, so ``fold_finalize`` runs first) -> the cohort's
        accumulator, the same on every rank."""
        if isinstance(acc, wire.SignFoldAcc):
            raise ValueError("reduce_across_devices takes a finalized "
                             "accumulator: call fold_finalize first")
        return wire.reduce_accumulator(acc, group)

    def _unscale(self, g: torch.Tensor, spec, lo: int = 0) -> torch.Tensor:
        # invert the tree-structured stages (sigma_sched), last stage first
        if not self._needs_spec:
            return g
        if spec is None:
            raise ValueError(
                "pipeline declares a tree-structured stage (sigma_sched): "
                "decode needs the round's wire.TreeSpec — pass spec=")
        for t in reversed(self.transforms):
            if getattr(t, "needs_tree_spec", False):
                g = t.unscale(g, spec, lo)
        return g

    def decode_sum(self, enc_sum, n_live, sigma=None, spec=None, lo: int = 0):
        """Server estimate from the ``aggregate`` output and the live count
        (``sigma``: the dynamic override, for the codec only; ``spec``: the
        round's TreeSpec, required with ``sigma_sched``; ``lo``: the flat
        coordinate of the sum's first entry, a range's on a grid)."""
        sig = sigma if self._sigma_stage == "codec" else None
        return self._unscale(self.codec.decode_sum(enc_sum, n_live,
                                                   sigma=sig), spec, lo)


# ---------------------------------------------------------------------------
# legacy factories
# ---------------------------------------------------------------------------

def Compressor(name: str = "identity") -> Pipeline:
    return Pipeline((), DenseCodec(), name=name)


def ZSignCompressor(name: str = "zsign", z: int = 1, sigma: float = 0.01,
                    **kw) -> Pipeline:
    return Pipeline((), SignCodec(z=z, sigma=sigma, **kw), name=name)


def PackedZSignCompressor(name: str = "zsign_packed", z: int = 1,
                          sigma: float = 0.01, encode_backend: str = "cuda",
                          **kw) -> Pipeline:
    return Pipeline((), SignCodec(z=z, sigma=sigma, dense_kernel=True,
                                  encode_backend=encode_backend, **kw),
                    name=name)


def StoSignCompressor(name: str = "stosign", **kw) -> Pipeline:
    return Pipeline((), SignCodec(z=znoise.Z_INF, sigma_mode="norm", **kw),
                    name=name)


def EFSignCompressor(name: str = "efsign", use_kernel: bool = False,
                     **kw) -> Pipeline:
    return Pipeline((ErrorFeedback(),),
                    SignCodec(scale="mean_abs", use_kernel=use_kernel, **kw),
                    name=name)


def QSGDCompressor(name: str = "qsgd", s: int = 1) -> Pipeline:
    return Pipeline((), QSGDCodec(s=s), name=name)


def TopKCompressor(name: str = "topk", frac: float = 0.01,
                   chunk: int = 65536) -> Pipeline:
    return Pipeline((ErrorFeedback(),), TopKCodec(frac=frac, chunk=chunk),
                    name=name)


def DPGaussianCompressor(name: str = "dpgauss",
                         sigma: float = 1.0) -> Pipeline:
    return Pipeline((DPTransform(noise=sigma),), DenseCodec(), name=name)


_REGISTRY = {
    "identity": Compressor,
    "zsign": ZSignCompressor,
    "zsign_packed": PackedZSignCompressor,
    "stosign": StoSignCompressor,
    "efsign": EFSignCompressor,
    "qsgd": QSGDCompressor,
    "topk": TopKCompressor,
    "dpgauss": DPGaussianCompressor,
}


def available() -> Tuple[str, ...]:
    """Compressor names the port builds (the reference's)."""
    return tuple(sorted(_REGISTRY))
