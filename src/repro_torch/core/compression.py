"""Compression pipelines over the flat wire buffer (port of
``repro.core.compression``, the subset the ported paths run).

Ported: the ``SignCodec`` (``zsign`` / ``zsign_packed`` / ``stosign`` with
agg=mean, sigma_mode fixed or norm, any z, scale none or mean_abs, the
counter-noise and the dense-noise encodes), the uncompressed ``DenseCodec``,
every transform stage (``ef`` error feedback, ``dp`` clip + Gaussian noise,
``cv`` control variates, ``sigma_sched`` per-layer sigma schedule), a
``Pipeline`` with its client and server state slots, the engine's dynamic
(Plateau) sigma, the round's TreeSpec and the fused EF kernel path, the spec
parser and the legacy factories. The codecs that are not ported (``qsgd``,
``topk``) and the robust ``agg=`` modes raise ``NotImplementedError`` naming
their ROADMAP item.

The round engine hands the pipeline a STACK of client buffers at once —
``encode_batch(keys, flat2d, n_coords, state, live)`` is the reference's
vmap of ``encode`` over clients, written out as a batch dimension: one
encode launch over all rows (kernel E1, C1 or F1 on a card) instead of n.
``aggregate`` is one sign-reduce over the (n, n_bytes) payload stack
(kernel R1 on a card). The plain work around the kernels (per-client norms,
the clip, the sigma_sched multiply, the cv rows) runs one row at a time or
in place, so no (n, d) temporary exists beside the cohort buffer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dp as dplib
from repro_torch.core import noise as znoise
from repro_torch.core import wire
from repro_torch.core.context import (AGG_BACKENDS, ENCODE_BACKENDS,
                                      RoundContext, resolve_backend)
from repro_torch.core.wire import WireFormat
from repro_torch.fed import client_state as cstate_lib
from repro_torch.fed.client_state import StateSlot
from repro_torch.kernels.efsign import ops as EK
from repro_torch.kernels.zsign import ops as K

__all__ = [
    "Pipeline", "SignCodec", "DenseCodec", "ErrorFeedback", "DPTransform",
    "ControlVariate", "SigmaSchedule", "RoundContext", "StateSlot",
    "Compressor", "ZSignCompressor", "PackedZSignCompressor",
    "StoSignCompressor", "EFSignCompressor", "DPGaussianCompressor",
    "available", "sign_reduce", "parse_spec", "AGG_BACKENDS",
    "ENCODE_BACKENDS",
]

#: encode tile, in elements (the kernels' tile; payloads are padded to
#: ceil(d/8192)*1024 bytes)
ENCODE_TILE = K.TILE

_QUEUE1 = "ROADMAP queue 1"


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


def sign_fold_finalize(acc: wire.SignFoldAcc,
                       backend: str = "auto") -> torch.Tensor:
    """Close a fold carry (``backend`` as in ``sign_reduce``): R1 in fold
    mode on the kernel route, the LUT fold elsewhere."""
    if resolve_backend("agg", backend, acc.sums.device.type) == "cuda":
        return K.sign_fold_finalize(acc)
    return wire.sign_fold_finalize(acc)


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
                   e2d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) f32: mean(|p[c, :d] (+ e[c])|) over the TRUE d coordinates of
    each row, one client at a time (no (n, d) temporary)."""
    out = []
    for c in range(p2d.shape[0]):
        row = p2d[c, :d] if e2d is None else p2d[c, :d] + e2d[c]
        out.append(torch.mean(torch.abs(row)))
    return torch.stack(out)


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
    why the pipeline refuses count-law decodes under ``cv`` (the port has
    none yet: the robust sign ``agg=`` modes and top-k's ``agg=coord`` are
    ROADMAP items 12 and 9). The corrections and the row updates run one
    client row at a time, IN PLACE over the buffer and the state rows; the
    server variate is updated in place too.
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
              sigma=None) -> torch.Tensor:
        """Clip, then add ``sig * N(0, 1)``, on each row's first n_coords
        entries IN PLACE (``sigma`` is the engine's dynamic override)."""
        if self.clip > 0.0:
            dplib.clip_rows_(p2d, n_coords, self.clip)
        if sigma is not None or self.noise > 0.0:
            sig = self.noise if sigma is None else sigma
            for c in range(p2d.shape[0]):
                xi = znoise.sample_z_noise(keys[c], (n_coords,), 1,
                                           device=p2d.device)
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

    def _mul_leaves(self, x: torch.Tensor, spec, factors) -> torch.Tensor:
        for off, size, f in zip(spec.offsets, self._sizes(spec), factors):
            x[..., off:off + size].mul_(float(f))
        return x

    def scale(self, p: torch.Tensor, spec) -> torch.Tensor:
        """p * m over the last axis, IN PLACE (the padding is untouched)."""
        return self._mul_leaves(p, spec, self.leaf_multipliers(spec))

    def unscale(self, g: torch.Tensor, spec) -> torch.Tensor:
        """g * f32(1 / m) over the last axis, IN PLACE."""
        return self._mul_leaves(g, spec,
                                np.float32(1.0) / self.leaf_multipliers(spec))


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
                                 need_decode: bool = False, sigma=None):
        del keys, sigma
        return p2d, ((lambda c: p2d[c, :n_coords]) if need_decode else None)

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        return wire.dense_masked_sum(payload, mask, acc)

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
        if self.agg != "mean":
            raise NotImplementedError(
                f"agg={self.agg!r} (robust vote aggregation) is not yet "
                f"ported ({_QUEUE1} item 12)")
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

    def _encode_dense(self, keys, x2d, n_coords: int, sig, add_noise: bool):
        """The dense-noise draw (``reference`` backend, and every finite
        z > 1): client c's noise is ``sample_z_noise(keys[c], (d,), z)``,
        zero in the tile padding, as the reference pads it."""
        n, d_pad = x2d.shape
        noise = None
        if add_noise:
            noise = torch.empty_like(x2d)
            noise[:, n_coords:].zero_()
            for c in range(n):
                noise[c, :n_coords] = znoise.sample_z_noise(
                    keys[c], (n_coords,), self.z, device=x2d.device)
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

    def _encode_bits(self, keys, x2d, n_coords: int, sig, add_noise: bool):
        backend = resolve_backend("encode", self.encode_backend,
                                  x2d.device.type)
        if backend == "reference" or (
                add_noise and not znoise.counter_supported(self.z)):
            return self._encode_dense(keys, x2d, n_coords, sig, add_noise)
        z = self.z if add_noise else None
        if backend == "cuda":
            return K.zsign_encode(x2d, keys, sig, z)
        return K.zsign_encode_plain(x2d, keys, sig, z)

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
                                 sigma=None):
        """(n, 2) client keys + (n, d_pad) f32 rows (d_pad a multiple of
        8192, zero past n_coords) -> (payload, local decode or None). The
        payload is the (n, d_pad/8) uint8 stack, with ``{"packed",
        "scale"}`` on the mean_abs wire. The local decode is a function of
        the client index c giving the exact (n_coords,) value the server
        attributes to client c's payload (what an ``ef`` residual subtracts
        and a ``cv`` row adds), made one row at a time so the (n, d) decode
        of a cohort never exists. ``sigma`` is the dynamic override (an f32
        scalar tensor)."""
        n = p2d.shape[0]
        sig0, add_noise = self._noise_gate(sigma)
        if sig0 is None:
            sig = dplib.row_norms(p2d, n_coords)
        elif isinstance(sig0, torch.Tensor):
            sig = sig0.to(device=p2d.device, dtype=torch.float32).reshape(
                1).expand(n).contiguous()
        else:
            sig = torch.full((n,), sig0, dtype=torch.float32,
                             device=p2d.device)
        if self.scale == "mean_abs":
            s = _mean_abs_rows(p2d, n_coords)
            if not add_noise:
                # EF-SignSGD proper: noise-free signs, p >= 0 -> +1 as on
                # the wire, so the residual accounts exactly for what the
                # server decodes
                packed = self._pack_rows(keys, p2d, sig)
                def local(c):
                    return torch.where(p2d[c, :n_coords] >= 0, s[c], -s[c])
            else:
                packed = self._encode_bits(keys, p2d, n_coords, sig, True)
                def local(c):
                    return _decode_row(packed[c], n_coords, s[c])
            return ({"packed": packed, "scale": s},
                    local if need_decode else None)
        packed = self._encode_bits(keys, p2d, n_coords, sig, add_noise)
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
        return sign_reduce(payload, mask, self.agg_backend,
                           weights_are_mask=self.weights_are_mask, acc=acc)

    def fold_init(self, payload):
        """The streaming fold's carry for this codec, or None where a flat
        zero accumulator is exact already. The f32-weighted routes
        (``scale="mean_abs"``, and agg=mean without the 0/1-mask guarantee)
        are order-sensitive, so they get a ``wire.SignFoldAcc`` sized from
        one shard's payload; 0/1-mask sums are integers, exact under any
        association."""
        if not (self.scale == "mean_abs" or not self.weights_are_mask):
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
        return self.decode_mean(enc_sum / n_live, sigma=sigma)


# ---------------------------------------------------------------------------
# spec strings and the pipeline
# ---------------------------------------------------------------------------

_TRANSFORM_SPECS = {"ef": ErrorFeedback, "dp": DPTransform,
                    "cv": ControlVariate, "sigma_sched": SigmaSchedule}
#: transform stages of the reference not yet ported, with their ROADMAP item
#: (every one is ported)
_TRANSFORMS_UNPORTED = {}
_CODECS_UNPORTED = {"qsgd": "item 9", "topk": "item 9"}


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
    for part in filter(None, (p.strip() for p in args.split(","))):
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
    the last is the codec. An ``ef`` transform in front of a noise-free
    fixed-sigma mean sign codec sets ``scale="mean_abs"`` unless given
    explicitly: ``"ef|zsign"`` IS EF-SignSGD (noisy z-sign and sto-sign keep
    their own decode laws)."""
    toks = [t for t in (p.strip() for p in spec.split("|")) if t]
    if not toks:
        raise ValueError("empty pipeline spec")
    transforms = []
    for tok in toks[:-1]:
        name, kw = _parse_stage(tok)
        if name in _TRANSFORMS_UNPORTED:
            raise NotImplementedError(
                f"transform stage {name!r} is not yet ported ({_QUEUE1} "
                f"{_TRANSFORMS_UNPORTED[name]})")
        if name not in _TRANSFORM_SPECS:
            raise ValueError(
                f"unknown transform stage {name!r} in {spec!r}; transforms: "
                f"{sorted(_TRANSFORM_SPECS)} (codecs must come last)")
        transforms.append(_TRANSFORM_SPECS[name](**kw))
    name, kw = _parse_stage(toks[-1])
    if name in _CODECS_UNPORTED:
        raise NotImplementedError(f"codec {name!r} is not yet ported "
                                  f"({_QUEUE1} {_CODECS_UNPORTED[name]})")
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
        # decodes. The count laws that break it (robust sign agg=, top-k
        # agg=coord) are not ported yet (ROADMAP items 12 and 9); the check
        # stands for them.
        linear_needers = [t for t in transforms
                          if getattr(t, "needs_linear_decode", False)]
        if (linear_needers and isinstance(codec, SignCodec)
                and codec.agg != "mean"):
            raise ValueError(
                f"{linear_needers[0].spec_name} control variates require a "
                f"server decode LINEAR in the per-client local decodes (the "
                f"variate update is exact only for mean-law codecs), but the "
                f"sign codec's agg={codec.agg!r} vote law decodes through a "
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
        scale-weighted (EF) reduce keeps the general LUT path. A dynamic
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
                     live_rows: Optional[Sequence[int]] = None):
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
        d) residual would cost another 15.8 GB."""
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
        if self._use_ef_kernel(sigma):
            e = state["ef"]
            # mean(|g + e|) over the true d, outside the kernel as in the
            # reference
            scale = _mean_abs_rows(flat2d, d, e)
            packed, e, _ = EK.ef_sign_rows(flat2d, e, scale, live=live,
                                           in_place=True)
            return {"packed": packed, "scale": scale}, {**state, "ef": e}
        p = flat2d
        for i, t in enumerate(self.transforms):
            if getattr(t, "needs_tree_spec", False):
                p = t.scale(p, spec)
            elif getattr(t, "stateful", False):
                p = t.pre_encode(p, state, server)
            else:
                p = t.apply(self._stage_key(keys, i), p, d,
                            sigma=sigma if self._sigma_stage == i else None)
        payload, local = self.codec.encode_with_decode_batch(
            self._stage_key(keys, len(self.transforms)), p, d,
            need_decode=bool(self._stateful_idx),
            sigma=sigma if self._sigma_stage == "codec" else None)
        if not self._stateful_idx:
            return payload, state
        rows = (_live_rows(p.shape[0], live) if live_rows is None
                else live_rows)
        new_state = dict(state)
        for i in self._stateful_idx:
            new_state.update(self.transforms[i].post_encode(state, p, local,
                                                            rows))
        return payload, new_state

    def stacks_group_payloads(self) -> bool:
        """Whether the sequential group scan stacks the raw payloads and
        reduces them once over all groups x clients (compressed wires), or
        carries the decoded group sums (the dense f32 wire)."""
        return self.wire_format().layout != "dense"

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        return self.codec.aggregate(payload, mask, n_coords, acc)

    def fold_init(self, payload):
        """The codec's structured streaming carry (a ``wire.SignFoldAcc`` on
        the f32-weighted sign routes), or None: the driver then starts from
        a flat zero accumulator."""
        init = getattr(self.codec, "fold_init", None)
        return None if init is None else init(payload)

    def fold_finalize(self, acc):
        """Close a streaming accumulator into what ``decode_sum`` takes: a
        ``SignFoldAcc`` flushes its pending block; a flat sum passes
        through."""
        if isinstance(acc, wire.SignFoldAcc):
            return sign_fold_finalize(acc, self.codec.agg_backend)
        return acc

    def _unscale(self, g: torch.Tensor, spec) -> torch.Tensor:
        # invert the tree-structured stages (sigma_sched), last stage first
        if not self._needs_spec:
            return g
        if spec is None:
            raise ValueError(
                "pipeline declares a tree-structured stage (sigma_sched): "
                "decode needs the round's wire.TreeSpec — pass spec=")
        for t in reversed(self.transforms):
            if getattr(t, "needs_tree_spec", False):
                g = t.unscale(g, spec)
        return g

    def decode_sum(self, enc_sum, n_live, sigma=None, spec=None):
        """Server estimate from the ``aggregate`` output and the live count
        (``sigma``: the dynamic override, for the codec only; ``spec``: the
        round's TreeSpec, required with ``sigma_sched``)."""
        sig = sigma if self._sigma_stage == "codec" else None
        return self._unscale(self.codec.decode_sum(enc_sum, n_live,
                                                   sigma=sig), spec)


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


def DPGaussianCompressor(name: str = "dpgauss",
                         sigma: float = 1.0) -> Pipeline:
    return Pipeline((DPTransform(noise=sigma),), DenseCodec(), name=name)


_REGISTRY = {
    "identity": Compressor,
    "zsign": ZSignCompressor,
    "zsign_packed": PackedZSignCompressor,
    "stosign": StoSignCompressor,
    "efsign": EFSignCompressor,
    "dpgauss": DPGaussianCompressor,
}


def available() -> Tuple[str, ...]:
    """Compressor names the port builds: the reference's, less ``qsgd`` and
    ``topk`` (ROADMAP item 9)."""
    return tuple(sorted(_REGISTRY))
