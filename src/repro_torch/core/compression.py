"""Compression pipelines over the flat wire buffer (port of
``repro.core.compression``, the subset the ported paths run).

Ported: the ``SignCodec`` (``zsign`` / ``zsign_packed`` with agg=mean,
sigma_mode=fixed, any z, scale none or mean_abs, the counter-noise and the
dense-noise encodes), the uncompressed ``DenseCodec``, the ``ErrorFeedback``
transform (``ef``, EF-SignSGD), a ``Pipeline`` with its state slots and the
fused EF kernel path, the spec parser and the legacy factories. Every stage,
mode or backend that is not ported raises ``NotImplementedError`` naming its
ROADMAP item.

The round engine hands the pipeline a STACK of client buffers at once —
``encode_batch(keys, flat2d, n_coords, state, live)`` is the reference's
vmap of ``encode`` over clients, written out as a batch dimension: one
encode launch over all rows (kernel E1, C1 or F1 on a card) instead of n.
``aggregate`` is one sign-reduce over the (n, n_bytes) payload stack
(kernel R1 on a card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

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
    "Pipeline", "SignCodec", "DenseCodec", "ErrorFeedback", "RoundContext",
    "Compressor", "ZSignCompressor", "PackedZSignCompressor",
    "EFSignCompressor", "available", "sign_reduce", "parse_spec",
    "AGG_BACKENDS", "ENCODE_BACKENDS",
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


def _signs_rows(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(n, nb) uint8 -> (n, d) f32 of each row's +/-1 signs."""
    signs = wire.unpack_signs(packed).reshape(packed.shape[0], -1)
    return signs[:, :d].to(torch.float32)


def _mean_abs_rows(p2d: torch.Tensor, d: int,
                   e2d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) f32: mean(|p[c, :d] (+ e[c])|) over the TRUE d coordinates of
    each row, one client at a time (no (n, d) temporary)."""
    out = []
    for c in range(p2d.shape[0]):
        row = p2d[c, :d] if e2d is None else p2d[c, :d] + e2d[c]
        out.append(torch.mean(torch.abs(row)))
    return torch.stack(out)


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

    def pre_encode(self, p2d: torch.Tensor, state) -> torch.Tensor:
        """p + e on the (n, d_pad) rows, added IN PLACE over the consumed
        buffer (the residual is (n, d); the tile padding stays zero)."""
        e = state["ef"]
        p2d[:, :e.shape[-1]].add_(e)
        return p2d

    def post_encode(self, state, codec_input: torch.Tensor,
                    local: torch.Tensor):
        del state
        return {"ef": codec_input[:, :local.shape[-1]] - local}


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
                                 need_decode: bool = False):
        del keys
        return p2d, (p2d[:, :n_coords] if need_decode else None)

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        return wire.dense_masked_sum(payload, mask, acc)

    def decode_sum(self, enc_sum, n_live):
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
      scale="mean_abs"   the EF-SignSGD wire: the payload carries ONE f32
                         magnitude (mean |p|) next to the bits, and the
                         aggregation weights become mask * scale.

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
        if self.sigma_mode != "fixed":
            raise NotImplementedError(
                f"sigma_mode={self.sigma_mode!r} (sto-sign) is not yet "
                f"ported ({_QUEUE1} item 4)")
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

    def encode_with_decode_batch(self, keys: torch.Tensor, p2d: torch.Tensor,
                                 n_coords: int, need_decode: bool = False):
        """(n, 2) client keys + (n, d_pad) f32 rows (d_pad a multiple of
        8192, zero past n_coords) -> (payload, local decode or None). The
        payload is the (n, d_pad/8) uint8 stack, with ``{"packed",
        "scale"}`` on the mean_abs wire; ``local`` is the exact (n,
        n_coords) value the server attributes to each client's payload —
        what an ``ef`` transform upstream subtracts to form its residual."""
        n = p2d.shape[0]
        add_noise = self.sigma > 0.0
        sig = torch.full((n,), self.sigma, dtype=torch.float32,
                         device=p2d.device)
        if self.scale == "mean_abs":
            s = _mean_abs_rows(p2d, n_coords)
            dec = None
            if not add_noise:
                # EF-SignSGD proper: noise-free signs, p >= 0 -> +1 as on
                # the wire, so the residual accounts exactly for what the
                # server decodes
                packed = self._pack_rows(keys, p2d, sig)
                if need_decode:
                    sc = s.reshape(n, 1)
                    dec = torch.where(p2d[:, :n_coords] >= 0, sc, -sc)
            else:
                packed = self._encode_bits(keys, p2d, n_coords, sig, True)
                if need_decode:
                    dec = s.reshape(n, 1) * _signs_rows(packed, n_coords)
            return {"packed": packed, "scale": s}, dec
        packed = self._encode_bits(keys, p2d, n_coords, sig, add_noise)
        if not need_decode:
            return packed, None
        factor = znoise.eta_z(self.z) * self.sigma if add_noise else 1.0
        return packed, factor * _signs_rows(packed, n_coords)

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

    def decode_mean(self, flat_mean):
        """mean_abs: the magnitudes are already in the aggregation weights;
        otherwise the Lemma 1 debias by f32(eta_z * sigma)."""
        if self.scale == "mean_abs" or self.sigma <= 0.0:
            return flat_mean
        return flat_mean * (znoise.eta_z(self.z) * self.sigma)

    def decode_sum(self, enc_sum, n_live):
        return self.decode_mean(enc_sum / n_live)


# ---------------------------------------------------------------------------
# spec strings and the pipeline
# ---------------------------------------------------------------------------

_TRANSFORM_SPECS = {"ef": ErrorFeedback}
#: transform stages of the reference and the ROADMAP item that ports them
_TRANSFORMS_UNPORTED = {"dp": "item 8", "cv": "item 11",
                        "sigma_sched": "item 11"}
_CODECS_UNPORTED = {"stosign": "item 4", "qsgd": "item 9", "topk": "item 9"}


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
    ``stage ("|" stage)*``, ``stage := name | name(k=v, ...)``; the last
    stage is the codec. An ``ef`` transform in front of a noise-free mean
    sign codec sets ``scale="mean_abs"`` unless given explicitly:
    ``"ef|zsign"`` IS EF-SignSGD."""
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
            raise ValueError(f"unknown transform stage {name!r} in {spec!r}")
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
            and codec.sigma == 0.0
            and any(isinstance(t, ErrorFeedback) for t in transforms)):
        codec = dataclasses.replace(codec, scale="mean_abs")
    return tuple(transforms), codec


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Transforms + one wire codec; the engine-facing compressor. Build it
    from a spec string (``Pipeline("ef|zsign")``) or from stages
    (``Pipeline((ErrorFeedback(),), SignCodec(scale="mean_abs"))``).

    Stateful stages declare named slots (``state_spec``); the names must be
    unique across stages, and at most one ``ef`` transform is allowed (two
    residuals would double-count the compression error)."""
    transforms: object = ()
    codec: object = None
    name: str = ""

    def __post_init__(self):
        transforms, codec = self.transforms, self.codec
        if isinstance(transforms, str):
            if codec is not None:
                raise ValueError("give either a spec string or stages, "
                                 "not both")
            spec = transforms
            transforms, codec = parse_spec(spec)
            object.__setattr__(self, "name", self.name or spec)
        transforms = tuple(transforms)
        if codec is None:
            raise ValueError("pipeline needs a wire codec as its last stage")
        for t in transforms:
            if not isinstance(t, ErrorFeedback):
                raise NotImplementedError(
                    f"transform stage {type(t).__name__} is not yet ported "
                    f"({_QUEUE1} items 8 and 11)")
        if len(transforms) > 1:
            raise ValueError("at most one ef transform per pipeline")
        object.__setattr__(self, "transforms", transforms)
        object.__setattr__(self, "codec", codec)
        object.__setattr__(self, "name", self.name or self.spec)
        n_random = sum(bool(getattr(t, "randomized", False))
                       for t in transforms + (codec,))
        object.__setattr__(self, "_n_random", n_random)
        object.__setattr__(self, "_stateful_idx", tuple(
            i for i, t in enumerate(transforms)
            if getattr(t, "stateful", False)))
        # slot-name collisions fail here, not deep in the engine
        self.state_slots(0)

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
        scale-weighted (EF) reduce keeps the general LUT path."""
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

    def pad_multiple(self) -> int:
        return self.codec.pad_multiple()

    def state_slots(self, n_coords: int):
        """The StateSlot declarations of the stateful stages, in order."""
        return cstate_lib.collect_slots(
            [self.transforms[i] for i in self._stateful_idx], n_coords)

    def init_state(self, n_coords: int, lead: Tuple[int, ...] = (),
                   device=None, pin_memory: bool = False):
        """Zero per-client state ``{slot: lead + (n_coords,)}`` over the
        client-scope slots (in pinned host memory with ``pin_memory``), or
        None for stateless pipelines."""
        return cstate_lib.init_tree(self.state_slots(n_coords), "client",
                                    lead, device, pin_memory)

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
                and self.codec.sigma == 0.0)

    def encode_batch(self, keys: torch.Tensor, flat2d: torch.Tensor,
                     n_coords: Optional[int] = None, state=None,
                     live: Optional[torch.Tensor] = None):
        """Encode a cohort: (n, 2) client keys, (n, d_pad) f32 rows (zero
        past ``n_coords``, which defaults to d_pad), the per-client state
        ``{slot: (n, n_coords)}`` and the (n,) participation mask ``live``
        -> (payload stack, new state). The rows are consumed: a transform
        may add into them in place. Dead clients (``live <= 0``) keep their
        state rows bit-exactly.

        The fused EF path (``ef|zsign(use_kernel=true)``) is one launch of
        F1 over the cohort, and updates the residual rows IN PLACE (the
        returned state holds the same tensors): at qwen2-0.5B width a
        second (n, d) residual would cost another 15.8 GB."""
        d = flat2d.shape[1] if n_coords is None else n_coords
        if self._ef_kernel_path:
            e = state["ef"]
            # mean(|g + e|) over the true d, outside the kernel as in the
            # reference
            scale = _mean_abs_rows(flat2d, d, e)
            packed, e, _ = EK.ef_sign_rows(flat2d, e, scale, live=live,
                                           in_place=True)
            return {"packed": packed, "scale": scale}, {**state, "ef": e}
        p = flat2d
        for t in self.transforms:
            p = t.pre_encode(p, state)
        payload, local = self.codec.encode_with_decode_batch(
            self._stage_key(keys, len(self.transforms)), p, d,
            need_decode=bool(self._stateful_idx))
        if not self._stateful_idx:
            return payload, state
        new_state = dict(state)
        for i in self._stateful_idx:
            new_state.update(self.transforms[i].post_encode(state, p, local))
        if live is not None:
            new_state = cstate_lib.merge_rows(new_state, state, live)
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

    def decode_sum(self, enc_sum, n_live):
        return self.codec.decode_sum(enc_sum, n_live)


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


def EFSignCompressor(name: str = "efsign", use_kernel: bool = False,
                     **kw) -> Pipeline:
    return Pipeline((ErrorFeedback(),),
                    SignCodec(scale="mean_abs", use_kernel=use_kernel, **kw),
                    name=name)


_REGISTRY = {
    "identity": Compressor,
    "zsign": ZSignCompressor,
    "zsign_packed": PackedZSignCompressor,
    "efsign": EFSignCompressor,
}


def available() -> Tuple[str, ...]:
    """Compressor names the port builds (the reference's other names —
    stosign, qsgd, topk, dpgauss — are not yet ported)."""
    return tuple(sorted(_REGISTRY))
