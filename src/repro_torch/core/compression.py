"""Compression pipelines over the flat wire buffer (port of
``repro.core.compression``, the main-path subset).

Ported: the ``SignCodec`` (``zsign`` / ``zsign_packed`` with agg=mean,
scale=none, sigma_mode=fixed, z in {inf, 1}), the uncompressed
``DenseCodec``, a ``Pipeline`` with no transform stages, the spec parser and
the legacy factories. Every stage, mode or backend that is not ported raises
``NotImplementedError`` naming its ROADMAP item.

The round engine hands the codec a STACK of client buffers at once —
``encode_batch(keys, flat2d)`` is the reference's vmap of ``encode`` over
clients, written out as a batch dimension: one fused-encode launch over all
rows (kernel E1) instead of n. ``aggregate`` is one sign-reduce over the
(n, n_bytes) payload stack (kernel R1 on a card).
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
from repro_torch.kernels.zsign import ops as K

__all__ = [
    "Pipeline", "SignCodec", "DenseCodec", "RoundContext",
    "Compressor", "ZSignCompressor", "PackedZSignCompressor", "available",
    "sign_reduce", "parse_spec",
    "AGG_BACKENDS", "ENCODE_BACKENDS",
]

#: fused-encode tile, in elements (the kernel's tile; payloads are padded
#: to ceil(d/8192)*1024 bytes)
ENCODE_TILE = K.TILE

_QUEUE1 = "ROADMAP queue 1"


def sign_reduce(packed: torch.Tensor, weights: torch.Tensor,
                backend: str = "auto", *, weights_are_mask: bool = False,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted sign-reduce over stacked bitpacked payloads: (n, n_bytes)
    u8 + (n,) f32 -> (8*n_bytes,) f32. ``backend``: ``auto`` (the CUDA
    kernel R1 for tensors on a card, the plain path elsewhere), ``cuda`` (the
    kernel's wrapper) or ``torch`` (``wire.unpack_sum``, or its popcount
    form ``wire.unpack_sum_mask`` under the static 0/1 ``weights_are_mask``
    guarantee). The kernel route adds ``acc`` after the blocked sum."""
    backend = resolve_backend("agg", backend, packed.device.type)
    if backend == "cuda":
        return K.sign_reduce(packed, weights, acc)
    if weights_are_mask:
        return wire.unpack_sum_mask(packed, weights, acc)
    return wire.unpack_sum(packed, weights, acc)


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


# ---------------------------------------------------------------------------
# wire codec stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseCodec:
    """Uncompressed f32 wire (identity / FedAvg baseline)."""
    spec_name = "dense"

    def wire_format(self) -> WireFormat:
        return WireFormat("float32", 32.0, "dense")

    def pad_multiple(self) -> int:
        return 1

    def encode_batch(self, keys, flat2d):
        del keys
        return flat2d

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        return wire.dense_masked_sum(payload, mask, acc)

    def decode_sum(self, enc_sum, n_live):
        return enc_sum / n_live


@dataclasses.dataclass(frozen=True)
class SignCodec:
    """The stochastic-sign wire codec: bitpacked Sign(p + sigma * xi_z) at
    1 bit/coord, counter-noise encode for z in {inf, 1}, reduced on the
    packed bytes, decoded as ``(sum / n_live) * f32(eta_z * sigma)``.
    ``sigma == 0.0`` is vanilla SignSGD (no random stream at all)."""
    z: int = 1
    sigma: float = 0.0
    sigma_mode: str = "fixed"
    scale: str = "none"
    agg_backend: str = "auto"
    encode_backend: str = "auto"
    weights_are_mask: bool = False
    agg: str = "mean"
    spec_name = "zsign"

    def __post_init__(self):
        object.__setattr__(self, "z", _norm_z(self.z))
        if self.sigma_mode != "fixed":
            raise NotImplementedError(
                f"sigma_mode={self.sigma_mode!r} (sto-sign) is not yet "
                f"ported ({_QUEUE1} item 4)")
        if self.scale != "none":
            raise NotImplementedError(
                f"scale={self.scale!r} (the EF-SignSGD wire) is not yet "
                f"ported ({_QUEUE1} item 8)")
        if self.agg != "mean":
            raise NotImplementedError(
                f"agg={self.agg!r} (robust vote aggregation) is not yet "
                f"ported ({_QUEUE1} item 12)")
        if self.sigma > 0.0 and not znoise.counter_supported(self.z):
            raise NotImplementedError(
                f"finite z={self.z} > 1 needs the dense-noise encode and "
                f"kernel K5, not yet ported (ROADMAP queue 2)")
        for kind, b in (("agg", self.agg_backend),
                        ("encode", self.encode_backend)):
            resolve_backend(kind, b)

    def wire_format(self) -> WireFormat:
        return WireFormat("uint8", 1.0, "bitpacked")

    def pad_multiple(self) -> int:
        """The cohort buffer's row length is a multiple of the encode tile,
        so the batched encode reads it without a padded copy."""
        return ENCODE_TILE

    def encode_batch(self, keys: torch.Tensor,
                     flat2d: torch.Tensor) -> torch.Tensor:
        """(n, 2) client keys + (n, d_pad) f32 rows (d_pad a multiple of
        8192) -> (n, d_pad/8) uint8 payload stack: one encode launch. A
        sigma of 0.0 switches the random stream off entirely."""
        n = flat2d.shape[0]
        sig = torch.full((n,), self.sigma, dtype=torch.float32,
                         device=flat2d.device)
        z = self.z if self.sigma > 0.0 else None
        backend = resolve_backend("encode", self.encode_backend,
                                  flat2d.device.type)
        if backend == "cuda":
            return K.zsign_encode(flat2d, keys, sig, z)
        return K.zsign_encode_plain(flat2d, keys, sig, z)

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        del n_coords
        return sign_reduce(payload, mask, self.agg_backend,
                           weights_are_mask=self.weights_are_mask, acc=acc)

    def decode_sum(self, enc_sum, n_live):
        """Lemma 1 debias: the mean sign times f32(eta_z * sigma)."""
        mean = enc_sum / n_live
        return mean * (znoise.eta_z(self.z) * self.sigma) \
            if self.sigma > 0.0 else mean


# ---------------------------------------------------------------------------
# spec strings and the pipeline
# ---------------------------------------------------------------------------

#: transform stages of the reference and the ROADMAP item that ports them
_TRANSFORMS_UNPORTED = {"ef": "item 8", "dp": "item 8", "cv": "item 11",
                        "sigma_sched": "item 11"}
_CODECS_UNPORTED = {"stosign": "item 4", "qsgd": "item 9", "topk": "item 9"}


_CODEC_SPECS = {
    "zsign": SignCodec,
    # the reference pins zsign_packed to its Pallas kernels; the port's
    # encode is the same kernel under both names (auto backend on a card)
    "zsign_packed": SignCodec,
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
    stage is the codec."""
    toks = [t for t in (p.strip() for p in spec.split("|")) if t]
    if not toks:
        raise ValueError("empty pipeline spec")
    for tok in toks[:-1]:
        name, _ = _parse_stage(tok)
        if name in _TRANSFORMS_UNPORTED:
            raise NotImplementedError(
                f"transform stage {name!r} is not yet ported ({_QUEUE1} "
                f"{_TRANSFORMS_UNPORTED[name]})")
        raise ValueError(f"unknown transform stage {name!r} in {spec!r}")
    name, kw = _parse_stage(toks[-1])
    if name in _CODECS_UNPORTED:
        raise NotImplementedError(f"codec {name!r} is not yet ported "
                                  f"({_QUEUE1} {_CODECS_UNPORTED[name]})")
    if name not in _CODEC_SPECS:
        raise ValueError(f"unknown codec stage {name!r} in {spec!r}; "
                         f"codecs: {sorted(_CODEC_SPECS)}")
    return (), _CODEC_SPECS[name](**kw)


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Transforms + one wire codec; the engine-facing compressor. Build it
    from a spec string (``Pipeline("zsign(z=1,sigma=0.5)")``) or from a
    codec (``Pipeline((), SignCodec(...))``). No transform stage is ported
    yet, so ``transforms`` is always empty."""
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
        if tuple(transforms):
            raise NotImplementedError(
                f"transform stages are not yet ported ({_QUEUE1} items 8 "
                f"and 11)")
        if codec is None:
            raise ValueError("pipeline needs a wire codec as its last stage")
        object.__setattr__(self, "transforms", ())
        object.__setattr__(self, "codec", codec)
        object.__setattr__(self, "name", self.name or self.spec)

    @property
    def spec(self) -> str:
        """Canonical spec string (non-default codec fields spelled out)."""
        c = self.codec
        kw = [f"{f.name}={getattr(c, f.name)}"
              for f in dataclasses.fields(c)
              if getattr(c, f.name) != f.default]
        return c.spec_name + (f"({','.join(kw)})" if kw else "")

    def with_context(self, ctx: RoundContext) -> "Pipeline":
        """Rebind the deployment's backend policy onto the sign codec."""
        codec = self.codec
        if isinstance(codec, SignCodec):
            kw = {}
            if ctx.agg_backend is not None:
                kw["agg_backend"] = ctx.agg_backend
            if ctx.encode_backend is not None:
                kw["encode_backend"] = ctx.encode_backend
            if ctx.weights_are_mask:
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

    def encode_batch(self, keys, flat2d):
        """The single random stage takes each raw client key."""
        return self.codec.encode_batch(keys, flat2d)

    def aggregate(self, payload, mask, n_coords: int, acc=None):
        return self.codec.aggregate(payload, mask, n_coords, acc)

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
                          sigma: float = 0.01, **kw) -> Pipeline:
    return Pipeline((), SignCodec(z=z, sigma=sigma, **kw), name=name)


_REGISTRY = {
    "identity": Compressor,
    "zsign": ZSignCompressor,
    "zsign_packed": PackedZSignCompressor,
}


def available() -> Tuple[str, ...]:
    """Compressor names the port builds (the reference's other names —
    stosign, efsign, qsgd, topk, dpgauss — are not yet ported)."""
    return tuple(sorted(_REGISTRY))
