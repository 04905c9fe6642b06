"""z-distribution noise and the counter-based random stream (port of
``repro.core.noise``).

p_z(t) = exp(-t^{2z}/2) / (2*eta_z),   eta_z = 2^{1/(2z)} * Gamma(1 + 1/(2z))
z=1 -> standard Gaussian, z=inf -> Uniform[-1, 1] (eta_inf = 1).

The fused client encode derives every random word from a COUNTER: quarter
counter c of client k gives ``threefry2x32(key_k, (c, 0))``, two words that
feed four coordinates as 16-bit open uniforms. Any tile of the stream can
therefore be generated on its own, in a CUDA block or in a chunk of the
plain version, and both give the reference's exact bits.

torch has no ``add`` or shifts for ``torch.uint32`` on the CPU, so the plain
threefry works on int64 tensors (or Python ints) that hold uint32 words and
masks every result with ``0xFFFFFFFF``.

PRNG keys are int64 tensors of shape (..., 2) holding the two uint32 words
of a jax key: ``prng_key(s)`` is ``(0, s)`` like ``jax.random.PRNGKey(s)``.
Key derivation matches jax (with ``jax_threefry_partitionable``):
``fold_in(key, i)`` and ``split(key)[i]`` are both threefry2x32 with 20
rounds on the counter ``(0, i)``.
"""
from __future__ import annotations

import math

import torch

Z_INF = 0  # sentinel for z = +inf (uniform noise). Any z <= 0 means infinity.

#: rounds of the encode stream (Random123's smallest BigCrush-clean count)
THREEFRY_ROUNDS = 13
#: rounds of jax's own key derivation (fold_in / split)
KEY_ROUNDS = 20

M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_TINY = 1e-30  # safe-division floor for dynamic sigma == 0
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def counter_supported(z: int) -> bool:
    """True iff the counter-based fused encode covers this z (inf or 1)."""
    return z <= Z_INF or z == 1


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1, rounds: int = THREEFRY_ROUNDS):
    """Threefry-2x32 block cipher on uint32 words held in int64 (or int).

    Random123's round structure: key injection, then rounds in groups of
    four with a subkey injection after each completed group; a trailing
    partial group (13 rounds) ends without one. 20 rounds is jax's PRNG.
    """
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k1, ks2, k0)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    r_idx = 0
    for i in range(5):
        group = min(4, rounds - r_idx)
        for _ in range(group):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, _ROT[r_idx % 8]) ^ x0
            r_idx += 1
        if group < 4:
            break
        x0 = (x0 + ks[i % 3]) & M32
        x1 = (x1 + ks[(i + 1) % 3] + (i + 1)) & M32
        if r_idx >= rounds:
            break
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor of u32 words;
    like jax without 64-bit mode, only the seed's low 32 bits count."""
    return torch.tensor([0, seed & M32], dtype=torch.int64)


def key_words(key: torch.Tensor):
    """(..., 2) key tensor -> (k0, k1) int64 tensors of shape (...)."""
    key = torch.as_tensor(key, dtype=torch.int64)
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for uint32 ``data`` (int or int64
    tensor); broadcasts over data and returns keys of shape data.shape+(2,)."""
    k0, k1 = key_words(key)
    idx = torch.as_tensor(data, dtype=torch.int64) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx, KEY_ROUNDS)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    return fold_in(key, torch.arange(num, dtype=torch.int64))


def client_keys(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Per-client keys by GLOBAL client index: key_j = fold_in(key, j) for
    j in [start, start + n) -> (n, 2). Counter-derived, so client j's key
    never depends on how the driver partitions the cohort."""
    return fold_in(key, start + torch.arange(n, dtype=torch.int64))


def halves_to_u01(bits: torch.Tensor):
    """uint32 words (int64) -> (u_lo, u_hi), centred 16-bit open uniforms
    ``(half + 0.5) * 2^-16`` in f32 (exact: every step is representable)."""
    scale = 2.0 ** -16
    lo = ((bits & 0xFFFF).to(torch.float32) + 0.5) * scale
    hi = ((bits >> 16).to(torch.float32) + 0.5) * scale
    return lo, hi


def counter_words(k0, k1, idx: torch.Tensor):
    """Quarter-counter array idx -> (y0, y1): 2 words = 4 u16 per counter."""
    return threefry2x32(k0, k1, idx, torch.zeros_like(idx))


def tile_u01(k0, k1, start: int, tile: int, device=None) -> torch.Tensor:
    """u01 values for elements [start, start + tile) of client (k0, k1)'s
    stream: a flat (tile,) f32 tensor in four quarters
    ``[lo16(y0) | hi16(y0) | lo16(y1) | hi16(y1)]`` over the global quarter
    counters ``start/4 + [0, tile/4)``. ``start`` is a multiple of 4."""
    q = tile // 4
    c = start // 4 + torch.arange(q, dtype=torch.int64, device=device)
    y0, y1 = counter_words(k0, k1, c)
    u0, u1 = halves_to_u01(y0)
    u2, u3 = halves_to_u01(y1)
    return torch.cat([u0, u1, u2, u3])


def sign_prob(r: torch.Tensor, z: int) -> torch.Tensor:
    """P_z(r) = P(r + xi_z >= 0) = F_z(r), in the reference's f32 order:
    z=inf ``clip(0.5*(r+1), 0, 1)``, z=1 ``0.5*(1 + erf(r*f32(1/sqrt2)))``."""
    if z <= Z_INF:
        return torch.clip(0.5 * (r + 1.0), 0.0, 1.0)
    if z == 1:
        return 0.5 * (1.0 + torch.erf(r * _INV_SQRT2))
    raise ValueError(f"sign_prob covers z=inf and z=1 only, got {z}")


def stochastic_sign_bits(x: torch.Tensor, u: torch.Tensor, sigma,
                         z: int) -> torch.Tensor:
    """Sign(x + sigma * F_z^{-1}(u)) >= 0 as the bool wire bit, computed as
    ``u > 1 - P_z(x * (1/max(sigma, 1e-30)))`` (the inverse-CDF coupling);
    sigma == 0 gives exactly the noise-free ``x >= 0``. ``sigma`` is an f32
    tensor broadcastable against x."""
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    r = x * torch.reciprocal(torch.clamp_min(sig, _TINY))
    noisy = u > (1.0 - sign_prob(r, z))
    return torch.where(sig > 0, noisy, x >= 0)


def eta_z(z: int) -> float:
    """Normalizer eta_z = 2^{1/(2z)} Gamma(1 + 1/(2z)); eta_inf = 1."""
    if z <= Z_INF:
        return 1.0
    return 2.0 ** (1.0 / (2 * z)) * math.gamma(1.0 + 1.0 / (2 * z))
