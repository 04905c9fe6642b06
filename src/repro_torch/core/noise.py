"""z-distribution noise and the counter-based random stream (port of
``repro.core.noise``).

p_z(t) = exp(-t^{2z}/2) / (2*eta_z),   eta_z = 2^{1/(2z)} * Gamma(1 + 1/(2z))
z=1 -> standard Gaussian, z=inf -> Uniform[-1, 1] (eta_inf = 1).

The fused client encode derives every random word from a COUNTER: quarter
counter c of client k gives ``threefry2x32(key_k, (c, 0))``, two words that
feed four coordinates as 16-bit open uniforms. Any tile of the stream can
therefore be generated on its own, in a CUDA block or in a chunk of the
plain version, and both give the reference's exact bits.

Finite z > 1 has no cheap inverse CDF: its encode draws a dense noise
buffer (``sample_z_noise``), each block of NOISE_BLOCK coordinates from a
``torch.Generator`` seeded from ``fold_in`` of the client's key and the
block's index, so a flat range's slice is drawn on its own. That draw
follows the reference's law, not its bits.

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


#: counters per slice where a caller walks a long ``random_bits`` stream
BITS_CHUNK = 1 << 24


def random_bits(key: torch.Tensor, lo: int, hi: int,
                device=None) -> torch.Tensor:
    """Words lo .. hi-1 of ``jax.random.bits(key, (n,))`` (uint32 words in
    int64): word i is ``y0 ^ y1`` of threefry2x32 (20 rounds) on the counter
    (0, i). Any slice can be drawn on its own."""
    k0, k1 = (w.to(device) for w in key_words(key))
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i, KEY_ROUNDS)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> ``jax.random.uniform``'s f32 in [0, 1):
    ``f32((bits >> 9) | 0x3F800000) - 1``."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


#: jax.random.normal's uniform range (lo, 1) in f32: lo is the float after
#: -1 toward 0, and f32(1 - lo) rounds to 2
_NORMAL_LO = -0.99999994039535522
_NORMAL_SCALE = 2.0
_SQRT2_F32 = 1.41421353816986084


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 (fewer than 2^32 values):
    the key's ``random_bits`` over the flat index, ``uniform`` on (lo, 1)
    as jax computes it (``max(lo, u01 * f32(1 - lo) + lo)``), then
    ``sqrt(2) * erfinv``. erfinv and the multiply-add may differ from XLA's
    in the last ulp."""
    shape = tuple(shape)
    n = math.prod(shape)
    u = bits_to_uniform(random_bits(key, 0, n, device))
    u = torch.clamp_min(u * _NORMAL_SCALE + _NORMAL_LO, _NORMAL_LO)
    return (torch.erfinv(u) * _SQRT2_F32).reshape(shape)


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


def u01_to_noise(u: torch.Tensor, z: int) -> torch.Tensor:
    """u in (0,1) -> xi = F_z^{-1}(u), the z-noise inverse CDF (z=inf or 1)."""
    xi = 2.0 * u - 1.0
    if z == 1:
        return math.sqrt(2.0) * torch.erfinv(xi)
    if z <= Z_INF:
        return xi
    raise ValueError(f"u01_to_noise covers z=inf and z=1 only, got {z}")


def counter_noise(key: torch.Tensor, n: int, z: int,
                  tile: int = 8192) -> torch.Tensor:
    """(n,) z-noise values from the counter stream (F_z^{-1} of tile_u01),
    the dense view of the stream the fused encode consumes."""
    if not counter_supported(z):
        raise ValueError(f"counter stream covers z=inf and z=1 only, got {z}")
    k0, k1 = key_words(key)
    n_tiles = -(-n // tile)
    u = torch.cat([tile_u01(k0, k1, t * tile, tile) for t in range(n_tiles)])
    return u01_to_noise(u, z)[:n]


def key_generator(key: torch.Tensor, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a key's two uint32
    words (seed = k0 << 32 | k1): the same key always gives the same draw."""
    k0, k1 = (int(w) & M32 for w in torch.as_tensor(key).reshape(2).tolist())
    gen = torch.Generator(device=torch.device(device or "cpu"))
    return gen.manual_seed((k0 << 32) | k1)


#: coordinates of one block of the dense draw (``sample_z_noise``): block b
#: of a row comes from the generator of ``fold_in(key, b)``
NOISE_BLOCK = 1 << 20


def _z_block(gen: torch.Generator, n: int, z: int,
             device) -> torch.Tensor:
    """n i.i.d. xi_z in f32 from ``gen``."""
    if z <= Z_INF:
        u = torch.rand((n,), generator=gen, device=device)
        return 2.0 * u - 1.0
    if z == 1:
        return torch.randn((n,), generator=gen, device=device)
    k = 1.0 / (2 * z)
    u = torch._standard_gamma(
        torch.full((n,), k, dtype=torch.float32, device=device),
        generator=gen)
    mag = (u * 2.0) ** k
    sign = torch.randint(0, 2, (n,), generator=gen, device=device,
                         dtype=torch.int8)
    return torch.where(sign > 0, mag, -mag)


def sample_z_noise(key: torch.Tensor, shape, z: int, device=None,
                   dtype=torch.float32, lo: int = 0) -> torch.Tensor:
    """Draw i.i.d. xi_z with p.d.f. p_z (Definition 1), block-keyed: the
    row's flat coordinate i lies in block b = i // NOISE_BLOCK, whose
    NOISE_BLOCK values come from the generator of ``fold_in(key, b)``
    (``key_generator``), always drawn whole. So coordinates [lo, lo + n)
    of a row (``lo``: a flat range's first coordinate, the model-sharded
    replica's) are bit for bit the slice of the whole row's draw, on any
    split of the row. The law is the reference's: uniform on [-1, 1) for
    z=inf, standard normal for z=1, and for finite z > 1 ``(2 *
    Gamma(1/(2z)))^(1/(2z))`` with a Rademacher sign. torch cannot
    reproduce jax.random's bits, so the draw matches the reference in
    distribution only."""
    device = torch.device(device or "cpu")
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty((n,), dtype=dtype, device=device)
    if n == 0:
        return out.reshape(shape)
    b0, b1 = lo // NOISE_BLOCK, (lo + n - 1) // NOISE_BLOCK + 1
    bkeys = fold_in(key, torch.arange(b0, b1, dtype=torch.int64)).tolist()
    for b, bk in zip(range(b0, b1), bkeys):
        start = b * NOISE_BLOCK
        a, e = max(lo, start), min(lo + n, start + NOISE_BLOCK)
        blk = _z_block(key_generator(torch.tensor(bk), device),
                       NOISE_BLOCK, z, device)
        out[a - lo:e - lo] = blk[a - start:e - start]
        del blk
    return out.reshape(shape)


def pdf_z(t, z: int) -> torch.Tensor:
    """p_z(t), for tests and benchmarks."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if z <= Z_INF:
        return torch.where(torch.abs(t) <= 1.0, 0.5, 0.0)
    return torch.exp(-(t ** (2 * z)) / 2.0) / (2.0 * eta_z(z))


def expected_sign(x, sigma: float, z: int) -> torch.Tensor:
    """eta_z * sigma * E[Sign(x + sigma*xi_z)], the debiased estimator's
    mean: ``sigma * Psi_z(x/sigma)`` with Psi_z(r) = int_0^r
    exp(-t^{2z}/2) dt (exact for z=inf, a 256-point midpoint rule on
    [0, r] otherwise, as in the reference)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    r = x / sigma
    if z <= Z_INF:
        return sigma * torch.clip(r, -1.0, 1.0)
    n = 256
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    integ = torch.mean(torch.exp(-((r[..., None] * u) ** (2 * z)) / 2.0),
                       dim=-1)
    return sigma * r * integ
