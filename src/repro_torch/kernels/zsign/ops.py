"""Wrappers of the z-sign CUDA kernels, and their plain PyTorch versions.

Four kernels (sources in ``csrc/``, built by ``repro_torch.kernels.build``):

  ``zsign_encode``        E1, the fused counter-noise sign encode of a stack
                          of clients (replaces the TPU kernels K1/K2,
                          ``compress_rng_pallas`` and
                          ``compress_rng_pallas_batched``)
  ``sign_reduce``         R1, the weighted sign-reduce over the packed client
                          stack (replaces K3, ``sign_reduce_pallas``); its
                          fold mode carries the streaming plan's
                          partition-invariant f32 fold (``sign_fold_step``,
                          ``sign_fold_finalize``)
  ``zsign_compress_rows`` C1, the dense-noise sign encode of a stack of
                          clients (replaces K5, ``compress_pallas``)
  ``unpack_sum``          U1, the unweighted sum of signs over the packed
                          client stack (replaces K6, ``unpack_sum_pallas``)

``zsign_compress`` and ``zsign_decompress_sum`` are the reference's public
ops of the same names (one client of any shape; a stack with a coordinate
count), built on C1 and U1.

Each wrapper takes the plain version for tensors that lie on the CPU and
launches its kernel for CUDA tensors; it never falls back. The launch counter
``<wrapper>.launches`` rises by one per kernel launch and nowhere else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import noise as znoise
from repro_torch.core import wire
from repro_torch.core.wire import SIGN_REDUCE_CLIENT_BLK, pack_bool, pad_to
from repro_torch.kernels.build import check_cuda, launcher, raise_on

TILE = 8192          # elements per encode tile (8 rows x 1024 lanes on TPU)
QUARTER = TILE // 4  # counters per tile: one threefry call feeds 4 elements
CHUNK_TILES = 256    # tiles per chunk of the plain encode

#: encode modes shared with the kernel: noise off, z = inf, z = 1
_MODES = {None: 0, znoise.Z_INF: 1, 1: 2}


def _mode(z) -> int:
    if z is not None and z <= znoise.Z_INF:
        z = znoise.Z_INF
    if z not in _MODES:
        raise ValueError(
            f"the counter encode covers z=inf and z=1; finite z={z} > 1 "
            "takes the dense-noise encode (zsign_compress_rows)")
    return _MODES[z]


# ---------------------------------------------------------------------------
# E1: fused counter-noise sign encode
# ---------------------------------------------------------------------------

def zsign_encode_plain(x2d: torch.Tensor, keys: torch.Tensor,
                       sigma: torch.Tensor, z,
                       tile0: Optional[int] = None) -> torch.Tensor:
    """Plain version of E1: (n, d_pad) f32, (n, 2) int64 key words, (n,)
    f32 sigma -> (n, d_pad/8) uint8; ``tile0`` is the global tile id of the
    rows' first tile (a flat range of the model-sharded replica; None: the
    rows are whole vectors, tile 0 first). Walks the tiles in chunks of
    CHUNK_TILES, so its widest intermediate is (n, CHUNK_TILES * 2048) int64
    counters, never an (n, d) integer surface."""
    n, d_pad = x2d.shape
    if d_pad % TILE:
        raise ValueError(f"d_pad={d_pad} is not a multiple of {TILE}")
    mode = _mode(z)
    tile0 = tile0 or 0
    out = torch.empty((n, d_pad // 8), dtype=torch.uint8, device=x2d.device)
    if mode == 0:
        for s in range(0, d_pad, CHUNK_TILES * TILE):
            e = min(s + CHUNK_TILES * TILE, d_pad)
            out[:, s // 8:e // 8] = pack_bool(x2d[:, s:e] >= 0)
        return out
    z = znoise.Z_INF if mode == 1 else 1
    dev = x2d.device
    k0 = keys[:, 0].to(dev).reshape(n, 1, 1)
    k1 = keys[:, 1].to(dev).reshape(n, 1, 1)
    sig = sigma.to(device=dev, dtype=torch.float32).reshape(n, 1, 1, 1)
    n_tiles = d_pad // TILE
    for t0 in range(0, n_tiles, CHUNK_TILES):
        nt = min(CHUNK_TILES, n_tiles - t0)
        # counters of tiles tile0+t0 .. +nt: (1, nt, 2048), client-local
        c = (tile0 + t0 + torch.arange(nt, device=dev)).reshape(1, nt, 1) \
            * QUARTER \
            + torch.arange(QUARTER, device=dev).reshape(1, 1, QUARTER)
        y0, y1 = znoise.counter_words(k0, k1, c)            # (n, nt, 2048)
        u0, u1 = znoise.halves_to_u01(y0)
        u2, u3 = znoise.halves_to_u01(y1)
        u = torch.stack([u0, u1, u2, u3], dim=2)            # (n, nt, 4, 2048)
        x = x2d[:, t0 * TILE:(t0 + nt) * TILE].reshape(n, nt, 4, QUARTER)
        bits = znoise.stochastic_sign_bits(x, u, sig, z)
        out[:, t0 * TILE // 8:(t0 + nt) * TILE // 8] = \
            pack_bool(bits.reshape(n, nt * TILE))
    return out


def zsign_encode(x2d: torch.Tensor, keys: torch.Tensor, sigma: torch.Tensor,
                 z, tile0: Optional[int] = None) -> torch.Tensor:
    """E1: client-batched fused encode. x2d (n, d_pad) f32 with d_pad a
    multiple of 8192; keys (n, 2) int64 tensor holding each client's two
    uint32 key words; sigma (n,) f32; z in {Z_INF, 1} or None (noise off).
    -> (n, d_pad/8) uint8, each client's bytes exactly those of its own
    n = 1 call (tile ids restart at ``tile0`` for every client: None or 0
    for a whole vector, the global id of a flat range's first tile on the
    model-sharded replica, whose bytes are then that byte slice of the
    whole vector's). ``launches_n1`` counts the launches with n = 1 (the
    sequential-client group scan) and ``launches_range`` those over a flat
    range (``tile0`` given, 0 included)."""
    if x2d.device.type == "cpu":
        return zsign_encode_plain(x2d, keys, sigma, z, tile0)
    mode = _mode(z)
    n, d_pad = x2d.shape
    if d_pad % TILE or d_pad // TILE >= 2 ** 31:
        raise ValueError(f"d_pad={d_pad} must be a multiple of {TILE}")
    if not 1 <= n < 65536:
        raise ValueError(f"n={n} clients is outside the kernel grid")
    keys = keys.to(device=x2d.device, dtype=torch.int64).contiguous()
    sigma = sigma.to(device=x2d.device, dtype=torch.float32).contiguous()
    if keys.shape != (n, 2) or sigma.shape != (n,):
        raise ValueError(f"keys {tuple(keys.shape)} / sigma "
                         f"{tuple(sigma.shape)} do not match n={n}")
    check_cuda(x2d, "x2d", torch.float32)
    out = torch.empty((n, d_pad // 8), dtype=torch.uint8, device=x2d.device)
    fn = launcher("zsign/csrc/zsign_encode.cu", "zsign_encode_launch")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), keys.data_ptr(), sigma.data_ptr(),
                 out.data_ptr(), n, d_pad, mode, int(tile0 or 0),
                 torch.cuda.current_stream().cuda_stream)
    raise_on(err, "zsign_encode")
    zsign_encode.launches += 1
    if n == 1:
        zsign_encode.launches_n1 += 1
    if tile0 is not None:
        zsign_encode.launches_range += 1
    return out


zsign_encode.launches = 0
zsign_encode.launches_n1 = 0
zsign_encode.launches_range = 0


def zsign_encode_fused(x: torch.Tensor, key: torch.Tensor, sigma, *, z,
                       add_noise: bool = True) -> torch.Tensor:
    """One client's fused encode (mirror of the reference's
    ``zsign_encode_fused``): any-shape f32 ``x`` and a (2,) key ->
    uint8 of ceil(x.numel()/8192)*1024 bytes."""
    flat = pad_to(x.reshape(-1).to(torch.float32), TILE)
    sig = torch.as_tensor(sigma, dtype=torch.float32,
                          device=flat.device).reshape(1)
    return zsign_encode(flat.reshape(1, -1), key.reshape(1, 2), sig,
                        z if add_noise else None).reshape(-1)


def element_u01(keys: torch.Tensor, client: torch.Tensor,
                elem: torch.Tensor) -> torch.Tensor:
    """The encode's uniform for element ``elem`` of client ``client`` (both
    int64 index tensors of one shape), without generating its tile."""
    k0 = keys[:, 0].to(elem.device)[client]
    k1 = keys[:, 1].to(elem.device)[client]
    t, e = elem // TILE, elem % TILE
    q, lane = e // QUARTER, e % QUARTER
    y0, y1 = znoise.counter_words(k0, k1, t * QUARTER + lane)
    w = torch.where(q < 2, y0, y1)
    half = torch.where(q % 2 == 1, w >> 16, w & 0xFFFF)
    return (half.to(torch.float32) + 0.5) * 2.0 ** -16


def erf_rule_flips(x2d: torch.Tensor, keys: torch.Tensor,
                   sigma: torch.Tensor, z, got: torch.Tensor,
                   want: torch.Tensor, max_ulps: int = 4,
                   tile0: Optional[int] = None):
    """Compare two encodes of the same inputs bit by bit. Two f32 ``erf``
    implementations (XLA's, torch's, CUDA's) differ by a few ulp, which can
    flip a wire bit only where ``u`` lies within a few ulp of the threshold
    ``1 - P_z(r)``. -> (number of differing bits, number of them farther
    than ``max_ulps`` f32 ulp from the threshold); the second must be 0.
    ``tile0``: the rows' first tile id (a flat range's; None: 0)."""
    diff = (got ^ want).to(x2d.device)
    client, byte = torch.nonzero(diff, as_tuple=True)
    if client.numel() == 0:
        return 0, 0
    bits = (diff[client, byte].unsqueeze(-1)
            >> torch.arange(8, device=x2d.device, dtype=torch.uint8)) & 1
    rows, ks = torch.nonzero(bits, as_tuple=True)
    client, elem = client[rows], byte[rows] * 8 + ks
    u = element_u01(keys, client, elem + (tile0 or 0) * TILE)
    x = x2d[client, elem]
    sig = sigma.to(x2d.device, torch.float32)[client]
    thr = 1.0 - znoise.sign_prob(x * torch.reciprocal(
        torch.clamp_min(sig, 1e-30)), znoise.Z_INF if z <= 0 else z)
    ulp = torch.abs(torch.nextafter(thr, torch.full_like(thr, 2.0)) - thr)
    far = (torch.abs(u - thr) > max_ulps * ulp) | (sig <= 0)
    return int(elem.numel()), int(far.sum())


# ---------------------------------------------------------------------------
# R1: weighted sign-reduce
# ---------------------------------------------------------------------------

def sign_reduce_plain(packed: torch.Tensor, weights: torch.Tensor,
                      acc: Optional[torch.Tensor] = None, *,
                      fold: bool = False) -> torch.Tensor:
    """Plain version of R1, in the kernel's exact order: left fold from +0.0
    over each block of 8 clients, block partials added in order (the first
    initialising), then ``acc + sum``. With ``fold`` the block partials are
    added to the carry ``acc`` instead, ((acc + b0) + b1) + ..., as R1's
    fold mode does (which writes the result over the carry). Padding
    clients of the last block would add -0.0, which changes no partial, so
    they are not visited."""
    n, nb = packed.shape
    w = weights.to(device=packed.device, dtype=torch.float32)
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    total = acc.reshape(nb, 8) if fold else None
    for b0 in range(0, n, SIGN_REDUCE_CLIENT_BLK):
        part = torch.zeros((nb, 8), dtype=torch.float32, device=packed.device)
        for c in range(b0, min(b0 + SIGN_REDUCE_CLIENT_BLK, n)):
            bits = ((packed[c].unsqueeze(-1) >> shifts) & 1).bool()
            part = part + torch.where(bits, w[c], -w[c])
        total = part if total is None else total + part
    out = total.reshape(-1)
    return out if acc is None or fold else acc + out


def _sign_reduce_launch(packed: torch.Tensor, weights: torch.Tensor,
                        acc: Optional[torch.Tensor], out: torch.Tensor,
                        fold: bool) -> None:
    """Launch R1 on card tensors: add mode (``acc`` or None) into a fresh
    ``out``, or fold mode into the carry ``out`` in place."""
    n, nb = packed.shape
    w = weights.to(device=packed.device, dtype=torch.float32).contiguous()
    if w.shape != (n,):
        raise ValueError(f"weights {tuple(w.shape)} do not match n={n}")
    packed = packed.contiguous()
    if packed.data_ptr() % 16:
        # a row slice of a stack whose rows are not a multiple of 16 bytes
        # (the round paths' rows are multiples of 1024 bytes)
        packed = packed.clone()
    check_cuda(packed, "packed", torch.uint8)
    for name, t in (("acc", acc), ("out", out)):
        if t is not None:
            check_cuda(t, name, torch.float32)
            if t.shape != (8 * nb,):
                raise ValueError(f"{name} {tuple(t.shape)} != ({8 * nb},)")
    fn = launcher("zsign/csrc/sign_reduce.cu", "sign_reduce_launch")
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), w.data_ptr(),
                 None if acc is None else acc.data_ptr(), out.data_ptr(),
                 n, nb, int(fold), torch.cuda.current_stream().cuda_stream)
    raise_on(err, "sign_reduce")
    sign_reduce.launches += 1
    if fold:
        sign_reduce.fold_launches += 1


def sign_reduce(packed: torch.Tensor, weights: torch.Tensor,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R1: (n, nb) uint8 payload stack, (n,) f32 weights -> (8*nb,) f32
    weighted sum of the +/-1 signs (plus ``acc`` when given, added last).
    Clients are reduced in zero-weight-padded blocks of 8, bit-exact with
    the reference's ``sign_reduce`` for any f32 weights."""
    if packed.device.type == "cpu":
        return sign_reduce_plain(packed, weights, acc)
    out = torch.empty(8 * packed.shape[1], dtype=torch.float32,
                      device=packed.device)
    _sign_reduce_launch(packed, weights, acc, out, fold=False)
    return out


def _fold_close(rows: torch.Tensor, w: torch.Tensor,
                sums: torch.Tensor) -> torch.Tensor:
    """Close complete 8-row blocks into the carry ``sums``: R1 in fold mode
    (in place) on a card, its plain version on the CPU."""
    if rows.device.type == "cpu":
        return sign_reduce_plain(rows, w, sums, fold=True)
    _sign_reduce_launch(rows, w, None, sums, fold=True)
    return sums


def sign_fold_step(packed: torch.Tensor, weights: torch.Tensor,
                   acc: wire.SignFoldAcc) -> wire.SignFoldAcc:
    """The partition-invariant fold of one shard through R1: the 0-7
    pending rows go in front of the shard's rows, R1 in fold mode closes
    every complete 8-row block into the carry in place, and the remainder
    rows and weights become the new pending block. Bit-identical, as int32
    patterns and zero signs included, to the reference's
    ``_sign_fold_step`` followed by ``sign_fold_finalize``, for any
    partition of the clients into shards. One launch when the shard
    completes a block, none otherwise."""
    return wire._sign_fold_step(packed, weights, acc, close=_fold_close)


def sign_fold_finalize(acc: wire.SignFoldAcc) -> torch.Tensor:
    """Close the pending block (weight-0 padding) through R1 in fold mode,
    -> the (8*nb,) f32 sum; no launch when nothing is pending."""
    return wire.sign_fold_finalize(acc, close=_fold_close)


sign_reduce.launches = 0
#: the subset of R1 launches in fold mode
sign_reduce.fold_launches = 0


# ---------------------------------------------------------------------------
# C1: dense-noise sign encode
# ---------------------------------------------------------------------------

def zsign_compress_rows_plain(x2d: torch.Tensor, noise2d: torch.Tensor,
                              sigma: torch.Tensor) -> torch.Tensor:
    """Plain version of C1: (n, d_pad) f32 x and noise, (n,) f32 sigma ->
    (n, d_pad/8) uint8 of ``x + sigma*noise >= 0``. The product and the sum
    are two tensor ops, each rounded on its own (no multiply-add). Walks
    CHUNK_TILES tiles at a time."""
    n, d_pad = x2d.shape
    if d_pad % TILE or noise2d.shape != x2d.shape:
        raise ValueError(f"x {tuple(x2d.shape)} / noise "
                         f"{tuple(noise2d.shape)}: rows must match and be a "
                         f"multiple of {TILE}")
    sig = sigma.to(device=x2d.device, dtype=torch.float32).reshape(n, 1)
    out = torch.empty((n, d_pad // 8), dtype=torch.uint8, device=x2d.device)
    for s in range(0, d_pad, CHUNK_TILES * TILE):
        e = min(s + CHUNK_TILES * TILE, d_pad)
        y = x2d[:, s:e] + sig * noise2d[:, s:e]
        out[:, s // 8:e // 8] = pack_bool(y >= 0)
    return out


def zsign_compress_rows(x2d: torch.Tensor, noise2d: torch.Tensor,
                        sigma: torch.Tensor) -> torch.Tensor:
    """C1: client-batched dense-noise encode. x2d and noise2d (n, d_pad)
    f32 with d_pad a multiple of 8192 (padded noise zero), sigma (n,) f32
    -> (n, d_pad/8) uint8: bit j of byte i of row c is
    ``x[c, 8i+j] + sigma_c * noise[c, 8i+j] >= 0``."""
    if x2d.device.type == "cpu":
        return zsign_compress_rows_plain(x2d, noise2d, sigma)
    n, d_pad = x2d.shape
    if d_pad % TILE or noise2d.shape != x2d.shape:
        raise ValueError(f"x {tuple(x2d.shape)} / noise "
                         f"{tuple(noise2d.shape)}: rows must match and be a "
                         f"multiple of {TILE}")
    if not 1 <= n < 65536:
        raise ValueError(f"n={n} clients is outside the kernel grid")
    sigma = sigma.to(device=x2d.device, dtype=torch.float32).contiguous()
    if sigma.shape != (n,):
        raise ValueError(f"sigma {tuple(sigma.shape)} does not match n={n}")
    check_cuda(x2d, "x2d", torch.float32)
    check_cuda(noise2d, "noise2d", torch.float32)
    out = torch.empty((n, d_pad // 8), dtype=torch.uint8, device=x2d.device)
    fn = launcher("zsign/csrc/zsign_compress.cu", "zsign_compress_launch")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), noise2d.data_ptr(), sigma.data_ptr(),
                 out.data_ptr(), n, d_pad,
                 torch.cuda.current_stream().cuda_stream)
    raise_on(err, "zsign_compress")
    zsign_compress_rows.launches += 1
    return out


zsign_compress_rows.launches = 0


def zsign_compress(x: torch.Tensor, noise: torch.Tensor,
                   sigma) -> torch.Tensor:
    """Fused noisy sign + bitpack of one client (mirror of the reference's
    ``zsign_compress``): any-shape f32 ``x`` and ``noise`` -> uint8 of
    ceil(x.numel()/8192)*1024 bytes (the zero-padded tail packs as +1)."""
    flat = pad_to(x.reshape(-1).to(torch.float32), TILE)
    nz = pad_to(noise.reshape(-1).to(torch.float32), TILE)
    sig = torch.as_tensor(sigma, dtype=torch.float32,
                          device=flat.device).reshape(1)
    return zsign_compress_rows(flat.reshape(1, -1), nz.reshape(1, -1),
                               sig).reshape(-1)


# ---------------------------------------------------------------------------
# U1: unweighted sign sum
# ---------------------------------------------------------------------------

def unpack_sum_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain version of U1: (n, nb) uint8 -> (8*nb,) f32, the count of set
    bits per coordinate turned into the sum of +/-1 (exact in f32 for
    n < 2^24, as any order of the reference's f32 sum is)."""
    n = packed.shape[0]
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    ones = ((packed.unsqueeze(-1) >> shifts) & 1).sum(0, dtype=torch.int32)
    return (2 * ones - n).to(torch.float32).reshape(-1)


def unpack_sum(packed: torch.Tensor) -> torch.Tensor:
    """U1: (n, nb) uint8 payload stack -> (8*nb,) f32 sum over clients of
    the +/-1 signs, bit-exact with the reference's ``unpack_sum_pallas``."""
    if packed.device.type == "cpu":
        return unpack_sum_plain(packed)
    n, nb = packed.shape
    if not 1 <= n < 2 ** 24:
        raise ValueError(f"n={n} clients: the f32 sum is exact only below "
                         f"2^24")
    packed = packed.contiguous()
    check_cuda(packed, "packed", torch.uint8)
    out = torch.empty(8 * nb, dtype=torch.float32, device=packed.device)
    fn = launcher("zsign/csrc/unpack_sum.cu", "unpack_sum_launch")
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), out.data_ptr(), n, nb,
                 torch.cuda.current_stream().cuda_stream)
    raise_on(err, "unpack_sum")
    unpack_sum.launches += 1
    return out


unpack_sum.launches = 0


def zsign_decompress_sum(packed: torch.Tensor, n_coords: int) -> torch.Tensor:
    """(n_clients, n_bytes) uint8 -> (n_coords,) f32 sum of signs (mirror of
    the reference's ``zsign_decompress_sum``)."""
    return unpack_sum(packed)[:n_coords]
