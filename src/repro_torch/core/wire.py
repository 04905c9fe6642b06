"""Flat wire-buffer substrate (port of ``repro.core.wire``): flatten once,
compress flat, unflatten once.

``TreeSpec`` flattens a parameter tree in jax tree order (dict keys sorted)
into one contiguous f32 buffer; the sign codecs bitpack that buffer
little-endian (element 8i+j -> bit j of byte i, ``x >= 0`` -> 1); the server
sums the +/-1 signs straight from the packed bytes (``unpack_sum``: 8x8 bit
transpose, then a per-block 256-entry weighted LUT; ``unpack_sum_mask``:
popcount for 0/1 masks) without a dense (n_clients, d) sign matrix.

The robust sign laws (``agg=vote|trimmed|median``) reduce to the integer
VOTE PAIR (signed count, n_live) of ``vote_accumulator`` and decode through
the closed forms of ``vote_decode``; the sparse COO wire of top-k is summed
by ``scatter_sum_coo``, one client at a time.

Summation order (what makes these bit-exact with the reference and with the
CUDA ``sign_reduce`` kernel): clients in blocks of SIGN_REDUCE_CLIENT_BLK;
within a block a left fold in client order that starts from +0.0; block
partials then added one after another, the first block initialising the sum.
The streaming plan folds shard after shard into one carry: a flat sum for
0/1 masks (integer sums, exact in any order), a ``SignFoldAcc`` for f32
weights (pending rows keep the global 8-client blocks, so the fold is
bit-identical to one call over all clients for any partition into shards).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import torch

from repro_torch.core.tree import Path, tree_paths, tree_set


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One client's uplink payload: wire dtype name, logical bits per model
    coordinate (padding excluded), and layout name."""
    dtype: str
    bits_per_coord: float
    layout: str


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Flatten-once metadata of a parameter tree: leaf paths in jax order,
    their shapes and offsets into the flat buffer."""
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    n_coords: int

    @classmethod
    def from_tree(cls, tree) -> "TreeSpec":
        paths, shapes, offsets, off = [], [], [], 0
        for path, leaf in tree_paths(tree):
            paths.append(path)
            shapes.append(tuple(leaf.shape))
            offsets.append(off)
            off += leaf.numel()
        return cls(paths=tuple(paths), shapes=tuple(shapes),
                   offsets=tuple(offsets), n_coords=off)

    def flatten(self, tree) -> torch.Tensor:
        """tree -> (n_coords,) f32 buffer."""
        return torch.cat([leaf.to(torch.float32).reshape(-1)
                          for _, leaf in tree_paths(tree)])

    def unflatten(self, flat: torch.Tensor) -> dict:
        """(>= n_coords,) buffer -> tree of f32 leaves (views of ``flat``);
        padding past n_coords is never read."""
        tree: dict = {}
        for path, shape, off in zip(self.paths, self.shapes, self.offsets):
            n = 1
            for s in shape:
                n *= s
            tree_set(tree, path, flat[off:off + n].reshape(shape))
        return tree


def tree_spec(tree) -> TreeSpec:
    return TreeSpec.from_tree(tree)


# ---------------------------------------------------------------------------
# sign bitpacking (little-endian bit order)
# ---------------------------------------------------------------------------

def _bit_weights(device) -> torch.Tensor:
    return torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=device)


def pack_bool(bits: torch.Tensor) -> torch.Tensor:
    """bool (..., len % 8 == 0) -> uint8 bitfield (..., len/8)."""
    b = bits.to(torch.uint8).reshape(*bits.shape[:-1], -1, 8)
    return (b * _bit_weights(bits.device)).sum(-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bitfield -> bool of len*8 (bit j of byte i at 8i+j)."""
    return ((packed.reshape(-1, 1) & _bit_weights(packed.device))
            > 0).reshape(-1)


def pack_signs(signs_i8: torch.Tensor) -> torch.Tensor:
    """int8 {-1,+1} (len % 8 == 0) -> uint8 bitfield of len/8."""
    return pack_bool(signs_i8 > 0)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bitfield -> int8 {-1,+1} of len*8 (bit j of byte i at 8i+j)."""
    bits = unpack_bits(packed)
    one = torch.ones((), dtype=torch.int8, device=packed.device)
    return torch.where(bits, one, -one)


def pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    r = (-x.shape[0]) % mult
    return torch.nn.functional.pad(x, (0, r)) if r else x


def pack_flat(flat: torch.Tensor) -> torch.Tensor:
    """(d,) f32 -> bitpacked uint8 of ceil(d/8): bit = flat[i] >= 0 (the
    zero-padded tail packs as +1 bits, never read back)."""
    return pack_bool(pad_to(flat, 8) >= 0)


# Clients per accumulation block; the CUDA sign_reduce kernel folds clients
# in the same blocks, which is what makes it bit-exact with unpack_sum.
SIGN_REDUCE_CLIENT_BLK = 8


def _bit_transpose_blocks(pm: torch.Tensor, n_blocks: int,
                          n_bytes: int) -> torch.Tensor:
    """(n_blocks*8, n_bytes) u8 -> (n_blocks, 8, n_bytes) u8 bitplanes:
    plane k's byte j holds, in bit i, bit k of client i's byte j (three
    butterfly stages over all bytes, Hacker's Delight 7-3)."""
    x = pm.reshape(n_blocks, 2, 2, 2, n_bytes)
    t, b = x[:, 0], x[:, 1]
    x = torch.stack([(t & 0x0F) | ((b & 0x0F) << 4),
                     ((t & 0xF0) >> 4) | (b & 0xF0)], dim=1)
    t, b = x[:, :, 0], x[:, :, 1]
    x = torch.stack([(t & 0x33) | ((b & 0x33) << 2),
                     ((t & 0xCC) >> 2) | (b & 0xCC)], dim=2)
    t, b = x[:, :, :, 0], x[:, :, :, 1]
    x = torch.stack([(t & 0x55) | ((b & 0x55) << 1),
                     ((t & 0xAA) >> 1) | (b & 0xAA)], dim=3)
    return x.reshape(n_blocks, 8, n_bytes)


def _block_luts(wb: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 8) f32 weights -> (n_blocks, 256) tables
    ``LUT[v] = sum_i (bit i of v ? +w_i : -w_i)``, summed as a left fold in
    client order from +0.0 (the reference's in-block order)."""
    v = torch.arange(256, device=wb.device)
    vbits = ((v[:, None] >> torch.arange(8, device=wb.device)) & 1) > 0
    terms = torch.where(vbits[None], wb[:, None, :], -wb[:, None, :])
    lut = torch.zeros(terms.shape[:2], dtype=torch.float32, device=wb.device)
    for i in range(terms.shape[-1]):
        lut = lut + terms[..., i]
    return lut


def _pad_clients(packed: torch.Tensor, weights: torch.Tensor):
    n = packed.shape[0]
    cpad = (-n) % SIGN_REDUCE_CLIENT_BLK
    w = weights.to(torch.float32)
    if cpad:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, cpad))
        w = torch.nn.functional.pad(w, (0, cpad))
    return packed, w, (n + cpad) // SIGN_REDUCE_CLIENT_BLK


def unpack_sum(packed: torch.Tensor, weights: torch.Tensor,
               acc=None):
    """(n_clients, n_bytes) u8, (n_clients,) f32 -> (8*n_bytes,) weighted
    sum of the +/-1 signs (LUT over bit-transposed planes; clients padded to
    blocks of 8 with weight 0).

    ``acc`` is the streaming fold hook: an (8*n_bytes,) f32 partial sum
    continues the left fold ``((acc + b_0) + b_1) + ...`` over this call's
    blocks; a :class:`SignFoldAcc` takes the shard-partition-invariant
    fold (``_sign_fold_step``) and returns the updated carry."""
    if isinstance(acc, SignFoldAcc):
        return _sign_fold_step(packed, weights, acc)
    n_bytes = packed.shape[1]
    packed, w, n_blocks = _pad_clients(packed, weights)
    planes = _bit_transpose_blocks(packed, n_blocks, n_bytes).long()
    lut = _block_luts(w.reshape(n_blocks, SIGN_REDUCE_CLIENT_BLK))
    if acc is None:
        a = lut[0][planes[0]]                     # (8, n_bytes)
        start = 1
    else:
        a = acc.reshape(n_bytes, 8).T
        start = 0
    for b in range(start, n_blocks):
        a = a + lut[b][planes[b]]
    # a[k, byte] is the weighted sum for coordinate byte*8 + k
    return a.T.reshape(-1)


@dataclasses.dataclass(frozen=True)
class SignFoldAcc:
    """Shard-partition-invariant carry of the f32-weighted sign fold (port
    of the reference's ``SignFoldAcc``).

    Clients that do not fill an 8-client block are PARKED as pending wire
    rows and the block is closed, in global client order, only once 8 rows
    exist, so a streamed fold replays the exact additions of one call over
    the concatenated clients, for any partition into shards.

      sums        (8*n_bytes,) f32 closed-block sum in R1's output layout
                  (coordinate 8i+k at [8i+k]); starts at -0.0, the additive
                  identity that keeps every bit pattern (the reference's
                  transposed (8, n_bytes) layout is internal to it)
      pend_bytes  (SIGN_REDUCE_CLIENT_BLK, n_bytes) u8 pending rows; rows
                  >= pend_n are zero
      pend_w      (SIGN_REDUCE_CLIENT_BLK,) f32 their weights (same rule)
      pend_n      number of pending rows, 0..7 (a Python int: the port's
                  shard loop is eager)

    The reference adds -0.0 for each absent block; the port skips it, which
    leaves every bit of the sum as it is. ``sums`` is updated in place by
    the kernel route (``kernels.zsign.ops.sign_fold_step``)."""
    sums: torch.Tensor
    pend_bytes: torch.Tensor
    pend_w: torch.Tensor
    pend_n: int


def sign_fold_init(n_bytes: int, device=None) -> SignFoldAcc:
    """Fresh fold carry for (.., n_bytes) wire rows."""
    blk = SIGN_REDUCE_CLIENT_BLK
    return SignFoldAcc(
        sums=torch.full((8 * n_bytes,), -0.0, dtype=torch.float32,
                        device=device),
        pend_bytes=torch.zeros((blk, n_bytes), dtype=torch.uint8,
                               device=device),
        pend_w=torch.zeros((blk,), dtype=torch.float32, device=device),
        pend_n=0)


def _lut_fold(rows: torch.Tensor, w: torch.Tensor,
              sums: torch.Tensor) -> torch.Tensor:
    """Close the complete 8-row blocks of ``rows`` into ``sums``, in
    order: ((sums + b_0) + b_1) + ..."""
    return unpack_sum(rows, w, acc=sums)


def _sign_fold_step(packed: torch.Tensor, weights: torch.Tensor,
                    acc: SignFoldAcc, close=_lut_fold) -> SignFoldAcc:
    """Fold one shard of (k, n_bytes) wire rows into the carry: the 0..7
    pending rows go in front of the shard's rows, every complete 8-row
    block is closed into ``sums`` by ``close(rows, w, sums)`` (the LUT fold
    here, kernel R1 in fold mode on a card), and the remainder becomes the
    new pending block."""
    blk = SIGN_REDUCE_CLIENT_BLK
    k = packed.shape[0]
    w = weights.to(device=packed.device, dtype=torch.float32)
    if acc.pend_n:
        rows = torch.cat([acc.pend_bytes[:acc.pend_n], packed])
        w = torch.cat([acc.pend_w[:acc.pend_n], w])
    else:
        rows = packed
    total = acc.pend_n + k
    n_full = (total // blk) * blk
    sums = acc.sums
    if n_full:
        sums = close(rows[:n_full], w[:n_full], sums)
    rem = total - n_full
    if rem == 0 and acc.pend_n == 0:
        # nothing pending before or after: the zero block stays as it is
        return dataclasses.replace(acc, sums=sums)
    pend_bytes = torch.zeros_like(acc.pend_bytes)
    pend_w = torch.zeros_like(acc.pend_w)
    pend_bytes[:rem] = rows[n_full:]
    pend_w[:rem] = w[n_full:]
    return SignFoldAcc(sums=sums, pend_bytes=pend_bytes, pend_w=pend_w,
                       pend_n=rem)


def sign_fold_finalize(acc: SignFoldAcc, close=_lut_fold) -> torch.Tensor:
    """Close the pending block (zero-weight padding, as the one-shot call
    pads its last block) and return the (8*n_bytes,) weighted sign sum,
    bit-identical to one ``unpack_sum`` over the concatenated clients, zero
    signs included. Without pending rows the sum is returned as it is."""
    if not acc.pend_n:
        return acc.sums
    return close(acc.pend_bytes, acc.pend_w, acc.sums)


_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)

#: the reference's debug-wire message (``check_mask_membership``)
MASK_MEMBERSHIP_MSG = (
    "debug_wire: mask violates the 0/1 membership contract required by the "
    "popcount/vote paths (weights_are_mask) — found fractional or negative "
    "weights. Use weights_are_mask=False (LUT path) for weighted "
    "aggregation.")


def check_mask_membership(mask) -> None:
    """Runtime assertion of the 0/1 membership contract (debug-wire mode):
    every entry of ``mask`` is exactly 0.0 or 1.0, else ``ValueError`` with
    the reference's message. The reference inserts a checkify check into
    the traced round; the port checks the host mask once a round (a mask
    on the card is read back, which waits for it)."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    if not bool(torch.all((m == 0.0) | (m == 1.0))):
        raise ValueError(MASK_MEMBERSHIP_MSG)


def unpack_sum_mask(packed: torch.Tensor, mask: torch.Tensor,
                    acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_clients, n_bytes) u8, (n_clients,) 0/1 mask -> (8*n_bytes,) f32
    masked sign sum, as ``2*count - sum(mask)`` of set bits over live
    clients (popcount of the bit-transposed planes). Exact integers, so
    bit-identical to ``unpack_sum`` for any 0/1 mask."""
    bitsum = _mask_bit_count(packed, mask).to(torch.float32)
    out = 2.0 * bitsum - mask.to(torch.float32).sum()
    return out if acc is None else acc + out


def _mask_bit_count(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(n_clients, n_bytes) u8 + (n_clients,) 0/1 mask -> (8*n_bytes,)
    per-coordinate count of set bits over the live clients: dead rows
    zeroed, clients padded to blocks of 8, each block bit-transposed, then
    a popcount per plane byte summed over blocks. The cross-block sum is
    uint8 while every settable bit fits, i.e. ``n + (-n) % 8 <= 255``,
    int32 otherwise (the reference's rule)."""
    n, n_bytes = packed.shape
    pm = packed * (mask > 0).to(torch.uint8)[:, None]
    pm, _, n_blocks = _pad_clients(pm, mask)
    planes = _bit_transpose_blocks(pm, n_blocks, n_bytes)
    cnt = _POPCOUNT.to(torch.uint8).to(packed.device)[planes.long()]
    acc_dtype = torch.uint8 if n_blocks * 8 <= 255 else torch.int32
    c = cnt.sum(0, dtype=acc_dtype) if n_blocks > 1 else cnt[0]
    # c[k, byte] counts set bit k over live clients; coordinate byte*8 + k
    return c.T.reshape(-1)


#: robust sign-aggregation laws decodable from the vote pair
VOTE_AGG_MODES = ("mean", "vote", "trimmed", "median")


def vote_accumulator(packed: torch.Tensor, mask: torch.Tensor,
                     acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_clients, n_bytes) u8 + (n_clients,) 0/1 mask -> (2, 8*n_bytes)
    int32 VOTE PAIR: row 0 the signed count ``sum_live sign_i = 2*count -
    n_live``, row 1 ``n_live`` on every coordinate. Both rows are integer
    sums over clients, so ``acc`` (a carried pair) folds shards exactly
    for any partition. The popcount route; ``compression.vote_pair`` takes
    row 0 from the kernel R1 on a card. The 0/1 contract is the caller's
    (the engine checks it under ``debug_wire``)."""
    bitsum = _mask_bit_count(packed, mask).to(torch.int32)
    n_live = mask.sum().to(torch.int32)
    pair = torch.stack([2 * bitsum - n_live, n_live.expand_as(bitsum)])
    return pair if acc is None else acc + pair


#: elements per slice of ``vote_decode`` (bounds its temporaries)
VOTE_DECODE_CHUNK = 1 << 24


def _vote_decode_slice(s: torch.Tensor, n: torch.Tensor, agg: str,
                       trim_f: int) -> torch.Tensor:
    if agg == "mean":
        return s / torch.clamp_min(n, 1.0)
    if agg == "vote":
        return torch.sign(s)
    f_max = torch.floor((torch.clamp_min(n, 1.0) - 1.0) / 2.0)
    f = (f_max if agg == "median"
         else torch.clamp_max(f_max, float(trim_f)))
    c = (s + n) * 0.5
    m = torch.clamp_min(n - 2.0 * f, 1.0)
    plus = torch.minimum(torch.clamp_min(c - f, 0.0), m)
    return torch.where(n > 0, (2.0 * plus - m) / m, 0.0)


def vote_decode(pair: torch.Tensor, agg: str, trim_f: int = 0) -> torch.Tensor:
    """(2, d) int32 vote pair -> (d,) f32 robust aggregate in [-1, 1], the
    reference's closed forms over s = pair[0], n = pair[1], c = (s + n)/2:

      mean        s / max(n, 1)
      vote        sign(s) (0 at a tie)
      trimmed(f)  the mean of the m = n - 2f middle votes, (2*plus - m)/m
                  with plus = clip(c - f, 0, m); an over-trimmed round
                  (n <= 2f) trims f_eff = (n - 1) // 2, the median
      median      trimmed with f = (n - 1) // 2

    All-dead coordinates (n = 0) decode to 0. Every step is an integer
    until the one division, so any f32 evaluation gives the same bits. Runs
    in slices of VOTE_DECODE_CHUNK coordinates."""
    if agg not in VOTE_AGG_MODES:
        raise ValueError(f"unknown vote agg mode {agg!r}; expected one of "
                         f"{VOTE_AGG_MODES}")
    d = pair.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=pair.device)
    for lo in range(0, d, VOTE_DECODE_CHUNK):
        hi = min(lo + VOTE_DECODE_CHUNK, d)
        out[lo:hi] = _vote_decode_slice(pair[0, lo:hi].to(torch.float32),
                                        pair[1, lo:hi].to(torch.float32),
                                        agg, trim_f)
    return out


def dense_masked_sum(payload: torch.Tensor, weights: torch.Tensor,
                     acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Server side of the dense f32 uplink: (n, d) payload, (n,) weights ->
    (d,) weighted sum, a left fold in client order from ``acc`` (or +0.0):
    ((acc + w_0 p_0) + w_1 p_1) + ... . Every plan (one batch, the group
    scan, stream shards) therefore adds the same terms in the same order;
    the reference's einsum order differs (agreement to f32 rounding)."""
    w = weights.to(device=payload.device, dtype=torch.float32)
    out = (torch.zeros(payload.shape[1:], dtype=torch.float32,
                       device=payload.device) if acc is None else acc.clone())
    for c in range(payload.shape[0]):
        out += payload[c].to(torch.float32) * w[c]
    return out


def scatter_sum_coo(values: torch.Tensor, indices: torch.Tensor,
                    weights: torch.Tensor, n_coords: int,
                    acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Server side of the sparse COO uplink: (n, k) f32 values, (n, k)
    int32 indices, (n,) weights -> (n_coords,) f32 weighted scatter-sum.
    Duplicate indices across clients accumulate; dead clients (weight 0)
    add exactly +/-0. ``acc`` is a carried partial sum, updated IN PLACE
    and returned.

    Clients are scattered one after another: within one client the indices
    are unique, so each ``index_add_`` is free of conflicts and
    deterministic on any device, and every coordinate sums ((base + v_0) +
    v_1) + ... in client order, the update order of the reference's
    ``.at[idx].add`` on the CPU."""
    vals = values * weights.to(device=values.device,
                               dtype=values.dtype)[:, None]
    base = (torch.zeros((n_coords,), dtype=torch.float32,
                        device=values.device) if acc is None else acc)
    for c in range(vals.shape[0]):
        base.index_add_(0, indices[c], vals[c])
    return base


def unpack_sum_dense(packed: torch.Tensor, weights: torch.Tensor,
                     acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense-matrix oracle of ``unpack_sum``: the full (n_clients,
    8*n_bytes) f32 sign matrix, then a weighted sum over clients (torch's
    float order, so exact for 0/1 weights and within rounding otherwise).
    No round path calls it unless asked to (agg backend ``dense``)."""
    n = packed.shape[0]
    signs = unpack_signs(packed).reshape(n, -1).to(torch.float32)
    out = torch.einsum("nd,n->d", signs, weights.to(torch.float32))
    return out if acc is None else acc + out


# ---------------------------------------------------------------------------
# the cross-rank reduce of stream(devices=D)
# ---------------------------------------------------------------------------

#: what ``reduce_accumulator`` moved in this process since the last
#: ``reset_reduce_stats``: calls, payload bytes sent and received, and
#: seconds spent inside the calls. Those seconds are not a transfer time:
#: they include the device work queued before the call and the wait for
#: the other ranks (a rank's first receive blocks until the rank before it
#: has finished its own shards); time a reduce after a barrier for a rate
REDUCE_STATS = {"calls": 0, "sent": 0, "received": 0, "seconds": 0.0}


def reset_reduce_stats() -> None:
    REDUCE_STATS.update(calls=0, sent=0, received=0, seconds=0.0)


def rank_world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group`` (the default torch.distributed group
    when None), or (0, 1) where no group is initialized."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def reduce_bytes_per_rank(acc_bytes: int, world: int) -> int:
    """Bytes the busiest rank sends plus receives in one
    ``reduce_accumulator`` of an ``acc_bytes`` accumulator: 2 messages at
    either end of the chain, 4 in its middle."""
    if world <= 1:
        return 0
    return acc_bytes * (2 if world == 2 else 4)


#: the cross-rank reduce moves its accumulator in pieces of at most this
#: many bytes: the pinned staging buffer stays small, and no message nears
#: the 2 GiB of a signed 32-bit size
REDUCE_CHUNK_BYTES = 256 << 20


def reduce_accumulator(acc: torch.Tensor, group=None) -> torch.Tensor:
    """Cross-rank sum of a wire ACCUMULATOR over a torch.distributed group
    (the port of the reference's ``psum_accumulator``): the flat f32 sum,
    the (2, d_pad) int32 vote pair, top-k's (2, d) value/count carry, the
    dense f32 wire, or the (1,) round loss. -> the sum, on every rank.

    The ranks fold IN RANK ORDER, ((a_0 + a_1) + a_2) + ...: rank r
    receives the running sum from rank r - 1, adds its own accumulator and
    sends the result on to rank r + 1; the total then walks back down the
    chain from the last rank to rank 0. So the float order is fixed
    whatever the backend, integer sums (0/1 masks, vote pairs) are exact,
    and each rank sends and receives at most 4 accumulators
    (``reduce_bytes_per_rank``): O(d), not the O(D * d) of an all-gather
    or of a broadcast whose root sends one copy to each rank. Both walks go
    in pieces of ``REDUCE_CHUNK_BYTES``. Gloo carries host bytes only: a
    CUDA accumulator is staged through one pinned host buffer of a piece,
    and the adds stay on its device. Counts into ``REDUCE_STATS``."""
    flat = acc.reshape(-1)
    return _rank_chain([lambda lo, hi: flat[lo:hi]], flat, group,
                       False).reshape(acc.shape)


def fold_rows_over_ranks(rows: torch.Tensor, weights: torch.Tensor,
                         group=None) -> torch.Tensor:
    """The dense f32 wire's client sum over the ranks of a client group:
    rank r holds the (G, L) rows of clients g * W + r (W ranks) and their
    (G,) weights -> ``dense_masked_sum`` of all G * W rows in GLOBAL client
    order, ((0 + w_0 p_0) + w_1 p_1) + ..., the same bits on every rank. The
    running sum walks the chain G times (rank W - 1 hands lap g on to rank
    0's lap g + 1) and the total walks back down, in the pieces and
    staging of ``reduce_accumulator``: the one-process fold, term for
    term, at G * W sequential hops of an (L,) piece."""
    w = weights.to(device=rows.device, dtype=torch.float32)
    terms = [lambda lo, hi, g=g: rows[g, lo:hi].to(torch.float32) * w[g]
             for g in range(rows.shape[0])]
    return _rank_chain(terms, rows[0], group, True)


def _rank_chain(terms, like: torch.Tensor, group, from_zero: bool):
    """The rank-order chain of ``reduce_accumulator`` over ``len(terms)``
    laps: ``terms[g](lo, hi)`` is this rank's piece [lo, hi) of lap g; the
    running sum starts at rank 0's first term (plus +0.0 where
    ``from_zero``), passes rank r - 1 -> r within a lap and the last rank
    -> rank 0 between laps; the total comes back down. -> the (n,) sum on
    every rank."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    rank, world = rank_world(group)
    laps = len(terms)
    if world == 1 and laps == 1 and not from_zero:
        return terms[0](0, like.numel())
    peer = ((lambda r: r) if group is None
            else (lambda r: dist.get_global_rank(group, r)))
    dtype, dev = like.dtype, like.device
    size = like.element_size()
    n = like.numel()
    staged = like.is_cuda and world > 1 and dist.get_backend(group) == "gloo"
    step = max(1, REDUCE_CHUNK_BYTES // size)
    host = (torch.empty((min(step, n),), dtype=dtype, pin_memory=True)
            if staged else None)

    def recv(src, m):
        buf = host[:m] if staged else torch.empty((m,), dtype=dtype,
                                                  device=dev)
        dist.recv(buf, src=peer(src), group=group)
        REDUCE_STATS["received"] += m * size
        return buf.to(dev) if staged else buf

    def send(piece, dst):
        if staged:                        # synchronous: the bytes are ready
            piece = host[:piece.numel()].copy_(piece)
        dist.send(piece.contiguous(), dst=peer(dst), group=group)
        REDUCE_STATS["sent"] += piece.numel() * size

    out = torch.empty((n,), dtype=dtype, device=dev)
    pieces = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
    for lo, hi in pieces:                 # the running sum, up the chain
        for g, term in enumerate(terms):
            if rank == 0 and g == 0:
                piece = term(lo, hi)
                if from_zero:
                    piece = torch.zeros_like(piece) + piece
            else:
                piece = (piece if world == 1 else
                         recv((rank - 1) % world, hi - lo)) + term(lo, hi)
            if rank == world - 1 and g == laps - 1:
                out[lo:hi] = piece
            elif world > 1:
                send(piece, (rank + 1) % world)
    for lo, hi in pieces:                 # the total, back down
        if rank < world - 1:
            out[lo:hi] = recv(rank + 1, hi - lo)
        if rank > 0:
            send(out[lo:hi], rank - 1)
    if staged:
        torch.cuda.current_stream(dev).synchronize()
    REDUCE_STATS["calls"] += 1
    REDUCE_STATS["seconds"] += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the model-sharded replica's wire on flat ranges
# ---------------------------------------------------------------------------

def flat_ranges(n_coords: int, parts: int,
                tile: int = 8192) -> Tuple[Tuple[int, int], ...]:
    """The TreeSpec-flattened coordinates [0, d_pad) (d padded to ``tile``)
    split into ``parts`` contiguous ranges, one per replica rank: range r
    starts on a tile boundary and holds a whole number of tiles (the last
    ones may hold fewer, or none)."""
    n_tiles = -(-n_coords // tile)
    per = -(-n_tiles // parts)
    return tuple((min(r * per, n_tiles) * tile,
                  min((r + 1) * per, n_tiles) * tile) for r in range(parts))


@dataclasses.dataclass(frozen=True)
class _LeafShards:
    """One leaf of the flat vector cut into ``n`` shards along one or two
    dimensions. Shard k's elements, in its local (row-major) order, lie in
    ``groups`` groups of G leaf positions; in each group they are R rows of
    ``cw`` elements at a row stride of W, from leaf position g*G +
    row0(k) + col0(k) on. So local element t = g*R*cw + i*cw + w sits at g*G
    + row0(k) + i*W + col0(k) + w.

    Cut along one dimension d into n (post = the elements past d): one
    group, R = numel / W rows, W = shape[d] * post, cw = W / n, row0 = 0,
    col0 = k * cw. Cut along d1 < d2 into n1 x n2 (shard k = k1 * n2 + k2;
    mid = the elements between d1 and d2; an MoE expert tensor (L, E, D, F)
    cut along E and F): a group per index before d1, G = shape[d1] * mid *
    W, R = shape[d1] / n1 * mid, W = shape[d2] * post, cw = W / n2, row0 =
    k1 * R * W, col0 = k2 * cw."""
    offset: int
    numel: int
    n: int          # shards
    W: int          # row stride (leaf positions)
    cw: int         # one shard's elements per row
    G: int          # group stride (leaf positions)
    R: int          # rows per group of one shard
    n2: int = 1     # shards along the inner dimension (two cut dims)

    @classmethod
    def of(cls, offset: int, shape, cuts=()) -> "_LeafShards":
        """``cuts``: ((dim, shards), ...), in dimension order, at most
        two."""
        numel = math.prod(shape)
        cuts = tuple((d, n) for d, n in cuts if n > 1)
        if not cuts:
            w = max(numel, 1)
            return cls(offset, numel, 1, w, w, w, 1)
        if len(cuts) > 2:
            raise ValueError(f"a leaf cut along {len(cuts)} dimensions")
        d2, n2 = cuts[-1]
        W = math.prod(shape[d2:])
        cw = W // n2
        if len(cuts) == 1:
            return cls(offset, numel, n2, W, cw, max(numel, 1),
                       numel // W, n2)
        d1, n1 = cuts[0]
        mid = math.prod(shape[d1 + 1:d2])
        return cls(offset, numel, n1 * n2, W, cw, shape[d1] * mid * W,
                   shape[d1] // n1 * mid, n2)

    def base(self, k: int) -> Tuple[int, int]:
        """(row0, col0) of shard k."""
        k1, k2 = divmod(k, self.n2)
        return k1 * self.R * self.W, k2 * self.cw

    def count_before(self, k: int, x: int) -> int:
        """Shard k's elements at leaf positions below ``x``."""
        row0, col0 = self.base(k)
        g, rem = divmod(x, self.G)
        y = rem - row0
        if y <= 0:
            return g * self.R * self.cw
        i, c = divmod(y, self.W)
        inside = self.R * self.cw if i >= self.R else \
            i * self.cw + min(max(c - col0, 0), self.cw)
        return g * self.R * self.cw + inside

    def position(self, k: int, t):
        """The leaf position of shard k's local element ``t`` (an int or
        an int64 tensor)."""
        row0, col0 = self.base(k)
        per = self.R * self.cw
        g, u = t // per, t % per
        return g * self.G + row0 + (u // self.cw) * self.W + col0 \
            + u % self.cw

    def blocks(self, k: int, t0: int, t1: int):
        """Shard k's local elements [t0, t1) as blocks (t, nrows, width,
        p): ``nrows`` rows of ``width`` from local t on, at leaf positions p
        + row * W + [0, width); at most two partial rows and one block a
        group."""
        out, t = [], t0
        while t < t1:
            i, w = divmod(t, self.cw)
            p = self.position(k, t)
            if w or t1 - t < self.cw:
                width = min(self.cw - w, t1 - t)
                out.append((t, 1, width, p))
                t += width
            else:
                nrows = min((t1 - t) // self.cw, self.R - i % self.R)
                out.append((t, nrows, self.cw, p))
                t += nrows * self.cw
        return out


class RangeLayout:
    """The re-layout between one client's parameter shards on the replica
    ranks of a grid (each leaf cut along its spec's dimensions over their
    axes, ``leaf_shards`` giving each leaf's ``launch/sharding.spec_dims``,
    and replicated over the other replica axes) and the flat ranges of
    ``flat_ranges`` (replica rank r holds coordinates [lo_r, hi_r) in f32).
    A leaf cut along two dimensions (an expert tensor of the big plan) maps
    a shard onto one strided block of the range a layer.

    ``to_range`` moves each rank's per-leaf shards (the pseudo-gradient)
    into its flat range and ``from_range`` moves a range (the decoded
    update) back onto the shards, each as one ``all_to_all_single``
    exchange over the replica group (in pieces of at most
    REDUCE_CHUNK_BYTES a rank, staged through pinned memory under gloo;
    ``launch/hints.all_to_all``). Each is O(d / R) a rank: no rank holds a
    (d,) vector or the whole tree. A leaf replicated over some replica axes
    reaches range r from the holder that shares r's coordinates on those
    axes (itself, for a fully replicated leaf)."""

    def __init__(self, spec: TreeSpec, leaf_shards, grid, replica_axes,
                 tile: int = 8192):
        self.spec = spec
        self.replica_axes = grid.axes(replica_axes)
        names = self.replica_axes
        sizes = [grid.shape[a] for a in names]
        self.R = 1
        for s in sizes:
            self.R *= s
        self.group = grid.group(names)
        self.me = grid.index(names)
        self.ranges = flat_ranges(spec.n_coords, self.R, tile)
        # replica rank j's coordinates over the replica axes
        coords = []
        for j in range(self.R):
            c, rem = {}, j
            for a, s in reversed(list(zip(names, sizes))):
                c[a] = rem % s
                rem //= s
            coords.append(c)
        self.leaves = []
        self._shard_of = []        # [leaf][replica rank] -> shard index
        self._src = []             # [leaf][dest rank][shard] -> source
        for dims, shape, off in zip(leaf_shards, spec.shapes,
                                    spec.offsets):
            dims = [(d, grid.axes(a)) for d, a in dims]
            axes = tuple(a for _, ax in dims for a in ax)
            self.leaves.append(_LeafShards.of(
                off, shape, [(d, math.prod(grid.shape[a] for a in ax))
                            for d, ax in dims]))
            # the shard index k = k1 * n2 + k2 over the cut dimensions
            shard_of = []
            for c in coords:
                k = 0
                for _, ax in dims:
                    k = k * math.prod(grid.shape[a] for a in ax) \
                        + grid.index_of(c, ax)
                shard_of.append(k)
            self._shard_of.append(shard_of)
            src = []
            for r in range(self.R):
                row = {}
                for j in range(self.R):
                    same = all(coords[j][a] == coords[r][a]
                               for a in names if a not in axes)
                    if same:
                        row[shard_of[j]] = j
                src.append(row)
            self._src.append(src)
        # this rank's streams only (O(R) pairs, not R^2): (sends, receives)
        me, ranks = self.me, range(self.R)
        self._fwd = ([self._fwd_segments(me, r) for r in ranks],
                     [self._fwd_segments(j, me) for j in ranks])
        self._bwd = ([self._bwd_segments(me, j) for j in ranks],
                     [self._bwd_segments(r, me) for r in ranks])
        self._pieces = {"to_range": self._n_pieces(self._most(True)),
                        "from_range": self._n_pieces(self._most(False))}

    @property
    def bounds(self) -> Tuple[int, int]:
        return self.ranges[self.me]

    def flat_coords(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The flat coordinates of this rank's local elements ``t`` (int64)
        of its shard of leaf i."""
        leaf = self.leaves[i]
        return leaf.offset + leaf.position(self._shard_of[i][self.me], t)

    def _run(self, i: int, k: int, r: int) -> Tuple[int, int]:
        """Shard k of leaf i's local run inside range r."""
        leaf = self.leaves[i]
        lo, hi = self.ranges[r]
        x0 = min(max(lo - leaf.offset, 0), leaf.numel)
        x1 = min(max(hi - leaf.offset, 0), leaf.numel)
        return leaf.count_before(k, x0), leaf.count_before(k, x1)

    def _fwd_segments(self, j: int, r: int):
        """(leaf, t0, t1) of stream j -> r of ``to_range``."""
        out = []
        for i in range(len(self.leaves)):
            k = self._shard_of[i][j]
            if self._src[i][r].get(k) != j:
                continue
            t0, t1 = self._run(i, k, r)
            if t1 > t0:
                out.append((i, t0, t1))
        return out

    def _bwd_segments(self, r: int, j: int):
        """(leaf, t0, t1) of stream r -> j of ``from_range``."""
        out = []
        for i in range(len(self.leaves)):
            t0, t1 = self._run(i, self._shard_of[i][j], r)
            if t1 > t0:
                out.append((i, t0, t1))
        return out

    @staticmethod
    def _length(segs) -> int:
        return sum(t1 - t0 for _, t0, t1 in segs)

    def _most(self, to_range: bool) -> int:
        """The most f32 elements any replica rank sends or receives in one
        exchange, the same on every rank: a rank's shards (every shard
        element goes to one range in ``to_range`` and comes from one in
        ``from_range``), a range's coordinates (``to_range`` receives each
        once), and, in ``from_range``, a range's elements of each leaf
        times the replica ranks that hold each of them."""
        shards = sum(leaf.numel // leaf.n for leaf in self.leaves)
        most = shards
        for lo, hi in self.ranges:
            if to_range:
                most = max(most, min(hi, self.spec.n_coords)
                           - min(lo, self.spec.n_coords))
                continue
            sent = 0
            for leaf in self.leaves:
                x0 = min(max(lo - leaf.offset, 0), leaf.numel)
                x1 = min(max(hi - leaf.offset, 0), leaf.numel)
                sent += (x1 - x0) * (self.R // leaf.n)
            most = max(most, sent)
        return most

    @staticmethod
    def _n_pieces(most: int) -> int:
        """Pieces of an exchange: a piece's send and receive bytes stay
        under REDUCE_CHUNK_BYTES on every rank."""
        return max(1, -(-4 * most // REDUCE_CHUNK_BYTES))

    @staticmethod
    def _cut(segs, p: int, P: int):
        """Piece p of P of a stream: its (leaf, t0, t1) sub-segments."""
        n = RangeLayout._length(segs)
        u0, u1 = n * p // P, n * (p + 1) // P
        out, pos = [], 0
        for i, t0, t1 in segs:
            a, b = max(u0 - pos, 0), min(u1 - pos, t1 - t0)
            if b > a:
                out.append((i, t0 + a, t0 + b))
            pos += t1 - t0
        return out

    def _exchange(self, streams, pack, unpack, device, use: str) -> None:
        from repro_torch.launch import hints
        P = self._pieces[use]
        for p in range(P):
            sends = [self._cut(seg, p, P) for seg in streams[0]]
            recvs = [self._cut(seg, p, P) for seg in streams[1]]
            parts = [pack(self.me, r, s) for r in range(self.R)
                     for s in sends[r]]
            send = (torch.cat(parts) if parts else
                    torch.empty((0,), dtype=torch.float32, device=device))
            in_splits = [self._length(s) for s in sends]
            out_splits = [self._length(s) for s in recvs]
            if self.group is None:
                recv = send
            else:
                recv = torch.empty((sum(out_splits),), dtype=torch.float32,
                                   device=device)
                hints.all_to_all(recv, send, out_splits, in_splits,
                                 self.group, use)
            pos = 0
            for j in range(self.R):
                for i, t0, t1 in recvs[j]:
                    unpack(j, i, t0, t1, recv[pos:pos + t1 - t0])
                    pos += t1 - t0

    def to_range(self, shards, out: Optional[torch.Tensor] = None):
        """This rank's per-leaf shards (in TreeSpec order, any float dtype)
        -> its flat range, a (hi - lo,) f32 buffer (``out`` if given);
        coordinates past n_coords are 0."""
        lo, hi = self.bounds
        flat = [s.reshape(-1) for s in shards]
        device = flat[0].device
        if out is None:
            out = torch.empty((hi - lo,), dtype=torch.float32, device=device)
        if hi > self.spec.n_coords:
            out[max(self.spec.n_coords - lo, 0):].zero_()

        def pack(j, r, seg):
            i, t0, t1 = seg
            return flat[i][t0:t1].to(torch.float32)

        def unpack(j, i, t0, t1, vals):
            leaf = self.leaves[i]
            k = self._shard_of[i][j]
            for t, nrows, width, p in leaf.blocks(k, t0, t1):
                dst = torch.as_strided(out, (nrows, width), (leaf.W, 1),
                                       out.storage_offset() + leaf.offset
                                       + p - lo)
                dst.copy_(vals[t - t0:t - t0 + nrows * width].view(
                    nrows, width))

        self._exchange(self._fwd, pack, unpack, device, "to_range")
        return out

    def from_range(self, rng: torch.Tensor, shard_shapes):
        """A (hi - lo,) f32 range (the decoded update) -> this rank's
        per-leaf f32 shards of ``shard_shapes`` (TreeSpec order)."""
        lo, _ = self.bounds
        outs = [torch.empty(tuple(s), dtype=torch.float32,
                            device=rng.device) for s in shard_shapes]
        flat = [o.reshape(-1) for o in outs]

        def pack(r, j, seg):
            i, t0, t1 = seg
            leaf = self.leaves[i]
            k = self._shard_of[i][j]
            parts = []
            for t, nrows, width, p in leaf.blocks(k, t0, t1):
                src = torch.as_strided(rng, (nrows, width), (leaf.W, 1),
                                       rng.storage_offset() + leaf.offset
                                       + p - lo)
                parts.append(src.reshape(-1))
            return torch.cat(parts)

        def unpack(r, i, t0, t1, vals):
            flat[i][t0:t1].copy_(vals)

        self._exchange(self._bwd, pack, unpack, rng.device, "from_range")
        return outs
