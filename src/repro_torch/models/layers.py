"""Shared layers (port of ``repro.models.layers``): RMSNorm, RoPE, GQA
attention (single-block and KV-chunked flash for training, one-token decode
against a KV cache), SwiGLU MLP, the capacity-based top-k MoE and the
sequence-chunked cross entropy.

Layer parameters are stacked over depth (leading dim L) with the reference's
names and layouts, so a parameter tree carries across the two packages as it
is. Under a grid (``launch/hints.py``) attention is sequence-parallel as
the reference's is: queries stay on this rank's slice, the GQA K/V are
gathered along the sequence at kv-head width in their stored dtype, and the
causal mask and RoPE take global positions; a decode step attends over
this rank's slice of the KV cache and folds its softmax statistics and
V products with the other sequence ranks' (``hints.softmax_stats``,
``sum_slots``); off a grid the hints are the identity. Matmuls whose
reference asks for an f32 result (``preferred_element_type``) run on f32
copies of their operands.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.launch import hints


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32,
          device="cpu") -> torch.Tensor:
    """N(0, scale^2) weights drawn from ``gen`` in f32, cast to ``dtype`` on
    ``device``; on the ``meta`` device an empty tensor of that shape and
    dtype (``gen`` unused), so a tree's shapes need no allocation."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else (
        1.0 / (shape[-2] ** 0.5) if len(shape) >= 2 else 1.0)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


def meta_shapes(init_params, cfg) -> dict:
    """The shapes of ``init_params(gen, cfg, device)``'s tree, from a
    ``meta``-device build: nothing is allocated at any width."""
    return tree_map(lambda t: tuple(t.shape),
                    init_params(None, cfg, device="meta"))


def unstack(tree, n: int) -> list:
    """A tree of depth-stacked tensors -> ``n`` per-index trees, one
    ``unbind`` per leaf: its backward is a single stack, where indexing
    each layer would zero-fill and add into the whole stack once a
    layer."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(d_head: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    sliding_window: int = 0   # 0 => full causal
    rope_theta: float = 1e4
    q_chunk: int = 512        # above this length: KV-chunked flash attention
    causal: bool = True


def attn_init(gen, cfg: AttnCfg, n_layers: int, dtype, device="cpu"):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": _init(gen, (n_layers, D, H * hd), dtype=dtype, device=device),
        "wk": _init(gen, (n_layers, D, K * hd), dtype=dtype, device=device),
        "wv": _init(gen, (n_layers, D, K * hd), dtype=dtype, device=device),
        "wo": _init(gen, (n_layers, H * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((n_layers, width), dtype=dtype,
                                  device=device)
    return p


def _qkv(x, lp, cfg: AttnCfg, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, K, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, K, hd)


def _causal_mask(q_pos, k_pos, cfg: AttnCfg):
    mask = q_pos[:, None] >= k_pos[None, :]
    if cfg.sliding_window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < cfg.sliding_window
    return mask


def _sdpa_chunk(q_chunk, k, v, q_pos, k_pos, cfg: AttnCfg):
    """softmax(q k^T) v for one query chunk against full K/V, grouped GQA.
    q_chunk: (B, c, H, hd); k/v: (B, S, K, hd)."""
    B, c, H, hd = q_chunk.shape
    K = k.shape[2]
    q5 = q_chunk.reshape(B, c, K, H // K, hd)
    scores = torch.einsum("bcgrd,bsgd->bgrcs", q5.to(torch.float32),
                          k.to(torch.float32)) / (hd ** 0.5)
    if cfg.causal:
        mask = _causal_mask(q_pos, k_pos, cfg)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    out = torch.einsum("bgrcs,bsgd->bcgrd", probs, v)
    return out.reshape(B, c, H, hd)


def _flash_kv_attention(q, k, v, positions, cfg: AttnCfg, kv_chunk: int,
                        k_pos=None):
    """Attention chunked over the KEY/VALUE axis with an online softmax:
    peak scores memory (B, H, S, kc) instead of (B, H, S, S). ``k_pos``:
    the keys' positions where they are not the queries' (the gathered K/V
    of a sequence shard)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rep = H // K
    k_pos = positions if k_pos is None else k_pos
    S_k = k.shape[1]
    kc = min(kv_chunk, S_k)
    if S_k % kc != 0:
        kc = S_k
    q5 = q.reshape(B, S, K, rep, hd).to(torch.float32)
    m = torch.full((B, K, rep, S), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, rep, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, rep, S, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, S_k, kc):
        k_c, v_c = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = torch.einsum("bsgrd,btgd->bgrst", q5,
                         k_c.to(torch.float32)) / (hd ** 0.5)
        if cfg.causal:
            mask = _causal_mask(positions, k_pos[c0:c0 + kc], cfg)
            s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p.to(v_c.dtype).to(torch.float32),
            v_c.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # (B, K, rep, S, hd) -> (B, S, H*hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(q.dtype)


def attention(x, lp, cfg: AttnCfg, positions):
    """Training attention, x: (B, S, D) -> (B, S, D): one block for
    S <= q_chunk, KV-chunked flash attention above (S the whole sequence;
    under a grid x is this rank's slice, ``positions`` its global
    positions, and the gathered K/V hold every key)."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, lp, cfg, positions)
    k, v = hints.gather_seq(k), hints.gather_seq(v)
    k_pos = hints.key_positions(positions, k.shape[1])
    if k.shape[1] <= cfg.q_chunk:
        y = _sdpa_chunk(q, k, v, positions, k_pos, cfg)
        y = y.reshape(B, S, cfg.n_heads * cfg.d_head)
    else:
        y = _flash_kv_attention(q, k, v, positions, cfg, cfg.q_chunk,
                                k_pos=k_pos)
    return y @ lp["wo"]


def attention_decode(x, lp, cfg: AttnCfg, cache_k, cache_v, position: int):
    """One-token decode against a KV cache. x: (B, 1, D); cache_k/v: (B,
    S_cache, K, hd), written IN PLACE at ``position`` with the new token's
    K/V (the reference returns updated copies). -> (y, cache_k, cache_v).

    The reference's ``dynamic_update_slice`` clamps a position past the
    cache into its last slot; the port raises instead. On a grid
    (``hints.serving``) the cache is this rank's slots [lo, hi) of the
    whole (``hints.cache_bounds``): only the slot's owner writes the new
    K/V, and the mask takes the keys' global positions (the sliding window
    too). The softmax's row max and sum of exponentials are folded over
    the ranks of the cache's sequence axes (``hints.softmax_stats``), and
    each rank's softmax over its slots is scaled to its share of the whole
    before the probabilities are rounded to x.dtype, as the reference
    rounds them; their products with the V slots are taken in f32 and
    summed over those ranks (``hints.sum_slots``) before one rounding to
    x.dtype, as a bf16 matmul accumulates. Off a grid the cache is whole,
    both hints are the identity and the share is exactly 1."""
    lo, hi, S = hints.cache_bounds(cache_k.shape[1])
    if not 0 <= position < S:
        raise ValueError(f"decode position {position} is outside the "
                         f"cache's {S} slots")
    pos = torch.full((1,), position, dtype=torch.long, device=x.device)
    q, k_new, v_new = _qkv(x, lp, cfg, pos)
    if lo <= position < hi:
        cache_k[:, position - lo] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, position - lo] = v_new[:, 0].to(cache_v.dtype)
    k_pos = torch.arange(lo, hi, device=x.device)
    valid = k_pos <= position
    if cfg.sliding_window > 0:
        valid &= (position - k_pos) < cfg.sliding_window
    y = _attend_slots(q, cache_k, cache_v, valid, cfg, x.dtype, "k")
    return y @ lp["wo"], cache_k, cache_v


def _attend_slots(q, cache_k, cache_v, valid, cfg: AttnCfg, dtype,
                  leaf: str):
    """One query a row (q: (B, 1, H, hd)) over this rank's slots of a
    cache layout (cache_k / cache_v: (B, S_loc, K, hd); ``leaf`` names the
    layout, ``hints.SLOT_LEAVES``), the keys where ``valid`` (None: every
    slot) -> (B, 1, H * hd) in ``dtype``. The softmax's row max and sum
    of exponentials are folded over the layout's slot ranks
    (``hints.softmax_stats``), each rank's softmax scaled to its share of
    the whole before the probabilities are rounded to ``dtype``; their f32
    products with V are summed over those ranks (``hints.sum_slots``)
    before one rounding. Off a grid the share is exactly 1."""
    B = q.shape[0]
    K, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q5 = q.reshape(B, 1, K, rep, cfg.d_head)
    scores = torch.einsum("bcgrd,bsgd->bgrcs", q5.to(torch.float32),
                          cache_k.to(torch.float32)) / (cfg.d_head ** 0.5)
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    # a rank whose slots are all masked has m = -1e30 and adds nothing
    e = torch.exp(scores - m)
    l = (e if valid is None else torch.where(valid, e, 0.0)).sum(
        dim=-1, keepdim=True)
    top, total = hints.softmax_stats(m, l, leaf)
    # this rank's share of the whole softmax (exactly 1 off a grid)
    share = torch.exp(m - top) * l / total
    probs = (torch.softmax(scores, dim=-1) * share).to(dtype)
    y = hints.sum_slots(torch.einsum("bgrcs,bsgd->bcgrd",
                                     probs.to(torch.float32),
                                     cache_v.to(torch.float32)), leaf)
    return y.reshape(B, 1, -1).to(dtype)


def cross_attention_decode(x, lp, cfg: AttnCfg, mem_k, mem_v):
    """One-token cross-attention over this rank's slots of the enc-dec
    memory (mem_k / mem_v: (B, S_src_loc, K, hd), the ``mem_k`` layout),
    unmasked, as the reference's ``_cross_attention``: x (B, 1, D) -> (B,
    1, D). On a grid the softmax is folded over the memory's slot ranks
    before the probabilities are rounded (``_attend_slots``); the memory is
    never gathered."""
    B = x.shape[0]
    q = (x @ lp["wq"]).reshape(B, 1, cfg.n_heads, cfg.d_head)
    return _attend_slots(q, mem_k, mem_v, None, cfg, x.dtype,
                         "mem_k") @ lp["wo"]


# ---------------------------------------------------------------------------
# MLP / MoE / loss
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, n_layers, dtype, device="cpu"):
    return {"w1": _init(gen, (n_layers, d_model, d_ff), dtype=dtype,
                        device=device),
            "w3": _init(gen, (n_layers, d_model, d_ff), dtype=dtype,
                        device=device),
            "w2": _init(gen, (n_layers, d_ff, d_model), dtype=dtype,
                        device=device)}


def swiglu(x, lp):
    return (F.silu(x @ lp["w1"]) * (x @ lp["w3"])) @ lp["w2"]


def moe_init(gen, d_model, d_ff, n_experts, n_layers, dtype, device="cpu"):
    """Stacked expert weights; the router stays f32 in any model dtype."""
    return {"router": _init(gen, (n_layers, d_model, n_experts),
                            dtype=torch.float32, device=device),
            "w1": _init(gen, (n_layers, n_experts, d_model, d_ff),
                        dtype=dtype, device=device),
            "w3": _init(gen, (n_layers, n_experts, d_model, d_ff),
                        dtype=dtype, device=device),
            "w2": _init(gen, (n_layers, n_experts, d_ff, d_model),
                        dtype=dtype, device=device)}


def _topk_iterative(scores: torch.Tensor, k: int):
    """top-k by k rounds of argmax, each subtracting one_hot * 1e9 from the
    chosen entry, as the reference does. Ties go to the first index (as
    ``jnp.argmax`` sends them), which ``torch.topk`` does not promise.
    -> (values, indices), each (..., k)."""
    vals, idxs = [], []
    s = scores
    for _ in range(k):
        i = torch.argmax(s, dim=-1)
        vals.append(torch.amax(s, dim=-1))
        idxs.append(i)
        s = s - F.one_hot(i, scores.shape[-1]).to(s.dtype) * 1e9
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


class MoERoute(NamedTuple):
    """One MoE layer's routing of (B, S) tokens to k of E experts."""
    gate_all: torch.Tensor     # (B, S, E) f32 softmax of the router logits
    gates: torch.Tensor        # (B, S, k) renormalised over the k chosen
    idx: torch.Tensor          # (B, S, k) chosen experts, best first
    keep: torch.Tensor         # (B, S*k) slot within its expert's capacity
    e_idx: torch.Tensor        # (B, S*k) buffer cell (expert, position);
    p_idx: torch.Tensor        #   dropped slots go to (E-1, C-1)
    capacity: int


def moe_route(x, router, n_experts: int, top_k: int,
              capacity_factor: float = 1.25) -> MoERoute:
    """The reference's routing of one sequence shard a batch row
    (``moe_apply`` gives it the (B * ns, S_loc) view): f32 router logits,
    softmax, the iterative top-k, gates renormalised; capacity C = max(1,
    int(S*k/E*1.25)) per row; a token's k slots take positions in
    token-major, then k, order from the running count of each expert; a
    slot past C is dropped."""
    B, S, _ = x.shape
    E, k = n_experts, top_k
    C = max(1, int(S * k / E * capacity_factor))
    gate_all = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    gates, idx = _topk_iterative(gate_all, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(B, S * k)
    oh = F.one_hot(flat_e, E)                                  # (B, S*k, E)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)        # (B, S*k)
    keep = pos < C
    return MoERoute(gate_all, gates, idx, keep,
                    torch.where(keep, flat_e, E - 1),
                    torch.where(keep, pos, C - 1), C)


def moe_seq_shards(seq_len: int, n_experts: int, top_k: int) -> int:
    """The reference's ns: the sequence shard count of the grid (or of
    ``hints.seq_shard_view``), or 1 when the sequence does not split into
    that many shards or a shard's S_loc * k slots are fewer than E."""
    ns = hints.seq_shard_count()
    if seq_len % ns or (seq_len // ns) * top_k < n_experts:
        return 1
    return ns


def _moe_aux(r: MoERoute, E: int, rows=None):
    """aux = E * sum(frac * prob): frac the share of tokens whose top
    choice is each expert, prob the mean gate, over every token of the
    (micro-)batch. On a grid each rank sees a slice of the tokens (``rows``:
    the sequence positions it owns of a gathered sequence), so the counts
    are summed over the token axes before the product (a product of
    means is not the mean of the ranks' products); the value is the global
    aux on every rank, the gradient this rank's share of it. A decode step
    on a grid (``hints.serving``) holds its rows whole: their aux alone."""
    top1 = F.one_hot(r.idx[..., 0], E).to(torch.float32)
    if not hints.active() or hints.serving():
        frac = torch.mean(top1, dim=(0, 1))
        prob = torch.mean(r.gate_all, dim=(0, 1))
        return E * torch.sum(frac * prob)
    gate = r.gate_all
    if rows is not None:
        top1, gate = top1[:, rows[0]:rows[1]], gate[:, rows[0]:rows[1]]
    prob_s = gate.sum(dim=(0, 1))
    n = torch.full((1,), float(top1.shape[0] * top1.shape[1]),
                   device=gate.device)
    tot = hints.reduce_sum(torch.cat([top1.sum(dim=(0, 1)), prob_s.detach(),
                                      n]), hints.token_axes(), "moe_aux")
    frac, prob, cnt = tot[:E], tot[E:2 * E], tot[2 * E]
    share = E * torch.sum(frac / cnt * (prob_s / cnt))
    return (share - share.detach()) + E * torch.sum(frac / cnt * (prob / cnt))


def moe_apply(x, lp, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, ep: bool = False):
    """Capacity-based top-k MoE with shard-local dispatch, x: (B, S, D) ->
    (out (B, S, D), aux), the reference's ``moe_apply``.

    The sequence splits into ns shards (``moe_seq_shards``), each with its
    own capacity: off a grid x is viewed as (B * ns, S / ns) rows; on a grid
    x is this rank's (B, S_loc) slice, one shard, unless ns falls back to 1,
    when the sequence is gathered first and this rank keeps its positions
    of the output. Routing as ``moe_route``; a dropped slot carries a zero
    value into cell (E-1, C-1); the output is summed over k in x.dtype; the
    aux as ``_moe_aux``. Kept slots map one to one onto buffer cells, so the
    scatter-add and the gather are each other's transposes, which autograd
    gives without the reference's custom_vjp.

    ``ep`` (a grid whose seq axes hold the experts, E/n of them a rank, in
    ``lp``): the (B, E, C, D) buffer goes to the experts' ranks and back by
    ``hints.expert_swap``, and this rank runs its experts' einsums over
    every shard's cells. The reference's ``ep`` branch dispatches by one-hot
    einsums; each kept cell receives exactly one value and every other term
    is a zero, so its buffer holds the values this ``index_put`` writes
    (and its combine reads the cells this gather reads).

    A decode step on a grid (``hints.serving``, S = 1: every rank of the
    sequence axes holds the same whole rows) routes its rows as one process
    routes them (ns = 1, the reference's fallback), the aux over these rows
    alone; with ``ep`` the dispatch still goes to the experts' ranks."""
    B, S, D = x.shape
    E, k = n_experts, top_k
    local = hints.serving()
    grid = hints.active() and not local
    ns = 1 if local else moe_seq_shards(hints.seq_len(S), E, k)
    rows = None
    if grid and ns == 1 and hints.seq_shard_count() > 1:
        rows = hints.seq_bounds(hints.seq_len(S))
        x = hints.gather_seq(x, keep=False, use="moe_seq")
    elif not grid and ns > 1:
        x = x.reshape(B * ns, S // ns, D)      # the reference's (B, ns, S_loc)
    Bv, Sv = x.shape[:2]
    r = moe_route(x, lp["router"], E, k, capacity_factor)
    b_idx = torch.arange(Bv, device=x.device)[:, None].expand(Bv, Sv * k)
    vals = x[:, :, None, :].expand(Bv, Sv, k, D).reshape(Bv, Sv * k, D)
    vals = torch.where(r.keep[..., None], vals, 0).to(x.dtype)
    buf = torch.zeros((Bv, E, r.capacity, D), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((b_idx, r.e_idx, r.p_idx), vals, accumulate=True)
    if ep:
        buf = hints.expert_swap(buf, True)     # (n, Bv, E/n, C, D)
        buf = buf.reshape((-1,) + tuple(buf.shape[2:]))
    h = torch.einsum("becd,edf->becf", buf, lp["w1"])
    g3 = torch.einsum("becd,edf->becf", buf, lp["w3"])
    y = torch.einsum("becf,efd->becd", F.silu(h) * g3, lp["w2"]).to(x.dtype)
    if ep:
        y = hints.expert_swap(y.reshape((-1, Bv) + tuple(y.shape[1:])),
                              False)
    out_slots = y[b_idx, r.e_idx, r.p_idx]                    # (Bv, S*k, D)
    out_slots = torch.where(r.keep[..., None], out_slots, 0) \
        * r.gates.reshape(Bv, Sv * k)[..., None].to(x.dtype)
    out = out_slots.reshape(Bv, Sv, k, D).sum(dim=2)
    aux = _moe_aux(r, E, rows)
    if rows is not None:
        out = out[:, rows[0]:rows[1]]
    return out.reshape(B, S, D), aux


def chunked_ce(x, head, targets, mask=None, chunk: int = 512):
    """Sequence-chunked mean cross entropy: logits exist one (B, chunk, V)
    chunk at a time, in the forward and, each chunk rematerialized, in the
    backward. x: (B, S, D); head: (D, V); targets: (B, S) int; mask: (B, S)
    float or None."""
    tot, cnt = chunked_ce_sums(x, head, targets, mask, chunk)
    return tot / torch.clamp_min(cnt, 1.0)


def _ce_chunk(xc, head, tc, mc):
    """One chunk's (masked NLL sum, mask sum)."""
    logits = (xc @ head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None].long())
    return torch.sum((lse - tgt[..., 0]) * mc), torch.sum(mc)


def chunked_ce_sums(x, head, targets, mask=None, chunk: int = 512):
    """``chunked_ce``'s (masked NLL sum, mask sum), each f32. Each chunk is
    its own remat region (``hints.remat_chunk``, the reference's per-chunk
    ``jax.checkpoint``): the backward keeps its input slice, not its f32
    logits."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    c = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        t, n = hints.remat_chunk(_ce_chunk, x[:, sl], head, targets[:, sl],
                                 mask[:, sl])
        tot = tot + t
        cnt = cnt + n
    return tot, cnt
