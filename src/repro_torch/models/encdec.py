"""Encoder-decoder transformer (port of ``repro.models.encdec``,
seamless-m4t style): a speech encoder stub and a text decoder with
cross-attention.

The modality frontend is a stub: the batch's ``embeds`` are precomputed
frame embeddings (B, S_src, D); the encoder is the bidirectional stack on
top of them. Both stacks walk their layers in a Python loop (the
reference's ``lax.scan``).

Cross-attention has no source mask, as in the reference: every slot of the
memory takes softmax weight, zero slots included. A serving cache of
``src_len`` slots must therefore be filled over exactly ``src_len`` frames
(``prefill_cache`` checks it).

Under a grid (``launch/hints.py``, the model-sharded replica's train cell)
the params are this rank's shards and each rank holds its (batch and)
sequence slice of the frames and of the target tokens. Each layer of
either stack gathers its weights just in time under its stack's prefix
(``hints.fsdp_gather``: ``enc_*``, or ``dec_*`` and ``x_attn``), keeps its
output on this rank's slice (``seq_shard``) and is rematerialized keeping
the gathered K/V (and, under ``remat_save_weights``, the gathered
weights), the reference's ``_remat_policy``. The encoder's bidirectional
self-attention gathers K and V along the sequence and attends over every
key unmasked, at the keys' global positions. The encoder's final memory
is gathered along the sequence ONCE (``all_gather:enc_mem``, this rank's
(B_loc, S_src / R, D) rows to (B_loc, S_src, D)) and kept for every
decoder layer and its recompute: each rank projects the cross-attention K
and V over the whole source from it, its own query rows attend over the
whole unmasked memory, and the backward reduce-scatters the memory's
gradient, summed over the decoder layers, once
(``reduce_scatter:enc_mem``). D values a source position cross the grid
that way, where gathering each layer's projected K and V (what GSPMD makes
of the reference) would move 2 n_layers K hd. The loss is the grid's
global token mean (``transformer.sharded_loss``), the next-token shift
crossing the target's sequence shards. Off a grid every hint is the
identity, and each layer of either stack is still rematerialized keeping
its input (and, in the decoder, the memory it reads), as the reference's
layer scans are on one device.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.launch import hints
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_ENC = ("enc_attn", "enc_mlp", "enc_ln1", "enc_ln2")
_DEC = ("dec_attn", "x_attn", "dec_mlp", "dec_ln1", "dec_ln2", "dec_ln3")


def init_params(gen, cfg, device):
    nl, D, V, dtype = cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    p = {
        "embed": L._init(gen, (V, D), scale=0.02, dtype=dtype, device=device),
        # encoder (bidirectional self-attention)
        "enc_attn": L.attn_init(gen, cfg.attn_cfg(), nl, dtype, device),
        "enc_mlp": L.mlp_init(gen, D, cfg.d_ff, nl, dtype, device),
        "enc_ln1": ones(nl, D), "enc_ln2": ones(nl, D), "enc_lnf": ones(D),
        # decoder (causal self-attention + cross-attention)
        "dec_attn": L.attn_init(gen, cfg.attn_cfg(), nl, dtype, device),
        "x_attn": L.attn_init(gen, cfg.attn_cfg(), nl, dtype, device),
        "dec_mlp": L.mlp_init(gen, D, cfg.d_ff, nl, dtype, device),
        "dec_ln1": ones(nl, D), "dec_ln2": ones(nl, D),
        "dec_ln3": ones(nl, D), "dec_lnf": ones(D),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (D, V), scale=0.02, dtype=dtype,
                               device=device)
    return p


def param_shapes(cfg):
    return L.meta_shapes(init_params, cfg)


def _cross_attention(x, mem_k, mem_v, lp, cfg):
    """x: (B, S_tgt, D) queries over fixed encoder memory K/V (B, S_src, K,
    hd), unmasked."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.d_head
    q = (x @ lp["wq"]).reshape(B, S, H, hd)
    rep = H // cfg.n_kv_heads
    k_r = mem_k.repeat_interleave(rep, dim=2)
    v_r = mem_v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bchd,bshd->bhcs", q.float(),
                          k_r.float()) / (hd ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    y = torch.einsum("bhcs,bshd->bchd", probs, v_r).reshape(B, S, H * hd)
    return y @ lp["wo"]


def _mem_kv(mem, lp, cfg):
    B, S, _ = mem.shape
    K, hd = cfg.n_kv_heads, cfg.d_head
    return ((mem @ lp["wk"]).reshape(B, S, K, hd),
            (mem @ lp["wv"]).reshape(B, S, K, hd))


def _enc_layer(cfg, x, lp, positions):
    """One encoder layer (bidirectional self-attention + SwiGLU); under a
    grid its weights gathered just in time, its sums on this rank's
    slice."""
    lp = hints.fsdp_gather(lp)
    h = hints.seq_shard(x + L.attention(L.rms_norm(x, lp["enc_ln1"]),
                                        lp["enc_attn"], cfg.attn_cfg_bidir(),
                                        positions))
    return hints.seq_shard(h + L.swiglu(L.rms_norm(h, lp["enc_ln2"]),
                                        lp["enc_mlp"]))


def _dec_layer(cfg, x, lp, mem, positions):
    """One decoder layer (causal self-attention, cross-attention over the
    whole memory ``mem``, SwiGLU); under a grid as ``_enc_layer``."""
    lp = hints.fsdp_gather(lp)
    h = hints.seq_shard(x + L.attention(L.rms_norm(x, lp["dec_ln1"]),
                                        lp["dec_attn"], cfg.attn_cfg(),
                                        positions))
    mk, mv = _mem_kv(mem, lp["x_attn"], cfg)
    h = hints.seq_shard(h + _cross_attention(L.rms_norm(h, lp["dec_ln2"]),
                                             mk, mv, lp["x_attn"], cfg))
    return hints.seq_shard(h + L.swiglu(L.rms_norm(h, lp["dec_ln3"]),
                                        lp["dec_mlp"]))


def _layers(cfg, layer, x, stack, *extra):
    """``layer`` over the stack's layers, each rematerialized
    (``hints.remat``, keeping its input and, under a grid, its gathered K/V
    and, under ``remat_save_weights``, the gathered weights)."""
    for lp in L.unstack(stack, cfg.n_layers):
        x = hints.remat(partial(layer, cfg), cfg.remat_save_weights, x, lp,
                        *extra)
    return x


def _final_norm(params, key):
    """A replicated final norm's weight, its gradient summed over the
    replica's ranks under a grid."""
    return hints.fsdp_gather({key: params[key]}, stacked=False)[key]


def encode(params, embeds, cfg):
    """embeds: (B, S_src, D) stub frame embeddings -> encoder memory (under
    a grid this rank's slice of it)."""
    positions = hints.local_positions(embeds.shape[0], embeds.shape[1],
                                      embeds.device)
    x = hints.seq_shard(embeds.to(cfg.dtype))
    x = _layers(cfg, _enc_layer, x, {k: params[k] for k in _ENC},
                positions)
    return L.rms_norm(x, _final_norm(params, "enc_lnf"))


def decode_train(params, mem, tokens, cfg):
    """mem: (B, S_src, D); tokens: (B, S_tgt) -> final-norm hidden. Under a
    grid ``mem`` is this rank's slice of the memory, gathered here along
    the sequence once (``all_gather:enc_mem``), and the hidden states are
    this rank's slice; the embedding is looked up in the table the caller
    gathered (``transformer._top``)."""
    mem = hints.gather_seq(mem, keep=False, use="enc_mem")
    positions = hints.local_positions(tokens.shape[0], tokens.shape[1],
                                      mem.device)
    x = params["embed"][hints.seq_shard(tokens)]
    x = _layers(cfg, _dec_layer, x, {k: params[k] for k in _DEC}, mem,
                positions)
    return L.rms_norm(x, _final_norm(params, "dec_lnf"))


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def loss_fn(params, batch, cfg):
    """batch: {embeds (B, S_src, D), tokens (B, S_tgt)}: next-token cross
    entropy over the target tokens; under a grid the global token mean
    (``transformer.sharded_loss``, the memory its hidden callable's)."""
    if hints.active():
        return T.sharded_loss(params, batch, cfg, lambda p, t: (
            decode_train(p, encode(p, batch["embeds"], cfg), t, cfg), None))
    mem = encode(params, batch["embeds"], cfg)
    x = decode_train(params, mem, batch["tokens"], cfg)
    return L.chunked_ce(x[:, :-1], _head(params, cfg), batch["tokens"][:, 1:],
                        chunk=cfg.q_chunk)


def init_cache(cfg, batch_size: int, max_len: int, src_len: int, device):
    """Zero caches in cfg.dtype: self-attention K/V (nl, B, max_len, K, hd)
    and the cross-attention memory K/V (nl, B, src_len, K, hd)."""
    nl, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    z = dict(dtype=cfg.dtype, device=device)
    return {"k": torch.zeros((nl, batch_size, max_len, K, hd), **z),
            "v": torch.zeros((nl, batch_size, max_len, K, hd), **z),
            "mem_k": torch.zeros((nl, batch_size, src_len, K, hd), **z),
            "mem_v": torch.zeros((nl, batch_size, src_len, K, hd), **z)}


@torch.no_grad()
def prefill_memory(params, embeds, cfg):
    """Run the encoder once and project each layer's cross K/V. -> (ks, vs),
    each (nl, B, S_src, K, hd). Under a grid's serving hints this rank's
    rows and frames of them: the encoder as in the train cell (without
    remat), each layer's ``wk`` / ``wv`` gathered just in time, and this
    rank's memory frames projected, nothing gathered along the source."""
    mem = encode(params, embeds, cfg)
    kv = [_mem_kv(mem, hints.fsdp_gather({"wk": wk, "wv": wv}, ("x_attn",)),
                  cfg) for wk, wv in
          zip(params["x_attn"]["wk"].unbind(0),
              params["x_attn"]["wv"].unbind(0))]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def prefill_cache(params, cache, embeds, cfg):
    """Fill ``cache``'s memory K/V from ``prefill_memory`` over ``embeds``,
    which must hold exactly the cache's ``src_len`` frames: the
    cross-attention is unmasked, so unfilled zero slots would take softmax
    weight. -> cache (written in place).

    Under a grid's serving hints (the decode cell's: ``embeds`` the whole
    (B, S_src, D) batch, ``cache`` this rank's slice) the encoder leaves
    its memory split over the seq axes and each rank projects its own
    frames into its own memory slots: the memory's slot axes must be the
    encoder's sequence axes (they are at batch > 1, ``launch/sharding.
    cache_specs``), so that the two splits are one; otherwise
    ``ValueError``."""
    lo, hi, src_len = hints.cache_bounds(cache["mem_k"].shape[2], "mem_k")
    if embeds.shape[1] != src_len:
        raise ValueError(f"{embeds.shape[1]} source frames for a cache of "
                         f"{src_len} memory slots (cross-attention has no "
                         f"source mask)")
    if (lo, hi) != hints.seq_bounds(src_len) or hints.slot_axes("mem_k") \
            and not hints.same_axes(hints.slot_axes("mem_k"),
                                    hints.seq_axes()):
        raise ValueError(f"the memory's slots lie over "
                         f"{hints.slot_axes('mem_k')}, the encoder's frames "
                         f"over {hints.seq_axes()}: not one split")
    ks, vs = prefill_memory(params, embeds, cfg)
    cache["mem_k"].copy_(ks)
    cache["mem_v"].copy_(vs)
    return cache


def _top(params):
    """The embedding, head and the decoder's final norm, gathered once a
    call (identity off a grid)."""
    p = dict(params)
    p.update(hints.fsdp_gather({k: params[k] for k in
                                ("embed", "lm_head", "dec_lnf")
                                if k in params}, stacked=False))
    return p


def _cross_decode(x, mem_k, mem_v, lp, cfg):
    """A decode step's cross-attention: the one-process ``_cross_attention``
    off a grid; on one, over this rank's memory slots with the softmax
    folded over the memory's slot ranks (``layers.cross_attention_decode``;
    the memory is never gathered)."""
    if hints.serving():
        return L.cross_attention_decode(x, lp, cfg.attn_cfg(), mem_k, mem_v)
    return _cross_attention(x, mem_k, mem_v, lp, cfg)


@torch.no_grad()
def decode_step(params, cache, tokens, position: int, cfg):
    """One decode step: tokens (B, 1) at ``position`` against the filled
    memory -> (f32 logits (B, 1, V), cache). The self-attention cache is
    written in place and returned.

    Under a grid's serving hints ``params`` are this rank's shards,
    ``cache`` its slice (its batch rows; the self-attention's slots and
    the memory's 2,048 slots, each over the axes of its slot dimension) and
    ``tokens`` the whole batch: the embedding, head and final norm
    gathered once a call, each decoder layer's weights just in time; the
    self-attention over its K/V slots and the cross-attention over this
    rank's memory slots, each softmax folded over its own slot ranks; the
    logits this rank's rows all-gathered over the batch axes. Off a grid
    every hint is the identity."""
    nl = cfg.n_layers
    B = tokens.shape[0]
    b0, b1 = hints.batch_bounds(B)
    if tuple(cache["k"].shape[:2]) != (nl, b1 - b0):
        raise ValueError(f"cache slice of {tuple(cache['k'].shape[:2])} "
                         f"layers x rows, the grid's is {(nl, b1 - b0)} of "
                         f"{B} rows")
    top = _top(params)
    x = top["embed"][tokens[b0:b1]]
    for i, lp in enumerate(L.unstack({k: params[k] for k in _DEC}, nl)):
        g = hints.fsdp_gather(lp)
        y, _, _ = L.attention_decode(L.rms_norm(x, g["dec_ln1"]),
                                     g["dec_attn"], cfg.attn_cfg(),
                                     cache["k"][i], cache["v"][i], position)
        h = x + y
        h = h + _cross_decode(L.rms_norm(h, g["dec_ln2"]),
                              cache["mem_k"][i], cache["mem_v"][i],
                              g["x_attn"], cfg)
        x = h + L.swiglu(L.rms_norm(h, g["dec_ln3"]), g["dec_mlp"])
        del g
    x = L.rms_norm(x, top["dec_lnf"])
    return hints.gather_rows((x @ _head(top, cfg)).to(torch.float32)), cache


@torch.no_grad()
def prefill(params, embeds, cfg):
    """The serving prefill (the reference's enc-dec prefill cell): the
    encoder's memory over ``embeds`` (B, S_src, D) -> its last frame (B, 1,
    D), in the model's dtype (not logits). Under a grid's serving hints the
    encoder of the train cell (``embeds`` the whole batch, its rows over
    the client and micro axes and its frames over the seq axes), without
    remat; the last frame is the last sequence rank's and the rows are
    all-gathered (``all_gather:mem_last``)."""
    mem = hints.last_position(encode(params, embeds, cfg))
    return hints.gather_rows(mem, use="mem_last")
