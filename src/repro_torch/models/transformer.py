"""Decoder-only transformer LM, dense or MoE (port of
``repro.models.transformer``): GQA + RoPE + SwiGLU or the top-k MoE, tied or
untied head; training loss, full logits and one-token KV-cache decode.

Parameters are the reference's tree: a dict of depth-stacked tensors
(``attn.wq: (L, D, H*hd)``, ``mlp.w1: (L, D, F)`` or ``moe.w1: (L, E, D,
F)``, ``ln1: (L, D)``, ...), so ``wire.TreeSpec`` order, weight carry-over
and the flat wire line up with the reference. The forward walks the layers
in a Python loop over the stacked slices (the reference's ``lax.scan``).

Under a grid (``launch/hints.py``; the model-sharded replica of the dense,
MoE and VLM families, whose grid loss ``sharded_loss`` the xLSTM, hybrid
and enc-dec families share) the params are this rank's shards: each layer gathers
its weights (``fsdp_gather``), computes on this rank's sequence slice and
keeps its output there (``seq_shard``), as the reference's ``_layer`` does;
each layer is rematerialized (``hints.remat``) keeping the gathered K/V,
and the gathered weights under ``remat_save_weights``, the reference's
``_remat_policy``. MoE experts are
gathered like any weight (replicated experts, granite) or, under
``moe_ep`` where the grid stores E over the sequence axes, keep their E
shard and take the dispatch by an all-to-all (llama4, jamba); the f32
router's gradient is summed over the replica axes as any replicated leaf's.
The loss is the global token mean: local sums, then one all-reduce of the
sum and the count over the replica axes; the MoE aux is global too
(``layers._moe_aux``) and enters it once. Off a grid every hint is the
identity, and each layer is still rematerialized as the reference's layer
scan is on one device: its input kept, the rest (its K/V too, which the
reference keeps there: ``hints``) recomputed.

Serving on a grid (``hints.serving_hints``, the dry run's prefill and
decode cells): ``prefill`` runs the forward above without remat and takes
the last position's logits from the last sequence rank; ``decode_step``
gathers each layer's weights just in time as training does, attends over
this rank's slice of the KV cache with the softmax folded over the
sequence ranks, and all-gathers the batch rows' logits. No rank keeps the
gathered replica across steps.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.launch import hints
from repro_torch.models import layers as L


def _ffn_key(cfg) -> str:
    return "moe" if cfg.moe_experts > 0 else "mlp"


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree's shapes, without allocating it."""
    return L.meta_shapes(init_params, cfg)


def init_params(gen: torch.Generator, cfg, device="cpu") -> Dict[str, Any]:
    """Random weights from ``gen`` (the reference's scales and layout; the
    numbers are torch's, not jax's)."""
    D, V, nl, dtype = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.dtype
    p = {
        "embed": L._init(gen, (V, D), scale=0.02, dtype=dtype, device=device),
        "attn": L.attn_init(gen, cfg.attn_cfg(), nl, dtype, device),
        "ln1": torch.ones((nl, D), dtype=dtype, device=device),
        "ln2": torch.ones((nl, D), dtype=dtype, device=device),
        "lnf": torch.ones((D,), dtype=dtype, device=device),
    }
    if cfg.moe_experts > 0:
        p["moe"] = L.moe_init(gen, D, cfg.d_ff, cfg.moe_experts, nl, dtype,
                              device)
    else:
        p["mlp"] = L.mlp_init(gen, D, cfg.d_ff, nl, dtype, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (D, V), scale=0.02, dtype=dtype,
                               device=device)
    return p


def _ffn(cfg, hn, lp, ep: bool = False):
    """-> (y, aux) of the layer's MLP or MoE on the normed hidden."""
    if cfg.moe_experts > 0:
        return L.moe_apply(hn, lp["moe"], cfg.moe_experts, cfg.moe_topk,
                           ep=ep)
    return L.swiglu(hn, lp["mlp"]), 0.0


def _expert_parallel(cfg, local_seq: int, e_dim: int = 1) -> bool:
    """Whether this grid runs the MoE expert-parallel: ``moe_ep``, the
    reference's ns equal to the grid's sequence shards (no fallback to
    one), and the experts' E dimension (``e_dim`` of the stored ``moe.w1``:
    1 under the depth stack, 2 under the hybrid's (nb, 4) one) stored over
    the sequence axes."""
    if not (cfg.moe_ep and hints.active()):
        return False
    ns = L.moe_seq_shards(hints.seq_len(local_seq), cfg.moe_experts,
                          cfg.moe_topk)
    return ns > 1 and hints.sharded_over(("moe", "w1"), e_dim,
                                         hints.seq_axes())


def _gather_layer(lp, ep: bool):
    """FSDP: the layer's weight shards gathered just in time; expert-
    parallel experts keep their E shard (gathered over the other axes)."""
    g = hints.fsdp_gather({k: v for k, v in lp.items() if k != "moe"})
    if "moe" in lp:
        g["moe"] = hints.fsdp_gather(
            lp["moe"], ("moe",), keep_axes=hints.seq_axes() if ep else ())
    return g


def _layer(cfg, x, lp, positions):
    ep = cfg.moe_experts > 0 and _expert_parallel(cfg, x.shape[1])
    lp = _gather_layer(lp, ep)
    h = x + L.attention(L.rms_norm(x, lp["ln1"]), lp["attn"],
                        cfg.attn_cfg(), positions)
    h = hints.seq_shard(h)
    y, aux = _ffn(cfg, L.rms_norm(h, lp["ln2"]), lp, ep)
    return hints.seq_shard(h + y), aux


def _remat_layer(cfg, x, lp, positions):
    """One layer rematerialized in the backward pass from its input; under
    a grid with its gathered K/V kept, and its gathered weights under
    ``remat_save_weights``."""
    def run(x, lp, positions):
        y, a = _layer(cfg, x, lp, positions)
        return y, torch.as_tensor(a, dtype=torch.float32, device=y.device)

    return hints.remat(run, cfg.remat_save_weights, x, lp, positions)


def _layer_params(params, cfg):
    """The stacked layer weights split per layer."""
    return L.unstack({k: params[k] for k in ("attn", _ffn_key(cfg), "ln1",
                                             "ln2")}, cfg.n_layers)


def forward_hidden(params, tokens, cfg, *, prefix=None):
    """tokens (B, S), with ``prefix`` (B, P, D) (the VLM's image embeds)
    cast to cfg.dtype in place of the first P tokens' embeddings -> (final-
    norm hidden states (B, S, D), layer-mean MoE aux). The token embeddings
    are looked up in ``params["embed"]``, which under a grid is the
    gathered table whose gradient the gather's backward sums."""
    positions = hints.local_positions(tokens.shape[0], tokens.shape[1],
                                      params["embed"].device)
    if prefix is not None:
        P = prefix.shape[1]
        x = hints.seq_shard(torch.cat(
            [prefix.to(cfg.dtype), params["embed"][tokens[:, P:]]], dim=1))
    else:
        x = params["embed"][hints.seq_shard(tokens)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layer_params(params, cfg):
        x, a = _remat_layer(cfg, x, lp, positions)
        aux = aux + a
    return L.rms_norm(x, params["lnf"]), aux / cfg.n_layers


def lm_head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg):
    """Full f32 logits (B, S, V) and the aux (small shapes: O(S*V))."""
    x, aux = forward_hidden(params, tokens, cfg)
    return (x @ lm_head(params, cfg)).to(torch.float32), aux


def loss_fn(params, batch, cfg):
    """Next-token cross entropy, sequence-chunked, + 0.01 * the MoE aux.
    ``batch`` may carry ``img_embeds`` (a prefix in place of the first
    tokens' embeddings, the VLM's) and a ``loss_mask`` (B, S)."""
    tokens = batch["tokens"]
    if hints.active():
        return sharded_loss(params, batch, cfg, lambda p, t: forward_hidden(
            p, t, cfg, prefix=batch.get("img_embeds")))
    x, aux = forward_hidden(params, tokens, cfg,
                            prefix=batch.get("img_embeds"))
    mask = batch.get("loss_mask")
    mask = mask[:, 1:].to(torch.float32) if mask is not None else None
    ce = L.chunked_ce(x[:, :-1], lm_head(params, cfg), tokens[:, 1:],
                      mask, chunk=cfg.q_chunk)
    return ce + 0.01 * aux


#: the stored leaves outside the layer stack
_TOP = ("embed", "lm_head", "lnf")


def sharded_loss(params, batch, cfg, hidden):
    """A family's ``loss_fn`` under a grid (this one's, the xLSTM's, the
    hybrid's and the enc-dec's): ``hidden(params, tokens)`` is the family's
    forward to the final-norm hidden states of this rank's slice and its
    aux (None where the family has none); a family's other inputs (the
    VLM's image prefix, the enc-dec's frames) are the callable's own. The
    tokens are the ones the head predicts (the enc-dec's target tokens). The embedding, head and final norm are gathered
    once (a vocab-sharded table whole: one all-gather of V x D, whose
    backward reduce-scatters the dense table gradient). Every rank holds
    the client's whole (B, S) token batch, so the next-token label of its
    last position is the first token of the next slice; the sequence's
    last position has none. The value is the global token mean; the
    gradient is this rank's share of it, which the reduce-scatters of the
    backward sum."""
    tokens = batch["tokens"]
    p = _top(params)
    x, aux = hidden(p, tokens)
    B, S = tokens.shape
    lo, hi = hints.seq_bounds(S)
    b0, b1 = hints.batch_bounds(B)
    dev = x.device
    pad = torch.zeros((b1 - b0, 1), dtype=tokens.dtype, device=dev)
    tgt = torch.cat([tokens[b0:b1], pad], dim=1)[:, lo + 1:hi + 1]
    valid = (torch.arange(lo, hi, device=dev) < S - 1).to(torch.float32)
    mask = valid.expand(b1 - b0, hi - lo)
    if batch.get("loss_mask") is not None:
        m = batch["loss_mask"].to(device=dev, dtype=torch.float32)
        m = torch.cat([m[b0:b1], pad.to(torch.float32)], dim=1)
        mask = mask * m[:, lo + 1:hi + 1]
    tot, cnt = L.chunked_ce_sums(x, lm_head(p, cfg), tgt, mask,
                                 chunk=cfg.q_chunk)
    sums = hints.reduce_sum(torch.stack([tot, cnt]), hints.replica_axes())
    n = torch.clamp_min(sums[1], 1.0)
    ce = tot / n
    # the value is exactly the global mean (x - x is +0.0), the gradient
    # this rank's share of it
    ce = (ce - ce.detach()) + sums[0] / n
    return ce if aux is None else ce + 0.01 * aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, device="cpu"):
    """Zero KV cache {"k", "v": (n_layers, B, max_len, K, hd)} in
    cfg.dtype."""
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


@torch.no_grad()
def decode_step(params, cache, tokens, position: int, cfg):
    """One decode step: tokens (B, 1) at ``position`` (a Python int below
    the cache length) -> (f32 logits (B, 1, V), cache). The cache is
    written in place and returned.

    Under a grid's serving hints (``hints.serving_hints``) ``params`` are
    this rank's shards, ``cache`` its slice of the KV cache (its batch rows
    and slots, ``launch/sharding.cache_specs``) and ``tokens`` the whole
    batch. The embedding, head and final norm are gathered once, each
    layer's weights just in time and dropped after it (no rank keeps the
    replica across steps); the attention runs on the cache slice with the
    softmax folded over the sequence ranks (``layers.attention_decode``);
    the MoE routes this rank's rows as one process does, its experts
    gathered a layer or, under ``moe_ep`` where the grid stores E over the
    seq axes, kept there with the dispatch swapped to their ranks. The
    logits are this rank's rows all-gathered over the batch axes
    (``all_gather:logits``), the same on every rank. Off a grid every hint
    is the identity."""
    B = tokens.shape[0]
    b0, b1 = hints.batch_bounds(B)
    nl, rows = cache["k"].shape[0], cache["k"].shape[1]
    if nl != cfg.n_layers or rows != b1 - b0:
        raise ValueError(f"cache slice of {nl} layers x {rows} rows, the "
                         f"grid's is {cfg.n_layers} x {b1 - b0} of {B}")
    top = _top(params)
    x = top["embed"][tokens[b0:b1]]
    ep = cfg.moe_experts > 0 and cfg.moe_ep and hints.sharded_over(
        ("moe", "w1"), 1, hints.seq_axes())
    for i, lp in enumerate(_layer_params(params, cfg)):
        g = _gather_layer(lp, ep)
        y, _, _ = L.attention_decode(L.rms_norm(x, g["ln1"]), g["attn"],
                                     cfg.attn_cfg(), cache["k"][i],
                                     cache["v"][i], position)
        h = x + y
        y, _ = _ffn(cfg, L.rms_norm(h, g["ln2"]), g, ep)
        x = h + y
        del g
    x = L.rms_norm(x, top["lnf"])
    logits = (x @ lm_head(top, cfg)).to(torch.float32)
    return hints.gather_rows(logits), cache


def _top(params):
    """The leaves outside the layer stack, gathered once a call (a
    vocab-sharded table whole)."""
    p = dict(params)
    p.update(hints.fsdp_gather({k: params[k] for k in _TOP if k in params},
                               stacked=False))
    return p


@torch.no_grad()
def prefill(params, tokens, cfg):
    """The serving prefill (the reference's prefill cell): the final hidden
    state of ``tokens`` (B, S) -> f32 logits of its last position (B, 1,
    V). Under a grid's serving hints ``params`` are this rank's shards and
    ``tokens`` the whole batch: the embedding, head and final norm are
    gathered once, each layer as in training (no remat); the last position
    is the last sequence rank's (``hints.last_position``), and the rows are
    all-gathered over the batch axes, so every rank returns every row. Off
    a grid every hint is the identity."""
    p = _top(params)
    x, _ = forward_hidden(p, tokens, cfg)
    x = hints.last_position(x)
    return hints.gather_rows((x @ lm_head(p, cfg)).to(torch.float32))
