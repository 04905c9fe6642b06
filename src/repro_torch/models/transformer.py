"""Decoder-only transformer LM, dense or MoE (port of
``repro.models.transformer``): GQA + RoPE + SwiGLU or the top-k MoE, tied or
untied head; training loss, full logits and one-token KV-cache decode.

Parameters are the reference's tree: a dict of depth-stacked tensors
(``attn.wq: (L, D, H*hd)``, ``mlp.w1: (L, D, F)`` or ``moe.w1: (L, E, D,
F)``, ``ln1: (L, D)``, ...), so ``wire.TreeSpec`` order, weight carry-over
and the flat wire line up with the reference. The forward walks the layers
in a Python loop over the stacked slices (the reference's ``lax.scan``; its
remat has no numerical effect).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

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


def _ffn(cfg, hn, lp):
    """-> (y, aux) of the layer's MLP or MoE on the normed hidden."""
    if cfg.moe_experts > 0:
        return L.moe_apply(hn, lp["moe"], cfg.moe_experts, cfg.moe_topk)
    return L.swiglu(hn, lp["mlp"]), 0.0


def _layer(cfg, x, lp, positions):
    h = x + L.attention(L.rms_norm(x, lp["ln1"]), lp["attn"],
                        cfg.attn_cfg(), positions)
    y, aux = _ffn(cfg, L.rms_norm(h, lp["ln2"]), lp)
    return h + y, aux


def _layer_params(params, cfg):
    """The stacked layer weights split per layer."""
    return L.unstack({k: params[k] for k in ("attn", _ffn_key(cfg), "ln1",
                                             "ln2")}, cfg.n_layers)


def forward_hidden(params, tokens, cfg, *, embeds=None):
    """tokens (B, S), or ``embeds`` (B, S, D) cast to cfg.dtype in their
    place -> (final-norm hidden states (B, S, D), layer-mean MoE aux)."""
    x = params["embed"][tokens] if embeds is None else embeds.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layer_params(params, cfg):
        x, a = _layer(cfg, x, lp, positions)
        aux = aux + a
    return L.rms_norm(x, params["lnf"]), aux / cfg.n_layers


def lm_head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg, *, embeds=None):
    """Full f32 logits (B, S, V) and the aux (small shapes: O(S*V))."""
    x, aux = forward_hidden(params, tokens, cfg, embeds=embeds)
    return (x @ lm_head(params, cfg)).to(torch.float32), aux


def loss_fn(params, batch, cfg):
    """Next-token cross entropy, sequence-chunked, + 0.01 * the MoE aux.
    ``batch`` may carry ``embeds`` (in place of the token embeddings) and a
    ``loss_mask`` (B, S)."""
    tokens = batch["tokens"]
    x, aux = forward_hidden(params, tokens, cfg, embeds=batch.get("embeds"))
    mask = batch.get("loss_mask")
    mask = mask[:, 1:].to(torch.float32) if mask is not None else None
    ce = L.chunked_ce(x[:, :-1], lm_head(params, cfg), tokens[:, 1:],
                      mask, chunk=cfg.q_chunk)
    return ce + 0.01 * aux


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
    written in place and returned."""
    x = params["embed"][tokens]
    for i, lp in enumerate(_layer_params(params, cfg)):
        y, _, _ = L.attention_decode(L.rms_norm(x, lp["ln1"]), lp["attn"],
                                     cfg.attn_cfg(), cache["k"][i],
                                     cache["v"][i], position)
        h = x + y
        y, _ = _ffn(cfg, L.rms_norm(h, lp["ln2"]), lp)
        x = h + y
    x = L.rms_norm(x, params["lnf"])
    return (x @ lm_head(params, cfg)).to(torch.float32), cache
