"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``): GQA + RoPE + SwiGLU, tied or untied head.

Parameters are the reference's tree: a dict of depth-stacked tensors
(``attn.wq: (L, D, H*hd)``, ``mlp.w1: (L, D, F)``, ``ln1: (L, D)``, ...), so
``wire.TreeSpec`` order, weight carry-over and the flat wire line up with the
reference. The forward walks the layers in a Python loop over the stacked
slices (the reference's ``lax.scan``; its remat has no numerical effect).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree's shapes, without allocating it."""
    D, V, nl = cfg.d_model, cfg.vocab, cfg.n_layers
    H, K, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    attn = {"wq": (nl, D, H * hd), "wk": (nl, D, K * hd),
            "wv": (nl, D, K * hd), "wo": (nl, H * hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=(nl, H * hd), bk=(nl, K * hd), bv=(nl, K * hd))
    p = {"embed": (V, D), "attn": attn, "ln1": (nl, D), "ln2": (nl, D),
         "lnf": (D,), "mlp": {"w1": (nl, D, Fd), "w3": (nl, D, Fd),
                              "w2": (nl, Fd, D)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = (D, V)
    return p


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
        "mlp": L.mlp_init(gen, D, cfg.d_ff, nl, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (D, V), scale=0.02, dtype=dtype,
                               device=device)
    return p


def _layer(cfg, x, lp, positions):
    h = x + L.attention(L.rms_norm(x, lp["ln1"]), lp["attn"],
                        cfg.attn_cfg(), positions)
    return h + L.swiglu(L.rms_norm(h, lp["ln2"]), lp["mlp"])


def forward_hidden(params, tokens, cfg):
    """tokens (B, S) -> final-norm hidden states (B, S, D)."""
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    # one unbind per stacked weight (its backward is a single stack); an
    # index per layer would cost a whole-weight zero-fill + add per layer
    attn = {k: v.unbind(0) for k, v in params["attn"].items()}
    mlp = {k: v.unbind(0) for k, v in params["mlp"].items()}
    ln1, ln2 = params["ln1"].unbind(0), params["ln2"].unbind(0)
    for i in range(cfg.n_layers):
        lp = {"attn": {k: v[i] for k, v in attn.items()},
              "mlp": {k: v[i] for k, v in mlp.items()},
              "ln1": ln1[i], "ln2": ln2[i]}
        x = _layer(cfg, x, lp, positions)
    return L.rms_norm(x, params["lnf"])


def lm_head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def loss_fn(params, batch, cfg):
    """Next-token cross entropy, sequence-chunked."""
    tokens = batch["tokens"]
    x = forward_hidden(params, tokens, cfg)
    mask = batch.get("loss_mask")
    mask = mask[:, 1:].to(torch.float32) if mask is not None else None
    return L.chunked_ce(x[:, :-1], lm_head(params, cfg), tokens[:, 1:],
                        mask, chunk=cfg.q_chunk)
