"""Jamba-style hybrid (port of ``repro.models.hybrid``): super-blocks of 8
sublayers, attention at sublayer 0 and mamba at 1..7; the FFN alternates
the MoE (even sublayers) and SwiGLU (odd), 4 of each a super-block.

Parameters are the reference's tree, stacked over super-blocks
(``n_layers // 8``): ``mamba`` (nb, 7, ...), ``moe`` and ``mlp`` (nb, 4,
...), ``ln_mix`` / ``ln_ffn`` (nb, 8, D). The forward walks the super-blocks
in a Python loop (the reference's ``lax.scan``). The reference's
``moe_ep=True`` branch is the same function as the port's one MoE dispatch
(``layers.moe_apply``).

Under a grid (``launch/hints.py``, the model-sharded replica on the big
plan) the params are this rank's shards and the residual stream its batch
and sequence slice, kept there after each residual add (``seq_shard``).
The attention sublayer and the SwiGLU MLPs gather their weights a sublayer
as the transformer's layer does (``fsdp_gather``); the attention takes the
global positions (``hints.local_positions``) and gathers its K/V. Each
mamba sublayer gathers its weights whole and runs channel-parallel over
the seq axes (``mamba.mamba_block``). The MoE sublayers run expert-parallel
where the grid stores E over the seq axes (``moe_ep``,
``transformer._expert_parallel``), their d_ff gathered over the other
axes, else with their experts gathered. Each super-block is rematerialized
keeping the gathered K/V and sequence gathers (and the gathered weights
under ``remat_save_weights``), the reference's policy; the loss is the
transformer's grid loss (``transformer.sharded_loss``), the aux global
(``layers._moe_aux``) over ``n_layers // 2``. Off a grid every hint is the
identity, and each super-block is still rematerialized keeping its input,
as the reference's is on one device; each
mamba scan chunk is a remat region of its own, on a grid and off it
(``mamba._scan_chunked``).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.launch import hints
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T

SUB = 8  # sublayers per super-block: 1 attn + 7 mamba
_STACK = ("attn", "mamba", "moe", "mlp", "ln_mix", "ln_ffn")


def init_params(gen, cfg, device):
    nb = cfg.n_layers // SUB
    D, V, dtype = cfg.d_model, cfg.vocab, cfg.dtype
    n_moe, n_mlp = SUB // 2, SUB - SUB // 2
    p = {
        "embed": L._init(gen, (V, D), scale=0.02, dtype=dtype, device=device),
        "attn": L.attn_init(gen, cfg.attn_cfg(), nb, dtype, device),
        "mamba": M.mamba_init(gen, D, nb * (SUB - 1), dtype, device),
        "moe": L.moe_init(gen, D, cfg.d_ff, cfg.moe_experts, nb * n_moe,
                          dtype, device),
        "mlp": L.mlp_init(gen, D, cfg.d_ff, nb * n_mlp, dtype, device),
        "ln_mix": torch.ones((nb, SUB, D), dtype=dtype, device=device),
        "ln_ffn": torch.ones((nb, SUB, D), dtype=dtype, device=device),
        "lnf": torch.ones((D,), dtype=dtype, device=device),
    }
    # restack per super-block: mamba (nb, 7, ...), moe / mlp (nb, 4, ...)
    for name, per in (("mamba", SUB - 1), ("moe", n_moe), ("mlp", n_mlp)):
        p[name] = {k: w.reshape(nb, per, *w.shape[1:])
                   for k, w in p[name].items()}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (D, V), scale=0.02, dtype=dtype,
                               device=device)
    return p


def param_shapes(cfg):
    return L.meta_shapes(init_params, cfg)


#: the sublayer stacks of a super-block and their lengths
_PER = {"mamba": SUB - 1, "moe": SUB // 2, "mlp": SUB - SUB // 2}


def _gathered_sublayers(bp, ep: bool):
    """Under a grid: -> get(name, j), the j-th sublayer of the ``name``
    stack ("mamba", "moe" or "mlp") with its weights gathered just in time
    (the MoE's E dimension kept where ``ep``). A stack whose spec cuts its
    sublayer dimension (the expert rule takes a stack of 4 for E where the
    config has 4 experts, as the reduced one does) is gathered whole, once
    a super-block. Off a grid: the stored slices as they are."""
    keep = {"moe": hints.seq_axes() if ep else ()}
    whole = {name for name in _PER if hints.cuts_dim((name,), 1)}
    split = {name: L.unstack(hints.fsdp_gather(
                 bp[name], (name,), keep_axes=keep.get(name, ()))
                 if name in whole else bp[name], n)
             for name, n in _PER.items()}

    def get(name, j):
        if name in whole:
            return split[name][j]
        return hints.fsdp_gather(split[name][j], (name,), stacked=2,
                                 keep_axes=keep.get(name, ()))
    return get


def _ffn(cfg, s, hn, lp, ep: bool = False):
    """Sublayer s's FFN from its weights ``lp``: the MoE on even s
    (expert-parallel where ``ep``), a SwiGLU on odd s. -> (y, aux or
    None)."""
    if s % 2 == 0:
        return L.moe_apply(hn, lp, cfg.moe_experts, cfg.moe_topk, ep=ep)
    return L.swiglu(hn, lp), None


def _super_block(cfg, x, bp, positions):
    """8 sublayers: [attn, mamba x7]; FFN alternates MoE (even) / MLP (odd)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ep = cfg.moe_experts > 0 and T._expert_parallel(cfg, x.shape[1], e_dim=2)
    get = _gathered_sublayers(bp, ep)
    ln = hints.fsdp_gather({k: bp[k] for k in ("ln_mix", "ln_ffn")})
    for s in range(SUB):
        xn = L.rms_norm(x, ln["ln_mix"][s])
        if s == 0:
            mix = L.attention(xn, hints.fsdp_gather(bp["attn"], ("attn",)),
                              cfg.attn_cfg(), positions)
        else:
            mix = M.mamba_block(xn, get("mamba", s - 1), d_model=cfg.d_model)
        x = hints.seq_shard(x + mix)
        y, a = _ffn(cfg, s, L.rms_norm(x, ln["ln_ffn"][s]),
                    get("moe" if s % 2 == 0 else "mlp", s // 2), ep)
        if a is not None:
            aux = aux + a
        x = hints.seq_shard(x + y)
    return x, aux


def _remat_super_block(cfg, x, bp, positions):
    """One super-block rematerialized in the backward pass from its input;
    under a grid with its gathered K/V and sequence gathers (and weights,
    under ``remat_save_weights``) kept."""
    return hints.remat(partial(_super_block, cfg), cfg.remat_save_weights,
                       x, bp, positions)


def forward_hidden(params, tokens, cfg):
    """-> (final-norm hidden (B, S, D), aux / (n_layers // 2)); under a
    grid this rank's slice of the hidden states, the embedding looked up in
    the table the caller gathered (``transformer._top``)."""
    positions = hints.local_positions(tokens.shape[0], tokens.shape[1],
                                      params["embed"].device)
    x = params["embed"][hints.seq_shard(tokens)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in L.unstack({k: params[k] for k in _STACK},
                        cfg.n_layers // SUB):
        x, a = _remat_super_block(cfg, x, bp, positions)
        aux = aux + a
    return L.rms_norm(x, params["lnf"]), aux / (cfg.n_layers // 2)


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg):
    x, aux = forward_hidden(params, tokens, cfg)
    return (x @ _head(params, cfg)).to(torch.float32), aux


def loss_fn(params, batch, cfg):
    """Next-token cross entropy + 0.01 * the MoE aux; under a grid the
    global token mean (``transformer.sharded_loss``)."""
    if hints.active():
        return T.sharded_loss(params, batch, cfg,
                              lambda p, t: forward_hidden(p, t, cfg))
    x, aux = forward_hidden(params, batch["tokens"], cfg)
    ce = L.chunked_ce(x[:, :-1], _head(params, cfg), batch["tokens"][:, 1:],
                      chunk=cfg.q_chunk)
    return ce + 0.01 * aux


def init_cache(cfg, batch_size: int, max_len: int, device):
    """Zero caches: attention K/V (nb, B, max_len, K, hd) in cfg.dtype,
    mamba state h (nb, 7, B, d_in, N) and conv tail (nb, 7, B, 3, d_in),
    f32."""
    nb = cfg.n_layers // SUB
    shape = (nb, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    mc = M.mamba_cache_init(batch_size, cfg.d_model, nb * (SUB - 1), device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "h": mc["h"].reshape(nb, SUB - 1, *mc["h"].shape[1:]),
            "conv": mc["conv"].reshape(nb, SUB - 1, *mc["conv"].shape[1:])}


@torch.no_grad()
def decode_step(params, cache, tokens, position: int, cfg):
    """One decode step: tokens (B, 1) at ``position`` -> (f32 logits (B, 1,
    V), cache). The cache is written in place and returned.

    Under a grid's serving hints ``params`` are this rank's shards,
    ``cache`` its slice (``launch/sharding.cache_specs``: its batch rows,
    the attention's slots, the mamba state's d_inner channels) and
    ``tokens`` the whole batch. The embedding, head and final norm are
    gathered once a call, each sublayer's weights just in time and
    dropped after it, as ``transformer.decode_step`` does: the attention
    over its K/V slots with the softmax folded over the slot ranks, each
    mamba sublayer on its state channels (``mamba.mamba_decode_step``), the
    MoE expert-parallel where the grid stores E over the seq axes. The
    logits are this rank's rows all-gathered over the batch axes. Off a
    grid every hint is the identity."""
    nb = cfg.n_layers // SUB
    B = tokens.shape[0]
    b0, b1 = hints.batch_bounds(B)
    if tuple(cache["k"].shape[:2]) != (nb, b1 - b0):
        raise ValueError(f"cache slice of {tuple(cache['k'].shape[:2])} "
                         f"super-blocks x rows, the grid's is "
                         f"{(nb, b1 - b0)} of {B} rows")
    top = T._top(params)
    x = top["embed"][tokens[b0:b1]]
    ep = cfg.moe_experts > 0 and cfg.moe_ep and hints.sharded_over(
        ("moe", "w1"), 2, hints.seq_axes())
    for b, bp in enumerate(L.unstack({k: params[k] for k in _STACK}, nb)):
        get = _gathered_sublayers(bp, ep)
        ln = hints.fsdp_gather({k: bp[k] for k in ("ln_mix", "ln_ffn")})
        for s in range(SUB):
            xn = L.rms_norm(x, ln["ln_mix"][s])
            if s == 0:
                mix, _, _ = L.attention_decode(
                    xn, hints.fsdp_gather(bp["attn"], ("attn",)),
                    cfg.attn_cfg(), cache["k"][b], cache["v"][b], position)
            else:
                mix, h, conv = M.mamba_decode_step(
                    xn, get("mamba", s - 1), cache["h"][b, s - 1],
                    cache["conv"][b, s - 1], d_model=cfg.d_model)
                cache["h"][b, s - 1] = h
                cache["conv"][b, s - 1] = conv
            x = x + mix
            y, _ = _ffn(cfg, s, L.rms_norm(x, ln["ln_ffn"][s]),
                        get("moe" if s % 2 == 0 else "mlp", s // 2), ep)
            x = x + y
    x = L.rms_norm(x, top["lnf"])
    return hints.gather_rows((x @ _head(top, cfg)).to(torch.float32)), cache


@torch.no_grad()
def prefill(params, tokens, cfg):
    """The serving prefill (the reference's hybrid prefill cell): the final
    hidden state of ``tokens`` (B, S) -> f32 logits of its last position
    (B, 1, V). Under a grid's serving hints the forward of the train cell
    (the channel-parallel mamba sublayers, the attention's K/V gathered),
    without remat; the last position is the last sequence rank's and the
    rows are all-gathered, as ``transformer.prefill`` does."""
    p = T._top(params)
    x, _ = forward_hidden(p, tokens, cfg)
    x = hints.last_position(x)
    return hints.gather_rows((x @ _head(p, cfg)).to(torch.float32))
