"""xLSTM blocks (port of ``repro.models.xlstm``, arXiv:2405.04517): mLSTM
(matrix memory) in its parallel training form and sLSTM (scalar memory),
strictly recurrent, and the LM of groups of 3 mLSTM + 1 sLSTM blocks.

mLSTM trains by the stabilised log-gate decay matrix, chunked over the KEY
axis with an online running max, in the reference's chunking and order of
f32 updates; decode is the O(1) matrix-memory recurrence. sLSTM steps
through the sequence in a Python loop (no parallel form exists), each of
the reference's scan chunks rematerialized in the backward pass as the
reference's is. The assigned xlstm-350m has d_ff = 0: the blocks carry
their own projections. Every tensor made here lies on the device of the
inputs.

Under a grid (``launch/hints.py``, the model-sharded replica) the params
are this rank's shards and the residual stream its sequence slice: each
block gathers its weights (``fsdp_gather``, the reference's
``fsdp_params``) and its output stays on the slice (``seq_shard``). The
mLSTM keeps its query rows and gathers K, V, the input gate and log
sigmoid(forget) along the sequence (``gather_seq``): the forget gates'
cumulative sum crosses the shards, so it is taken over the gathered gates
and this rank's rows are sliced out of it (the one-process values, where a
per-rank prefix offset would add in another order); the causal mask takes
the queries' global positions and the key chunks the global length. The
sLSTM gathers its normed input (D wide, in the model's dtype), runs the
recurrence over the whole sequence on every sequence rank and keeps this
rank's rows before ``wo``; the gather's backward sums each rank's share.
Each group of 4 blocks is rematerialized (``hints.remat``), on a grid and
off it as the reference's is: under a grid keeping the gathered tensors
(and the gathered weights under ``remat_save_weights``), off it only the
group's input. Off a grid every other hint is the identity.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.launch import hints
from repro_torch.models import transformer
from repro_torch.models.layers import _init, chunked_ce, meta_shapes, \
    rms_norm, unstack

CHUNK = 256
GROUP = 4  # 3 mLSTM + 1 sLSTM per group
_STACK = ("mlstm", "slstm", "ln")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d_model: int, n_heads: int, n_layers: int, dtype,
               device):
    return {
        "wqkv": _init(gen, (n_layers, d_model, 3 * d_model), dtype=dtype,
                      device=device),
        "wif": _init(gen, (n_layers, d_model, 2 * n_heads), scale=0.02,
                     dtype=dtype, device=device),
        "bif": torch.zeros((n_layers, 2 * n_heads), dtype=torch.float32,
                           device=device),
        "wo": _init(gen, (n_layers, d_model, d_model), dtype=dtype,
                    device=device),
        "ln_sk": torch.ones((n_layers, d_model), dtype=dtype, device=device),
    }


def _mlstm_gates(x, lp):
    """-> (input-gate pre-activation, log sigmoid(forget)), each (B, T, H)
    f32."""
    gif = x.float() @ lp["wif"].float() + lp["bif"]
    i_pre, f_pre = torch.chunk(gif, 2, dim=-1)
    return i_pre, -F.softplus(-f_pre)


def mlstm_block(x, lp, *, n_heads: int):
    """Parallel (chunk-quadratic) mLSTM forward. x: (B, T, D), under a grid
    this rank's sequence slice [lo, lo + T) of the whole length S (S = T
    off a grid). Keys are chunked by kc = min(256, S) (kc = S when it does
    not divide S); row t keeps the running max m (floored at -1e30),
    numerator and denominator of sum_s exp(F_t - F_s + i_s - m) (q_t .
    k_s) over s <= t; masked exponents are -inf, so they weigh exactly
    0."""
    B, T, D = x.shape
    H, hd = n_heads, D // n_heads
    S = hints.seq_len(T)
    lo, _ = hints.seq_bounds(S)
    q, k, v = torch.chunk(x @ lp["wqkv"], 3, dim=-1)
    q = q.reshape(B, T, H, hd).transpose(1, 2)            # (B, H, T, hd)
    # keys, values and gates of the whole sequence (gathered on a grid)
    k = hints.gather_seq(k.reshape(B, T, H, hd) / (hd ** 0.5)).transpose(
        1, 2)
    v = hints.gather_seq(v.reshape(B, T, H, hd)).transpose(1, 2)
    i_pre, log_f = _mlstm_gates(x, lp)
    i_pre = hints.gather_seq(i_pre, use="gates").transpose(1, 2)  # (B,H,S)
    Fc = torch.cumsum(hints.gather_seq(log_f, use="gates").transpose(1, 2),
                      dim=-1)                             # log prod f
    Fq = Fc[..., lo:lo + T]                               # the query rows
    kc = min(CHUNK, S)
    if S % kc != 0:
        kc = S
    qf = q.float()
    t_pos = torch.arange(lo, lo + T, device=x.device)
    s_pos = torch.arange(S, device=x.device)
    m = torch.full((B, H, T), -1e30, dtype=torch.float32, device=x.device)
    num = torch.zeros((B, H, T, hd), dtype=torch.float32, device=x.device)
    den = torch.zeros((B, H, T), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, kc):
        sl = slice(c0, c0 + kc)
        expo = Fq[..., :, None] - Fc[..., None, sl] + i_pre[..., None, sl]
        mask = t_pos[:, None] >= s_pos[None, sl]
        expo = torch.where(mask, expo, float("-inf"))      # (B, H, T, kc)
        m_new = torch.maximum(torch.maximum(m, expo.amax(dim=-1)),
                              m.new_tensor(-1e30))
        w = torch.exp(expo - m_new[..., None])
        qk = torch.einsum("bhtd,bhsd->bhts", qf, k[:, :, sl].float())
        sc = qk * w
        scale = torch.exp(m - m_new)
        num = num * scale[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", sc, v[:, :, sl].float())
        den = den * scale + sc.sum(dim=-1)
        m = m_new
    y = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    y = y.transpose(1, 2).reshape(B, T, D).to(x.dtype)
    return rms_norm(y, lp["ln_sk"]) @ lp["wo"]


def mlstm_cache_init(batch, d_model, n_heads, n_layers, device):
    hd = d_model // n_heads
    return {"C": torch.zeros((n_layers, batch, n_heads, hd, hd),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((n_layers, batch, n_heads, hd),
                             dtype=torch.float32, device=device),
            "m": torch.full((n_layers, batch, n_heads), -1e30,
                            dtype=torch.float32, device=device)}


def mlstm_decode_step(x, lp, C, n, m, *, n_heads: int):
    """O(1) recurrent step. x: (B, 1, D) -> (y, C, n, m)."""
    B, _, D = x.shape
    H, hd = n_heads, D // n_heads
    q, k, v = torch.chunk(x @ lp["wqkv"], 3, dim=-1)
    q = q.reshape(B, H, hd).float()
    k = (k.reshape(B, H, hd) / (hd ** 0.5)).float()
    v = v.reshape(B, H, hd).float()
    i_pre, log_f = _mlstm_gates(x, lp)
    i_pre, log_f = i_pre[:, 0], log_f[:, 0]               # (B, H)
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_pre)
    dec = torch.exp(lfm - m_new)[..., None]
    inp = torch.exp(i_pre - m_new)[..., None]
    C = dec[..., None] * C + (inp * k)[..., :, None] * v[..., None, :]
    n = dec * n + inp * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    y = (num / den).reshape(B, 1, D).to(x.dtype)
    return rms_norm(y, lp["ln_sk"]) @ lp["wo"], C, n, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d_model: int, n_heads: int, n_layers: int, dtype,
               device):
    hd = d_model // n_heads
    return {
        "wx": _init(gen, (n_layers, d_model, 4 * d_model), dtype=dtype,
                    device=device),
        # block-diagonal recurrent weights, one (hd, 4*hd) block per head,
        # f32 in any model dtype
        "wr": _init(gen, (n_layers, n_heads, hd, 4 * hd), scale=hd ** -0.5,
                    dtype=torch.float32, device=device),
        "b": torch.zeros((n_layers, 4 * d_model), dtype=torch.float32,
                         device=device),
        "wo": _init(gen, (n_layers, d_model, d_model), dtype=dtype,
                    device=device),
        "ln_sk": torch.ones((n_layers, d_model), dtype=dtype, device=device),
    }


def _slstm_step(carry, x_t, wr, n_heads):
    """carry (h, c, n, m), each (B, D) f32; x_t: (B, 4D) input
    pre-activation. -> (carry, h)."""
    h, c, n, m = carry
    B, D = h.shape
    rec = torch.einsum("bkh,khf->bkf", h.reshape(B, n_heads, D // n_heads),
                       wr).reshape(B, 4 * D)
    z_pre, i_pre, f_pre, o_pre = torch.chunk(x_t + rec, 4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    lfm = -F.softplus(-f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(lfm - m_new)
    c = f * c + i * z
    n = torch.maximum(f * n + i, torch.exp(-m_new))
    h_new = o * (c / n)
    return (h_new, c, n, m_new), h_new


def _slstm_chunk(h, c, n, m, x_pre, wr, *, n_heads):
    """The steps of one scan chunk from the carry (h, c, n, m): x_pre (B,
    c, 4D). -> (h, c, n, m at the chunk's end, every step's h (B, c,
    D))."""
    carry, hs = (h, c, n, m), []
    for t in range(x_pre.shape[1]):
        carry, h = _slstm_step(carry, x_pre[:, t], wr, n_heads)
        hs.append(h)
    return (*carry, torch.stack(hs, dim=1))


def _slstm_scan(x_pre, wr, n_heads):
    """The recurrence over x_pre (B, S, 4D) from the zero carry -> every
    step's h (B, S, D), in the reference's chunks of c = S // max(1, S //
    256) steps (a shorter last chunk where they do not tile S), each chunk
    its own remat region (``hints.remat_chunk``): the backward keeps the
    chunk carries and the pre-activation, one chunk's steps at a time."""
    B, S = x_pre.shape[:2]
    carry = _slstm_carry0(B, x_pre.shape[2] // 4, x_pre.device)
    c = S // max(1, S // CHUNK)
    hs = []
    for c0 in range(0, S, c):
        *carry, h = hints.remat_chunk(partial(_slstm_chunk, n_heads=n_heads),
                                      *carry, x_pre[:, c0:c0 + c], wr)
        hs.append(h)
    return torch.cat(hs, dim=1)


def _slstm_carry0(batch, d_model, device):
    """h = c = 0, n = 1e-6, m = -1e30 (four tensors: decode writes them in
    place)."""
    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, d_model), **z),
            torch.zeros((batch, d_model), **z),
            torch.full((batch, d_model), 1e-6, **z),
            torch.full((batch, d_model), -1e30, **z))


def slstm_block(x, lp, *, n_heads: int):
    """Sequential sLSTM, x: (B, T, D): one step a position, each scan
    chunk rematerialized (``_slstm_scan``). Under a grid x is this rank's
    sequence slice: the slices are gathered (``gather_seq``, D wide in x's
    dtype, not the 4D-wide f32 pre-activation), the recurrence runs over
    the whole sequence and this rank's rows are kept before ``wo``."""
    xs = hints.gather_seq(x, use="slstm_in")                 # (B, S, D)
    S = xs.shape[1]
    lo, hi = hints.seq_bounds(S)
    x_pre = (xs @ lp["wx"]).float() + lp["b"]                 # (B, S, 4D)
    h = _slstm_scan(x_pre, lp["wr"].float(), n_heads)[:, lo:hi].to(x.dtype)
    return rms_norm(h, lp["ln_sk"]) @ lp["wo"]


def slstm_cache_init(batch, d_model, n_layers, device):
    return dict(zip("hcnm", (torch.stack([t] * n_layers) for t in
                             _slstm_carry0(batch, d_model, device))))


def slstm_decode_step(x, lp, h, c, n, m, *, n_heads: int):
    """One sLSTM step, x: (B, 1, D) -> (y, h, c, n, m). Under a grid's
    serving hints whose cache cuts the state's D (``hints.state_bounds``)
    h, c, n and m are this rank's channels [lo, hi): the recurrence mixes
    channels across heads (``rec`` is (B, H, 4 hd) laid out as (B, 4D) and
    split into the four gates), so the four slices are all-gathered over
    the channel ranks in one tensor (``all_gather:slstm_state``), the step
    runs whole as in one process and this rank's slice of the new state is
    kept. Off a grid the state is whole."""
    D = x.shape[-1]
    lo, hi = hints.state_bounds(D)
    if h.shape[-1] != hi - lo:
        raise ValueError(f"sLSTM state slice of {h.shape[-1]} channels, the "
                         f"grid's is {hi - lo} of {D}")
    if hi - lo < D:
        h, c, n, m = hints.gather_state(torch.stack([h, c, n, m]), 2,
                                        "slstm_state").unbind(0)
    x_pre = (x[:, 0] @ lp["wx"]).float() + lp["b"]
    (h, c, n, m), h_out = _slstm_step((h, c, n, m), x_pre, lp["wr"].float(),
                                      n_heads)
    y = rms_norm(h_out[:, None, :].to(x.dtype), lp["ln_sk"])
    if hi - lo < D:
        h, c, n, m = (t[:, lo:hi] for t in (h, c, n, m))
    return y @ lp["wo"], h, c, n, m


# ---------------------------------------------------------------------------
# the xLSTM LM: groups of 4 (3 mLSTM + 1 sLSTM) over depth
# ---------------------------------------------------------------------------

def init_params(gen, cfg, device):
    ng = cfg.n_layers // GROUP
    D, V, H, dtype = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.dtype
    p = {
        "embed": _init(gen, (V, D), scale=0.02, dtype=dtype, device=device),
        "mlstm": mlstm_init(gen, D, H, ng * (GROUP - 1), dtype, device),
        "slstm": slstm_init(gen, D, H, ng, dtype, device),
        "ln": torch.ones((ng, GROUP, D), dtype=dtype, device=device),
        "lnf": torch.ones((D,), dtype=dtype, device=device),
    }
    p["mlstm"] = {k: w.reshape(ng, GROUP - 1, *w.shape[1:])
                  for k, w in p["mlstm"].items()}
    if not cfg.tie_embeddings:
        p["lm_head"] = _init(gen, (D, V), scale=0.02, dtype=dtype,
                             device=device)
    return p


def param_shapes(cfg):
    return meta_shapes(init_params, cfg)


def _group_fwd(cfg, x, gp):
    """One group: 3 mLSTM blocks and the sLSTM, each on its pre-norm and
    added to the residual; under a grid each block's weights gathered just
    in time and its sum kept on this rank's slice."""
    mlstm = unstack(gp["mlstm"], GROUP - 1)
    ln = hints.fsdp_gather({"ln": gp["ln"]})["ln"]
    for s in range(GROUP):
        xn = rms_norm(x, ln[s])
        if s < GROUP - 1:
            lp = hints.fsdp_gather(mlstm[s], ("mlstm",), stacked=2)
            x = hints.seq_shard(x + mlstm_block(xn, lp, n_heads=cfg.n_heads))
        else:
            lp = hints.fsdp_gather(gp["slstm"], ("slstm",))
            x = hints.seq_shard(x + slstm_block(xn, lp, n_heads=cfg.n_heads))
    return x


def _remat_group(cfg, x, gp):
    """One group rematerialized in the backward pass; under a grid with
    its gathered K/V, gates and sLSTM input (and weights, under
    ``remat_save_weights``) kept."""
    return hints.remat(partial(_group_fwd, cfg), cfg.remat_save_weights,
                       x, gp)


def forward_hidden(params, tokens, cfg):
    """tokens (B, S) -> final-norm hidden states (B, S, D); under a grid
    this rank's (batch and) sequence slice of them, the embedding looked up
    in the table the caller gathered (``transformer._top``)."""
    hints.local_positions(tokens.shape[0], tokens.shape[1],
                          params["embed"].device)
    x = params["embed"][hints.seq_shard(tokens)]
    for gp in unstack({k: params[k] for k in _STACK},
                      cfg.n_layers // GROUP):
        x = _remat_group(cfg, x, gp)
    return rms_norm(x, params["lnf"])


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg):
    return (forward_hidden(params, tokens, cfg) @ _head(params, cfg)).to(
        torch.float32)


def loss_fn(params, batch, cfg):
    """Next-token cross entropy, sequence-chunked; under a grid the global
    token mean (``transformer.sharded_loss``)."""
    if hints.active():
        return transformer.sharded_loss(
            params, batch, cfg,
            lambda p, t: (forward_hidden(p, t, cfg), None))
    x = forward_hidden(params, batch["tokens"], cfg)
    return chunked_ce(x[:, :-1], _head(params, cfg), batch["tokens"][:, 1:],
                      chunk=cfg.q_chunk)


def init_cache(cfg, batch_size: int, max_len: int, device):
    """The O(1) recurrent state, whatever ``max_len``: mLSTM C (ng, 3, B, H,
    hd, hd), n (ng, 3, B, H, hd), m (ng, 3, B, H); sLSTM h, c, n, m (ng,
    B, D); all f32."""
    del max_len
    ng = cfg.n_layers // GROUP
    mc = mlstm_cache_init(batch_size, cfg.d_model, cfg.n_heads,
                          ng * (GROUP - 1), device)
    mc = {k: w.reshape(ng, GROUP - 1, *w.shape[1:]) for k, w in mc.items()}
    return {"m": mc, "s": slstm_cache_init(batch_size, cfg.d_model, ng,
                                           device)}


@torch.no_grad()
def decode_step(params, cache, tokens, position: int, cfg):
    """One decode step: tokens (B, 1) -> (f32 logits (B, 1, V), cache); the
    recurrent state is written in place and returned (``position`` is not
    needed).

    Under a grid's serving hints ``params`` are this rank's shards,
    ``cache`` its slice (``launch/sharding.cache_specs``: its batch rows;
    the sLSTM's D channels over the axes its spec names) and ``tokens``
    the whole batch. The embedding, head and final norm are gathered once a
    call, each block's weights just in time and dropped after it; the
    mLSTM steps this rank's rows, the sLSTM gathers its state's channels
    (``slstm_decode_step``); the logits are this rank's rows all-gathered
    over the batch axes. Off a grid every hint is the identity."""
    del position
    ng = cfg.n_layers // GROUP
    B = tokens.shape[0]
    b0, b1 = hints.batch_bounds(B)
    mc, sc = cache["m"], cache["s"]
    if tuple(mc["C"].shape[:3]) != (ng, GROUP - 1, b1 - b0):
        raise ValueError(f"cache slice of {tuple(mc['C'].shape[:3])} "
                         f"groups x blocks x rows, the grid's is "
                         f"{(ng, GROUP - 1, b1 - b0)} of {B} rows")
    top = transformer._top(params)
    x = top["embed"][tokens[b0:b1]]
    for g, gp in enumerate(unstack({k: params[k] for k in _STACK}, ng)):
        mlstm = unstack(gp["mlstm"], GROUP - 1)
        ln = hints.fsdp_gather({"ln": gp["ln"]})["ln"]
        for s in range(GROUP):
            xn = rms_norm(x, ln[s])
            if s < GROUP - 1:
                lp = hints.fsdp_gather(mlstm[s], ("mlstm",), stacked=2)
                y, *state = mlstm_decode_step(
                    xn, lp, mc["C"][g, s], mc["n"][g, s], mc["m"][g, s],
                    n_heads=cfg.n_heads)
                for name, new in zip("Cnm", state):
                    mc[name][g, s] = new
            else:
                lp = hints.fsdp_gather(gp["slstm"], ("slstm",))
                y, *state = slstm_decode_step(
                    xn, lp, *(sc[name][g] for name in "hcnm"),
                    n_heads=cfg.n_heads)
                for name, new in zip("hcnm", state):
                    sc[name][g] = new
            x = x + y
            del lp
    x = rms_norm(x, top["lnf"])
    return hints.gather_rows((x @ _head(top, cfg)).to(torch.float32)), cache


@torch.no_grad()
def prefill(params, tokens, cfg):
    """The serving prefill (the reference's xLSTM prefill cell): the final
    hidden state of ``tokens`` (B, S) -> f32 logits of its last position
    (B, 1, V). Under a grid's serving hints the forward of the train cell
    (the mLSTM across sequence shards, the sLSTM run whole on each sequence
    rank), without remat; the last position is the last sequence rank's
    and the rows are all-gathered, as ``transformer.prefill`` does."""
    p = transformer._top(params)
    x = hints.last_position(forward_hidden(p, tokens, cfg))
    return hints.gather_rows((x @ _head(p, cfg)).to(torch.float32))
