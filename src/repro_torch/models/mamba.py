"""Selective SSM (Mamba-1 style) block (port of ``repro.models.mamba``):
the chunked selective scan for training and the O(1) one-token recurrence
for decode.

The scan carries the (B, d_inner, d_state) f32 state through a Python loop
over the time steps of each chunk; each chunk's decay and input terms are
computed at once, elementwise as the reference's step computes them. Each
chunk is rematerialized in the backward pass, as the reference's is
(``hints.remat_chunk``): the backward keeps the chunk carries, not every
step's state. Every tensor made here lies on the device of the inputs.

Under a grid (``launch/hints.py``) the block is channel-parallel, as the
reference's is: the time recurrence cannot be split over the sequence, but
each channel of d_inner runs on its own. The input is gathered along the
sequence (``gather_seq``), and this rank computes on its contiguous slice
of d_inner over the seq axes, with every channel-indexed tensor cut the
same way (the x- and z-half columns of ``in_proj``, ``conv_w``, the rows of
``x_proj``, the columns of ``dt_proj``, ``dt_bias``, ``a_log``,
``d_skip``, the rows of ``out_proj``). ``x_in @ x_proj`` over a channel
slice is a partial, summed over the seq axes before dt, B and C are formed
(``sum_partials``); ``y @ out_proj`` is one too, reduce-scattered to this
rank's sequence slice (``scatter_seq``). The conv and the chunked scan run
on the whole sequence, chunked on its global length. The caller hands in
the sublayer's gathered weights (``hints.fsdp_gather``: the stored shards
of ``in_proj`` do not line up with the channel slices, see
``launch/sharding.py``). Off a grid every hint is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import hints
from repro_torch.models.layers import _init

D_STATE = 16
D_CONV = 4
CHUNK = 256
#: f32 bit patterns of log(1..D_STATE) as the reference computes them (XLA's
#: f32 log): its log(7) lies one ulp above the correctly rounded value that
#: torch's CPU log gives, so a table, not a device's log, keeps a_log equal
#: to the bit in both packages on any device
_A_LOG_BITS = (0, 1060205080, 1066180436, 1068593688, 1070465552, 1071994976,
               1073288086, 1074075026, 1074569044, 1075010958, 1075410718,
               1075775670, 1076111393, 1076422225, 1076711602, 1076982296)


def mamba_init(gen, d_model: int, n_layers: int, dtype, device,
               expand: int = 2):
    d_in = expand * d_model
    dt_rank = max(1, d_model // 16)
    a = torch.tensor(_A_LOG_BITS, dtype=torch.int32).view(torch.float32)
    a = a.to(device)
    return {
        "in_proj": _init(gen, (n_layers, d_model, 2 * d_in), dtype=dtype,
                         device=device),
        "conv_w": _init(gen, (n_layers, D_CONV, d_in), scale=0.5,
                        dtype=dtype, device=device),
        "x_proj": _init(gen, (n_layers, d_in, dt_rank + 2 * D_STATE),
                        dtype=dtype, device=device),
        "dt_proj": _init(gen, (n_layers, dt_rank, d_in),
                         scale=dt_rank ** -0.5, dtype=dtype, device=device),
        "dt_bias": torch.zeros((n_layers, d_in), dtype=dtype, device=device),
        "a_log": a.expand(n_layers, d_in, D_STATE).contiguous(),
        "d_skip": torch.ones((n_layers, d_in), dtype=torch.float32,
                             device=device),
        "out_proj": _init(gen, (n_layers, d_in, d_model), dtype=dtype,
                          device=device),
    }


def _ssm_params(x_in, lp, dt_rank):
    """x_in: (B, T, d_in) -> dt (B, T, d_in), B_ / C_ (B, T, d_state), f32."""
    return _ssm_from_proj(x_in @ lp["x_proj"], lp, dt_rank)


def _ssm_from_proj(proj, lp, dt_rank):
    """The ``x_proj`` output (B, T, dt_rank + 2 d_state) -> dt, B_, C_."""
    dt_low, B_, C_ = torch.split(proj, [dt_rank, D_STATE, D_STATE], dim=-1)
    dt = F.softplus(dt_low @ lp["dt_proj"] + lp["dt_bias"])
    return dt.float(), B_.float(), C_.float()


def _scan_chunk(h, dt, B_, C_, x, A):
    """One chunk of the scan from the carry ``h``: dt / x (B, c, d_in)
    (x f32), B_ / C_ (B, c, N), A (d_in, N). -> y (B, c, d_in) f32, h at
    the chunk's end. The decay and input terms of the chunk are computed at
    once, elementwise as the reference's step computes them."""
    da = torch.exp(dt[..., None] * A)                     # (B, c, d_in, N)
    dbx = (dt * x)[..., None] * B_[:, :, None, :]
    hs = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    return torch.einsum("btdn,btn->btd", torch.stack(hs, dim=1), C_), h


def _scan_chunked(dt, B_, C_, x, a_log, h0):
    """Selective scan. dt / x: (B, T, d_in); B_ / C_: (B, T, N); h0: (B, d_in,
    N) f32. -> y (B, T, d_in) f32, h_T. Step t: h = exp(dt_t A) h + (dt_t
    x_t) B_t; y_t = sum_n h C_t. The steps run in the reference's chunks
    of c = T // max(1, T // 256) (with a shorter last chunk where they do
    not tile T, a length the reference's reshape refuses), each chunk its
    own remat region (``hints.remat_chunk``): the backward keeps the chunk
    carries and the inputs, and holds one chunk's steps at a time."""
    T = x.shape[1]
    c = T // max(1, T // CHUNK)
    A = -torch.exp(a_log)                                      # (d_in, N)
    x = x.float()
    h, ys = h0, []
    for c0 in range(0, T, c):
        sl = slice(c0, c0 + c)
        y, h = hints.remat_chunk(_scan_chunk, h, dt[:, sl], B_[:, sl],
                                 C_[:, sl], x[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _causal_conv(x, w):
    """Depthwise causal conv, x: (B, T, d_in); w: (K, d_in): the taps summed
    by Python's ``sum`` (from 0, tap 0 first) in x's dtype, as the
    reference writes it."""
    T = x.shape[1]
    xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    return sum(xp[:, i:i + T, :] * w[i] for i in range(D_CONV))


def mamba_block(x, lp, *, d_model: int):
    """x: (B, T, D) -> (B, T, D). Training forward; channel-parallel under
    a grid (x and the output this rank's sequence slice, ``lp`` the
    gathered weights)."""
    del d_model
    if hints.active():
        return _channel_block(x, lp)
    d_in = lp["in_proj"].shape[-1] // 2
    dt_rank = lp["dt_proj"].shape[0]
    xz = x @ lp["in_proj"]
    x_in, z = torch.split(xz, d_in, dim=-1)
    x_in = F.silu(_causal_conv(x_in, lp["conv_w"]))
    dt, B_, C_ = _ssm_params(x_in, lp, dt_rank)
    h0 = torch.zeros((x.shape[0], d_in, D_STATE), dtype=torch.float32,
                     device=x.device)
    y, _ = _scan_chunked(dt, B_, C_, x_in, lp["a_log"], h0)
    y = y + x_in.float() * lp["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ lp["out_proj"]


def _channel_slice(d_in: int) -> slice:
    """This rank's contiguous slice of the d_inner channels: d_inner over
    the seq axes, in their rank order."""
    n = hints.seq_shard_count()
    if d_in % n:
        raise ValueError(f"d_inner {d_in} does not split over {n} ranks")
    c = d_in // n
    i = hints.seq_index()
    return slice(i * c, (i + 1) * c)


def _channel_block(x, lp):
    """``mamba_block`` on this rank's channel slice of the whole sequence:
    x (B, T_loc, D) -> (B, T_loc, D)."""
    d_in = lp["in_proj"].shape[-1] // 2
    dt_rank = lp["dt_proj"].shape[0]
    ch = _channel_slice(d_in)
    zc = slice(d_in + ch.start, d_in + ch.stop)
    xs = hints.gather_seq(x, use="mamba_in")                 # (B, S, D)
    w_in = lp["in_proj"]
    x_in = F.silu(_causal_conv(xs @ w_in[:, ch], lp["conv_w"][:, ch]))
    z = xs @ w_in[:, zc]
    proj = hints.sum_partials(x_in @ lp["x_proj"][ch], use="mamba_xproj")
    part = {"dt_proj": lp["dt_proj"][:, ch], "dt_bias": lp["dt_bias"][ch]}
    dt, B_, C_ = _ssm_from_proj(proj, part, dt_rank)
    h0 = torch.zeros((x.shape[0], ch.stop - ch.start, D_STATE),
                     dtype=torch.float32, device=x.device)
    y, _ = _scan_chunked(dt, B_, C_, x_in, lp["a_log"][ch], h0)
    y = y + x_in.float() * lp["d_skip"][ch]
    y = y.to(x.dtype) * F.silu(z)
    return hints.scatter_seq(y @ lp["out_proj"][ch], use="mamba_out")


def mamba_cache_init(batch: int, d_model: int, n_layers: int, device,
                     expand: int = 2):
    d_in = expand * d_model
    return {"h": torch.zeros((n_layers, batch, d_in, D_STATE),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((n_layers, batch, D_CONV - 1, d_in),
                                dtype=torch.float32, device=device)}


def _whole_width(t, ch: slice, d_in: int):
    """``t``, this rank's channels ``ch`` of d_inner along its last
    dimension, laid into zeros of the whole width (``t`` itself where ``ch`` is every
    channel). The card's batched matmul behind the decode step's conv
    einsum sums a channel's taps otherwise over a slice of the channels
    than over all of them (an H100 gave 9.5e-7 apart at 8,192 of 16,384
    channels): at the whole width each channel is summed as one process
    sums it."""
    if ch.stop - ch.start == d_in:
        return t
    whole = t.new_zeros(t.shape[:-1] + (d_in,))
    whole[..., ch] = t
    return whole


def mamba_decode_step(x, lp, h, conv_tail, *, d_model: int):
    """One-token recurrence. x: (B, 1, D); h: (B, d_in, N); conv_tail: (B,
    D_CONV-1, d_in). -> (y, h, conv_tail). Its conv is an f32 einsum over
    an f32 window (the training conv sums in x's dtype), as the
    reference's.

    Under a grid's serving hints whose cache cuts the state's d_inner
    (``hints.state_bounds``: over the axes the cache's spec names), ``h``
    and ``conv_tail`` are this rank's channels [lo, hi) and only they are
    stepped; ``lp`` holds the sublayer's gathered weights. The conv's
    activations (the input of ``x_proj``) and the gated output (the input
    of ``out_proj``) are all-gathered over the channel ranks, B_loc x
    d_inner each in x's dtype (``all_gather:mamba_act``, ``:mamba_y``), so
    every sum over channels is the one-process sum and every rank returns
    the one-process bits (the conv's taps are summed at the whole width,
    ``_whole_width``). Off a grid the channels are all of d_inner and both
    gathers are the identity."""
    del d_model
    d_in = lp["in_proj"].shape[-1] // 2
    dt_rank = lp["dt_proj"].shape[0]
    lo, hi = hints.state_bounds(d_in)
    if h.shape[1] != hi - lo or conv_tail.shape[2] != hi - lo:
        raise ValueError(f"mamba state slice of {h.shape[1]} / "
                         f"{conv_tail.shape[2]} channels, the grid's is "
                         f"{hi - lo} of {d_in}")
    ch = slice(lo, hi)
    xz = x @ lp["in_proj"]
    x_in, z = torch.split(xz, d_in, dim=-1)                    # (B, 1, d_in)
    window = torch.cat([conv_tail, x_in[..., ch].float()], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", _whole_width(window, ch, d_in),
                            lp["conv_w"].float())[:, ch]
    x_c = F.silu(conv_out)[:, None, :]                         # (B, 1, c)
    x_all = hints.gather_state(x_c.to(x.dtype), 2, "mamba_act")
    dt, B_, C_ = _ssm_params(x_all, lp, dt_rank)
    A = -torch.exp(lp["a_log"][ch])
    da = torch.exp(dt[:, 0, ch, None] * A)
    h = da * h + (dt[:, 0, ch] * x_c[:, 0].float())[..., None] \
        * B_[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_[:, 0])
    y = y + x_c[:, 0].float() * lp["d_skip"][ch]
    y = y[:, None, :].to(x.dtype) * F.silu(z[..., ch])
    y = hints.gather_state(y, 2, "mamba_y")
    return y @ lp["out_proj"], h, window[:, 1:]
