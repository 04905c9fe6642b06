"""Wrapper of the fused EF-SignSGD CUDA kernel, and its plain PyTorch
version (port of ``repro.kernels.efsign.ops``).

One kernel (source in ``csrc/``, built by ``repro_torch.kernels.build``):

  ``ef_sign_rows``  F1, one pass over a stack of clients that yields the
                    bitpacked payload of Sign(g + e), the new residual
                    e' = g + e - scale * Sign(g + e) and, optionally,
                    q = scale * Sign(g + e) (replaces K4, ``ef_update_pallas``)

``ef_sign_update`` and ``ef_sign_encode`` are the reference's public ops (one
client of any shape), built on F1. The wrapper takes the plain version for
tensors that lie on the CPU and launches its kernel for CUDA tensors; it
never falls back. ``ef_sign_rows.launches`` rises by one per kernel launch
and nowhere else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.wire import pack_bool, pad_to
from repro_torch.kernels.build import check_cuda, launcher, raise_on

TILE = 8192          # elements per tile (the reference's 8 x 1024 block)
CHUNK = 256 * TILE   # columns per step of the plain version


def _check_rows(g2d: torch.Tensor, e2d: torch.Tensor, scale: torch.Tensor,
                live: Optional[torch.Tensor]) -> None:
    n, d_pad = g2d.shape
    if d_pad % TILE:
        raise ValueError(f"g2d rows of {d_pad} are not a multiple of {TILE}")
    if e2d.ndim != 2 or e2d.shape[0] != n or not 1 <= e2d.shape[1] <= d_pad:
        raise ValueError(f"e2d {tuple(e2d.shape)} does not fit g2d "
                         f"{tuple(g2d.shape)}")
    if scale.shape != (n,) or (live is not None and live.shape != (n,)):
        raise ValueError(f"scale / live must have shape ({n},)")


def ef_sign_rows_plain(g2d: torch.Tensor, e2d: torch.Tensor,
                       scale: torch.Tensor, *,
                       live: Optional[torch.Tensor] = None,
                       in_place: bool = False, with_q: bool = False):
    """Plain version of F1, same arguments and results as
    ``ef_sign_rows``. Walks CHUNK columns at a time, so its temporaries stay
    (n, CHUNK) wide."""
    scale = scale.to(device=g2d.device, dtype=torch.float32)
    _check_rows(g2d, e2d, scale, live)
    n, d_pad = g2d.shape
    d = e2d.shape[1]
    e_out = e2d if in_place else e2d.clone()
    q = torch.empty((n, d), dtype=torch.float32,
                    device=g2d.device) if with_q else None
    rows = (torch.ones(n, dtype=torch.bool, device=g2d.device)
            if live is None else live.to(g2d.device) > 0)
    packed = torch.empty((n, d_pad // 8), dtype=torch.uint8,
                         device=g2d.device)
    sc = scale.reshape(n, 1)
    for s in range(0, d_pad, CHUNK):
        t, v = min(s + CHUNK, d_pad), min(s + CHUNK, d)
        e = torch.zeros((n, t - s), dtype=torch.float32, device=g2d.device)
        if v > s:
            e[:, :v - s] = e2d[:, s:v]
        p = g2d[:, s:t] + e
        pos = p >= 0
        qs = torch.where(pos, sc, -sc)
        if v > s:
            en = (p - qs)[:, :v - s]
            e_out[:, s:v] = torch.where(rows.reshape(n, 1), en, e_out[:, s:v])
            if q is not None:
                q[:, s:v] = qs[:, :v - s]
        packed[:, s // 8:t // 8] = pack_bool(pos)
    return packed, e_out, q


def ef_sign_rows(g2d: torch.Tensor, e2d: torch.Tensor, scale: torch.Tensor,
                 *, live: Optional[torch.Tensor] = None,
                 in_place: bool = False, with_q: bool = False):
    """F1: the fused EF-SignSGD step of n clients in one launch.

    g2d (n, d_pad) f32 rows (d_pad a multiple of 8192, zero past the true
    length), e2d (n, d) f32 residual rows (d <= d_pad, read as 0 past d),
    scale (n,) f32, live (n,) f32 or None. For each row, p = g + e,
    q = p >= 0 ? +scale : -scale, e' = p - q, and the payload packs p >= 0.
    -> (packed (n, d_pad/8) uint8, e_new (n, d) f32, q (n, d) f32 or None).
    Rows with ``live <= 0`` keep their residual bit-exactly. ``in_place``
    writes e_new over e2d (no second (n, d) buffer); ``with_q`` also returns
    q (the encode form has no use for it)."""
    if g2d.device.type == "cpu":
        return ef_sign_rows_plain(g2d, e2d, scale, live=live,
                                  in_place=in_place, with_q=with_q)
    scale = scale.to(device=g2d.device, dtype=torch.float32).contiguous()
    if live is not None:
        live = live.to(device=g2d.device, dtype=torch.float32).contiguous()
    _check_rows(g2d, e2d, scale, live)
    n, d_pad = g2d.shape
    d = e2d.shape[1]
    if not 1 <= n < 65536:
        raise ValueError(f"n={n} clients is outside the kernel grid")
    for name, t in (("g2d", g2d), ("e2d", e2d)):
        if t.device != g2d.device or t.dtype != torch.float32 \
                or t.stride(1) != 1:
            raise ValueError(f"{name} must be f32 rows on {g2d.device} with "
                             f"unit column stride")
    if g2d.stride(0) < d_pad:
        raise ValueError("g2d rows overlap")
    if in_place:
        e_out = e2d
    elif live is not None:
        e_out = e2d.clone()
    else:
        e_out = torch.empty((n, d), dtype=torch.float32, device=g2d.device)
    q = torch.empty((n, d), dtype=torch.float32,
                    device=g2d.device) if with_q else None
    packed = torch.empty((n, d_pad // 8), dtype=torch.uint8,
                         device=g2d.device)
    check_cuda(packed, "packed", torch.uint8)
    fn = launcher("efsign/csrc/ef_sign.cu", "ef_sign_launch")
    with torch.cuda.device(g2d.device):
        err = fn(g2d.data_ptr(), g2d.stride(0), e2d.data_ptr(),
                 e2d.stride(0), e_out.data_ptr(), e_out.stride(0),
                 None if q is None else q.data_ptr(),
                 0 if q is None else q.stride(0), scale.data_ptr(),
                 None if live is None else live.data_ptr(),
                 packed.data_ptr(), n, d, d_pad,
                 torch.cuda.current_stream().cuda_stream)
    raise_on(err, "ef_sign")
    ef_sign_rows.launches += 1
    return packed, e_out, q


ef_sign_rows.launches = 0


def _ef_call(g: torch.Tensor, e: torch.Tensor, scale, with_q: bool):
    flat_g = pad_to(g.reshape(-1).to(torch.float32), TILE)
    flat_e = e.reshape(-1).to(device=flat_g.device, dtype=torch.float32)
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=flat_g.device).reshape(1)
    return ef_sign_rows(flat_g.reshape(1, -1), flat_e.reshape(1, -1), sc,
                        with_q=with_q)


def ef_sign_update(g: torch.Tensor, e: torch.Tensor, scale):
    """Fused EF step on any-shape g and e (mirror of the reference's
    ``ef_sign_update``). Returns (q, e_new), shaped like g."""
    _, e_new, q = _ef_call(g, e, scale, with_q=True)
    return q.reshape(g.shape), e_new.reshape(g.shape)


def ef_sign_encode(g: torch.Tensor, e: torch.Tensor, scale):
    """Fused EF encode for the flat wire codec (mirror of the reference's
    ``ef_sign_encode``): -> (packed, e_new), the payload tile-padded to
    ceil(g.numel()/8192)*1024 bytes (the zero pad packs as +1 bits)."""
    packed, e_new, _ = _ef_call(g, e, scale, with_q=False)
    return packed.reshape(-1), e_new.reshape(g.shape)
