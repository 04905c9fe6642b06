"""DP-SignFedAvg (paper Algorithm 2 + Appendix F; port of
``repro.core.dp``).

Client side: clip the pseudo-gradient to L2 norm C, add N(0, sigma^2 C^2 I)
and send the sign, i.e. the z=1 sign codec whose Gaussian noise gives both
the DP guarantee and the sign-bias correction (``Pipeline`` fuses a ``dp``
stage's noise into the codec's sigma). The ``dp`` pipeline stage clips
each client row with ``clip_rows_``.

Accounting: Renyi-DP of the subsampled Gaussian mechanism (Mironov, Talwar,
Zhang 2019) with the integer-alpha closed form, converted to (eps,
delta)-DP. Pure Python, the reference's arithmetic step for step.

The norms are torch's (``torch.linalg.vector_norm``), which sums in another
order than XLA: a norm, and so a clip factor or a sto-sign sigma, can differ
from the reference's by an ulp or two. ``clip_rows_`` takes given norms so
a test can hold the rest to the reference bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def l2_norm(flat: torch.Tensor) -> torch.Tensor:
    """The f32 L2 norm of one flat buffer (a 0-d tensor on its device)."""
    return torch.linalg.vector_norm(flat)


def row_norms(p2d: torch.Tensor, n_coords: int,
              all_sum: Optional[Callable] = None) -> torch.Tensor:
    """(n,) f32: the L2 norm of each row over its first ``n_coords``
    entries, one row at a time (no (n, d) temporary).

    With ``all_sum`` the rows are flat RANGES of longer vectors whose other
    ranges lie on other ranks (the model-sharded replica): each row's sum
    of squares over its range is the partial, ``all_sum(partials, use)``
    adds the partials of every range in rank order (the same bits on every
    rank), and the norm is its square root."""
    if all_sum is None:
        return torch.stack([l2_norm(p2d[c, :n_coords])
                            for c in range(p2d.shape[0])])
    part = torch.stack([torch.sum(torch.square(p2d[c, :n_coords]))
                        for c in range(p2d.shape[0])])
    return torch.sqrt(all_sum(part, "row_norm"))


def clip_factor(nrm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``1 / max(1, nrm / max_norm)`` in the reference's f32 order."""
    return torch.reciprocal(torch.clamp_min(nrm / max_norm, 1.0))


def clip_flat(flat: torch.Tensor, max_norm: float,
              nrm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-clip a flat buffer to ``max_norm`` (Algorithm 2 line 9): ``flat *
    (1 / max(1, ||flat|| / max_norm))``. ``nrm`` gives the norm instead of
    computing it."""
    if nrm is None:
        nrm = l2_norm(flat)
    nrm = torch.as_tensor(nrm, dtype=torch.float32, device=flat.device)
    return flat * clip_factor(nrm, max_norm)


def clip_rows_(p2d: torch.Tensor, n_coords: int, max_norm: float,
               nrms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``clip_flat`` of each row's first ``n_coords`` entries, IN PLACE (the
    padding past them stays zero); ``nrms`` gives the (n,) norms instead of
    ``row_norms``. -> p2d."""
    if nrms is None:
        nrms = row_norms(p2d, n_coords)
    nrms = torch.as_tensor(nrms, dtype=torch.float32, device=p2d.device)
    factor = clip_factor(nrms, max_norm)
    for c in range(p2d.shape[0]):
        p2d[c, :n_coords].mul_(factor[c])
    return p2d


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def rdp_subsampled_gaussian(q: float, noise_multiplier: float,
                            steps: int, alphas: Sequence[int]) -> list:
    """RDP epsilon at each integer alpha after ``steps`` compositions.

    For q == 1 (full participation) uses the exact Gaussian-mechanism RDP
    alpha / (2 sigma^2); otherwise the binomial-expansion upper bound for the
    sampled Gaussian mechanism (valid for integer alpha >= 2).
    """
    sig = noise_multiplier
    out = []
    for a in alphas:
        if a < 2:
            raise ValueError("alpha must be >= 2")
        if q >= 1.0:
            eps_a = a / (2.0 * sig * sig)
        else:
            # log E_{k~Bin(alpha,q)} exp(k(k-1)/(2 sigma^2))
            log_terms = [
                _log_comb(a, k) + k * math.log(q) + (a - k) * math.log1p(-q)
                + k * (k - 1) / (2.0 * sig * sig)
                for k in range(a + 1)
            ]
            m = max(log_terms)
            log_mgf = m + math.log(sum(math.exp(t - m) for t in log_terms))
            eps_a = log_mgf / (a - 1)
        out.append(steps * eps_a)
    return out


def compute_epsilon(q: float, noise_multiplier: float, steps: int,
                    delta: float,
                    alphas: Sequence[int] = tuple(range(2, 256))) -> float:
    """(eps, delta)-DP from the optimal RDP order."""
    rdp = rdp_subsampled_gaussian(q, noise_multiplier, steps, alphas)
    return min(r + math.log(1.0 / delta) / (a - 1)
               for r, a in zip(rdp, alphas))


def calibrate_noise(q: float, steps: int, target_eps: float, delta: float,
                    lo: float = 0.3, hi: float = 50.0,
                    iters: int = 60) -> float:
    """Smallest noise multiplier achieving (target_eps, delta)-DP
    (bisection)."""
    if compute_epsilon(q, hi, steps, delta) > target_eps:
        raise ValueError("target epsilon unreachable within noise bound")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if compute_epsilon(q, mid, steps, delta) > target_eps:
            lo = mid
        else:
            hi = mid
    return hi
