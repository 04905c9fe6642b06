"""Synthetic data (port of ``repro.data.synthetic``).

1. ``TokenStream``: LM tokens, deterministic and seekable per (seed, round),
   drawn from a ``torch.Generator``. Its tokens are not the reference's (jax
   and torch generators differ); tests that compare the two packages feed the
   reference's tokens to both.
2. The paper's non-i.i.d. classification task (Gaussian class clusters) and
   its client partitions: label (paper section 4.2), Dirichlet (section 4.3)
   and the per-round client batches. These draw from numpy ``RandomState``s
   exactly as the reference does, so their arrays equal the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seed: int = 0

    def round_batch(self, round_idx: int, layout: tuple, seq: int,
                    device="cpu") -> torch.Tensor:
        """layout = (groups, n_clients, E, micro) -> int64 tokens of shape
        (groups, n_clients, E, micro, seq)."""
        gen = torch.Generator(device="cpu").manual_seed(
            self.seed * 1_000_003 + round_idx)
        tokens = torch.randint(0, self.vocab, tuple(layout) + (seq,),
                               generator=gen, dtype=torch.int64)
        return tokens.to(device)


def gaussian_mixture_task(n_classes: int = 10, dim: int = 64,
                          n_per_class: int = 256, seed: int = 0):
    """-> (x, y): clustered Gaussian classification data, f32 (n, dim) and
    int32 (n,) CPU tensors."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, dim) * 3.0
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(centers[c] + rng.randn(n_per_class, dim))
        ys.append(np.full(n_per_class, c))
    return (torch.from_numpy(np.concatenate(xs).astype(np.float32)),
            torch.from_numpy(np.concatenate(ys).astype(np.int32)))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def label_partition(y, n_clients: int) -> list:
    """Extreme non-i.i.d. split (paper section 4.2): client i holds the
    samples of labels i, i + n_clients, ... -> index arrays."""
    y_np = _np(y)
    labels = np.unique(y_np)
    assert len(labels) >= n_clients
    return [np.where(np.isin(y_np, labels[i::n_clients]))[0]
            for i in range(n_clients)]


def dirichlet_partition(y, n_clients: int, alpha: float = 1.0,
                        seed: int = 0) -> list:
    """Label skew (paper section 4.3): each class is split over the clients
    by proportions drawn from a symmetric Dirichlet(alpha) -> index
    arrays (possibly empty)."""
    rng = np.random.RandomState(seed)
    y_np = _np(y)
    n_classes = int(y_np.max()) + 1
    idx_by_class = [np.where(y_np == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].append(part)
    return [np.concatenate(parts) for parts in client_idx]


def client_batches(x, y, parts, layout, seed: int, round_idx: int,
                   device="cpu") -> dict:
    """A round's batch ``{"x", "y"}`` with leading (groups, n, E, micro):
    client slot g*n + i samples ``E * micro`` indices of its part, with
    replacement (an empty part raises ValueError)."""
    groups, n, E, micro = layout
    x_np, y_np = _np(x), _np(y)
    rng = np.random.RandomState((seed * 100003 + round_idx) % (2 ** 31))
    bx = np.zeros((groups, n, E, micro, x_np.shape[-1]), np.float32)
    by = np.zeros((groups, n, E, micro), np.int32)
    for g in range(groups):
        for i in range(n):
            part = parts[(g * n + i) % len(parts)]
            sel = rng.choice(part, size=E * micro, replace=True)
            bx[g, i] = x_np[sel].reshape(E, micro, -1)
            by[g, i] = y_np[sel].reshape(E, micro)
    return {"x": torch.from_numpy(bx).to(device),
            "y": torch.from_numpy(by).to(device)}
