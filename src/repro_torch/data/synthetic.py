"""Synthetic token stream (port of ``repro.data.synthetic.TokenStream``).

Deterministic and seekable per (seed, round), drawn from a ``torch.Generator``.
Its tokens are not the reference's (jax and torch generators differ); tests
that compare the two packages feed the reference's tokens to both.
"""
from __future__ import annotations

import dataclasses

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
