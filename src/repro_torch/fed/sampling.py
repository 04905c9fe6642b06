"""Client participation (port of ``repro.fed.sampling``,
``ParticipationSampler``): pure numpy, so the same seed gives the reference's
identical mask."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ParticipationSampler:
    """Uniform partial participation with straggler over-provisioning
    (sample ceil(k * over_provision), keep k) and injected failures; the
    mask is exactly 0/1 and never all-zero."""
    total_clients: int
    per_round: int
    over_provision: float = 1.0
    failure_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def mask(self, layout: tuple) -> np.ndarray:
        """layout = (groups, n_clients) slots for this round."""
        groups, n = layout
        slots = groups * n
        m = min(slots, int(np.ceil(self.per_round * self.over_provision)))
        chosen = self._rng.choice(slots, size=m, replace=False)
        if m > self.per_round:  # straggler cut: keep the first k acks
            chosen = self._rng.permutation(chosen)[: self.per_round]
        mask = np.zeros(slots, np.float32)
        mask[chosen] = 1.0
        if self.failure_rate > 0:
            fail = self._rng.rand(slots) < self.failure_rate
            mask[fail] = 0.0
        if mask.sum() == 0:  # never lose a whole round
            mask[self._rng.randint(slots)] = 1.0
        return mask.reshape(groups, n)
