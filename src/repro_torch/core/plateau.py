"""Plateau criterion for the adaptive noise scale (paper §4.4; port of
``repro.core.plateau``, pure Python and the same arithmetic).

Start with sigma_init; whenever the objective has not improved for ``kappa``
communication rounds, set sigma <- beta * sigma (beta in [1.5, 2]); stop
growing once sigma >= sigma_bound. Runs on the host between rounds: the
round step reads the new sigma from ``ServerState.sigma`` (an f32 scalar)
when it runs under ``RoundContext(dynamic_sigma=True)``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class PlateauController:
    sigma_init: float
    sigma_bound: float
    kappa: int
    beta: float = 1.5
    rel_improve: float = 1e-4   # minimum relative improvement that counts

    sigma: float = dataclasses.field(init=False)
    best: float = dataclasses.field(init=False, default=math.inf)
    stale: int = dataclasses.field(init=False, default=0)
    history: list = dataclasses.field(init=False, default_factory=list)

    def __post_init__(self):
        if not (self.sigma_bound >= self.sigma_init > 0):
            raise ValueError("require sigma_bound >= sigma_init > 0")
        self.sigma = self.sigma_init

    def update(self, loss: float) -> float:
        """Feed the round loss; returns the sigma for the *next* round."""
        loss = float(loss)
        if (loss < self.best * (1.0 - self.rel_improve)
                or not math.isfinite(self.best)):
            self.best = loss
            self.stale = 0
        else:
            self.stale += 1
            if self.stale >= self.kappa and self.sigma < self.sigma_bound:
                self.sigma = min(self.sigma * self.beta, self.sigma_bound)
                self.stale = 0
                self.best = loss  # re-anchor after a scale change
        self.history.append(self.sigma)
        return self.sigma
