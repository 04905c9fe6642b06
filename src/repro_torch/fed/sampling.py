"""Client participation (port of ``repro.fed.sampling``): pure numpy, so
the same seed gives the reference's identical masks and live sets.

``ParticipationSampler``  uniform partial participation over (groups,
    n_clients) slots, a dense exact 0/1 mask.
``CohortSampler``         the massive-cohort sampler: the round's live set
    as sorted indices + weights in O(k), per-shard weight rows by binary
    search; tiers ``uniform`` (0/1), ``importance`` (Gumbel top-k,
    1/(k p_i) weights) and ``arrival`` (Bernoulli arrivals, 1/rate
    weights). Only the uniform tier gives exact 0/1 weights; the weighted
    tiers run under ``RoundContext(weights_are_mask=False)``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

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


COHORT_TIERS = ("uniform", "importance", "arrival")


@dataclasses.dataclass
class CohortSampler:
    """Massive-cohort participation in O(per_round) space.

    ``sample()`` returns the round's live set as ``(idx, w)`` — sorted
    global client indices plus per-client aggregation weights — without
    ever materializing a dense mask or an O(total) permutation:

      uniform      k distinct clients, rejection-sampled when k << total
                   (O(k) expected) and Floyd-style otherwise; weights 1.0
                   (an exact 0/1 membership mask once densified).
      importance   Gumbel top-k over ``log(scores)``: the classic
                   weighted-without-replacement draw, one vectorized pass
                   over the scores. Weights 1/(k p_i) (p_i = normalized
                   score) so high-probability clients are down-weighted and
                   the weighted sum stays an unbiased mean estimate.
      arrival      every client arrives independently w.p. ``rate`` (the
                   asynchronous cross-device model): the arrival count is
                   one Binomial draw, the arrivals a uniform subset, and
                   weights 1/rate debias the random cohort size
                   (Horvitz-Thompson).

    ``shard_weights`` densifies one ``shard``-client slice of the weight
    vector by binary search over the sorted indices — O(log k + hits) per
    shard, so a 100k-slot round never allocates more than the slice the
    streaming round driver is about to consume. ``dense`` densifies the
    whole layout for the vmap path (still O(total) OUTPUT, but O(k)
    sampling work).
    """
    total_clients: int
    per_round: int
    tier: str = "uniform"
    #: per-client importance scores, shape (total_clients,) — importance tier
    scores: Optional[np.ndarray] = None
    #: per-round arrival probability — arrival tier
    rate: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.tier not in COHORT_TIERS:
            raise ValueError(f"unknown cohort sampling tier {self.tier!r}; "
                             f"expected one of {COHORT_TIERS}")
        if not 0 < self.per_round <= self.total_clients:
            raise ValueError(f"per_round must be in [1, total_clients], got "
                             f"{self.per_round} of {self.total_clients}")
        if self.tier == "importance":
            if self.scores is None:
                raise ValueError("importance tier needs per-client scores")
            s = np.asarray(self.scores, np.float64)
            if s.shape != (self.total_clients,) or (s <= 0).any():
                raise ValueError("scores must be positive with shape "
                                 "(total_clients,)")
            self.scores = s
        if self.tier == "arrival" and not 0.0 < self.rate <= 1.0:
            raise ValueError(f"arrival rate must be in (0, 1], got "
                             f"{self.rate}")
        self._rng = np.random.RandomState(self.seed)

    def _uniform_indices(self, k: int) -> np.ndarray:
        total = self.total_clients
        if k >= total:
            return np.arange(total, dtype=np.int64)
        if k <= total // 64:
            # rejection sampling: expected < 2 draws per kept index at this
            # density — O(k), no O(total) permutation buffer
            chosen: set = set()
            while len(chosen) < k:
                need = int((k - len(chosen)) * 1.2) + 8
                chosen.update(self._rng.randint(0, total, need).tolist())
            return np.fromiter(chosen, np.int64, len(chosen))[:k]
        return self._rng.choice(total, size=k, replace=False).astype(np.int64)

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (idx, w): sorted global client indices (int64, ascending) and
        their aggregation weights (float32), both of the live-count length.
        Never densifies over total_clients."""
        if self.tier == "uniform":
            idx = self._uniform_indices(self.per_round)
            w = np.ones(idx.size, np.float32)
        elif self.tier == "importance":
            p = self.scores / self.scores.sum()
            gumbel = -np.log(-np.log(
                self._rng.uniform(1e-12, 1.0, self.total_clients)))
            keys = np.log(p) + gumbel
            idx = np.argpartition(keys, -self.per_round)[-self.per_round:]
            idx = idx.astype(np.int64)
            w = (1.0 / (self.per_round * p[idx])).astype(np.float32)
        else:  # arrival
            k = int(self._rng.binomial(self.total_clients, self.rate))
            k = max(1, k)  # never lose a whole round
            idx = self._uniform_indices(k)
            w = np.full(idx.size, 1.0 / self.rate, np.float32)
        order = np.argsort(idx, kind="stable")
        return idx[order], w[order]

    def shard_weights(self, idx: np.ndarray, w: np.ndarray,
                      shard_idx: int, shard: int) -> np.ndarray:
        """Dense (shard,) f32 weight row for global slots
        [shard_idx * shard, (shard_idx + 1) * shard) — zeros for absent
        clients. O(log k + hits) via searchsorted on the sorted ``idx``."""
        lo = shard_idx * shard
        a, b = np.searchsorted(idx, [lo, lo + shard])
        row = np.zeros(shard, np.float32)
        row[idx[a:b] - lo] = w[a:b]
        return row

    def iter_shards(self, idx: np.ndarray, w: np.ndarray,
                    shard: int) -> Iterator[np.ndarray]:
        """Yield every shard's dense weight row in order (the streaming
        driver's host-side feed); the last shard is zero-padded past
        total_clients."""
        n_shards = -(-self.total_clients // shard)
        for s in range(n_shards):
            yield self.shard_weights(idx, w, s, shard)

    def device_partitions(self, idx: np.ndarray, w: np.ndarray, *,
                          shard: int, devices: int) -> Iterator[np.ndarray]:
        """Per-device weight blocks for the multi-device streaming round
        (``stream(devices=D)``): device d gets the same CONTIGUOUS slice of
        the global shard sequence the engine's shard_map partition assigns
        it — ceil(n_shards / devices) shards each, the trailing all-padding
        shards densified as zero rows. Yields ``devices`` arrays of shape
        (shards_per_device, shard), still O(k) sampling work + O(slice)
        output per device, so a host can stage each device's feed
        independently."""
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        n_shards = -(-self.total_clients // shard)
        n_shards = -(-n_shards // devices) * devices   # engine's device pad
        per = n_shards // devices
        for d in range(devices):
            yield np.stack([self.shard_weights(idx, w, s, shard)
                            for s in range(d * per, (d + 1) * per)])

    def partition_state_rows(self, cstate: dict, *, shard: int,
                             devices: int) -> Iterator[dict]:
        """Per-device blocks of the KEYED client-state tree (the stacked
        ``{slot: (groups, n_clients, ...)}`` of Pipeline.init_state — EF
        residuals, cv client variates), partitioned EXACTLY like
        ``device_partitions`` partitions the weight rows: device d gets the
        same contiguous shard slice, and padded slots wrap cyclically to
        the cohort's first rows (``slot % total_clients``) — the engine's
        own reshard rule, so a host can stage each device's state feed
        next to its weight feed without ever materializing the wrapped
        O(slots) copy for more than one device. Yields ``devices`` dicts of
        leaves shaped (shards_per_device, shard, ...)."""
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        total = self.total_clients
        n_shards = -(-total // shard)
        n_shards = -(-n_shards // devices) * devices   # engine's device pad
        per = n_shards // devices
        flat = {k: np.asarray(v).reshape((total,) + np.shape(v)[2:])
                for k, v in cstate.items()}
        for d in range(devices):
            sl = np.arange(d * per * shard, (d + 1) * per * shard) % total
            yield {k: v[sl].reshape((per, shard) + v.shape[1:])
                   for k, v in flat.items()}

    def dense(self, idx: np.ndarray, w: np.ndarray,
              layout: tuple) -> np.ndarray:
        """Full (groups, n_clients) weight mask for the engine's round-step
        signature (groups * n_clients slots must cover total_clients)."""
        groups, n = layout
        mask = np.zeros(groups * n, np.float32)
        mask[idx] = w
        return mask.reshape(groups, n)

    def mask(self, layout: tuple) -> np.ndarray:
        """ParticipationSampler-compatible convenience: one fresh sample,
        densified."""
        return self.dense(*self.sample(), layout)
