"""Async straggler-tolerant rounds under heavy-tail client latency, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_async_stragglers.py [--device cpu]

A least-squares cohort whose client latency is lognormal: the sync round
waits for the slowest straggler every round, while the async driver
(``round_mode="async(deadline=p90,...)"``) closes at the p90 deadline and
folds the slow tail back one or two rounds later at the staleness weight.
Checks, as ``examples/async_stragglers.py`` does:

  * the simulated async close time sits far below the sync barrier at the
    tail percentiles;
  * delaying and down-weighting the tail costs little: the async run's
    final loss lands within a small factor of the sync run's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import compression, fedavg
from repro_torch.core.context import RoundContext, RoundModePolicy
from repro_torch.core.noise import prng_key
from repro_torch.fed.async_server import parse_latency, simulate_close_times
from repro_torch.launch.train import resolve_device

N, D, ROUNDS = 64, 256, 30
LATENCY = "lognormal(median=1.0,sigma=1.0,seed=7)"

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(ap.parse_args().device)

# deadline = the latency model's p90: the round closes when ~90% of the
# cohort has reported; the slow tail folds late via poly staleness
_model = parse_latency(LATENCY)
_draws = np.concatenate([_model.sample(r, N) for r in range(ROUNDS)])
DEADLINE = round(float(np.percentile(_draws[np.isfinite(_draws)], 90)), 3)


def run(round_mode, latency):
    comp = compression.Pipeline("ef|zsign")
    cfg = fedavg.FedConfig(n_clients=N, client_lr=0.05, server_lr=0.5)
    ctx = RoundContext(cohort="stream(shard=16,feed=host)",
                       round_mode=round_mode, latency=latency)

    def loss_fn(p, b):
        return 0.5 * torch.mean((p["x"] - b["y"]) ** 2)

    step = fedavg.build_round_step(loss_fn, comp, cfg, ctx)
    target = torch.randn((D,), generator=torch.Generator().manual_seed(3))
    y = target.expand(1, N, 1, D) + 0.1 * torch.randn(
        (1, N, 1, D), generator=torch.Generator().manual_seed(4))
    st = fedavg.init_server_state({"x": torch.zeros(D, device=device)}, cfg,
                                  comp, prng_key(1), host_state=True)
    mask = torch.ones((1, N))
    for _ in range(ROUNDS):
        st, m = step(st, {"y": y}, mask)
    return float(m.loss), float(m.participation)


ASYNC = f"async(deadline={DEADLINE},min_clients=8,staleness=poly(0.5))"
policy = RoundModePolicy.parse(ASYNC)
t0 = time.time()
sync_loss, sync_part = run("sync", "zero")
async_loss, async_part = run(ASYNC, LATENCY)
dt = time.time() - t0

closes = simulate_close_times(policy, _model, ROUNDS, N)
p50a, p90a = np.percentile(closes[:, 0], [50, 90])
p50s, p90s = np.percentile(closes[:, 1], [50, 90])

print(f"cohort n={N} d={D} rounds={ROUNDS} latency={LATENCY}")
print(f"deadline=p90={DEADLINE}  ({dt:.1f}s for both runs on {device})")
print(f"round close time: async p50={p50a:.2f} p90={p90a:.2f} | "
      f"sync barrier p50={p50s:.2f} p90={p90s:.2f}")
print(f"final loss: sync={sync_loss:.5f} async={async_loss:.5f} | "
      f"last-round participation: sync={sync_part:.1f} "
      f"async={async_part:.1f}")

# the deadline must beat the straggler barrier at the tail...
assert p90a < 0.5 * p90s, (p90a, p90s)
# ...without giving up convergence: within a small factor of sync
assert async_loss < 3.0 * sync_loss + 1e-3, (async_loss, sync_loss)
assert async_part > 0.5 * N
print("OK")
