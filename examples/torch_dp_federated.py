"""DP-SignFedAvg on the PyTorch port (paper Algorithm 2 / Appendix F):
client-level DP with a 1-bit uplink, as ONE pipeline spec.

    PYTHONPATH=src python examples/torch_dp_federated.py [--device cpu]

Calibrates the Gaussian noise multiplier to a target (eps, delta) with the
RDP accountant, then trains with the ``dp`` stage over the sign codec,

    dp(clip=C, noise=nm*C) | zsign(z=1)

whose noise is the codec's sigma: the same Gaussian gives the privacy and
the sign-bias correction of the paper's Lemma 1, and the wire stays at 1 bit
a coordinate (the counter-noise encode, kernel E1 on the card). As
``examples/dp_federated.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import compression, fedavg
from repro_torch.core.dp import calibrate_noise, compute_epsilon
from repro_torch.core.noise import eta_z, prng_key
from repro_torch.data import synthetic
from repro_torch.launch.train import resolve_device
from repro_torch.models.mlp import mlp_loss_builder

ROUNDS, N, CLIP, DELTA = 200, 50, 0.5, 1e-3
Q = 0.3        # client subsampling ratio (privacy amplification, App. F)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(ap.parse_args().device)

x, y = synthetic.gaussian_mixture_task(n_classes=10, dim=64, n_per_class=200)
parts = synthetic.dirichlet_partition(y, min(N, 10), alpha=1.0)
init, loss_fn, acc_fn = mlp_loss_builder(64, 10)
x_dev, y_dev = x.to(device), y.to(device)

for target_eps in [2.0, 8.0]:
    nm = calibrate_noise(q=Q, steps=ROUNDS, target_eps=target_eps,
                         delta=DELTA)
    sigma = nm * CLIP
    comp = compression.Pipeline(f"dp(clip={CLIP},noise={sigma})|zsign(z=1)")
    assert comp.wire_bits_per_coord == 1.0          # DP rides the 1-bit wire
    assert comp.codec.sigma == sigma                # noise fused into sigma
    cfg = fedavg.FedConfig(n_clients=N, client_lr=0.05,
                           server_lr=0.005 / (eta_z(1) * sigma * 0.05),
                           server_opt="momentum",
                           server_opt_kw=(("beta", 0.9),))
    step = fedavg.build_round_step(loss_fn, comp, cfg)
    state = fedavg.init_server_state(
        init(torch.Generator().manual_seed(0), device), cfg, comp,
        prng_key(1))
    rng = np.random.RandomState(0)
    for t in range(ROUNDS):
        batch = synthetic.client_batches(x, y, parts, (1, N, 1, 32),
                                         seed=3, round_idx=t, device=device)
        mask = np.zeros(N, np.float32)
        mask[rng.choice(N, max(1, int(Q * N)), replace=False)] = 1.0
        state, m = step(state, batch, mask[None])
    eps = compute_epsilon(q=Q, noise_multiplier=nm, steps=ROUNDS,
                          delta=DELTA)
    wf = comp.wire_format()
    print(f"target eps={target_eps:4.1f}: noise multiplier={nm:5.2f} "
          f"(achieved eps={eps:5.2f}, delta={DELTA})  "
          f"acc={acc_fn(state.params, x_dev, y_dev):.3f}  "
          f"[{wf.bits_per_coord:g} bit/coord {wf.layout} uplink]")
