"""Quickstart on the PyTorch port: the paper's section 4.1 consensus
problem.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Vanilla SignSGD stalls under heterogeneous gradients; z-SignSGD (the
paper's stochastic sign) converges; the uplink is 1 bit a coordinate either
way. Compressors are pipeline spec strings, as in ``examples/quickstart.py``;
the round runs on the card (kernels E1 and R1) unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch.core import compression, fedavg, noise
from repro_torch.launch.train import resolve_device

D, N, ROUNDS = 200, 10, 2000

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(ap.parse_args().device)

gen = torch.Generator().manual_seed(0)
targets = torch.randn((1, N, D), generator=gen).to(device)  # y_i per client
optimum = targets[0].mean(0)
batch = {"y": targets[:, :, None]}                    # (groups, N, E, D)
mask = torch.ones((1, N))


def loss_fn(p, b):
    return 0.5 * torch.sum((p["x"] - b["y"]) ** 2)


print(f"consensus problem: d={D}, {N} clients  "
      f"(optimum = mean of client targets)")
for name, spec, slr in [
        ("uncompressed GD", "identity", 1.0),
        ("vanilla SignSGD", "zsign", 0.05),       # sigma defaults to 0
        ("1-SignSGD  (z=1, Gaussian)", "zsign(z=1,sigma=2.0)", 2.0),
        ("inf-SignSGD (z=inf, uniform)", "zsign(z=inf,sigma=2.0)", 2.5),
]:
    comp = compression.Pipeline(spec)
    cfg = fedavg.FedConfig(n_clients=N, client_lr=0.01, server_lr=slr)
    step = fedavg.build_round_step(loss_fn, comp, cfg)
    state = fedavg.init_server_state({"x": torch.zeros(D, device=device)},
                                     cfg, comp, noise.prng_key(1))
    for _ in range(ROUNDS):
        state, m = step(state, batch, mask)
    dist = float(torch.linalg.vector_norm(state.params["x"] - optimum))
    wf = comp.wire_format()
    print(f"  {name:30s} dist-to-opt={dist:8.4f}   "
          f"uplink={float(m.uplink_bits)/1e3:7.1f} kbit/round "
          f"[{wf.layout}/{wf.dtype}]")
