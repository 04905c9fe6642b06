"""Non-i.i.d. federated classification on the PyTorch port (paper section
4.2 setting).

    PYTHONPATH=src python examples/torch_noniid_classification.py \
        [--device cpu]

Each of 10 clients holds ONE class's data (extreme heterogeneity). Compares
uncompressed SGD+momentum, vanilla SignSGD (diverges), EF-SignSGD and the
paper's 1-SignSGD, with partial participation and simulated stragglers, as
``examples/noniid_classification.py`` does.
"""
import argparse

import torch

from repro_torch.core import compression, fedavg
from repro_torch.core.noise import eta_z, prng_key
from repro_torch.data import synthetic
from repro_torch.fed.sampling import ParticipationSampler
from repro_torch.launch.train import resolve_device
from repro_torch.models.mlp import mlp_loss_builder

N, ROUNDS = 10, 200

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(ap.parse_args().device)

x, y = synthetic.gaussian_mixture_task(n_classes=10, dim=64, n_per_class=200)
parts = synthetic.label_partition(y, N)
init, loss_fn, acc_fn = mlp_loss_builder(64, 10)
sampler = ParticipationSampler(total_clients=N, per_round=8,
                               over_provision=1.25, failure_rate=0.05)
x_dev, y_dev = x.to(device), y.to(device)

for name, spec, slr in [
        ("SGD+momentum (32 bit)", "identity", 0.05),
        ("vanilla SignSGD", "zsign", 0.2),          # sigma defaults to 0
        ("EF-SignSGD", "ef|zsign", 1.0),            # EF composes as a stage
        ("1-SignSGD (paper)", "zsign(z=1,sigma=0.05)",
         0.01 / (eta_z(1) * 0.05 * 0.05)),
]:
    comp = compression.Pipeline(spec)
    opt = ("momentum", (("beta", 0.9),)) if spec in ("identity", "ef|zsign") \
        else ("sgd", ())
    cfg = fedavg.FedConfig(n_clients=N, client_lr=0.05, server_lr=slr,
                           server_opt=opt[0], server_opt_kw=opt[1])
    step = fedavg.build_round_step(loss_fn, comp, cfg)
    state = fedavg.init_server_state(
        init(torch.Generator().manual_seed(0), device), cfg, comp,
        prng_key(1))
    bits = 0.0
    for t in range(ROUNDS):
        batch = synthetic.client_batches(x, y, parts, (1, N, 1, 32),
                                         seed=1, round_idx=t, device=device)
        mask = sampler.mask((1, N))
        state, m = step(state, batch, mask)
        bits += float(m.uplink_bits)
    acc = acc_fn(state.params, x_dev, y_dev)
    wf = comp.wire_format()
    print(f"{name:24s} acc={acc:.3f}  uplink={bits/1e6:8.2f} Mbit "
          f"({32.0/wf.bits_per_coord:4.0f}x compression, "
          f"{wf.layout}/{wf.dtype} wire)")
