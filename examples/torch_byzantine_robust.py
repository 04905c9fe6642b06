"""Byzantine-robust compressed aggregation under a live wire attack, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_byzantine_robust.py \
        [--adversary SPEC] [--agg MODE] [--all] [--device cpu]

n=16 clients solve the consensus problem while f=6 of them (f < n/2)
sign-flip every payload on the wire (``fed/adversary.py``). Every robust
``agg=`` mode stays in the compressed domain: majority vote, trimmed(f)
mean and coordinate-wise median are closed forms of the carried int32
(signed_count, n_live) vote pair, which kernel R1 counts on the card.

``agg=vote`` converges at full speed, while ``agg=mean`` is degraded: the
flipped votes shrink its step to (n - 2f)/n = 1/4 of a unit. As
``examples/byzantine_robust.py``.
"""
import argparse

import torch

from repro_torch.core import compression, fedavg
from repro_torch.core.noise import prng_key
from repro_torch.launch.train import resolve_device

N, D, F, ROUNDS = 16, 128, 6, 60


def run(agg: str, adversary: str, device, rounds: int = ROUNDS):
    gen = torch.Generator().manual_seed(0)
    targets = (5.0 + torch.randn((1, N, D), generator=gen)).to(device)
    honest_opt = targets[0, F:].mean(0)

    def loss_fn(p, b):
        return 0.5 * torch.sum((p["x"] - b["y"]) ** 2)

    batch = {"y": targets[:, :, None]}
    mask = torch.ones((1, N))
    comp = compression.Pipeline(f"zsign_packed(agg={agg})")
    # effective sign step = server_lr * client_lr = 0.1 per coordinate
    cfg = fedavg.FedConfig(n_clients=N, client_lr=0.05, server_lr=2.0)
    ctx = fedavg.RoundContext(weights_are_mask=True, adversary=adversary)
    step = fedavg.build_round_step(loss_fn, comp, cfg, ctx)
    state = fedavg.init_server_state({"x": torch.zeros(D, device=device)},
                                     cfg, comp, prng_key(1))
    for _ in range(rounds):
        state, m = step(state, batch, mask)
    dist = float(torch.linalg.vector_norm(state.params["x"] - honest_opt))
    return dist, float(torch.linalg.vector_norm(honest_opt)), m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--adversary", default=f"sign_flip(f={F})",
                    help="attack spec (fed/adversary.py grammar); e.g. "
                         f"'byte_corrupt(f={F},p=0.2)', 'collude(f={F})', "
                         f"'dropout(f={F})'")
    ap.add_argument("--agg", default=None,
                    help="run one agg mode (mean|vote|trimmed(f=..)|median) "
                         "instead of the vote-vs-mean comparison")
    ap.add_argument("--all", action="store_true",
                    help="sweep every agg mode under the attack")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device = resolve_device(args.device)

    modes = ([args.agg] if args.agg else
             ["mean", "vote", "trimmed(f=6)", "median"] if args.all else
             ["mean", "vote"])
    print(f"consensus: d={D}, n={N} clients, adversary={args.adversary}, "
          f"{args.rounds} rounds")
    dists = {}
    for agg in modes:
        dist, d0, m = run(agg, args.adversary, device, args.rounds)
        dists[agg] = dist
        print(f"  agg={agg:14s} dist-to-honest-opt={dist:8.3f}  "
              f"(init was {d0:.1f})  uplink="
              f"{float(m.uplink_bits) / 1e3:.1f} kbit/round")
    if "vote" in dists and "mean" in dists:
        verdict = ("vote converged, mean degraded"
                   if dists["vote"] < 0.5 * dists["mean"]
                   else "no separation (attack below robustness threshold?)")
        print(f"  -> {verdict}")


if __name__ == "__main__":
    main()
