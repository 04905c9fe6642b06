"""Federated LM training driver (port of ``repro.launch.train``, the CLI
subset of the main path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \
        --rounds 3 --clients 8 --local-steps 2 --micro-batch 2 --seq-len 64 \
        --compressor zsign --z 1 --sigma 0.01

``--pipeline`` takes a spec string: ``"ef|zsign(use_kernel=true)"`` is the
EF-SignSGD round through the fused kernel F1, ``"zsign_packed(z=2,
sigma=0.01)"`` the finite-z round through the dense-noise kernel C1,
``"dp(clip=1.0,eps=2.0)|zsign_packed"`` DP-SignFedAvg (the calibrated
Gaussian noise is the codec's sigma), ``"cv|zsign_packed(sigma=0.01)"``
control variates, ``"sigma_sched(head=2.0,tail=0.5)|zsign(sigma=0.01)"``
the per-layer sigma schedule, ``"zsign(z=1,sigma=0.01,agg=vote)"`` the
majority vote (also ``agg=trimmed(f=2)`` and ``agg=median``),
``"topk(frac=0.01,agg=coord)"`` top-k with per-coordinate counts.
``--compressor stosign`` is sto-sign (each client's sigma is its own
||p||_2), ``--compressor dpgauss`` the dense DP-FedAvg baseline (noise std
``--sigma``), ``--compressor qsgd`` QSGD with ``--qsgd-s`` levels and
``--compressor topk`` EF top-k keeping ``--topk-frac`` of the
coordinates. ``--adversary "byte_corrupt(f=2,p=0.1)"`` (or ``sign_flip``,
``collude``, ``dropout``) attacks the wire; ``--debug-wire`` checks the 0/1
mask every round. ``--plateau`` adapts sigma with
the Plateau criterion (kappa = 10 stalled rounds, bound 100 x ``--sigma``).
``--groups G`` runs G sequential client groups of ``--clients`` each (the
group scan; ``--clients 1 --groups 8`` is the sequential-client mode), and
``--cohort`` picks the cohort plan: ``auto`` (streams when the round is
large: qwen2-0.5B at more than 8 clients), ``vmap``, or
``stream(shard=K|auto[,feed=device|host])``, e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \
        --reduced --clients 20 --cohort "stream(shard=6)" --device cpu

``--round-mode "async(deadline=1.0,staleness=cutoff(2))"`` closes each round
at a deadline under the simulated client latency ``--latency`` (e.g.
``"linear(base=0.0,step=0.25)"``): late payloads fold in a later round at
the staleness weight (``fed/async_server.py``). ``staleness=poly(a)`` needs
a scale-weighted pipeline such as ``ef|zsign``: this driver sets the 0/1
``weights_are_mask`` guarantee, which fractional weights would break.

``--ckpt-dir DIR`` checkpoints the server state every ``--save-every``
rounds and at the end (``checkpoint/manager.py``), and a rerun resumes from
the newest valid checkpoint (``# resumed from checkpoint at round N``),
then runs rounds N .. ``--rounds``-1. As in the reference, the Plateau
controller, the participation sampler and an async run's late-payload
queue start afresh on resume. ``--arch`` takes every arch of the registry
(dense, moe, vlm, and the hybrid ``jamba_1_5_large_398b``, the xLSTM
``xlstm_350m`` and the encoder-decoder ``seamless_m4t_large_v2``); a vlm
arch's image embeds and an encdec arch's source frames are drawn per round
as jax's ``normal`` draws them from ``fold_in(PRNGKey(7), round)``, and the
tokens are cut to the text length.

``--cohort "stream(shard=K,devices=D)"`` splits the cohort's shards over
D ranks, one process each, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2_0_5b --reduced \
        --clients 8 --cohort "stream(shard=2,devices=2)" --device cpu

Each rank joins the group from the environment (``launch/mesh.py``, with a
timeout on init and on every collective, so a dead rank fails the run),
walks its slice of the shards and holds its clients' state rows; the ranks
meet once a round in one O(d) reduce. Rank 0 alone prints and writes
checkpoints (the other ranks send it their state rows).

Runs on ``cuda`` unless ``--device cpu`` is given; asking for CUDA on a
machine without a card raises. ``run(args)`` is the same driver, callable in
process (in each rank of a group that is already up, too), and returns the
metrics of the rounds it ran.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, StateRows
from repro_torch.configs.common import get_arch
from repro_torch.core import compression, fedavg, noise, wire
from repro_torch.core.plateau import PlateauController
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import TokenStream
from repro_torch.fed.sampling import ParticipationSampler
from repro_torch.models.api import build_model, check_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family f32 config (CPU-sized)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--groups", type=int, default=1,
                    help="sequential client groups; total clients = "
                         "groups * clients")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--compressor", default="zsign",
                    choices=list(compression.available()))
    ap.add_argument("--pipeline", default=None, metavar="SPEC",
                    help="pipeline spec string overriding --compressor, "
                         "e.g. 'zsign(z=1,sigma=0.01)', "
                         "'ef|zsign(use_kernel=true)' or "
                         "'zsign_packed(z=2,sigma=0.01)'")
    ap.add_argument("--agg-backend", default="auto",
                    choices=list(compression.AGG_BACKENDS),
                    help="server sign-reduce backend (auto = CUDA kernel on "
                         "a card, plain PyTorch elsewhere)")
    ap.add_argument("--encode-backend", default="auto",
                    choices=list(compression.ENCODE_BACKENDS),
                    help="client encode backend (auto = CUDA kernel on a "
                         "card, plain PyTorch elsewhere; reference = the "
                         "dense-noise draw)")
    ap.add_argument("--cohort", default="auto",
                    help="cohort execution policy: 'auto' (stream only when "
                         "the round is large), 'vmap', or 'stream(shard=K|"
                         "auto[,unroll=U][,devices=D|auto]"
                         "[,feed=device|host])': shards of K "
                         "clients through one buffer, folding each shard "
                         "into one running wire accumulator; devices=D "
                         "splits the shards over D ranks (torchrun); "
                         "feed=host keeps batch and state rows in pinned "
                         "host memory and copies one shard ahead")
    ap.add_argument("--adversary", default="none", metavar="SPEC",
                    help="wire-level fault injection: 'none', "
                         "'sign_flip(f=4)', 'byte_corrupt(f=2,p=0.1)', "
                         "'collude(f=4,rotate=true)', 'dropout(f=8)', with "
                         "optional every=/start= scheduling, applied to the "
                         "encoded payload stack (or the participation "
                         "mask) under every cohort plan")
    ap.add_argument("--round-mode", default="sync", metavar="SPEC",
                    help="round execution mode: 'sync' (barrier round) or "
                         "'async(deadline=T[,min_clients=M][,staleness="
                         "none|poly(a)|cutoff(s)])': on-time payloads fold "
                         "now, late ones s rounds later at the staleness "
                         "weight, failures are dead clients")
    ap.add_argument("--latency", default="zero", metavar="SPEC",
                    help="simulated client latency of async rounds: "
                         "'zero', 'const(t=T)', 'linear(base=B,step=S)', "
                         "'lognormal(median=M,sigma=S)', "
                         "'pareto(xm=X,alpha=A)', each with optional "
                         "fail=P / seed=N")
    ap.add_argument("--debug-wire", action="store_true",
                    help="check every round that the participation mask "
                         "is exactly 0/1 (also via REPRO_DEBUG_WIRE=1)")
    ap.add_argument("--z", type=int, default=1, help="1=Gaussian, 0=uniform")
    ap.add_argument("--sigma", type=float, default=0.01,
                    help="z-sign noise scale / dpgauss noise stddev")
    ap.add_argument("--qsgd-s", type=int, default=1,
                    help="QSGD quantization levels")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="top-k kept fraction")
    ap.add_argument("--plateau", action="store_true",
                    help="adapt sigma with the Plateau criterion (the round "
                         "takes the state's sigma at encode and decode)")
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--server-lr", type=float, default=0.5)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--over-provision", type=float, default=1.0)
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest valid "
                         "checkpoint, save every --save-every rounds and at "
                         "the end")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """``cuda`` (raises without a card; f32 matmuls stay full f32, no TF32,
    as in the reference) or ``cpu`` -> the torch device."""
    device = check_device(name)
    if device.type == "cuda":
        # f32 matmuls stay full f32 (no TF32), as in the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def extra_leaves(per_step, layout, round_idx: int, device) -> dict:
    """The round's non-token batch leaves of ``train_batch_spec`` (image
    embeds, source frames): f32 ``layout + shape[1:]``, drawn as the
    reference's launcher draws them, jax's ``normal`` on
    ``fold_in(PRNGKey(7), round)``."""
    key = noise.fold_in(noise.prng_key(7), round_idx)
    return {name: noise.normal(key, tuple(layout) + tuple(leaf.shape[1:]),
                               device)
            for name, leaf in per_step.items() if name != "tokens"}


def run(args: argparse.Namespace,
        on_round: Optional[Callable] = None,
        on_build: Optional[Callable] = None,
        on_ckpt: Optional[Callable] = None) -> List[fedavg.RoundMetrics]:
    """Train up to ``args.rounds`` rounds (from a checkpoint's round under
    ``--ckpt-dir``); -> the metrics of the rounds run. ``on_round(t,
    state_before, state_after, metrics, seconds)`` is called after each;
    ``on_build(step)`` once with the round step this run built (an async
    step holds its late-payload queue in ``step.pending``);
    ``on_ckpt(event, stats)`` after each checkpoint save or restore
    (``event`` "save" or "restore", ``stats`` the manager's timings; rank
    0 only). Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) it joins
    the cohort group first."""
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from repro_torch.launch.mesh import make_cohort_group
        make_cohort_group(device_type=device.type)
    rank, world = wire.rank_world()
    if world > 1 and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    say = print if rank == 0 else (lambda *a, **k: None)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    bundle = build_model(arch.model)
    if args.pipeline:
        comp = compression.Pipeline(args.pipeline)
    else:
        # legacy per-name kwargs -> the equivalent pipeline
        comp = {
            "zsign": lambda: compression.ZSignCompressor(
                z=args.z, sigma=args.sigma),
            "zsign_packed": lambda: compression.PackedZSignCompressor(
                z=args.z, sigma=args.sigma),
            "dpgauss": lambda: compression.DPGaussianCompressor(
                sigma=args.sigma),
            "efsign": compression.EFSignCompressor,
            "qsgd": lambda: compression.QSGDCompressor(s=args.qsgd_s),
            "topk": lambda: compression.TopKCompressor(frac=args.topk_frac),
            "stosign": compression.StoSignCompressor,
            "identity": compression.Compressor,
        }[args.compressor]()
    cfg = fedavg.FedConfig(n_clients=args.clients, client_groups=args.groups,
                           local_steps=args.local_steps,
                           client_lr=args.client_lr,
                           server_lr=args.server_lr)
    # the sampler below emits exact 0/1 membership masks
    ctx_kw = dict(agg_backend=args.agg_backend,
                  encode_backend=args.encode_backend, weights_are_mask=True,
                  dynamic_sigma=args.plateau, cohort=args.cohort,
                  adversary=args.adversary, round_mode=args.round_mode,
                  latency=args.latency)
    if args.debug_wire:  # else the REPRO_DEBUG_WIRE default
        ctx_kw["debug_wire"] = True
    ctx = fedavg.RoundContext(**ctx_kw)
    step = fedavg.build_round_step(bundle.loss_fn, comp, cfg, ctx)
    if on_build is not None:
        on_build(step)
    # stream(feed=host) keeps batch and state rows on the host
    host = fedavg.CohortPolicy.parse(args.cohort).feed == "host"
    gen = torch.Generator(device=device).manual_seed(0)
    params = bundle.init(gen, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    state = fedavg.init_server_state(params, cfg, comp, noise.prng_key(1),
                                     sigma0=args.sigma, host_state=host,
                                     ctx=ctx)
    total = args.groups * args.clients
    plan = fedavg.resolve_cohort(args.cohort, total, n_params)
    # under stream(devices=D) each rank holds its own state rows
    rows = None
    if fedavg.state_rows(cfg, ctx, n_params) is not None:
        rows = StateRows(tuple(fedavg.owned_rows(plan, total, r)
                               for r in range(plan.devices)),
                         (args.groups, args.clients))
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def save(r: int) -> None:
        # gathered to rank 0 with rows; else rank 0 holds every row
        if rows is not None or rank == 0:
            mgr.save(r, state._asdict(), rows=rows)
        if rank == 0:
            _ckpt_line("saved", mgr.last_save, on_ckpt)

    if mgr is not None:
        r, restored = mgr.restore_latest(state._asdict(), rows=rows)
        if restored is not None:
            state, start = fedavg.ServerState(**restored), r
            say(f"# resumed from checkpoint at round {r}")
            if rank == 0:
                _ckpt_line("restored", mgr.last_restore, on_ckpt)
    stream = TokenStream(vocab=arch.model.vocab)
    sampler = ParticipationSampler(
        total_clients=total,
        per_round=max(1, int(total * args.participation)),
        over_provision=args.over_provision, failure_rate=args.failure_rate)
    plateau = (PlateauController(sigma_init=args.sigma,
                                 sigma_bound=args.sigma * 100, kappa=10)
               if args.plateau else None)
    layout = (args.groups, args.clients, args.local_steps, args.micro_batch)
    per_step = bundle.train_batch_spec(args.micro_batch, args.seq_len)
    wf = comp.wire_format()
    say(f"# arch={arch.model.name} params={n_params:,} "
        f"compressor={comp.name} wire={wf.layout}/{wf.dtype} "
        f"({wf.bits_per_coord:g} bits/coord) device={device} "
        f"cohort={plan.mode}"
        + (f"(shard={plan.shard},feed={plan.feed}"
           + (f",devices={plan.devices}" if plan.devices > 1 else "") + ")"
           if plan.mode == "stream" else f" groups={args.groups}")
        + (f" round_mode={args.round_mode} latency={args.latency}"
           if args.round_mode != "sync" else ""))
    say("round,loss,ghat_norm,live,Mbits_cum,sigma,sec")
    history, bits, saved = [], 0.0, None
    feed = "cpu" if host else device
    for t in range(start, args.rounds):
        tokens = stream.round_batch(t, layout, args.seq_len, feed)
        batch = {"tokens": tokens,
                 **extra_leaves(per_step, layout, t, feed)}
        if "embeds" in per_step or "img_embeds" in per_step:
            # the text tokens after the image prefix or the source frames
            batch["tokens"] = tokens[..., :per_step["tokens"].shape[-1]]
        mask = sampler.mask((args.groups, args.clients))
        t0 = time.time()
        new_state, m = step(state, batch, mask)
        loss = float(m.loss)          # waits for the round's device work
        sec = time.time() - t0
        bits += float(m.uplink_bits)
        if plateau is not None:
            new_state = new_state._replace(sigma=torch.tensor(
                plateau.update(loss), dtype=torch.float32, device=device))
        say(f"{t},{loss:.4f},{float(m.grad_est_norm):.3f},"
            f"{int(m.participation)},{bits / 1e6:.2f},"
            f"{float(new_state.sigma):.4f},{sec:.3f}")
        if on_round is not None:
            on_round(t, state, new_state, m, sec)
        state = new_state
        history.append(m)
        if mgr is not None and (t + 1) % args.save_every == 0:
            save(t + 1)
            saved = t + 1
    if mgr is not None and saved != args.rounds:
        save(args.rounds)
    say(f"# done: {args.rounds} rounds, {bits / 1e6:.1f} Mbit uplink "
        f"({32.0 / comp.wire_bits_per_coord:.0f}x less than fp32)")
    return history


def _ckpt_line(what: str, stats: dict, on_ckpt) -> None:
    print(f"# checkpoint {what}: round {stats['round']}, "
          f"{stats['bytes']:,} bytes; "
          + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in stats.items()
                      if k.endswith("_s")))
    if on_ckpt is not None:
        on_ckpt("save" if what == "saved" else "restore", dict(stats))


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
