"""The rank side of ``tests/test_torch_sharded_encdec.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch, numpy and the port only.

The test process writes the inputs (numpy params of the reduced
seamless-m4t-large-v2, the rounds' (G, N, E, micro, S_src, D) frame and
(G, N, E, micro, S_tgt) token batches, the block cases' weights and
inputs) to ``<out>/inputs.pkl``. Every rank runs

  * each round of ``ROUNDS`` through the port's model-sharded round step
    (``core/fedavg.build_sharded_round_step``) on a ``ReplicaGrid`` of the
    default group, recording its coordinates, its range, each group's
    pseudo-gradient range and payload bytes (at ``Pipeline.encode_range``),
    its param shards after the round, the loss and the collective bytes by
    kind and use;
  * each block case of ``BLOCKS`` on this rank's sequence slice under the
    regular plan's hints (the sequence over `model`), its weights whole:
    the encoder's bidirectional self-attention, or the cross-attention of
    this rank's query rows over the memory gathered along the sequence
    (``all_gather:enc_mem``), forward and backward of a fixed upstream
    gradient: the output rows, the inputs' gradients (this rank's rows of
    the queries and of the memory) and each weight's gradient (this rank's
    share, before any sum);

and pickles what it saw to ``<out>/rank<r>.pkl``.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import numpy as np
import torch

import torch_sharded_ranks as R

ARCH_ID = "seamless_m4t_large_v2"
#: the round's sequence: S_src = S_tgt = 32 (the reference's src_frac)
SEQ = 64
_Z1 = f"zsign(z=1,sigma={R.SIGMA})"
#: name -> (grid shape, options). seamless is a regular arch: a client a
#: data row, the replica and the sequence over `model`
ROUNDS = {"ed_22": ((2, 2), {}), "ed_14": ((1, 4), {}),
          "ed_22_noremat": ((2, 2), {"remat": False}),
          "ed_22_noweights": ((2, 2), {"save_weights": False}),
          # a vocab that splits over `model`: the tied table is stored
          # sharded, gathered once and used twice (lookup and head)
          "ed_22_v256": ((2, 2), {"vocab": 256})}
#: the block cases: name -> (grid shape, block, batch, seq)
BLOCKS = {"cross_22": ((2, 2), "cross", 2, 32),
          "cross_14": ((1, 4), "cross", 2, 32),
          "enc_22": ((2, 2), "enc", 2, 32),
          "enc_14": ((1, 4), "enc", 2, 32)}


def arch(save_weights=None, vocab=None):
    """The port's ArchConfig of the reduced seamless (2 + 2 layers, d_model
    64, 4 heads, vocab 997, f32; ``remat_save_weights`` as the arch's
    unless given)."""
    from repro_torch.configs.common import get_arch
    a = get_arch(ARCH_ID).reduced()
    m = a.model
    if save_weights is not None:
        m = dataclasses.replace(m, remat_save_weights=save_weights)
    if vocab is not None:
        m = dataclasses.replace(m, vocab=vocab)
    return dataclasses.replace(a, model=m, client_lr=R.CLR,
                               server_lr=R.SLR)


def plan_for(grid):
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch.sharding import make_plan
    return make_plan(arch(), ShapeCfg("test", "train", SEQ, 4), grid)


def _run(name, grid, inputs):
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model, shard_params
    _, opt = ROUNDS[name]
    a = arch(opt.get("save_weights"), opt.get("vocab"))
    plan = plan_for(grid)
    params = inputs["params_v256" if "vocab" in opt else "params"]
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    full = {}
    for p, v in tree_paths(params):
        tree_set(full, p, tuple(v.shape))
    specs = SH.param_specs(full, grid, plan)
    comp = TC.Pipeline(_Z1)
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups, local_steps=1,
                        client_lr=R.CLR, server_lr=R.SLR)
    step = TF.build_sharded_round_step(
        build_model(a.model).loss_fn, comp, fcfg, SH.round_context(plan),
        grid=grid, plan=plan, specs=specs, remat=opt.get("remat", True))
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1))
    seen = {"x": [], "bytes": []}
    enc = TC.Pipeline.encode_range

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        seen["x"].append(x2d.clone().numpy())
        out = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        seen["bytes"].append(out.clone().numpy())
        return out

    TC.Pipeline.encode_range = encode_range
    hints.reset_collective_stats()
    try:
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["batches"][name].items()}
        state, m = step(state, batch, np.ones((plan.client_groups,
                                               plan.n_clients), np.float32))
    finally:
        TC.Pipeline.encode_range = enc
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": step.layout(shards).bounds,
            "params": {p: v.float().numpy()
                       for p, v in tree_paths(state.params)},
            "loss": float(m.loss),
            "collectives": hints.collective_totals(0),
            "collective_by_use": {k: v[0] for k, v in
                                  hints.COLLECTIVES.items()}, **seen}


def block_plan():
    """The regular plan's axes: the sequence and the replica over
    `model`, the batch whole."""
    from repro_torch.launch.sharding import ParallelPlan
    return ParallelPlan(client_axes=("data",), micro_axes=(),
                        seq_axes=("model",), replica_axes=("model",),
                        n_clients=1, client_groups=1, micro=1, local_steps=1)


def _block(name, grid, inputs):
    """One block case on this rank's sequence slice under the grid's
    hints -> the output rows and the gradients (this rank's rows of each
    input, each whole weight's share of this rank)."""
    from repro_torch.launch import hints
    from repro_torch.models import encdec as TE
    from repro_torch.models import layers as L
    _, kind, B, S = BLOCKS[name]
    case = inputs["blocks"][name]
    cfg = arch().model
    plan = block_plan()
    lp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in case["lp"].items()}
    with hints.sharding_hints(grid, plan.seq_axes, plan.micro_axes,
                              replica_axes=plan.replica_axes, specs={},
                              remat=False):
        positions = hints.local_positions(B, S, "cpu")
        x = hints.seq_shard(torch.from_numpy(case["x"])).clone()
        x.requires_grad_(True)
        dy = hints.seq_shard(torch.from_numpy(case["dy"]))
        hints.reset_collective_stats()
        if kind == "cross":
            mem = hints.seq_shard(torch.from_numpy(case["mem"])).clone()
            mem.requires_grad_(True)
            full = hints.gather_seq(mem, keep=False, use="enc_mem")
            mk, mv = TE._mem_kv(full, lp, cfg)
            y = TE._cross_attention(x, mk, mv, lp, cfg)
            inputs_ = [x, mem]
        else:
            y = L.attention(x, lp, cfg.attn_cfg_bidir(), positions)
            inputs_ = [x]
        names = sorted(lp)
        grads = torch.autograd.grad(y, inputs_ + [lp[k] for k in names], dy)
    n = len(inputs_)
    return {"coords": dict(grid.coords), "y": y.detach().numpy(),
            "dx": grads[0].numpy(),
            "dmem": grads[1].numpy() if kind == "cross" else None,
            "dw": {k: g.numpy() for k, g in zip(names, grads[n:])},
            "collective_by_use": {k: v[0] for k, v in
                                  hints.COLLECTIVES.items()}}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    shapes = sorted({v[0] for v in list(ROUNDS.values())
                     + list(BLOCKS.values())})
    grids = {s: make_replica_grid(s, ("data", "model"), device_type="cpu")
             for s in shapes}
    rec = {}
    for name, case in BLOCKS.items():
        rec[name] = _block(name, grids[case[0]], inputs)
    for name, case in ROUNDS.items():
        rec[name] = _run(name, grids[case[0]], inputs)
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
