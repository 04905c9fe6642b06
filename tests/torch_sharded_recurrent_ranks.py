"""The rank side of ``tests/test_torch_sharded_recurrent.py``: one process
per rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch, numpy and the port only.

The test process writes the inputs (numpy params of the reduced xLSTM and
hybrid models, their (G, N, E, micro, S) token batches, the block cases'
weights and inputs) to ``<out>/inputs.pkl``. Every rank runs

  * each round of ``ROUNDS`` through the port's model-sharded round step
    (``core/fedavg.build_sharded_round_step``) on a ``ReplicaGrid`` of the
    default group, recording its coordinates, its range, each group's
    pseudo-gradient range and payload bytes (at ``Pipeline.encode_range``),
    its param shards after the round, the loss, each client's MoE aux (at
    ``hybrid.forward_hidden``) and the collective bytes by kind and use;
  * each block case of ``BLOCKS`` on this rank's slice under the grid's
    hints: the mLSTM and sLSTM blocks with their weights whole, the mamba
    block with its weights stored as the big plan's shards and gathered
    (``hints.fsdp_gather``), forward and backward of a fixed upstream
    gradient: the output slice, the input slice's gradient and each
    weight's gradient (the whole weight's, or this rank's shard's);

and pickles what it saw to ``<out>/rank<r>.pkl``.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import numpy as np
import torch

import torch_sharded_ranks as R

#: the reduced families: name -> (arch id, seq, ModelCfg overrides)
MODELS = {"xlstm": ("xlstm_350m", 512, {}),
          "hybrid": ("jamba_1_5_large_398b", 64, {})}
_Z1 = f"zsign(z=1,sigma={R.SIGMA})"
#: name -> (grid shape, big plan, model, options). xLSTM-350m is a regular
#: arch (a client a data row, the replica and sequence over `model`),
#: Jamba a big one (2 sequential groups, the replica over data x model,
#: the micro-batch over `data`, the sequence over `model`)
ROUNDS = {
    "xlstm_22": ((2, 2), False, "xlstm", {}),
    "xlstm_14": ((1, 4), False, "xlstm", {}),
    # the mLSTM's key chunk cut to 16 in both packages (``CHUNK``, which
    # moves no value's formula): 2 key chunks at seq 32, where the f32
    # gradients of both packages are well conditioned
    "xlstm_c16_22": ((2, 2), False, "xlstm", {"seq": 32, "chunk": 16}),
    "xlstm_c16_14": ((1, 4), False, "xlstm", {"seq": 32, "chunk": 16}),
    "xlstm_22_noremat": ((2, 2), False, "xlstm", {"remat": False}),
    "xlstm_22_noweights": ((2, 2), False, "xlstm", {"save_weights": False}),
    "hybrid_22": ((2, 2), True, "hybrid", {}),
    "hybrid_14": ((1, 4), True, "hybrid", {}),
    "hybrid_22_noremat": ((2, 2), True, "hybrid", {"remat": False}),
    "hybrid_22_weights": ((2, 2), True, "hybrid", {"save_weights": True}),
}
#: the block cases: name -> (grid shape, block, batch, seq). Each runs
#: under the big plan's hints of its grid (the sequence over `model`, the
#: batch over `data`)
BLOCKS = {"mamba_22": ((2, 2), "mamba", 4, 32),
          "mamba_14": ((1, 4), "mamba", 2, 32),
          "mlstm_22": ((2, 2), "mlstm", 4, 512),
          "mlstm_14": ((1, 4), "mlstm", 2, 512),
          "slstm_14": ((1, 4), "slstm", 2, 16)}
BLOCK_D, BLOCK_H = 32, 4


def arch(model: str, big: bool, save_weights=None):
    """The port's ArchConfig of the reduced ``MODELS[model]`` (f32), on
    the regular or the big plan (2 sequential groups)."""
    from repro_torch.configs.common import get_arch
    arch_id, _, over = MODELS[model]
    m = get_arch(arch_id).reduced().model
    if save_weights is not None:
        over = dict(over, remat_save_weights=save_weights)
    m = dataclasses.replace(m, **over)
    return dataclasses.replace(get_arch(arch_id), model=m, big=big,
                               seq_client_groups=2, client_lr=R.CLR,
                               server_lr=R.SLR)


def seq_of(name: str) -> int:
    _, _, model, opt = ROUNDS[name]
    return opt.get("seq", MODELS[model][1])


def plan_for(grid, name: str):
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch.sharding import make_plan
    _, big, model, _ = ROUNDS[name]
    return make_plan(arch(model, big), ShapeCfg("test", "train",
                                                seq_of(name), 4), grid)


def _run(name, grid, inputs):
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models import hybrid as TH
    from repro_torch.models import xlstm as TX
    from repro_torch.models.api import build_model, shard_params
    _, big, model, opt = ROUNDS[name]
    a = arch(model, big, opt.get("save_weights"))
    plan = plan_for(grid, name)
    params = inputs["params"][model]
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    full = {}
    for p, v in tree_paths(params):
        tree_set(full, p, tuple(v.shape))
    specs = SH.param_specs(full, grid, plan, moe_experts=a.model.moe_experts)
    comp = TC.Pipeline(_Z1)
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups, local_steps=1,
                        client_lr=R.CLR, server_lr=R.SLR)
    step = TF.build_sharded_round_step(
        build_model(a.model).loss_fn, comp, fcfg, SH.round_context(plan),
        grid=grid, plan=plan, specs=specs, remat=opt.get("remat", True))
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1))
    seen = {"x": [], "bytes": [], "aux": []}
    enc, fwd = TC.Pipeline.encode_range, TH.forward_hidden

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        seen["x"].append(x2d.clone().numpy())
        out = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        seen["bytes"].append(out.clone().numpy())
        return out

    def forward_hidden(*args, **kw):
        x, aux = fwd(*args, **kw)
        seen["aux"].append(float(aux.detach()))
        return x, aux

    chunk = TX.CHUNK
    TC.Pipeline.encode_range, TH.forward_hidden = encode_range, \
        forward_hidden
    TX.CHUNK = opt.get("chunk", chunk)
    hints.reset_collective_stats()
    try:
        batch = {"tokens": torch.from_numpy(inputs["tokens"][name])}
        state, m = step(state, batch, np.ones((plan.client_groups,
                                               plan.n_clients), np.float32))
    finally:
        TC.Pipeline.encode_range, TH.forward_hidden = enc, fwd
        TX.CHUNK = chunk
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": step.layout(shards).bounds,
            "params": {p: v.float().numpy() for p, v in tree_paths(state.params)},
            "loss": float(m.loss),
            "collectives": hints.collective_totals(0),
            "collective_by_use": {k: v[0] for k, v in
                                  hints.COLLECTIVES.items()}, **seen}


def _block_plan(grid):
    """The big plan's axes on ``grid``: the sequence over `model`, the
    batch over `data`, the replica over both."""
    from repro_torch.launch.sharding import ParallelPlan
    return ParallelPlan(client_axes=(), micro_axes=("data",),
                        seq_axes=("model",), replica_axes=("data", "model"),
                        n_clients=1, client_groups=1, micro=1, local_steps=1)


def _block(name, grid, inputs):
    """One block case: this rank's slice of x and of the upstream gradient
    through the block under the grid's hints -> its output slice and the
    gradients (input slice; mamba: each weight shard's, mLSTM / sLSTM:
    each whole weight's, this rank's share before any sum)."""
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models import mamba as TM
    from repro_torch.models import xlstm as TX
    _, kind, B, S = BLOCKS[name]
    case = inputs["blocks"][name]
    plan = _block_plan(grid)
    specs, lp = {}, {}
    if kind == "mamba":
        # the stored (1, ...) leaves, cut by the big plan's spec rules
        stored = {"mamba": {k: v[None] for k, v in case["lp"].items()}}
        shapes = {"mamba": {k: v.shape for k, v in stored["mamba"].items()}}
        specs = SH.param_specs(shapes, grid, plan)
        for path, spec in tree_paths(specs):
            v = stored[path[0]][path[1]]
            idx = [slice(None)] * v.ndim
            for d, axes in SH.spec_dims(spec):
                n = SH.axis_size(grid, axes)
                c = v.shape[d] // n
                i = grid.index(axes)
                idx[d] = slice(i * c, (i + 1) * c)
            tree_set(lp, path, torch.from_numpy(
                np.ascontiguousarray(v[tuple(idx)])).requires_grad_(True))
    else:
        lp = {kind: {k: torch.from_numpy(v.copy()).requires_grad_(True)
                     for k, v in case["lp"].items()}}
    with hints.sharding_hints(grid, plan.seq_axes, plan.micro_axes,
                              replica_axes=plan.replica_axes, specs=specs,
                              remat=False):
        hints.local_positions(B, S, "cpu")
        x = hints.seq_shard(torch.from_numpy(case["x"]))
        dy = hints.seq_shard(torch.from_numpy(case["dy"]))
        x = x.clone().requires_grad_(True)
        hints.reset_collective_stats()
        if kind == "mamba":
            w = hints.fsdp_gather({k: v[0] for k, v in lp["mamba"].items()},
                                  ("mamba",))
            y = TM.mamba_block(x, w, d_model=BLOCK_D)
        elif kind == "mlstm":
            y = TX.mlstm_block(x, lp["mlstm"], n_heads=BLOCK_H)
        else:
            y = TX.slstm_block(x, lp["slstm"], n_heads=BLOCK_H)
        leaves = [x] + [v for _, v in tree_paths(lp)]
        grads = torch.autograd.grad(y, leaves, dy)
    return {"coords": dict(grid.coords), "y": y.detach().numpy(),
            "dx": grads[0].numpy(),
            "dw": {".".join(p): g.numpy() for (p, _), g in
                   zip(tree_paths(lp), grads[1:])},
            "specs": {".".join(p): s for p, s in tree_paths(specs)},
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
