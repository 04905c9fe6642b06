"""The rank side of ``tests/test_torch_sharded_round.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch, numpy and the port only.

The test process writes the inputs (numpy params of a reduced dense model,
tokens, fixed pseudo-gradients) to ``<out>/inputs.pkl``; every rank runs
each scenario of ``SCENARIOS`` through the port's model-sharded round step
(``core/fedavg.build_sharded_round_step``) on a ``ReplicaGrid`` of the
default group and pickles what it saw to ``<out>/rank<r>.pkl``: its
coordinates, its range, the pseudo-gradient range and payload bytes of each
group (recorded at ``Pipeline.encode_range``), the decoded range (at
``Pipeline.decode_sum``), its param shards after the round, the loss, and
the collective bytes by kind.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import numpy as np
import torch

#: the reduced dense model (qwen2-0.5B's shape rules at test size)
MODEL = dict(name="reduced-dense", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, qkv_bias=True,
             q_chunk=16)
SEQ = 32
SIGMA, CLR, SLR = 0.01, 0.1, 0.5
WIRE_INF = "zsign(z=inf,sigma=0.05)"
WIRE_Z1 = "zsign_packed(z=1,sigma=0.01)"

#: name -> (grid shape, big plan, pipeline, options)
SCENARIOS = {
    "wire_inf_22": ((2, 2), False, WIRE_INF, {"linear": True}),
    "wire_inf_14": ((1, 4), False, WIRE_INF, {"linear": True}),
    "wire_z1_22": ((2, 2), False, WIRE_Z1, {"linear": True}),
    "round_regular": ((2, 2), False, f"zsign(z=1,sigma={SIGMA})", {}),
    "round_big": ((2, 2), True, f"zsign(z=1,sigma={SIGMA})", {}),
    "round_regular_noremat": ((2, 2), False, f"zsign(z=1,sigma={SIGMA})",
                              {"remat": False}),
    "round_regular_saveweights": ((2, 2), False,
                                  f"zsign(z=1,sigma={SIGMA})",
                                  {"save_weights": True}),
    "round_big_noremat": ((2, 2), True, f"zsign(z=1,sigma={SIGMA})",
                          {"remat": False}),
}


def arch(big: bool, save_weights: bool = False):
    """The port's ArchConfig of the reduced dense model: regular (clients
    over data) or big (2 sequential groups, the replica over data x
    model)."""
    from repro_torch.configs.common import ArchConfig
    from repro_torch.models.api import ModelCfg
    m = ModelCfg(dtype=torch.float32, remat_save_weights=save_weights,
                 **MODEL)
    return ArchConfig(arch_id="reduced_dense", model=m, source="test",
                      big=big, seq_client_groups=2, client_lr=CLR,
                      server_lr=SLR)


def plan_for(grid, big: bool):
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch.sharding import make_plan
    # micro-batch 2 per client step
    return make_plan(arch(big), ShapeCfg("test", "train", SEQ, 4), grid)


def _run(name, grid, inputs):
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model, shard_params
    shape, big, spec, opt = SCENARIOS[name]
    a = arch(big, opt.get("save_weights", False))
    plan = plan_for(grid, big)
    bundle = build_model(a.model)
    shards = shard_params(inputs["params"], a.model, grid, plan,
                          device="cpu")
    # the specs of the FULL shapes
    full_shapes = {p: np.asarray(v).shape
                   for p, v in tree_paths(inputs["params"])}
    specs = {}
    for p, s in full_shapes.items():
        tree_set(specs, p, s)
    specs = SH.param_specs(specs, grid, plan)
    if opt.get("linear"):
        # the fixed pseudo-gradient of client c is G[c]: a linear loss
        g_shards = [shard_params(g, a.model, grid, plan, device="cpu")
                    for g in inputs["G"]]

        def loss_fn(p, b):
            c = int(b["c"].reshape(-1)[0])
            return sum(torch.sum(w * gw) for (_, w), (_, gw) in
                       zip(tree_paths(p), tree_paths(g_shards[c])))
        batch = {"c": torch.from_numpy(inputs["client_index"][
            :plan.client_groups, :plan.n_clients])}
    else:
        loss_fn = bundle.loss_fn
        batch = {"tokens": torch.from_numpy(
            inputs["tokens_big" if big else "tokens"])}
    comp = TC.Pipeline(spec)
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups, local_steps=1,
                        client_lr=CLR, server_lr=SLR)
    step = TF.build_sharded_round_step(loss_fn, comp, fcfg,
                                       SH.round_context(plan), grid=grid,
                                       plan=plan, specs=specs,
                                       remat=opt.get("remat", True))
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1))
    seen = {"x": [], "bytes": [], "decoded": None}
    enc, dec = TC.Pipeline.encode_range, TC.Pipeline.decode_sum

    def encode_range(self, keys, x2d, tile0, sigma=None):
        out = enc(self, keys, x2d, tile0, sigma=sigma)
        seen["x"].append(x2d.clone().numpy())
        seen["bytes"].append(out.clone().numpy())
        seen["tile0"] = tile0
        return out

    def decode_sum(self, *a, **k):
        g = dec(self, *a, **k)
        seen["decoded"] = g.clone().numpy()
        return g

    TC.Pipeline.encode_range, TC.Pipeline.decode_sum = encode_range, \
        decode_sum
    hints.reset_collective_stats()
    try:
        state, m = step(state, batch, np.ones((plan.client_groups,
                                               plan.n_clients), np.float32))
    finally:
        TC.Pipeline.encode_range, TC.Pipeline.decode_sum = enc, dec
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": step.layout(shards).bounds,
            "params": {p: v.numpy() for p, v in tree_paths(state.params)},
            "loss": float(m.loss), "norm": float(m.grad_est_norm),
            "uplink_bits": float(m.uplink_bits),
            "collectives": hints.collective_totals(0), **seen}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    grids = {s: make_replica_grid(s, ("data", "model"), device_type="cpu")
             for s in sorted({v[0] for v in SCENARIOS.values()})}
    rec = {}
    for name, (shape, _, _, _) in SCENARIOS.items():
        rec[name] = _run(name, grids[shape], inputs)
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
