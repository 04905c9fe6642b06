"""The rank side of ``tests/test_torch_sharded_stream.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch, numpy and the port only.

The test process writes the inputs (numpy params of the reduced
qwen2.5-32b and the (G, 1, 1, micro, S) token batches of G = 2 and 3) to
``<out>/inputs.pkl``. Every rank runs each scenario of ``SCENARIOS``
through the port's model-sharded round step on the big plan of a 2 x 2
``ReplicaGrid`` (G sequential groups of one client, the replica over data
x model, the micro-batch over `data`): the group round (the vmap plan) or
a forced ``stream(...)`` cohort, for ``ROUNDS`` rounds from the range state
of ``init_server_state(layout=)`` (round 1 drops the cohort's last
client). Each round records what each encode saw (at
``Pipeline.encode_range``: the (k, hi - lo) pseudo-gradient rows and
their payload), the param shards and the range state after it, the loss,
``shard_clients`` and the collective bytes by kind and use; the rank
pickles them to ``<out>/rank<r>.pkl``.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import numpy as np
import torch

import torch_sharded_ranks as R

ARCH_ID = "qwen2_5_32b"
SEQ = 32
ROUNDS = 2
SPECS = {"z": f"zsign(z=1,sigma={R.SIGMA})",
         "ef": "ef|zsign(use_kernel=true)"}
#: cohort of each scenario kind, by G: the group round and the streams
COHORTS = {"group": "auto", "k1": "stream(shard=1)", "k2": "stream(shard=2)",
           "k3": "stream(shard=3)", "k2_host": "stream(shard=2,feed=host)",
           "k1_dev2": "stream(shard=1,devices=2)"}
#: name -> (G, spec key, cohort key)
SCENARIOS = {
    **{f"{s}_g2_{k}": (2, s, k) for s in SPECS
       for k in ("group", "k1", "k2")},
    **{f"{s}_g3_{k}": (3, s, k) for s in SPECS
       for k in ("group", "k1", "k2", "k3", "k1_dev2")},
    "z_g3_k2_host": (3, "z", "k2_host"),
}


def arch(groups: int):
    """The port's ArchConfig of the reduced qwen2.5-32b (2 layers, d_model
    64, 4 heads with 2 kv heads, QKV bias, vocab 997, f32), a big arch of
    ``groups`` sequential client groups."""
    from repro_torch.configs.common import get_arch
    a = get_arch(ARCH_ID).reduced()
    return dataclasses.replace(a, seq_client_groups=groups, client_lr=R.CLR,
                               server_lr=R.SLR)


def plan_for(grid, groups: int):
    """The big plan: G groups of one client, micro-batch 2 over `data`."""
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch.sharding import make_plan
    return make_plan(arch(groups), ShapeCfg("test", "train", SEQ,
                                            2 * groups), grid)


def mask_of(groups: int, t: int) -> np.ndarray:
    """Round t's (G, 1) mask: everyone in round 0; round 1 drops the last
    client."""
    m = np.ones((groups, 1), np.float32)
    if t == 1:
        m[-1, 0] = 0.0
    return m


def _run(name, grid, inputs):
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model, shard_params
    G, spec, cohort = SCENARIOS[name]
    a = arch(G)
    plan = plan_for(grid, G)
    params = inputs["params"]
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    full = {}
    for p, v in tree_paths(params):
        tree_set(full, p, tuple(v.shape))
    specs = SH.param_specs(full, grid, plan)
    comp = TC.Pipeline(SPECS[spec])
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups, local_steps=1,
                        client_lr=R.CLR, server_lr=R.SLR)
    step = TF.build_sharded_round_step(
        build_model(a.model).loss_fn, comp, fcfg,
        SH.round_context(plan, cohort=COHORTS[cohort]), grid=grid,
        plan=plan, specs=specs)
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1),
                                 layout=step.layout(shards))
    enc = TC.Pipeline.encode_range
    rounds = []
    for t in range(ROUNDS):
        seen = {"x": [], "bytes": []}

        def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
            seen["x"].append(x2d.clone().numpy())
            out = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
            seen["bytes"].append(
                {k: v.clone().numpy() for k, v in out.items()}
                if isinstance(out, dict) else out.clone().numpy())
            return out

        TC.Pipeline.encode_range = encode_range
        hints.reset_collective_stats()
        try:
            batch = {"tokens": torch.from_numpy(inputs["tokens"][G][t])}
            state, m = step(state, batch, mask_of(G, t))
        finally:
            TC.Pipeline.encode_range = enc
        rounds.append({
            "params": {p: v.float().numpy().copy()
                       for p, v in tree_paths(state.params)},
            "state": ({k: v.numpy().copy()
                       for k, v in state.comp_state.items()}
                      if state.comp_state is not None else None),
            "loss": float(m.loss), "shard_clients": int(m.shard_clients),
            "collectives": hints.collective_totals(0),
            "collective_by_use": {k: v[0] for k, v in
                                  hints.COLLECTIVES.items()}, **seen})
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": step.layout(shards).bounds, "rounds": rounds}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    grid = make_replica_grid((2, 2), ("data", "model"), device_type="cpu")
    rec = {name: _run(name, grid, inputs) for name in SCENARIOS}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
