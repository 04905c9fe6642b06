"""The rank side of ``tests/test_torch_sharded_round.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once per test module. Imports torch, numpy and the port only.

The test process writes the inputs (numpy params of a reduced dense model,
tokens, fixed pseudo-gradients; or, for ``tests/test_torch_sharded_moe.py``,
the reduced MoE and VLM models' params and batches) to
``<out>/inputs.pkl``; every rank runs each scenario of ``SCENARIOS`` (or
``MOE_SCENARIOS``) through the port's model-sharded round step
(``core/fedavg.build_sharded_round_step``) on a ``ReplicaGrid`` of the
default group and pickles what it saw to ``<out>/rank<r>.pkl``: its
coordinates, its range, the pseudo-gradient range and payload bytes of each
group (recorded at ``Pipeline.encode_range``), the decoded range (at
``Pipeline.decode_sum``), its param shards after the round, the loss, each
client's MoE aux (recorded at ``transformer.forward_hidden``), and the
collective bytes by kind. ``tests/test_torch_sharded_pipelines.py`` runs
``PIPELINE_SCENARIOS`` (``which="pipelines"``): two rounds each of the
stateful and transform pipelines on the range state, with what each round
saw.
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
    # a bare stream cohort on a plan with client axes is the vmap round
    "round_regular_stream": ((2, 2), False, f"zsign(z=1,sigma={SIGMA})",
                             {"cohort": "stream"}),
}

#: the pipelines of ``tests/test_torch_sharded_pipelines.py``, each on
#: the regular plan of the 2 x 2 and 1 x 4 grids and the big plan of the
#: 2 x 2 grid, on the linear-loss wire harness: the stateful and transform
#: stages, the robust sign laws, dense z > 1, top-k (``sched_topk``: a
#: codec whose pad multiple is 1 behind the leaf-offset stage), QSGD and
#: dpgauss
PIPELINE_SPECS = {"ef": "ef|zsign", "ef_f1": "ef|zsign(use_kernel=true)",
                  "ef_noisy": "ef|zsign(z=1,sigma=0.01)",
                  "cv": "cv|zsign_packed",
                  "dp": "dp(clip=1.0,eps=2.0)|zsign_packed",
                  "sched": "sigma_sched(head=1.0,tail=0.25)|zsign(z=1,"
                           "sigma=0.01)",
                  "stosign": "stosign",
                  "vote": "zsign(z=1,sigma=0.01,agg=vote)",
                  "trimmed": "zsign(z=1,sigma=0.01,agg=trimmed(f=1))",
                  "median": "zsign(z=1,sigma=0.01,agg=median)",
                  "z2": "zsign_packed(z=2,sigma=0.01)",
                  "topk": "topk(frac=0.25)",
                  "ef_topk": "ef|topk(frac=0.25)",
                  "topk_coord": "topk(frac=0.25,agg=coord)",
                  "sched_topk": "sigma_sched(head=1.0,tail=0.25)|topk("
                                "frac=0.25)",
                  "qsgd": "qsgd(s=1)",
                  "dpgauss": "dp(clip=1.0,noise=0.1)|dense"}
#: the specs whose dense noise both packages draw from one numpy table
#: (``inputs["noise"]``, by client key), so that the grid is held to the
#: reference as the one-process round is
TABLE_NOISE = ("z2", "dpgauss")
PIPELINE_GRIDS = {"22": ((2, 2), False), "14": ((1, 4), False),
                  "big": ((2, 2), True)}
PIPELINE_ROUNDS = 2
#: the robust laws under each adversary kind: every law with the clients
#: side by side (2 x 2), and the median on the big plan's groups
ADVERSARIES = {"sign_flip": "sign_flip(f=1)",
               "byte_corrupt": "byte_corrupt(f=1,p=0.1)",
               "collude": "collude(f=1)", "dropout": "dropout(f=1)"}
ADVERSARY_SCENARIOS = {
    **{f"adv_{law}_{kind}_22": ((2, 2), False, PIPELINE_SPECS[law],
                                {"linear": True, "adversary": adv})
       for law in ("vote", "trimmed", "median")
       for kind, adv in ADVERSARIES.items()},
    **{f"adv_median_{kind}_big": ((2, 2), True, PIPELINE_SPECS["median"],
                                  {"linear": True, "adversary": adv})
       for kind, adv in ADVERSARIES.items()}}
PIPELINE_SCENARIOS = {
    **{f"{k}_{g}": (shape, big, spec,
                    {"linear": True, "table": k in TABLE_NOISE})
       for k, spec in PIPELINE_SPECS.items()
       for g, (shape, big) in PIPELINE_GRIDS.items()},
    # the block-keyed dense draw itself (no table)
    **{f"{k}_block_22": ((2, 2), False, PIPELINE_SPECS[k], {"linear": True})
       for k in TABLE_NOISE},
    # 2 groups of 2 clients side by side: the dense wire's fold walks the
    # client axis twice
    **{f"{k}_g2_22": ((2, 2), False, PIPELINE_SPECS[k],
                      {"linear": True, "groups": 2})
       for k in ("qsgd", "dpgauss")},
    **ADVERSARY_SCENARIOS}


def pipeline_mask(plan, t: int) -> np.ndarray:
    """Round t's (G, N) 0/1 mask: everyone in round 0; round 1 drops the
    cohort's last client."""
    m = np.ones((plan.client_groups, plan.n_clients), np.float32)
    if t == 1:
        m[-1, -1] = 0.0
    return m


#: the reduced MoE and VLM models: name -> (arch id, ModelCfg overrides)
FAMILIES = {"granite": ("granite_moe_1b_a400m", {}),
            "llama4": ("llama4_scout_17b_a16e", {}),
            "internvl2": ("internvl2_1b", {}),
            # a vocab that splits over the model axis: the embedding table
            # is stored sharded, so the text lookup must read the gathered
            # table
            "internvl2_v256": ("internvl2_1b", {"vocab": 256})}
#: the sequence of the MoE scenarios, and the one whose S_loc * k < E
#: forces the reference's ns = 1 (llama4: k = 1, E = 4, S_loc = 3)
MOE_SEQ, MOE_SEQ_NS1 = 32, 6
_Z1 = f"zsign(z=1,sigma={SIGMA})"
MOE_SCENARIOS = {
    "granite_regular": ((2, 2), False, _Z1, {"model": "granite"}),
    "llama4_big": ((2, 2), True, _Z1, {"model": "llama4"}),
    "llama4_big_ns1": ((2, 2), True, _Z1, {"model": "llama4",
                                           "seq": MOE_SEQ_NS1}),
    "internvl2_regular": ((2, 2), False, _Z1, {"model": "internvl2"}),
    "internvl2_v256": ((2, 2), False, _Z1, {"model": "internvl2_v256"}),
}


def arch(big: bool, save_weights: bool = False, model=None):
    """The port's ArchConfig of the reduced dense model, or of the reduced
    ``FAMILIES[model]``: regular (clients over data) or big (2 sequential
    groups, the replica over data x model)."""
    from repro_torch.configs.common import ArchConfig, get_arch
    from repro_torch.models.api import ModelCfg
    if model is None:
        m = ModelCfg(dtype=torch.float32, remat_save_weights=save_weights,
                     **MODEL)
    else:
        arch_id, over = FAMILIES[model]
        m = dataclasses.replace(get_arch(arch_id).reduced().model, **over)
    return ArchConfig(arch_id=model or "reduced_dense", model=m,
                      source="test", big=big, seq_client_groups=2,
                      client_lr=CLR, server_lr=SLR)


def plan_for(grid, big: bool, seq: int = SEQ, groups=None):
    """The plan rules' plan (micro-batch 2 per client step), or, with
    ``groups``, that many sequential groups beside its clients."""
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch.sharding import make_plan
    plan = make_plan(arch(big), ShapeCfg("test", "train", seq, 4), grid)
    if groups is None:
        return plan
    return dataclasses.replace(plan, client_groups=groups,
                               micro=max(1, plan.micro // groups))


def _cell(name, grid, inputs):
    """The scenario's sharded round step on ``grid`` -> (step, its
    FedConfig, the pipeline, this rank's param shards, the batch, plan)."""
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model, shard_params
    shape, big, spec, opt = {**SCENARIOS, **MOE_SCENARIOS,
                             **PIPELINE_SCENARIOS}[name]
    a = arch(big, opt.get("save_weights", False), opt.get("model"))
    plan = plan_for(grid, big, opt.get("seq", SEQ), opt.get("groups"))
    bundle = build_model(a.model)
    params = inputs["params"] if "model" not in opt else \
        inputs["models"][opt["model"]]
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    # the specs of the FULL shapes
    full_shapes = {p: np.asarray(v).shape for p, v in tree_paths(params)}
    specs = {}
    for p, s in full_shapes.items():
        tree_set(specs, p, s)
    specs = SH.param_specs(specs, grid, plan,
                           moe_experts=a.model.moe_experts)
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
    elif "model" in opt:
        loss_fn = bundle.loss_fn
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["batches"][name].items()}
    else:
        loss_fn = bundle.loss_fn
        batch = {"tokens": torch.from_numpy(
            inputs["tokens_big" if big else "tokens"])}
    comp = TC.Pipeline(spec)
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups, local_steps=1,
                        client_lr=CLR, server_lr=SLR)
    step = TF.build_sharded_round_step(
        loss_fn, comp, fcfg,
        SH.round_context(plan, cohort=opt.get("cohort", "auto"),
                         adversary=opt.get("adversary", "none")), grid=grid,
        plan=plan, specs=specs, remat=opt.get("remat", True))
    return step, fcfg, comp, shards, batch, plan


def _run(name, grid, inputs):
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import hints
    from repro_torch.models import transformer as TT
    step, fcfg, comp, shards, batch, plan = _cell(name, grid, inputs)
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1))
    seen = {"x": [], "bytes": [], "decoded": None, "aux": []}
    enc, dec = TC.Pipeline.encode_range, TC.Pipeline.decode_sum
    fwd = TT.forward_hidden

    def forward_hidden(*a, **k):
        x, aux = fwd(*a, **k)
        seen["aux"].append(float(aux.detach()))
        return x, aux

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        seen["x"].append(x2d.clone().numpy())
        out = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        seen["bytes"].append(out.clone().numpy())
        seen["tile0"] = tile0
        return out

    def decode_sum(self, *a, **k):
        g = dec(self, *a, **k)
        seen["decoded"] = g.clone().numpy()
        return g

    TC.Pipeline.encode_range, TC.Pipeline.decode_sum = encode_range, \
        decode_sum
    TT.forward_hidden = forward_hidden
    hints.reset_collective_stats()
    try:
        state, m = step(state, batch, np.ones((plan.client_groups,
                                               plan.n_clients), np.float32))
    finally:
        TC.Pipeline.encode_range, TC.Pipeline.decode_sum = enc, dec
        TT.forward_hidden = fwd
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": step.layout(shards).bounds,
            "params": {p: v.numpy() for p, v in tree_paths(state.params)},
            "loss": float(m.loss), "norm": float(m.grad_est_norm),
            "uplink_bits": float(m.uplink_bits),
            "collectives": hints.collective_totals(0),
            "collective_by_use": {k: v[0] for k, v in
                                  hints.COLLECTIVES.items()}, **seen}


def table_noise(table):
    """A stand-in for ``noise.sample_z_noise`` that reads client key k's
    noise row from ``table`` ({(k0, k1): (d,) f32}), coordinates [lo, lo +
    n) of it."""
    def sample(key, shape, z, device=None, dtype=torch.float32, lo=0):
        n = int(np.prod(shape))
        row = table[tuple(int(w) for w in key.reshape(2).tolist())]
        return torch.from_numpy(row[lo:lo + n].copy()).reshape(shape)
    return sample


def _run_pipeline(name, grid, inputs):
    """PIPELINE_ROUNDS rounds of a PIPELINE_SCENARIOS cell from the range
    state of ``init_server_state(layout=)``: each round's pseudo-gradient
    range and payload of each group (at ``Pipeline.encode_range``; after
    the adversary's attack, ``Adversary.corrupt``), the whole-vector
    statistics the ranks summed (``dp.row_norms`` over ranges; the EF
    scale rides in the payload), the decoded range, the state and server
    rows, the params, the metrics and the collective bytes by kind and
    use."""
    from repro_torch.core import compression as TC
    from repro_torch.core import dp as TD
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths
    from repro_torch.fed import adversary as TA
    from repro_torch.launch import hints
    step, fcfg, comp, shards, batch, plan = _cell(name, grid, inputs)
    layout = step.layout(shards)
    state = TF.init_server_state(shards, fcfg, comp, TN.prng_key(1),
                                 layout=layout)
    enc, dec, norms = (TC.Pipeline.encode_range, TC.Pipeline.decode_sum,
                       TD.row_norms)
    corrupt, draw = TA.Adversary.corrupt, TN.sample_z_noise
    rounds = []

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        rd = rounds[-1]
        rd["x"].append(x2d.clone().numpy())
        fused = self._use_ef_kernel(sigma)
        if fused:
            # F1 reads g and e and writes e': its codec input is g + e
            p = x2d[:, :kw["state"]["ef"].shape[-1]] + kw["state"]["ef"]
        out = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        # the stages work in place: the rows are now the codec's input
        rd["codec_in"].append(p.numpy() if fused else x2d.clone().numpy())
        rd["payload"].append(_numpy_payload(out))
        if "packed" in rd["payload"][-1]:
            rd["bytes"].append(rd["payload"][-1]["packed"])
        if isinstance(out, dict) and "scale" in out:
            rd["scale"].append(out["scale"].clone().numpy())
        rd["tile0"] = tile0
        return out

    def attack(self, payload, idx, round_idx, b0=0):
        out = corrupt(self, payload, idx, round_idx, b0)
        rounds[-1]["attacked"].append(_numpy_payload(out))
        return out

    def decode_sum(self, *a, **k):
        g = dec(self, *a, **k)
        rounds[-1]["decoded"] = g.clone().numpy()
        return g

    def row_norms(p2d, n_coords, all_sum=None):
        out = norms(p2d, n_coords, all_sum)
        if all_sum is not None:
            rounds[-1]["norms"].append(out.clone().numpy())
        return out

    TC.Pipeline.encode_range, TC.Pipeline.decode_sum = encode_range, \
        decode_sum
    TD.row_norms = row_norms
    TA.Adversary.corrupt = attack
    if PIPELINE_SCENARIOS[name][3].get("table"):
        TN.sample_z_noise = table_noise(inputs["noise"])
    try:
        for t in range(PIPELINE_ROUNDS):
            rounds.append({"x": [], "codec_in": [], "bytes": [], "scale": [],
                           "norms": [], "payload": [], "attacked": []})
            hints.reset_collective_stats()
            state, m = step(state, batch, pipeline_mask(plan, t))
            rounds[-1].update({
                "state": {k: v.clone().numpy() for k, v in
                          (state.comp_state or {}).items()},
                "server": {k: v.clone().numpy() for k, v in
                           (state.comp_server or {}).items()},
                "params": {p: v.clone().numpy()
                           for p, v in tree_paths(state.params)},
                "loss": float(m.loss), "norm": float(m.grad_est_norm),
                "uplink_bits": float(m.uplink_bits),
                "collectives": hints.collective_totals(0),
                "collective_by_use": {k: v[0] for k, v in
                                      hints.COLLECTIVES.items()}})
    finally:
        TC.Pipeline.encode_range, TC.Pipeline.decode_sum = enc, dec
        TD.row_norms = norms
        TA.Adversary.corrupt, TN.sample_z_noise = corrupt, draw
    return {"coords": dict(grid.coords), "plan": dataclasses.asdict(plan),
            "bounds": layout.bounds, "d": layout.spec.n_coords,
            "rounds": rounds}


def _numpy_payload(p) -> dict:
    """A payload as numpy arrays by kind: "packed" (and "scale") bytes,
    "dense" f32 rows, or top-k's "values" and "indices"."""
    if isinstance(p, dict):
        return {k: v.clone().numpy() for k, v in p.items()}
    return {"packed" if p.dtype == torch.uint8 else "dense":
            p.clone().numpy()}


def _expert_swap_bf16(grid):
    """A bf16 (B, E, C, D) buffer, this rank's own values, to the experts'
    ranks over `model` and back (``hints.expert_swap``), as int16 words."""
    from repro_torch.launch import hints
    B, E, C, D = 2, 4, 3, 8
    x = (torch.arange(B * E * C * D, dtype=torch.float32) / 7
         + 100 * grid.rank).reshape(B, E, C, D).to(torch.bfloat16)
    with hints.sharding_hints(grid, ("model",), replica_axes=("model",)):
        to = hints.expert_swap(x, True)
        back = hints.expert_swap(to, False)
    return {"coords": dict(grid.coords),
            **{k: v.view(torch.int16).numpy()
               for k, v in (("x", x), ("to", to), ("back", back))}}


def main(rank: int, world: int, store: str, out: str,
         which: str = "dense") -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    scenarios = {"dense": SCENARIOS, "moe": MOE_SCENARIOS,
                 "pipelines": PIPELINE_SCENARIOS}[which]
    run = _run_pipeline if which == "pipelines" else _run
    grids = {s: make_replica_grid(s, ("data", "model"), device_type="cpu")
             for s in sorted({v[0] for v in scenarios.values()})}
    rec = {}
    for name, (shape, _, _, _) in scenarios.items():
        rec[name] = run(name, grids[shape], inputs)
    if which == "moe":
        rec["expert_swap_bf16"] = _expert_swap_bf16(grids[(2, 2)])
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
