"""The rank side of ``tests/test_torch_sharded_serving.py``: one process per
rank of a 4-rank gloo group on the CPU (a ``FileStore``, no TCP port),
spawned once for the module. Imports torch and the port only.

The test process writes each scenario's numpy params, prefill input, start
tokens and (enc-dec) source frames to ``<out>/inputs.pkl``. For each
scenario of ``SCENARIOS`` every rank that belongs to the scenario's grid
(2 x 2 or 1 x 4, over the same four ranks) runs the dry run's serving cells
(``launch/dryrun.build_prefill_cell``, ``build_decode_cell``) from its
shards of the params (``models/api.shard_params``): one prefill, then (the
enc-dec's memory filled first by the cell's ``fill_cache``) a greedy
decode of ``steps`` steps from its slice of the family's initial cache
(``models/api.shard_cache``), feeding back its own argmax. It pickles to
``<out>/rank<r>.pkl`` its coordinates, the prefill's output, each step's
logits and token, its final cache slice and the collective bytes by use of
the prefill and of each step. Beside each scenario the port's one-process
prefill and greedy decode of the same weights run in the rank (no grid;
the hybrid's prefill under ``hints.seq_shard_view``, the grid's MoE
capacity), and the grid's decode again fed the one-process tokens
(``feed``), so that the test can hold them bit for bit where the design
keeps every sum whole. ``BF16_SCENARIOS`` run both again in bf16.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle

import numpy as np
import torch

#: the reduced models at widths whose states the cache's feature rule cuts
#: (a dimension of 1,024 or more over `model`): name -> (arch id, ModelCfg
#: overrides). Jamba at d_model 512 has d_inner 1,024 (its mamba h and conv
#: cut on d_inner); xlstm-350m at d_model 1,024 (one group: 3 mLSTM + 1
#: sLSTM) has the sLSTM's four (1, B, 1,024) leaves cut on D; seamless as
#: reduced (2 + 2 layers, d_model 64), its memory 2,048 slots
MODELS = {"hybrid": ("jamba_1_5_large_398b", {"d_model": 512}),
          "xlstm": ("xlstm_350m", {"d_model": 1024}),
          "encdec": ("seamless_m4t_large_v2", {})}
#: name -> (model, grid, big plan, decode batch, cache slots, steps,
#: prefill (batch, seq)). A batch of 16 splits over the production mesh's
#: client and micro axes (``cache_specs``), so over `data`: 8 rows a rank
#: on 2 x 2, 16 on 1 x 4. The slots (8: 4 or 2 a sequence rank; 12 at
#: batch 1, over both axes, 3 a rank) equal no other cache dimension (16 is
#: the mamba's d_state, 2,048 the memory's); the steps write into every
#: slot rank's slots. The enc-dec prefill's seq 64 is 32 frames
SCENARIOS = {
    "hybrid_22": ("hybrid", (2, 2), True, 16, 8, 8, (4, 32)),
    "hybrid_14": ("hybrid", (1, 4), True, 16, 8, 8, (4, 32)),
    "hybrid_b1": ("hybrid", (2, 2), True, 1, 12, 10, (2, 32)),
    "xlstm_22": ("xlstm", (2, 2), False, 16, 8, 6, (4, 32)),
    "xlstm_14": ("xlstm", (1, 4), False, 16, 8, 6, (4, 32)),
    "xlstm_b1": ("xlstm", (2, 2), False, 1, 8, 6, (2, 32)),
    "encdec_22": ("encdec", (2, 2), False, 16, 8, 8, (4, 64)),
    "encdec_14": ("encdec", (1, 4), False, 16, 8, 8, (4, 64)),
}
#: the scenarios run again in bf16 (the grid against the port's one
#: process; the reference runs f32 only)
BF16_SCENARIOS = ("hybrid_22", "xlstm_22", "encdec_22")
SRC_LEN = 2048


def arch(name, dtype=torch.float32):
    """The port's ArchConfig of a scenario's model in ``dtype``."""
    from repro_torch.configs.common import get_arch
    model, _, big = SCENARIOS[name][:3]
    arch_id, over = MODELS[model]
    m = dataclasses.replace(get_arch(arch_id).reduced().model, dtype=dtype,
                            **over)
    return dataclasses.replace(get_arch(arch_id), model=m, big=big,
                               seq_client_groups=2)


def shapes(name):
    """(prefill shape, decode shape) of a scenario."""
    from repro_torch.configs.common import ShapeCfg
    _, _, _, batch, slots, _, (pb, ps) = SCENARIOS[name]
    return (ShapeCfg("test_prefill", "prefill", ps, pb),
            ShapeCfg("test_decode", "decode", slots, batch))


def _by_use():
    from repro_torch.launch import hints
    return {k: v[0] for k, v in hints.COLLECTIVES.items()}


def _np(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda v: v.float().numpy().copy(), tree)


def _grid_run(name, grid, inputs, a, params, feed=None):
    """The scenario on the grid: arch ``a`` from ``params`` (a tree of
    tensors or numpy arrays); step t's input the previous step's argmax or,
    given ``feed``, ``feed[t]``."""
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import build_model, shard_cache, \
        shard_params
    steps = SCENARIOS[name][5]
    pre_shape, dec_shape = shapes(name)
    encdec = a.model.family == "encdec"
    rec = {"coords": dict(grid.coords)}
    prefill, _, plan = dryrun.build_prefill_cell(a, pre_shape, grid)
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    hints.reset_collective_stats()
    rec["prefill"] = prefill(shards, torch.from_numpy(
        inputs["prefill"][name])).float().numpy()
    rec["prefill_by_use"] = _by_use()
    step, ex, plan = dryrun.build_decode_cell(a, dec_shape, grid)
    shards = shard_params(params, a.model, grid, plan, device="cpu")
    whole = build_model(a.model).init_cache(dec_shape.global_batch,
                                            dec_shape.seq_len, device="cpu")
    cache = shard_cache(whole, ex["cache_specs"], grid, device="cpu")
    if encdec:
        hints.reset_collective_stats()
        ex["fill_cache"](shards, cache,
                         torch.from_numpy(inputs["frames"][name]))
        rec["fill_by_use"] = _by_use()
    tok = torch.from_numpy(inputs["start"][name])
    rec.update(logits=[], tokens=[], by_use=[])
    for t in range(steps):
        hints.reset_collective_stats()
        logits, cache = step(shards, cache, tok if feed is None else feed[t],
                             t)
        rec["by_use"].append(_by_use())
        rec["logits"].append(logits.numpy().copy())
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        rec["tokens"].append(tok.numpy().copy())
    rec["cache"] = _np(cache)
    rec["cache_specs"] = ex["cache_specs"]
    return rec


def _one_process(name, inputs, a, params):
    """The scenario in this process alone through the bundle's entry points
    (no grid): the prefill (the hybrid's under ``hints.seq_shard_view`` of
    the grid's sequence shards, whose MoE capacity the grid counts), the
    enc-dec's ``prefill_cache``, the greedy decode. -> prefill, logits,
    tokens (the start token first) and the final cache."""
    from repro_torch.launch import hints
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    _, grid_shape, _, batch, slots, steps, _ = SCENARIOS[name]
    bundle = build_model(a.model)
    with hints.seq_shard_view(grid_shape[1]):
        out = {"prefill": bundle.prefill(params, torch.from_numpy(
            inputs["prefill"][name])).float().numpy()}
    cache = bundle.init_cache(batch, slots, device="cpu")
    if a.model.family == "encdec":
        encdec.prefill_cache(params, cache,
                             torch.from_numpy(inputs["frames"][name]),
                             a.model)
    feed = [torch.from_numpy(inputs["start"][name])]
    logits = []
    for t in range(steps):
        lg, cache = bundle.decode_step(params, cache, feed[-1], t)
        logits.append(lg.numpy().copy())
        feed.append(torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None])
    out.update(logits=logits, tokens=[f.numpy() for f in feed],
               cache=_np(cache), feed=feed)
    return out


def _run(name, grids, inputs, dtype=torch.float32):
    """-> {"grid": the grid's own greedy run, "one": the one-process run,
    "fed": the grid's decode fed the one-process tokens (the grid's own run
    where its tokens are the one-process tokens)} in ``dtype`` (the f32
    numpy weights rounded, each leaf to the family's dtype for it)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import family_module
    a = arch(name, dtype)
    grid = grids[SCENARIOS[name][1]]
    # each leaf in the family's own dtype (the router, a_log, d_skip and
    # the xLSTM's gate biases and recurrent weights stay f32)
    params = tree_map(lambda v, m: torch.from_numpy(v).to(m.dtype),
                      inputs["params"][SCENARIOS[name][0]],
                      family_module(a.model).init_params(None, a.model,
                                                         device="meta"))
    one = _one_process(name, inputs, a, params)
    feed = one.pop("feed")
    own = _grid_run(name, grid, inputs, a, params)
    same = all(np.array_equal(t, f.numpy())
               for t, f in zip(own["tokens"], feed[1:]))
    return {"grid": own, "one": one,
            "fed": own if same else _grid_run(name, grid, inputs, a, params,
                                              feed)}


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_replica_grid
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    grids = {shape: make_replica_grid(shape, ("data", "model"),
                                      device_type="cpu")
             for shape in sorted({s[1] for s in SCENARIOS.values()})}
    import os, time
    rec = {}
    for name in SCENARIOS:
        t0 = time.time()
        rec[name] = _run(name, grids, inputs)
        if os.environ.get("SERVE_TIMES") and rank == 0:
            print("TIME", name, time.time() - t0, flush=True)
    rec["bf16"] = {name: _run(name, grids, inputs, torch.bfloat16)
                   for name in BF16_SCENARIOS}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
